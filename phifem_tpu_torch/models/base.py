"""Shared scheme machinery: tagging and measures (bg and sub mode), the
re-discretized and the lattice preconditioners, error norms.

Counterpart of :mod:`phifem_tpu.models.base`.  One path of
``lattice_preconditioner`` raises ``NotImplementedError``: the Ritz modes
(measured not to help S5).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..assembly import Batch, CellTerm, assemble_scalar
from ..grid import Grid
from ..measures import FacetSideList
from ..spaces import Function, Space, interpolate
from ..tagging import TagsMeasures, _build_submesh, compute_tags_measures

LevelSetLike = Union[Callable, Function]


@dataclasses.dataclass
class SchemeBase:
    """Common state of the phi-FEM schemes.  ``mode="bg"`` solves on the
    background grid with one-sided boundary measures (box mode);
    ``mode="sub"`` integrates the boundary term over the exterior of the
    submesh of active cells (box_mode=False)."""

    grid: Grid
    mode: str = "bg"
    detection_degree: int = 1
    single_layer_cut: bool = False
    pen_coef: float = 1.0
    stab_coef: float = 1.0

    def tag(self, detection_levelset: LevelSetLike) -> TagsMeasures:
        """Tag the grid; the dense parent-grid host tags drive the terms'
        regions in both modes (the submesh is an active-cell view of the
        same grid)."""
        if self.mode not in ("bg", "sub"):
            raise ValueError(f"mode must be 'bg' or 'sub', got {self.mode!r}")
        res = compute_tags_measures(
            self.grid,
            detection_levelset,
            self.detection_degree,
            box_mode=True,
            single_layer_cut=self.single_layer_cut,
        )
        self.tags = res
        self.cell_tags = res.cells_tags.as_numpy()
        self.facet_tags = res.facets_tags.as_numpy()
        if self.mode == "sub":
            self.submesh = _build_submesh(self.grid, self.cell_tags, self.facet_tags)
        else:
            self.submesh = None
        return res

    def boundary_measure(self) -> FacetSideList:
        """The scheme's ds on Gamma_h: one-sided subdomain id 100 in bg
        mode, the submesh exterior in sub mode."""
        if self.mode == "bg":
            return self.tags.boundaries_measure(100)
        return self.submesh.exterior

    # ------------------------------------------------------ multigrid
    def _mg_cached(self, key, refresh: bool):
        cache = self.__dict__.setdefault("_mg_cache", {})
        return None if refresh else cache.get(key)

    def mg_preconditioner(self, min_n: int = 8, refresh: bool = False, **vcycle_kw):
        """Geometric V-cycle with re-discretized (re-tagged, re-assembled)
        coarse levels, the CutFEM multigrid design
        (:func:`phifem_tpu_torch.mg.build_hierarchy`), plus the cut-band
        interface solve.  Needs ``setup`` and ``assemble``; each scheme's
        ``setup`` records its arguments so coarse levels rebuild the same
        problem.  ``interface_*`` keywords go to
        :func:`~phifem_tpu_torch.mg.attach_interface_solve` (``interface=
        False`` drops the band solve), the rest to ``build_hierarchy``.
        Memoized per argument set and operator data version;
        ``refresh=True`` rebuilds."""
        from ..mg import attach_interface_solve, build_hierarchy
        from ..solvers import masked_operator

        key = ("mg", min_n, repr(sorted(vcycle_kw.items())), self.op.data_version)
        vc = self._mg_cached(key, refresh)
        if vc is not None:
            return vc
        interface = vcycle_kw.pop("interface", True)
        interface_kw = {
            k[len("interface_") :]: vcycle_kw.pop(k) for k in list(vcycle_kw) if k.startswith("interface_")
        }

        def make_level(grid: Grid):
            if grid is self.grid:
                s = self
            else:
                s = dataclasses.replace(self, grid=grid)
                s.setup(*self._setup_args)
                s.assemble(rhs=False)
            return s.op, getattr(s, "bcs", ())

        vc = build_hierarchy(self.grid, make_level, min_n=min_n, **vcycle_kw)
        if interface:
            _, _, active = masked_operator(self.op, getattr(self, "bcs", ()))
            vc = attach_interface_solve(vc, self.op, active, **interface_kw)
        self._mg_cache[key] = vc
        return vc

    def lattice_preconditioner(
        self,
        min_n: int = 16,
        dtype: torch.dtype = torch.float32,
        interface: bool = True,
        refresh: bool = False,
        ritz_modes: int = 0,
        ritz_arnoldi: Optional[int] = None,
        **interface_kw,
    ):
        """Full-box lattice V-cycle + cut-band interface correction
        (:class:`phifem_tpu_torch.mg.LatticeBulkVCycle`).  Nothing is
        re-discretized per level: each scalar P1 field with a bulk stencil
        (S1's u and p, S3/S4's u) is cycled on the whole box; a field of
        :meth:`_bulk_neumann_fields` (S5's displacements) takes the
        free-boundary variable-stencil block cycle
        (:class:`~phifem_tpu_torch.ops.lattice.LatticeVarMG`), any other
        vector P1 field with a uniform cell batch the constant block cycle
        (:class:`~phifem_tpu_torch.ops.lattice.LatticeBlockMG`); the other
        fields (fluxes, DG0) get damped Jacobi.  The cut-cell couplings are
        handled by the interface solve (``interface_kw``: see
        :func:`~phifem_tpu_torch.mg.attach_interface_solve`; ``sweeps_coef``
        defaults to the scheme's ``_iface_sweeps_coef``), and a scheme with
        a coarse space (:meth:`_coarse_matrix_builder`,
        :meth:`_coarse_modes`) gets its rank-k correction.  Memoized per
        argument set and operator data version; ``refresh=True`` rebuilds.

        ``ritz_modes > 0`` raises ``NotImplementedError``: Ritz modes were
        measured not to help S5 (docs/s5_preconditioner.md) and are not
        ported; ``ritz_arnoldi`` is taken for them."""
        from ..mg import (
            LatticeBulkVCycle,
            Level,
            _masked_matvec,
            attach_coarse_correction,
            attach_coarse_correction_device,
            attach_interface_solve,
            data_dependent_selection,
        )
        from ..ops.lattice import (
            build_lattice_mg,
            block_vertex_stencil_weights,
            build_lattice_block_mg,
            build_lattice_var_mg,
            orientation_cell_masks,
            vertex_stencil_weights,
        )
        from ..ops.stencil import StencilCellBatch, orientation_offsets
        from ..solvers import masked_operator

        if ritz_modes > 0:
            raise NotImplementedError(
                "Ritz modes are not ported: measured not to help S5 (docs/s5_preconditioner.md), "
                "they wait for a later PR (ROADMAP queue 1)"
            )
        key = (
            "lattice", min_n, str(dtype), interface, ritz_arnoldi, repr(sorted(interface_kw.items())),
            self.op.data_version,
        )
        vc = self._mg_cached(key, refresh)
        if vc is not None:
            return vc

        bcs = getattr(self, "bcs", ())
        matvec, inv_diag, active = _masked_matvec(self.op, bcs, dtype)
        g = self.grid
        offs = orientation_offsets(g)
        neum = set(self._bulk_neumann_fields())
        ws: Dict[str, np.ndarray] = {}  # scalar P1 field -> (3, 3) vertex stencil
        wsb: Dict[str, np.ndarray] = {}  # vector P1 field -> (3, 3, vsz, vsz) block stencil
        wsv: Dict[str, list] = {}  # free-boundary field -> [(mats, cell indicator)]
        for b in self.op.batches:
            if isinstance(b, StencilCellBatch):
                w = vertex_stencil_weights(b.matrices.numpy(), offs)
                ws[b.field] = ws.get(b.field, 0.0) + w
            elif isinstance(b, Batch) and b.orient is not None and not b.dynamic and len(b.segments) == 1:
                # a geometry-uniform single-field vector P1 cell batch (S5's
                # elasticity bulks)
                name, dofs, vs = b.segments[0]
                sp = self.op.system.fields[name]
                if not (vs and sp.element.family == "Lagrange" and sp.degree == 1
                        and dofs.shape[1] == len(offs[0])):
                    continue
                if name in neum and b.cells is not None:
                    covered = np.zeros(g.num_cells, bool)
                    covered[b.cells] = True
                    wsv.setdefault(name, []).append((b.matrices.cpu().numpy(), orientation_cell_masks(g, covered)))
                    continue
                wb = block_vertex_stencil_weights(b.matrices.cpu().numpy(), offs, sp.value_size)
                wsb[name] = wsb.get(name, 0.0) + wb
        # interface (h^-3 penalty) DoFs are excluded from the bulk cycles:
        # corrections there come from the band solve only
        _, _, active_full = masked_operator(self.op, bcs)
        sel = data_dependent_selection(self.op, active_full)
        R, C = g.ny + 1, g.nx + 1
        bulk_np, vertex_np = {}, {}
        for f in list(ws) + list(wsb) + list(wsv):
            sp = self.op.system.fields[f]
            act = np.broadcast_to(active_full[f].cpu().numpy(), sp.dof_shape).reshape(-1, sp.value_size)
            m = act & ~sel[f].reshape(-1, sp.value_size)
            bulk_np[f] = m.reshape(sp.dof_shape)
            # the cycle's per-vertex mask: bulk iff every component is
            vertex_np[f] = m.all(axis=1).reshape(R, C)
        mgs = {}
        for f, w in ws.items():
            mgs[f] = build_lattice_mg(g.nx, g.ny, w, min_n=min_n, dtype=dtype, mask=vertex_np[f], device=g.device)
        for f, wb in wsb.items():
            if vertex_np[f].any():  # else no bulk DoF: Jacobi
                mgs[f] = build_lattice_block_mg(g.nx, g.ny, wb, min_n=min_n, dtype=dtype, mask=vertex_np[f],
                                                device=g.device)
        for f, contribs in wsv.items():
            if vertex_np[f].any():
                mgs[f] = build_lattice_var_mg(
                    g, contribs, self.op.system.fields[f].value_size, min_n=min_n, dtype=dtype,
                    mask=vertex_np[f], device=g.device,
                )
        vc = LatticeBulkVCycle(
            [Level(g, matvec, inv_diag, active)],
            tuple(mgs),
            dtype=dtype,
            mgs=mgs,
            lattice_shapes={f: (R, C) for f in bulk_np},
            bulk_masks={f: torch.as_tensor(m, device=g.device) for f, m in bulk_np.items()},
        )
        if interface:
            interface_kw.setdefault("sweeps_coef", getattr(self, "_iface_sweeps_coef", 0.2))
            vc = attach_interface_solve(vc, self.op, active_full, **interface_kw)
        builder = self._coarse_matrix_builder()
        if builder is not None:
            vc = attach_coarse_correction_device(vc, self.op, active_full, builder[0], bcs)
        else:
            modes = self._coarse_modes()
            if modes:
                vc = attach_coarse_correction(vc, self.op, active_full, modes, bcs)
        self._mg_cache[key] = vc
        return vc

    def coupled_preconditioner(
        self,
        min_n: int = 16,
        dtype: torch.dtype = torch.float32,
        refresh: bool = False,
        max_coarse_dofs: int = 9000,
        **interface_kw,
    ):
        """Multilevel coupled hierarchy (:class:`phifem_tpu_torch.mg.
        CoupledVCycle`): the scheme re-discretized on halved grids while
        ``n/2 >= min_n`` and it has more than ``max_coarse_dofs`` DoFs, each
        level smoothed by its own flat :meth:`lattice_preconditioner`
        (``interface_kw`` go there), and a dense pseudo-inverse of the
        coarsest coupled operator.  For interface-transmission systems
        (S5), where the flat bulk / band preconditioner contracts at
        1 - O(h)."""
        from ..mg import CoupledVCycle, Level, _coarse_pinv, _masked_matvec

        key = ("coupled", min_n, str(dtype), max_coarse_dofs, repr(sorted(interface_kw.items())),
               self.op.data_version)
        vc = self._mg_cached(key, refresh)
        if vc is not None:
            return vc
        levels = []
        s = self
        vertex_fields = None
        while True:
            g = s.grid
            matvec, _, active = _masked_matvec(s.op, getattr(s, "bcs", ()), dtype)
            if vertex_fields is None:
                vertex_fields = tuple(n for n, v in active.items() if v.shape[0] == g.num_vertices)
            can_halve = g.nx % 2 == 0 and g.ny % 2 == 0 and g.nx // 2 >= min_n and g.ny // 2 >= min_n
            if not can_halve or s.op.system.num_dofs <= max_coarse_dofs:
                coarse = Level(
                    g, matvec, None, active, coarse_inv=_coarse_pinv(s.op, active).to(dtype),
                    field_shapes={n: tuple(sp.dof_shape) for n, sp in s.op.system.fields.items()},
                )
                break
            M = SchemeBase.lattice_preconditioner(s, min_n=min_n, dtype=dtype, **interface_kw)
            levels.append({"grid": g, "matvec": matvec, "active": active, "M": M})
            s = dataclasses.replace(s, grid=dataclasses.replace(g, nx=g.nx // 2, ny=g.ny // 2))
            s.setup(*self._setup_args)
            s.assemble(rhs=False)
        vc = CoupledVCycle(levels, coarse, vertex_fields, dtype=dtype)
        self._mg_cache[key] = vc
        return vc

    def _p1_twin(self):
        """The same scheme with every FE degree field (``primal_degree``,
        ``flux_degree``, ``auxiliary_degree``) set to 1, level-set and
        detection degrees untouched: the p-multigrid coarse problem.  As in
        the JAX package, S3 / S4's ``vector_degree`` is not among them."""
        degree_fields = {"primal_degree", "flux_degree", "auxiliary_degree"}
        repl = {f.name: 1 for f in dataclasses.fields(self) if f.name in degree_fields}
        return dataclasses.replace(self, **repl)

    def p_multigrid_preconditioner(
        self,
        min_n: int = 16,
        dtype: torch.dtype = torch.float32,
        low_iters: int = 10,
        refresh: bool = False,
        **interface_kw,
    ):
        """p-multigrid preconditioner of a degree >= 2 system
        (:func:`phifem_tpu_torch.pmg.build_p_preconditioner`): damped-Jacobi
        smoothing of the high-degree operator, the P1 twin's
        ``lattice_preconditioner(min_n, dtype)`` inside ``low_iters``
        BiCGStab iterations, and the cut-band solve of the high-degree
        penalty block (``interface_kw``).  Nonstationary: pair it with
        ``method="fgmres"``.  Memoized per argument set and operator data
        version; ``refresh=True`` rebuilds."""
        from ..pmg import build_p_preconditioner

        key = ("pmg", min_n, str(dtype), low_iters, repr(sorted(interface_kw.items())), self.op.data_version)
        vc = self._mg_cached(key, refresh)
        if vc is None:
            vc = build_p_preconditioner(self, min_n=min_n, dtype=dtype, low_iters=low_iters, **interface_kw)
            self._mg_cache[key] = vc
        return vc

    def _bulk_neumann_fields(self) -> tuple:
        """Fields whose bulk lattice MG must use the free-boundary variable
        stencil (:class:`~phifem_tpu_torch.ops.lattice.LatticeVarMG`):
        fields with a natural (traction, flux) condition at the immersed
        boundary.  The Dirichlet-masked constant stencil mis-corrects their
        boundary's harmonic-extension modes, and outer iterations grow like
        1/h."""
        return ()

    def _coarse_modes(self) -> tuple:
        """Near-null mode dicts for the lattice preconditioner's rank-k
        Galerkin correction (none by default)."""
        return ()

    def _coarse_matrix_builder(self):
        """Optional device-side coarse-basis builder ``(z_builder, k)``,
        preferred over :meth:`_coarse_modes` (None by default)."""
        return None

    # ------------------------------------------------------------- errors
    def l2_h1_errors(
        self,
        uh: Function,
        exact: Callable,
        region: Tuple[int, ...] = (1, 2),
        ref_degree: Optional[int] = None,
        vector: bool = False,
    ) -> Dict[str, float]:
        """Relative L2 and H1/H10 errors against an analytic solution, as
        the reference demos compute them: interpolate both into a degree+2
        space and integrate over the cells of ``region``."""
        g = self.grid
        deg = ref_degree or (uh.space.degree + 2)
        ref_space = Space.lagrange(g, deg, uh.space.value_shape)
        u_ref = interpolate(uh, ref_space)
        uex_ref = interpolate(exact, ref_space)
        err = Function(ref_space, uex_ref.data - u_ref.data)

        def sq(v):
            return torch.sum(v * v)

        def integral(fn, data):
            term = CellTerm(fn, region, degree=2 * deg)
            return assemble_scalar(g, cell_terms=[(term, data)], cell_tags=self.cell_tags)

        l2_num = integral(lambda d, x, ctx: sq(d["e"].val), {"e": err})
        l2_den = integral(lambda d, x, ctx: sq(d["u"].val), {"u": uex_ref})
        h1_num = integral(lambda d, x, ctx: sq(d["e"].grad), {"e": err})
        h1_den = integral(lambda d, x, ctx: sq(d["u"].grad), {"u": uex_ref})
        return {
            "l2": float(torch.sqrt(l2_num / l2_den)),
            "h10": float(torch.sqrt(h1_num / h1_den)),
            "h1": float(torch.sqrt((l2_num + h1_num) / (l2_den + h1_den))),
        }
