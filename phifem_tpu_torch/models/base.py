"""Shared scheme machinery: tagging and measures (bg and sub mode), the
re-discretized and the lattice preconditioners, error norms.

Counterpart of :mod:`phifem_tpu.models.base`.  The vector and
free-boundary bulk cycles, coarse corrections and Ritz modes of
``lattice_preconditioner`` (S5) come with slice D and raise
``NotImplementedError`` naming it.
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
        **interface_kw,
    ):
        """Full-box lattice V-cycle + cut-band interface correction
        (:class:`phifem_tpu_torch.mg.LatticeBulkVCycle`).  Nothing is
        re-discretized per level: each scalar P1 field with a bulk stencil
        (S1's u and p, S3/S4's u) is cycled on the whole box, the other
        fields (vector y, DG0 p) get damped Jacobi, and the cut-cell
        couplings are handled by the interface solve
        (``interface_kw``: see
        :func:`~phifem_tpu_torch.mg.attach_interface_solve`).  Memoized per
        argument set and operator data version; ``refresh=True``
        rebuilds."""
        from ..mg import (
            LatticeBulkVCycle,
            Level,
            _masked_matvec,
            attach_interface_solve,
            data_dependent_selection,
        )
        from ..ops.lattice import build_lattice_mg, vertex_stencil_weights
        from ..ops.stencil import StencilCellBatch, orientation_offsets
        from ..solvers import masked_operator

        if ritz_modes > 0:
            raise NotImplementedError(
                "coarse corrections and Ritz modes are not ported yet (ROADMAP slice D)"
            )
        key = (
            "lattice", min_n, str(dtype), interface, repr(sorted(interface_kw.items())),
            self.op.data_version,
        )
        vc = self._mg_cached(key, refresh)
        if vc is not None:
            return vc

        bcs = getattr(self, "bcs", ())
        matvec, inv_diag, active = _masked_matvec(self.op, bcs, dtype)
        g = self.grid
        offs = orientation_offsets(g)
        ws: Dict[str, np.ndarray] = {}  # scalar P1 field -> (3, 3) vertex stencil
        for b in self.op.batches:
            if isinstance(b, StencilCellBatch):
                w = vertex_stencil_weights(b.matrices.numpy(), offs)
                ws[b.field] = ws.get(b.field, 0.0) + w
            elif isinstance(b, Batch) and b.orient is not None and not b.dynamic and len(b.segments) == 1:
                name, _, vs = b.segments[0]
                if vs:
                    raise NotImplementedError(
                        "vector/tensor P1 bulk cycles (LatticeBlockMG, LatticeVarMG) are "
                        "not ported yet (ROADMAP slice D)"
                    )
        # interface (h^-3 penalty) DoFs are excluded from the Laplacian bulk
        # cycle: corrections there come from the band solve only
        _, _, active_full = masked_operator(self.op, bcs)
        sel = data_dependent_selection(self.op, active_full)
        R, C = g.ny + 1, g.nx + 1
        mgs, bulk_masks = {}, {}
        for f, w in ws.items():
            bulk = active_full[f].cpu().numpy() & ~sel[f]
            bulk_masks[f] = torch.as_tensor(bulk, device=g.device)
            mgs[f] = build_lattice_mg(
                g.nx, g.ny, w, min_n=min_n, dtype=dtype, mask=bulk.reshape(R, C), device=g.device
            )
        vc = LatticeBulkVCycle(
            [Level(g, matvec, inv_diag, active)],
            tuple(mgs),
            dtype=dtype,
            mgs=mgs,
            lattice_shapes={f: (R, C) for f in ws},
            bulk_masks=bulk_masks,
        )
        if interface:
            vc = attach_interface_solve(vc, self.op, active_full, **interface_kw)
        self._mg_cache[key] = vc
        return vc

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
