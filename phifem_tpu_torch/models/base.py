"""Shared scheme machinery: tagging and measures, the lattice
preconditioner, error norms.

Counterpart of :mod:`phifem_tpu.models.base` (bg mode, scalar P1 bulk
fields).  The submesh mode, the re-discretized ``mg_preconditioner`` and
the vector bulk cycles and the Ritz modes of ``lattice_preconditioner``
come with later slices and raise ``NotImplementedError`` naming them.
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
from ..tagging import TagsMeasures, compute_tags_measures

LevelSetLike = Union[Callable, Function]


@dataclasses.dataclass
class SchemeBase:
    """Common state of the phi-FEM schemes.  ``mode="bg"`` solves on the
    background grid with one-sided boundary measures (box mode)."""

    grid: Grid
    mode: str = "bg"
    detection_degree: int = 1
    single_layer_cut: bool = False
    pen_coef: float = 1.0
    stab_coef: float = 1.0

    def tag(self, detection_levelset: LevelSetLike) -> TagsMeasures:
        """Tag the grid; the host tags drive the terms' regions."""
        if self.mode != "bg":
            raise NotImplementedError(
                f"mode={self.mode!r}: the submesh mode is not ported yet (ROADMAP slice C)"
            )
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
        return res

    def boundary_measure(self) -> FacetSideList:
        """The scheme's ds on Gamma_h: one-sided subdomain id 100."""
        return self.tags.boundaries_measure(100)

    # ------------------------------------------------------ multigrid
    def lattice_preconditioner(
        self,
        min_n: int = 16,
        dtype: torch.dtype = torch.float32,
        interface: bool = True,
        kind: str = "auto",
        ritz_modes: int = 0,
    ):
        """Full-box lattice V-cycle + cut-band interface correction
        (:class:`phifem_tpu_torch.mg.LatticeBulkVCycle`).  Nothing is
        re-discretized per level: the bulk P1 stencil is
        refinement-invariant and the cut-cell couplings are handled by the
        interface solve (``kind``: see
        :func:`~phifem_tpu_torch.mg.attach_interface_solve`).  Memoized per
        argument set and operator data version."""
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
        key = ("lattice", min_n, str(dtype), interface, kind, self.op.data_version)
        cache = getattr(self, "_mg_cache", None)
        if cache is None:
            cache = self._mg_cache = {}
        if key in cache:
            return cache[key]

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
                        "not ported yet (ROADMAP slices C and D)"
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
            vc = attach_interface_solve(vc, self.op, active_full, kind=kind)
        cache[key] = vc
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
