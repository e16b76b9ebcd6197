"""S4 -- Robin phi-FEM (mixed flux formulation).

Counterpart of :mod:`phifem_tpu.models.robin`:
  -Delta u + u = f in Omega,  du/dn + alpha u = g on Gamma
The mixed space of S3; the penalty flux factor picks up the Robin term
``- |grad phi| alpha u`` and the ghost stabilization acts on dS(2) (the cut
facets) instead of S3's dS(3).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch

from ..assembly import BoundaryTerm, CellTerm, FacetTerm
from ..spaces import Function
from .base import LevelSetLike
from .neumann import MixedFluxScheme, _div, _norm


def s4_forms(pen, stab, robin_coef, primal_degree, vector_degree, levelset_degree, phi_h, f_h, u_R, ds):
    """The S4 term lists: S3's with the Robin flux factor and the ghost
    term on dS(2)."""
    qdeg = 2 * (vector_degree + levelset_degree) + 2

    def flux_factor(w, d, ctx):
        phi = d["phi"]
        return (
            torch.dot(w["y"].val, phi.grad)
            - _norm(phi.grad) * robin_coef * w["u"].val
            + w["p"].val * phi.val / ctx.h
        )

    def bulk(u, v, d, x, ctx):
        return torch.dot(u["u"].grad, v["u"].grad) + u["u"].val * v["u"].val

    def boundary_flux(u, v, d, x, n, ctx):
        return torch.dot(u["y"].val, n) * v["u"].val

    def penalty(u, v, d, x, ctx):
        h = ctx.h
        t1 = torch.dot(u["y"].val + u["u"].grad, v["y"].val + v["u"].grad)
        t2 = (_div(u["y"]) + u["u"].val) * (_div(v["y"]) + v["u"].val)
        t3 = flux_factor(u, d, ctx) * flux_factor(v, d, ctx) / h**2
        return pen * (t1 + t2 + t3)

    def ghost(u0, u1, v0, v1, d0, d1, x, n, ctx):
        ju = torch.dot(u0["u"].grad - u1["u"].grad, n)
        jv = torch.dot(v0["u"].grad - v1["u"].grad, n)
        return stab * ctx.h * ju * jv

    def rhs_bulk(v, d, x, ctx):
        return d["f"].val * v["u"].val

    def rhs_pen(v, d, x, ctx):
        h = ctx.h
        t1 = -d["uR"].val * _norm(d["phi"].grad) * flux_factor(v, d, ctx) / h**2
        t2 = d["f"].val * (_div(v["y"]) + v["u"].val)
        return pen * (t1 + t2)

    cell_terms = [
        (CellTerm(bulk, (1, 2), degree=2 * primal_degree, uniform=True), {}),
        (CellTerm(penalty, (2,), degree=qdeg), {"phi": phi_h}),
    ]
    facet_terms = [(FacetTerm(ghost, region=(2,), npts=2), {})]
    boundary_terms = [(BoundaryTerm(boundary_flux, ds, npts=3), {})]
    rhs_cell_terms = [
        (CellTerm(rhs_bulk, (1, 2), degree=qdeg, uniform=True), {"f": f_h}),
        (CellTerm(rhs_pen, (2,), degree=qdeg), {"f": f_h, "uR": u_R, "phi": phi_h}),
    ]
    return cell_terms, facet_terms, boundary_terms, rhs_cell_terms


@dataclasses.dataclass
class RobinPoisson(MixedFluxScheme):
    """phi-FEM Robin solver."""

    robin_coef: float = 1.0

    def setup(
        self,
        levelset: LevelSetLike,
        f: Union[Callable, Function],
        u_R: Union[Callable, Function],
        detection_levelset: Optional[LevelSetLike] = None,
    ):
        self.u_R = self._setup_mixed(levelset, f, u_R, detection_levelset)
        return self

    def _forms(self):
        return s4_forms(
            self.pen_coef,
            self.stab_coef,
            self.robin_coef,
            self.primal_degree,
            self.vector_degree,
            self.levelset_degree,
            self.phi_h,
            self.f_h,
            self.u_R,
            self.boundary_measure(),
        )
