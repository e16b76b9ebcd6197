"""S2 -- strong Dirichlet phi-FEM: product-space ansatz u = phi * w.

Counterpart of :mod:`phifem_tpu.models.strong_dirichlet`.  The homogeneous
Dirichlet condition holds by construction, since u_h = phi_h w_h vanishes
on {phi_h = 0}.  Single P1 field w:

  a(w; v) = int_{dx(1,2)} grad(phi w) . grad(phi v)
          - int_{Gamma_h} (grad(phi w) . n)(phi v)                   (ds)
          + stab h^2 int_{dx(2)} Delta(phi w) Delta(phi v)
          + stab int_{dS(2,3)} avg(h) [grad(phi w) . n][grad(phi v) . n]

  L(v)    = int_{dx(1,2)} f (phi v) - stab h^2 int_{dx(2)} f Delta(phi v)

Every term carries phi, so every batch is data-dependent: the operator has
no stencil bulk, and its whole matvec is the tap form (the tap kernel on
the card).  The product rules are written out on FieldEvals.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch

from ..assembly import (
    BoundaryTerm,
    CellTerm,
    FacetTerm,
    FieldEval,
    System,
    assemble_operator,
    assemble_vector,
)
from ..solvers import SolveResult, solve
from ..spaces import Function, Space, interpolate
from .base import LevelSetLike, SchemeBase


def _mul(phi: FieldEval, w: FieldEval):
    """Value, gradient and Laplacian of the product phi * w."""
    val = phi.val * w.val
    grad = phi.val * w.grad + w.val * phi.grad
    lap = phi.val * w.lap + 2.0 * torch.dot(phi.grad, w.grad) + w.val * phi.lap
    return val, grad, lap


def s2_forms(stab, primal_degree, levelset_degree, phi_h, f_h, ds):
    """The S2 term lists: ``(cell_terms, facet_terms, boundary_terms,
    rhs_cell_terms)``."""
    qdeg = 2 * (primal_degree + levelset_degree) + 2

    def stiffness(u, v, d, x, ctx):
        _, gu, _ = _mul(d["phi"], u["w"])
        _, gv, _ = _mul(d["phi"], v["w"])
        return torch.dot(gu, gv)

    def boundary_flux(u, v, d, x, n, ctx):
        _, gu, _ = _mul(d["phi"], u["w"])
        pv, _, _ = _mul(d["phi"], v["w"])
        return -torch.dot(gu, n) * pv

    def cell_stab(u, v, d, x, ctx):
        _, _, lu = _mul(d["phi"], u["w"])
        _, _, lv = _mul(d["phi"], v["w"])
        return stab * ctx.h**2 * lu * lv

    def ghost(u0, u1, v0, v1, d0, d1, x, n, ctx):
        _, gu0, _ = _mul(d0["phi"], u0["w"])
        _, gu1, _ = _mul(d1["phi"], u1["w"])
        _, gv0, _ = _mul(d0["phi"], v0["w"])
        _, gv1, _ = _mul(d1["phi"], v1["w"])
        ju = torch.dot(gu0 - gu1, n)
        jv = torch.dot(gv0 - gv1, n)
        return stab * ctx.h * ju * jv

    def rhs_bulk(v, d, x, ctx):
        pv, _, _ = _mul(d["phi"], v["w"])
        return d["f"].val * pv

    def rhs_stab(v, d, x, ctx):
        _, _, lv = _mul(d["phi"], v["w"])
        return -stab * ctx.h**2 * d["f"].val * lv

    data = {"phi": phi_h}
    rdata = {"phi": phi_h, "f": f_h}
    cell_terms = [
        (CellTerm(stiffness, (1, 2), degree=qdeg), data),
        (CellTerm(cell_stab, (2,), degree=qdeg), data),
    ]
    facet_terms = [(FacetTerm(ghost, region=(2, 3), npts=3), data)]
    boundary_terms = [(BoundaryTerm(boundary_flux, ds, npts=3), data)]
    rhs_cell_terms = [
        (CellTerm(rhs_bulk, (1, 2), degree=qdeg), rdata),
        (CellTerm(rhs_stab, (2,), degree=qdeg), rdata),
    ]
    return cell_terms, facet_terms, boundary_terms, rhs_cell_terms


@dataclasses.dataclass
class StrongDirichletPoisson(SchemeBase):
    """phi-FEM strong-Dirichlet Poisson solver (u = phi w)."""

    primal_degree: int = 1
    levelset_degree: int = 1
    solution_degree: int = 1

    def setup(
        self,
        levelset: LevelSetLike,
        f: Union[Callable, Function],
        detection_levelset: Optional[LevelSetLike] = None,
    ):
        g = self.grid
        self.tag(detection_levelset if detection_levelset is not None else levelset)
        V = Space.lagrange(g, self.primal_degree)
        Vphi = Space.lagrange(g, self.levelset_degree)
        self.V, self.Vphi = V, Vphi
        self.system = System({"w": V})
        self.phi_h = levelset if isinstance(levelset, Function) else interpolate(levelset, Vphi)
        self.f_h = f if isinstance(f, Function) else interpolate(f, V)
        self._setup_args = (levelset, f, detection_levelset)
        return self

    def assemble(self, rhs: bool = True):
        g = self.grid
        cell_terms, facet_terms, boundary_terms, rhs_cell_terms = s2_forms(
            self.stab_coef,
            self.primal_degree,
            self.levelset_degree,
            self.phi_h,
            self.f_h,
            self.boundary_measure(),
        )
        self.op = assemble_operator(
            self.system,
            g,
            cell_terms=cell_terms,
            facet_terms=facet_terms,
            boundary_terms=boundary_terms,
            cell_tags=self.cell_tags,
            facet_tags=self.facet_tags,
        )
        if rhs:
            self.b = assemble_vector(self.system, g, cell_terms=rhs_cell_terms, cell_tags=self.cell_tags)
        return self

    def solve(self, method: str = "bicgstab", tol: float = 1e-10, **kw) -> SolveResult:
        res = solve(self.op, self.b, method=method, tol=tol, **kw)
        self.result = res
        self.w_h = Function(self.V, res.x["w"])
        # u_h = interp(w) * interp(phi) in the solution space, nodal product
        Vs = Space.lagrange(self.grid, self.solution_degree)
        w_s = interpolate(self.w_h, Vs)
        phi_s = interpolate(self.phi_h, Vs)
        self.u_h = Function(Vs, w_s.data * phi_s.data)
        return res
