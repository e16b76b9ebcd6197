"""S3 -- Neumann phi-FEM (mixed flux formulation).

Counterpart of :mod:`phifem_tpu.models.neumann`:
  -Delta u + u = f in Omega,  du/dn = g on Gamma
Fields: u (P1), y ~ -grad u (P1 vector), p (DG0 auxiliary):

  a = int_{dx(1,2)} (grad u . grad v + u v)
    + int_{Gamma_h} (y . n) v                                        (ds)
    + pen int_{dx(2)} [ (y + grad u).(z + grad v)
                      + (div y + u)(div z + v)
                      + h^-2 (y.grad phi + h^-1 p phi)(z.grad phi + h^-1 q phi) ]
    + stab int_{dS(3)} avg(h) [grad u . n][grad v . n]

  L = int_{dx(1,2)} f v
    + pen int_{dx(2)} [ -h^-2 u_N |grad phi| (z.grad phi + h^-1 q phi)
                      + f (div z + v) ]

The bulk term touches u only: a masked stencil batch (the stencil kernel on
the card, quadrilaterals included).  Everything else is the tap form over
the u, y and p block lattices.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch

from ..assembly import (
    BoundaryTerm,
    CellTerm,
    FacetTerm,
    System,
    assemble_operator,
    assemble_vector,
)
from ..solvers import SolveResult, solve
from ..spaces import Function, Space, interpolate
from .base import LevelSetLike, SchemeBase


def _div(field_eval):
    """Divergence of a vector FieldEval: trace of its (k, 2) gradient."""
    return torch.diagonal(field_eval.grad, dim1=-2, dim2=-1).sum(-1)


def _norm(v):
    return torch.sqrt(torch.dot(v, v))


def s3_forms(pen, stab, primal_degree, vector_degree, levelset_degree, phi_h, f_h, u_N, ds):
    """The S3 term lists: ``(cell_terms, facet_terms, boundary_terms,
    rhs_cell_terms)``."""
    qdeg = 2 * (vector_degree + levelset_degree) + 2

    def flux_factor(w, d, ctx):
        phi = d["phi"]
        return torch.dot(w["y"].val, phi.grad) + w["p"].val * phi.val / ctx.h

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
        t1 = -d["uN"].val * _norm(d["phi"].grad) * flux_factor(v, d, ctx) / h**2
        t2 = d["f"].val * (_div(v["y"]) + v["u"].val)
        return pen * (t1 + t2)

    cell_terms = [
        (CellTerm(bulk, (1, 2), degree=2 * primal_degree, uniform=True), {}),
        (CellTerm(penalty, (2,), degree=qdeg), {"phi": phi_h}),
    ]
    facet_terms = [(FacetTerm(ghost, region=(3,), npts=2), {})]
    boundary_terms = [(BoundaryTerm(boundary_flux, ds, npts=3), {})]
    rhs_cell_terms = [
        (CellTerm(rhs_bulk, (1, 2), degree=qdeg, uniform=True), {"f": f_h}),
        (CellTerm(rhs_pen, (2,), degree=qdeg), {"f": f_h, "uN": u_N, "phi": phi_h}),
    ]
    return cell_terms, facet_terms, boundary_terms, rhs_cell_terms


@dataclasses.dataclass
class MixedFluxScheme(SchemeBase):
    """Shared set-up, assembly and solve of the mixed (u, y, p) schemes S3
    and S4; ``_forms`` gives the scheme's term lists."""

    primal_degree: int = 1
    vector_degree: int = 1
    auxiliary_degree: int = 0
    levelset_degree: int = 2

    def _setup_mixed(self, levelset, f, g_data, detection_levelset) -> Function:
        """Tag, build the spaces and interpolate the data; returns the
        boundary data ``g_data`` on P1."""
        g = self.grid
        self.tag(detection_levelset if detection_levelset is not None else levelset)
        V = Space.lagrange(g, self.primal_degree)
        Y = Space.lagrange(g, self.vector_degree, (2,))
        Q = Space.dg0(g)
        Vphi = Space.lagrange(g, self.levelset_degree)
        self.V, self.Y, self.Q, self.Vphi = V, Y, Q, Vphi
        self.system = System({"u": V, "y": Y, "p": Q})
        self.phi_h = levelset if isinstance(levelset, Function) else interpolate(levelset, Vphi)
        self.f_h = f if isinstance(f, Function) else interpolate(f, V)
        self._setup_args = (levelset, f, g_data, detection_levelset)
        return g_data if isinstance(g_data, Function) else interpolate(g_data, V)

    def assemble(self, rhs: bool = True):
        g = self.grid
        cell_terms, facet_terms, boundary_terms, rhs_cell_terms = self._forms()
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
        self.u_h = Function(self.V, res.x["u"])
        self.y_h = Function(self.Y, res.x["y"])
        return res


@dataclasses.dataclass
class NeumannPoisson(MixedFluxScheme):
    """phi-FEM Neumann solver."""

    def setup(
        self,
        levelset: LevelSetLike,
        f: Union[Callable, Function],
        u_N: Union[Callable, Function],
        detection_levelset: Optional[LevelSetLike] = None,
    ):
        self.u_N = self._setup_mixed(levelset, f, u_N, detection_levelset)
        return self

    def _forms(self):
        return s3_forms(
            self.pen_coef,
            self.stab_coef,
            self.primal_degree,
            self.vector_degree,
            self.levelset_degree,
            self.phi_h,
            self.f_h,
            self.u_N,
            self.boundary_measure(),
        )
