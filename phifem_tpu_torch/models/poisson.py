"""Plain Poisson on the full background box — the pure-multigrid path.

Counterpart of :mod:`phifem_tpu.models.poisson`.  Not a phi-FEM scheme: no
level set, no cut cells — every cell is a bulk cell, so the operator is ONE
maskless uniform P1 stencil batch (the hand-written CUDA kernel on the card)
and the V-cycle needs no interface correction.  Three solve paths:

* :meth:`BoxPoisson.solve`: the generic equilibrated CG of
  :mod:`phifem_tpu_torch.solvers`, preconditioned by the re-discretized
  V-cycle of :mod:`phifem_tpu_torch.mg` (every matvec through the kernel);
* :meth:`BoxPoisson.solve_lattice`: float64 CG with a float32 V-cycle on
  padded lattices (:mod:`phifem_tpu_torch.ops.lattice`);
* :meth:`BoxPoisson.solve_ir`: float32 MG-preconditioned CG corrections in a
  float64 iterative-refinement loop (:func:`phifem_tpu_torch.solvers.solve_ir`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch

from ..assembly import CellTerm, System, assemble_operator, uniform_element_matrices
from ..grid import Grid
from ..ops.lattice import (
    LatticeMG,
    _conv_interior,
    _embed,
    _terms,
    build_lattice_mg,
    lattice_cg,
    vertex_stencil_weights,
)
from ..ops.stencil import StencilCellBatch, orientation_offsets
from ..solvers import DirichletBC, SolveResult, solve, solve_ir
from ..spaces import Function, Space, boundary_dof_mask, interpolate

__all__ = ["BoxPoisson"]


def _stiffness(u, v, d, x, ctx):
    return torch.dot(u["u"].grad, v["u"].grad)


def _mass(u, v, d, x, ctx):
    return u["u"].val * v["u"].val


@dataclasses.dataclass
class BoxPoisson:
    """-Delta u = f on the box, u = u_D on the box boundary, P1."""

    grid: Grid

    def setup(
        self,
        f: Union[Callable, Function],
        u_D: Union[Callable, Function, None] = None,
    ):
        """``f`` and ``u_D``: callables on ``(n, 2)`` coordinate tensors,
        or Functions; ``u_D`` defaults to zero."""
        g = self.grid
        V = Space.lagrange(g, 1)
        self.V = V
        self.system = System({"u": V})
        self.f = f
        if u_D is None:
            u_D = lambda x: torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        self.u_D = u_D if isinstance(u_D, Function) else interpolate(u_D, V)
        self.bcs = (DirichletBC("u", boundary_dof_mask(V), self.u_D.data),)
        self._setup_args = (f, u_D)
        return self

    def assemble(self, rhs: bool = True):
        g = self.grid
        self.op = assemble_operator(
            self.system, g, cell_terms=[(CellTerm(_stiffness, None, degree=2, uniform=True), {})]
        )
        if not rhs:
            return self
        f_h = self.f if isinstance(self.f, Function) else interpolate(self.f, self.V)
        # load vector b = M f_h as a 9-point vertex-stencil convolution:
        # interior mass rows are uniform, and boundary rows are overwritten
        # by the Dirichlet lift in every solve path
        mats = uniform_element_matrices(self.system, g, _mass, 2)
        terms = _terms(vertex_stencil_weights(mats.cpu().numpy(), orientation_offsets(g)))
        R, C = g.ny + 1, g.nx + 1
        fp = torch.zeros((R + 2, C + 2), dtype=g.dtype, device=g.device)
        fp[1 : 1 + R, 1 : 1 + C] = f_h.data.reshape(R, C)
        b2 = torch.zeros((R, C), dtype=g.dtype, device=g.device)
        b2[1:-1, 1:-1] = _conv_interior(fp, terms, R, C)
        self.b = {"u": b2.reshape(-1)}
        return self

    def mg_preconditioner(self, min_n: int = 8, dtype: Optional[torch.dtype] = None, **vcycle_kw):
        """Geometric V-cycle: re-discretized uniform stiffness per level."""
        from ..mg import build_hierarchy

        def make_level(grid: Grid):
            if grid == self.grid:
                return self.op, self.bcs
            s = BoxPoisson(grid).setup(*self._setup_args).assemble(rhs=False)
            return s.op, s.bcs

        return build_hierarchy(self.grid, make_level, min_n=min_n, dtype=dtype, **vcycle_kw)

    def solve(self, method: str = "cg", tol: float = 1e-10, **kw) -> SolveResult:
        res = solve(self.op, self.b, bcs=self.bcs, method=method, tol=tol, **kw)
        self.result = res
        self.u_h = Function(self.V, res.x["u"])
        return res

    def solve_ir(self, tol: float = 1e-10, **kw) -> SolveResult:
        """Mixed-precision solve: float32 MG-preconditioned CG corrections in
        a float64 iterative-refinement loop (:func:`~phifem_tpu_torch.
        solvers.solve_ir`); the preconditioner defaults to
        ``mg_preconditioner(dtype=torch.float32)``."""
        precond = kw.pop("precond", None)
        if precond is None:
            precond = self.mg_preconditioner(dtype=torch.float32)
        res = solve_ir(self.op, self.b, bcs=self.bcs, precond=precond, tol=tol, **kw)
        self.result = res
        self.u_h = Function(self.V, res.x["u"])
        return res

    # ---------------------------------------------------- lattice fast path
    def lattice_solver(self, min_n: int = 16, dtype: torch.dtype = torch.float32, **kw) -> LatticeMG:
        """2D lattice-resident V-cycle: the P1 stiffness vertex stencil is
        refinement-invariant in 2D, so no level is assembled."""
        batch = next(b for b in self.op.batches if isinstance(b, StencilCellBatch))
        w = vertex_stencil_weights(batch.matrices.numpy(), orientation_offsets(self.grid))
        return build_lattice_mg(
            self.grid.nx, self.grid.ny, w, min_n=min_n, dtype=dtype, device=self.grid.device, **kw
        )

    def solve_lattice(self, tol: float = 1e-10, maxiter: int = 60, mg: Optional[LatticeMG] = None) -> SolveResult:
        """f64 CG preconditioned by the f32 lattice V-cycle, on 2D padded
        lattices; the boundary values are lifted into the RHS."""
        if mg is None:
            mg = getattr(self, "_lattice_mg", None) or self.lattice_solver()
            self._lattice_mg = mg
        g = self.grid
        R, C = g.ny + 1, g.nx + 1
        b2 = self.b["u"].reshape(R, C)
        border = torch.zeros((R, C), dtype=torch.bool, device=g.device)
        border[0, :] = border[-1, :] = True
        border[:, 0] = border[:, -1] = True
        xD = torch.where(border, self.u_D.data.reshape(R, C), 0.0)
        xDp = torch.zeros((R + 2, C + 2), dtype=b2.dtype, device=g.device)
        xDp[1 : 1 + R, 1 : 1 + C] = xD
        lift = _conv_interior(xDp, mg.terms, R, C)
        bp = _embed(b2[1:-1, 1:-1] - lift, R, C)
        xp, rel, it = lattice_cg(mg, bp, tol=tol, maxiter=maxiter)
        u = (xp[1 : 1 + R, 1 : 1 + C] + xD).reshape(-1)
        res = SolveResult(
            x={"u": u}, residual=rel, iterations=it, converged=rel <= tol, recurrence=rel
        )
        self.result = res
        self.u_h = Function(self.V, u)
        return res
