"""Linear solvers: matrix-free preconditioned CG / BiCGStab, a dense direct
solve for small systems, and Dirichlet BC handling.

Counterpart of :mod:`phifem_tpu.solvers`.  DoFs with a zero diagonal
(touched by no active term) and Dirichlet DoFs get identity rows and a unit
preconditioner entry, so Krylov iterations leave them fixed.  The system is
symmetrically diagonally equilibrated before the Krylov loop, as in the JAX
package.  Vectors are dicts of per-field tensors.

The Krylov loops are eager Python; each iteration reads one host value
(the exit test).  Dots run in the working dtype (float64 for the outer
solve), where the JAX package computes the recurrence's dots in float32.
GMRES, deflation and the sparse direct path come with slice D.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .assembly import Operator

Vec = Dict[str, torch.Tensor]

__all__ = ["DirichletBC", "masked_operator", "lift_rhs", "solve", "SolveResult"]


def tree_dot(a: Vec, b: Vec) -> torch.Tensor:
    return sum(torch.dot(a[k].reshape(-1), b[k].reshape(-1)) for k in a)


def tree_axpy(alpha, x: Vec, y: Vec) -> Vec:
    return {k: alpha * x[k] + y[k] for k in x}


@dataclasses.dataclass(frozen=True)
class DirichletBC:
    """Strong Dirichlet condition on one field: boolean mask over scalar
    DoFs (optionally per-component) + prescribed values."""

    field: str
    mask: torch.Tensor  # bool, shape = space.dof_shape (broadcastable)
    values: torch.Tensor  # same shape as the field's dof array


def _apply_masks(x: Vec, bcs, zero: bool) -> Vec:
    out = dict(x)
    for bc in bcs:
        out[bc.field] = torch.where(
            bc.mask, torch.zeros_like(out[bc.field]) if zero else bc.values, out[bc.field]
        )
    return out


def masked_operator(
    op: Operator, bcs: Tuple[DirichletBC, ...] = ()
) -> Tuple[Callable, Vec, Dict[str, torch.Tensor]]:
    """Wrap an operator with Dirichlet-BC row/column masking and
    exterior-DoF identity rows.

    Returns ``(matvec, diag, active)``: ``matvec`` acts as the reduced
    operator (identity on constrained/inactive DoFs), ``diag`` is its
    Jacobi diagonal, and ``active`` masks the genuinely active DoFs.
    ``matvec.raw`` is the unmasked operator (BC lifting needs it)."""
    diag = op.diagonal()
    active = {k: d != 0.0 for k, d in diag.items()}
    for bc in bcs:
        active[bc.field] = active[bc.field] & ~bc.mask
    # the tap form (ops.taps) where there is one: one lattice kernel instead
    # of a gather -> batched matmul -> scatter per entity batch
    lat = op.lattice_form()
    base_mv = op.matvec if lat is None else lat.make_matvec(op)

    def matvec(x: Vec) -> Vec:
        y = base_mv({k: torch.where(active[k], x[k], 0.0) for k in x})
        return {k: torch.where(active[k], y[k], x[k]) for k in y}

    matvec.raw = base_mv
    diag_red = {k: torch.where(active[k], d, 1.0) for k, d in diag.items()}
    return matvec, diag_red, active


def lift_rhs(
    op: Operator,
    b: Vec,
    bcs: Tuple[DirichletBC, ...],
    active,
    raw_matvec: Optional[Callable] = None,
) -> Vec:
    """Dirichlet lifting: b <- b - A g on active DoFs, b|_bc = g,
    b|_inactive = 0."""
    if bcs:
        g = _apply_masks({n: torch.zeros_like(v) for n, v in b.items()}, bcs, zero=False)
        Ag = (raw_matvec or op.matvec)(g)
        b = _apply_masks({k: b[k] - Ag[k] for k in b}, bcs, zero=False)
    b = {k: torch.where(active[k], v, 0.0) for k, v in b.items()}
    for bc in bcs:
        b[bc.field] = torch.where(bc.mask, bc.values, b[bc.field])
    return b


@dataclasses.dataclass
class SolveResult:
    """Solution + solver statistics: the relative residual reported by the
    solver, iterations, and the Krylov loop's own (recurrence) relative
    residual at exit, the one its stopping test reads."""

    x: Vec
    residual: float
    iterations: int
    converged: bool
    recurrence: float


def _pcg(matvec, b: Vec, x0: Vec, *, tol, atol, maxiter, M, dot=tree_dot):
    """Preconditioned CG on dicts of tensors.  Returns ``(x, iterations,
    recurrence relative residual at exit)``."""
    bnorm2 = float(dot(b, b))
    target2 = max(tol * tol * bnorm2, atol * atol)
    r = {k: b[k] - v for k, v in matvec(x0).items()}
    z = M(r)
    x, p, rz, it = x0, z, dot(r, z), 0
    rr = float(dot(r, r))
    while it < maxiter and rr > target2:
        Ap = matvec(p)
        alpha = rz / dot(p, Ap)
        x = tree_axpy(alpha, p, x)
        r = tree_axpy(-alpha, Ap, r)
        z = M(r)
        rz_new = dot(r, z)
        p = tree_axpy(rz_new / rz, p, z)
        rz = rz_new
        it += 1
        rr = float(dot(r, r))
    return x, it, float(np.sqrt(rr / max(bnorm2, 1e-300)))


def _pbicgstab(matvec, b: Vec, x0: Vec, *, tol, atol, maxiter, M, dot=tree_dot):
    """Preconditioned BiCGStab on dicts of tensors (classical recurrence,
    right-preconditioned form).  Returns ``(x_best, iterations, recurrence
    relative residual of x_best)``.

    A rho breakdown (loss of rhat orthogonality after stagnation) restarts
    the recurrence with rhat = r; the BEST iterate seen is returned, so a
    late breakdown cannot destroy a near-converged solve.  Exits on the
    residual test, a non-finite residual, or runaway divergence (1e8x past
    the best).  The coefficients stay on the device; the loop reads the
    residual norms once per iteration."""
    bnorm2 = float(dot(b, b))
    target2 = max(tol * tol * bnorm2, atol * atol)
    r = {k: b[k] - v for k, v in matvec(x0).items()}
    rhat = r
    p = v = {k: torch.zeros_like(t) for k, t in b.items()}
    one = torch.ones((), dtype=next(iter(b.values())).dtype, device=next(iter(b.values())).device)
    rho = alpha = omega = one
    x = xb = x0
    rrb = dot(r, r)
    rr = rrb_f = float(rrb)
    it = 0
    while rr > target2 and it < maxiter and np.isfinite(rr) and rr < 1e16 * (rrb_f + 1e-300):
        rho_new = dot(rhat, r)
        rr_cur = dot(r, r)
        restart = torch.abs(rho_new) < 1e-12 * torch.sqrt(rr_cur * dot(rhat, rhat))
        rhat = {k: torch.where(restart, r[k], rhat[k]) for k in r}
        rho_new = torch.where(restart, rr_cur, rho_new)
        if it == 0:
            beta = torch.zeros_like(one)
        else:
            beta = torch.where(restart, 0.0, (rho_new / rho) * (alpha / omega))
        p = {k: r[k] + beta * (p[k] - omega * v[k]) for k in r}
        phat = M(p)
        v = matvec(phat)
        alpha = rho_new / dot(rhat, v)
        s = tree_axpy(-alpha, v, r)
        shat = M(s)
        t = matvec(shat)
        omega = dot(t, s) / dot(t, t)
        x = {k: x[k] + alpha * phat[k] + omega * shat[k] for k in x}
        r = tree_axpy(-omega, t, s)
        rho = rho_new
        rr_t = dot(r, r)
        better = torch.isfinite(rr_t) & (rr_t < rrb)
        xb = {k: torch.where(better, x[k], xb[k]) for k in x}
        rrb = torch.where(better, rr_t, rrb)
        it += 1
        rr, rrb_f = torch.stack([rr_t, rrb]).tolist()
    return xb, it, float(np.sqrt(rrb_f / max(bnorm2, 1e-300)))


def _eq_context(op: Operator, bcs, precond):
    """The symmetric-diagonally-equilibrated system the Krylov loop
    solves.  Returns ``(matvec, active, dsqrt, dinv_sqrt, mv_eq, M)``:
    ``mv_eq = D^-1/2 A D^-1/2`` and ``M = D^1/2 P D^1/2`` for a
    preconditioner ``P ~ A^-1`` of the unscaled system (identity without
    one: the scaled system has unit diagonal)."""
    matvec, diag, active = masked_operator(op, bcs)
    dsqrt = {
        k: torch.sqrt(torch.where(torch.abs(d) > 1e-30, torch.abs(d), 1.0))
        for k, d in diag.items()
    }
    dinv_sqrt = {k: 1.0 / d for k, d in dsqrt.items()}

    def mv_eq(y: Vec) -> Vec:
        z = matvec({k: v * dinv_sqrt[k] for k, v in y.items()})
        return {k: v * dinv_sqrt[k] for k, v in z.items()}

    if precond is None:
        M = lambda r: r
    else:
        def M(r: Vec) -> Vec:
            z = precond({k: v * dsqrt[k] for k, v in r.items()})
            return {k: v * dsqrt[k] for k, v in z.items()}

    return matvec, active, dsqrt, dinv_sqrt, mv_eq, M


def solve(
    op: Operator,
    b: Vec,
    bcs: Tuple[DirichletBC, ...] = (),
    method: str = "bicgstab",
    tol: float = 1e-10,
    atol: float = 0.0,
    maxiter: Optional[int] = None,
    x0: Optional[Vec] = None,
    precond: Optional[Callable] = None,
) -> SolveResult:
    """Solve ``A x = b`` with preconditioned CG or BiCGStab on the
    equilibrated, BC-reduced system, or (``method="dense"``, small systems)
    by a host least-squares solve.  ``precond`` is a preconditioner of the
    unscaled system (e.g. a :class:`phifem_tpu_torch.mg.VCycle`); the
    reported residual is the equilibrated one, relative to the equilibrated
    RHS."""
    if method == "dense":
        _, _, active = masked_operator(op, bcs)
        return _dense_solve(op, lift_rhs(op, b, bcs, active), active)
    runners = {"cg": _pcg, "bicgstab": _pbicgstab}
    if method not in runners:
        raise NotImplementedError(
            f"method={method!r} is not ported yet (ported: 'cg', 'bicgstab', "
            "'dense'; ROADMAP slice D)"
        )
    if maxiter is None:
        maxiter = 25 * int(np.sqrt(op.system.num_dofs)) + 1000
    matvec, active, dsqrt, dinv_sqrt, mv_eq, M = _eq_context(op, bcs, precond)
    b_l = lift_rhs(op, b, bcs, active, raw_matvec=matvec.raw)
    b_eq = {k: v * dinv_sqrt[k] for k, v in b_l.items()}
    if x0 is None:
        x0_eq = {k: torch.zeros_like(v) for k, v in b_eq.items()}
    else:
        x0_eq = {k: v * dsqrt[k] for k, v in x0.items()}
    x, it, rec = runners[method](mv_eq, b_eq, x0_eq, tol=tol, atol=atol, maxiter=maxiter, M=M)
    r = {k: b_eq[k] - v for k, v in mv_eq(x).items()}
    rel = float(torch.sqrt(tree_dot(r, r)) / torch.clamp(torch.sqrt(tree_dot(b_eq, b_eq)), min=1e-300))
    x = {k: v * dinv_sqrt[k] for k, v in x.items()}  # undo x = D^-1/2 y
    return SolveResult(
        x=x, residual=rel, iterations=it, converged=rel <= 10 * tol, recurrence=rec
    )


def _dense_solve(op: Operator, b: Vec, active) -> SolveResult:
    """Host least-squares solve of the masked dense system (minimum norm
    on numerically null pivots, the reference's MUMPS null-pivot
    handling).  Small systems only."""
    A = op.to_dense()
    off = op.system.offsets()
    n = op.system.num_dofs
    act = np.zeros(n, bool)
    bv = np.zeros(n)
    for name, s in op.system.fields.items():
        sl = slice(off[name], off[name] + s.num_dofs)
        act[sl] = np.broadcast_to(active[name].cpu().numpy(), s.dof_shape).reshape(-1)
        bv[sl] = b[name].cpu().numpy().reshape(-1)
    A[~act, :] = 0.0
    A[:, ~act] = 0.0
    A[~act, ~act] = 1.0
    xv, *_ = np.linalg.lstsq(A, bv, rcond=None)
    x = {}
    for name, s in op.system.fields.items():
        sl = slice(off[name], off[name] + s.num_dofs)
        x[name] = s.grid._tensor(xv[sl].reshape(s.dof_shape))
    r = float(np.linalg.norm(A @ xv - bv) / max(np.linalg.norm(bv), 1e-300))
    return SolveResult(x=x, residual=r, iterations=1, converged=True, recurrence=r)
