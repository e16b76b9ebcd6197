"""Linear solvers: matrix-free preconditioned CG / BiCGStab (optionally
deflated by a known null basis), a dense direct solve for small systems, a
host sparse LU (SuperLU) for larger ones, and Dirichlet BC handling.

Counterpart of :mod:`phifem_tpu.solvers`.  DoFs with a zero diagonal
(touched by no active term) and Dirichlet DoFs get identity rows and a unit
preconditioner entry, so Krylov iterations leave them fixed.  The system is
symmetrically diagonally equilibrated before the Krylov loop, as in the JAX
package.  Vectors are dicts of per-field tensors.

The Krylov loops are eager Python; each iteration reads one host value
(the exit test).  Dots run in the working dtype (float64 for the outer
solve), where the JAX package computes the recurrence's dots in float32.
GMRES and flexible GMRES come with slice E (p-multigrid is their first
user).
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


def _eq_context(op: Operator, bcs, precond, defl=None):
    """The symmetric-diagonally-equilibrated (and optionally deflated)
    system the Krylov loop solves.  Returns ``(matvec, active, dsqrt,
    dinv_sqrt, mv_eq, M, proj)``: ``mv_eq = D^-1/2 A D^-1/2`` and ``M =
    D^1/2 P D^1/2`` for a preconditioner ``P ~ A^-1`` of the unscaled system
    (identity without one: the scaled system has unit diagonal).

    ``defl``: vectors spanning a known null space of the reduced operator.
    Their equilibrated images ``D^1/2 v``, masked to the active DoFs and
    orthonormalized (Gram-Schmidt in float64), are stacked into a ``(k,
    n_flat)`` basis Q; then ``mv_eq = P A P + Q Q^T`` and ``M = P M P`` with
    ``P = I - Q Q^T``, and ``proj`` applies P (None without ``defl``)."""
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

    if not defl:
        return matvec, active, dsqrt, dinv_sqrt, mv_eq, M, None
    ortho = []
    for v in defl:
        q = {k: torch.where(active[k], v[k].to(dsqrt[k]), 0.0) * dsqrt[k] for k in v}
        for o in ortho:
            q = tree_axpy(-tree_dot(o, q), o, q)
        nrm = torch.clamp(torch.sqrt(tree_dot(q, q)), min=1e-300)
        ortho.append({k: t / nrm for k, t in q.items()})
    # the projections run on the stacked flat basis: two (k, n) products
    # per application instead of k * fields separate dots
    names = sorted(defl[0])
    shapes = [ortho[0][k].shape for k in names]
    sizes = [int(np.prod(sh)) for sh in shapes]

    def fl(t: Vec) -> torch.Tensor:
        return torch.cat([t[k].reshape(-1) for k in names])

    def unfl(vf: torch.Tensor) -> Vec:
        out, cur = {}, 0
        for k, sh, sz in zip(names, shapes, sizes):
            out[k] = vf[cur : cur + sz].reshape(sh)
            cur += sz
        return out

    Q = torch.stack([fl(o) for o in ortho])  # (k, n_flat)

    def proj(v: Vec) -> Vec:
        vf = fl(v)
        return unfl(vf - Q.T @ (Q @ vf))

    mv_plain, M_plain = mv_eq, M

    def mv_eq(y: Vec) -> Vec:
        yf = fl(y)
        c = Q @ yf
        z = proj(mv_plain(unfl(yf - Q.T @ c)))
        return unfl(fl(z) + Q.T @ c)  # identity on the deflated span

    def M(r: Vec) -> Vec:
        return proj(M_plain(proj(r)))

    return matvec, active, dsqrt, dinv_sqrt, mv_eq, M, proj


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
    deflate: Optional[Tuple[Vec, ...]] = None,
) -> SolveResult:
    """Solve ``A x = b`` with preconditioned CG or BiCGStab on the
    equilibrated, BC-reduced system, or directly: ``method="dense"`` (host
    least squares, small systems) and ``method="sparse"`` (host SuperLU of
    the active submatrix, cached on the operator).  ``precond`` is a
    preconditioner of the unscaled system (e.g. a
    :class:`phifem_tpu_torch.mg.VCycle`); the reported residual is the
    equilibrated one, relative to the equilibrated RHS.

    ``deflate``: vectors (dicts in the system's layout) spanning a known
    null space of the reduced operator, e.g. the collective rigid modes of
    S5.  The Krylov methods then solve ``P A P + Q Q^T`` (see
    :func:`_eq_context`): the solution has no component along the basis and
    the reported residual is the deflated one.  The sparse path solves the
    bordered system ``[[A, Q], [Q^T, 0]]`` instead."""
    if method not in ("cg", "bicgstab", "gmres", "fgmres", "dense", "sparse"):
        raise ValueError(f"Unknown method {method!r}.")
    if method in ("gmres", "fgmres"):
        raise NotImplementedError(
            f"method={method!r} is not ported yet: it comes with slice E (p-multigrid)"
        )
    if method in ("dense", "sparse"):
        matvec, _, active = masked_operator(op, bcs)
        b_l = lift_rhs(op, b, bcs, active, raw_matvec=matvec.raw)
        if method == "dense":
            return _dense_solve(op, b_l, active)
        return _sparse_solve(op, b_l, bcs, active, deflate)
    runners = {"cg": _pcg, "bicgstab": _pbicgstab}
    if maxiter is None:
        maxiter = 25 * int(np.sqrt(op.system.num_dofs)) + 1000
    matvec, active, dsqrt, dinv_sqrt, mv_eq, M, proj = _eq_context(op, bcs, precond, deflate)
    b_l = lift_rhs(op, b, bcs, active, raw_matvec=matvec.raw)
    b_eq = {k: v * dinv_sqrt[k] for k, v in b_l.items()}
    if proj is not None:
        b_eq = proj(b_eq)
    if x0 is None:
        x0_eq = {k: torch.zeros_like(v) for k, v in b_eq.items()}
    else:
        x0_eq = {k: v * dsqrt[k] for k, v in x0.items()}
        if proj is not None:
            x0_eq = proj(x0_eq)
    x, it, rec = runners[method](mv_eq, b_eq, x0_eq, tol=tol, atol=atol, maxiter=maxiter, M=M)
    r = {k: b_eq[k] - v for k, v in mv_eq(x).items()}
    rel = float(torch.sqrt(tree_dot(r, r)) / torch.clamp(torch.sqrt(tree_dot(b_eq, b_eq)), min=1e-300))
    if proj is not None:
        x = proj(x)  # zero null-component gauge
    x = {k: v * dinv_sqrt[k] for k, v in x.items()}  # undo x = D^-1/2 y
    return SolveResult(
        x=x, residual=rel, iterations=it, converged=rel <= 10 * tol, recurrence=rec
    )


def _host_layout(op: Operator, b: Vec, active):
    """Global flat host arrays ``(act, bv)`` of the active mask and the RHS."""
    off = op.system.offsets()
    n = op.system.num_dofs
    act = np.zeros(n, bool)
    bv = np.zeros(n)
    for name, s in op.system.fields.items():
        sl = slice(off[name], off[name] + s.num_dofs)
        act[sl] = np.broadcast_to(active[name].cpu().numpy(), s.dof_shape).reshape(-1)
        bv[sl] = b[name].cpu().numpy().reshape(-1)
    return act, bv


def _from_host(op: Operator, xv: np.ndarray) -> Vec:
    off = op.system.offsets()
    return {
        name: s.grid._tensor(xv[off[name] : off[name] + s.num_dofs].reshape(s.dof_shape))
        for name, s in op.system.fields.items()
    }


def _sparse_solve(op: Operator, b: Vec, bcs, active, deflate=None) -> SolveResult:
    """Host sparse direct LU (SuperLU) of the reduced system, the analogue
    of the reference's MUMPS LU at sizes where the dense path's O(n^2)
    memory is out of reach.  Only the ACTIVE submatrix of
    ``op.restricted_csr`` is factored (inactive rows are ``x = b``).  The
    factorization is cached on the operator, keyed by its data version, the
    BC objects and the deflation rank, so repeated right-hand sides reuse
    it.  If COLAMD's fill-in overflows SuperLU's workspace, the factor is
    retried with MMD on the symmetrized pattern.

    ``deflate`` switches to the bordered system ``[[A, Q], [Q^T, 0]]`` (Q
    the orthonormalized masked null basis): x is the zero-null-gauge
    solution and the reported residual is the deflated one, as on the
    Krylov path."""
    import scipy.sparse as sp
    from scipy.sparse.linalg import splu

    n = op.system.num_dofs
    off = op.system.offsets()
    act, bv = _host_layout(op, b, active)
    Q = None
    if deflate:
        Q = np.zeros((n, len(deflate)))
        for j, m in enumerate(deflate):
            for name, s in op.system.fields.items():
                Q[off[name] : off[name] + s.num_dofs, j] = m[name].cpu().numpy().reshape(-1)
        Q[~act] = 0.0
        Q, _ = np.linalg.qr(Q)

    key = (op.data_version, tuple(id(bc) for bc in bcs), len(deflate or ()))
    cached = op.__dict__.get("_splu_cache")
    if cached is None or cached[0] != key:
        A, _ = op.restricted_csr({name: np.ones(s.dof_shape, bool) for name, s in op.system.fields.items()})
        A = A.tocoo()
        keep = act[A.row] & act[A.col]
        idx = np.where(act)[0]
        ren = np.full(n, -1, np.int64)
        ren[idx] = np.arange(len(idx))
        Ared = sp.csc_matrix((A.data[keep], (ren[A.row[keep]], ren[A.col[keep]])), shape=(len(idx),) * 2)
        Afac = Ared
        if Q is not None:
            Qa = sp.csc_matrix(Q[idx])
            Afac = sp.bmat([[Ared, Qa], [Qa.T, None]], format="csc")
        try:
            lu = splu(Afac)
        except (RuntimeError, MemoryError):
            lu = splu(Afac, permc_spec="MMD_AT_PLUS_A", options={"SymmetricMode": True})
        # the bc objects stay referenced so the id()-based key stays unique
        cached = op._splu_cache = (key, lu, Ared, idx, tuple(bcs))
    _, lu, Ared, idx = cached[:4]

    ba = bv[idx]
    xv = bv.copy()  # inactive identity rows: x = b
    if Q is None:
        xa = lu.solve(ba)
        r = np.linalg.norm(Ared @ xa - ba) / max(np.linalg.norm(ba), 1e-300)
    else:
        Qa = Q[idx]  # orthonormal: Q has no mass on inactive rows
        xa = lu.solve(np.concatenate([ba, np.zeros(Qa.shape[1])]))[: len(idx)]
        rv = ba - Ared @ xa
        rv -= Qa @ (Qa.T @ rv)  # deflated residual (Krylov-path semantics)
        bd = ba - Qa @ (Qa.T @ ba)
        r = np.linalg.norm(rv) / max(np.linalg.norm(bd), 1e-300)
    xv[idx] = xa
    return SolveResult(x=_from_host(op, xv), residual=float(r), iterations=1, converged=True, recurrence=float(r))


def _dense_solve(op: Operator, b: Vec, active) -> SolveResult:
    """Host least-squares solve of the masked dense system (minimum norm
    on numerically null pivots, the reference's MUMPS null-pivot
    handling).  Small systems only."""
    A = op.to_dense()
    act, bv = _host_layout(op, b, active)
    A[~act, :] = 0.0
    A[:, ~act] = 0.0
    A[~act, ~act] = 1.0
    xv, *_ = np.linalg.lstsq(A, bv, rcond=None)
    r = float(np.linalg.norm(A @ xv - bv) / max(np.linalg.norm(bv), 1e-300))
    return SolveResult(x=_from_host(op, xv), residual=r, iterations=1, converged=True, recurrence=r)
