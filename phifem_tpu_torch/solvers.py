"""Linear solvers: matrix-free preconditioned CG / BiCGStab (optionally
deflated by a known null basis), restarted GMRES and flexible GMRES, a
mixed-precision iterative refinement loop, a dense direct solve for small
systems, a host sparse LU (SuperLU) for larger ones, and Dirichlet BC
handling.

Counterpart of :mod:`phifem_tpu.solvers`.  DoFs with a zero diagonal
(touched by no active term) and Dirichlet DoFs get identity rows and a unit
preconditioner entry, so Krylov iterations leave them fixed.  The system is
symmetrically diagonally equilibrated before the Krylov loop, as in the JAX
package.  Vectors are dicts of per-field tensors.

The Krylov loops are eager Python; CG and BiCGStab read one host value per
iteration (the exit test), GMRES one per Arnoldi step (the breakdown test)
and flexible GMRES one small (m+1) x m Hessenberg matrix per restart cycle
(its least-squares problem is solved on the host in float64).  Dots run in
float64 (the working dtype of the outer solve, and float64 casts in the
float32 corrections of :func:`solve_ir`), where the JAX package computes
the CG / BiCGStab recurrences' dots in float32.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .assembly import Operator

Vec = Dict[str, torch.Tensor]

__all__ = ["DirichletBC", "masked_operator", "lift_rhs", "solve", "solve_ir", "SolveResult"]


def tree_dot(a: Vec, b: Vec) -> torch.Tensor:
    return sum(torch.dot(a[k].reshape(-1), b[k].reshape(-1)) for k in a)


def tree_dot64(a: Vec, b: Vec) -> torch.Tensor:
    """:func:`tree_dot` in float64 whatever the vectors' dtype: the dots of
    the float32 corrections of :func:`solve_ir`."""
    return sum(torch.dot(a[k].reshape(-1).double(), b[k].reshape(-1).double()) for k in a)


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
    bb = dot(b, b)
    bnorm2 = float(bb)
    target2 = max(tol * tol * bnorm2, atol * atol)
    r = {k: b[k] - v for k, v in matvec(x0).items()}
    rhat = r
    p = v = {k: torch.zeros_like(t) for k, t in b.items()}
    # the coefficients live where the dots do (a sharded dot over several
    # cards returns host scalars)
    one = torch.ones((), dtype=bb.dtype, device=bb.device)
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


def _flat_ops(b: Vec, names=None):
    """``(fl, unfl)``: a dict vector in ``b``'s layout to one flat tensor
    (fields in the order of ``names``, by default ``b``'s) and back: the
    GMRES bases and the deflation basis are stored flat."""
    names = list(b) if names is None else list(names)
    shapes = [b[k].shape for k in names]
    sizes = [b[k].numel() for k in names]

    def fl(t: Vec) -> torch.Tensor:
        return torch.cat([t[k].reshape(-1) for k in names])

    def unfl(v: torch.Tensor) -> Vec:
        return {k: c.reshape(sh) for k, c, sh in zip(names, torch.split(v, sizes), shapes)}

    return fl, unfl


def _pfgmres(matvec, b: Vec, x0: Vec, *, tol, atol, maxiter, M, restart: int = 20):
    """Restarted flexible GMRES (Saad 1993; PETSc ``KSPFGMRES``) on dicts of
    tensors, with JAX's ``_pfgmres`` semantics: the preconditioned basis Z
    is stored apart from V, so M may change between applications (an inner
    iterative solve); two classical Gram-Schmidt passes per Arnoldi step;
    whole cycles of ``restart`` steps, counted ``it += restart``; the loop
    exits when the least-squares residual estimate ``||beta e1 - H y||``
    reaches ``max(tol ||b||, atol)``, when it is not finite, or at
    ``maxiter``.  Memory: ``2 restart + 1`` flat vectors.

    The (m+1) x m least-squares problem is read to the host and solved there
    in float64 (``numpy.linalg.lstsq``, SVD-based as ``jnp.linalg.lstsq``):
    one small read per cycle, while the Arnoldi steps run without one.
    Returns ``(x, iterations, recurrence relative residual at exit)``."""
    fl, unfl = _flat_ops(b)
    A = lambda v: fl(matvec(unfl(v)))
    Mf = lambda v: fl(M(unfl(v)))
    bf, x = fl(b), fl(x0)
    m = int(restart)
    bnorm = float(torch.linalg.vector_norm(bf))
    target = max(tol * bnorm, atol)
    V = bf.new_zeros((m + 1, bf.numel()))
    Z = bf.new_zeros((m, bf.numel()))
    rnorm = float(torch.linalg.vector_norm(bf - A(x)))
    it = 0
    while rnorm > target and it < maxiter and np.isfinite(rnorm):
        r = bf - A(x)
        beta = torch.linalg.vector_norm(r)
        V.zero_()
        V[0] = r / torch.clamp(beta, min=1e-300)
        H = bf.new_zeros((m + 1, m))
        for j in range(m):
            z = Mf(V[j])
            w = A(z)
            Vj = V[: j + 1]
            h = Vj @ w  # two passes for orthogonality
            w = w - Vj.T @ h
            h2 = Vj @ w
            w = w - Vj.T @ h2
            hj = torch.linalg.vector_norm(w)
            V[j + 1] = w / torch.clamp(hj, min=1e-300)
            H[: j + 1, j] = h + h2
            H[j + 1, j] = hj
            Z[j] = z
        Hh = H.cpu().numpy().astype(np.float64)
        e1 = np.zeros(m + 1)
        e1[0] = float(beta)
        y = np.linalg.lstsq(Hh, e1, rcond=None)[0]
        x = x + Z.T @ torch.as_tensor(y, dtype=Z.dtype, device=Z.device)
        rnorm = float(np.linalg.norm(e1 - Hh @ y))
        it += m
    return unfl(x), it, rnorm / max(bnorm, 1e-300)


def _pgmres(matvec, b: Vec, x0: Vec, *, tol, atol, maxiter, M, restart: int = 50):
    """Restarted, LEFT-preconditioned GMRES with the contract of
    ``jax.scipy.sparse.linalg.gmres(..., solve_method="batched")``, which
    the JAX package's ``solve(method="gmres")`` calls: the Krylov space is
    built on ``M A``; ``maxiter`` counts restart cycles; each cycle runs all
    ``restart`` Arnoldi steps unless the new basis vector vanishes (below
    eps times its norm before orthogonalization: a breakdown ends the
    cycle); the loop stops when ``||M (b - A x)||`` reaches ``max(tol ||b||,
    atol)``.  JAX orthogonalizes by iterated classical Gram-Schmidt (a
    second pass only where the first lost over 1 - 1/sqrt(2) of the norm)
    and solves the least-squares problem by its normal equations; here
    always two passes and ``numpy.linalg.lstsq`` on the host, so the
    iterates agree to the tolerance, not bit for bit.  Each Arnoldi step reads its norm to
    the host (the breakdown test).  Returns ``(x, cycles, ||M r|| /
    ||b||)``; :func:`solve` reports -1 iterations, as the JAX package."""
    fl, unfl = _flat_ops(b)
    MA = lambda v: fl(M(matvec(unfl(v))))
    bf, x = fl(b), fl(x0)
    n = bf.numel()
    m = min(int(restart), n)
    eps = float(torch.finfo(bf.dtype).eps)
    bnorm = float(torch.linalg.vector_norm(bf))
    target = max(tol * bnorm, atol)
    r = fl(M(unfl(bf - fl(matvec(unfl(x))))))
    rnorm = float(torch.linalg.vector_norm(r))
    V = bf.new_zeros((m + 1, n))
    k = 0
    while k < maxiter and rnorm > target:
        V.zero_()
        V[0] = r / rnorm if rnorm > eps else 0.0
        # the Hessenberg matrix, columns of unreached steps as the identity
        # (JAX's eye(restart, restart + 1) rows)
        H = np.eye(m + 1, m)
        for j in range(m):
            w = MA(V[j])
            norm0 = float(torch.linalg.vector_norm(w))
            Vj = V[: j + 1]
            h = Vj @ w
            w = w - Vj.T @ h
            h2 = Vj @ w
            w = w - Vj.T @ h2
            hj = float(torch.linalg.vector_norm(w))
            col = (h + h2).cpu().numpy()
            breakdown = not hj > eps * norm0
            H[:, j] = 0.0
            H[: j + 1, j] = col
            H[j + 1, j] = 0.0 if breakdown else hj
            if breakdown:
                break
            V[j + 1] = w / hj
        e1 = np.zeros(m + 1)
        e1[0] = rnorm
        y = np.linalg.lstsq(H, e1, rcond=None)[0]
        x = x + V[:m].T @ torch.as_tensor(y, dtype=V.dtype, device=V.device)
        r = fl(M(unfl(bf - fl(matvec(unfl(x))))))
        rnorm = float(torch.linalg.vector_norm(r))
        k += 1
    return unfl(x), k, rnorm / max(bnorm, 1e-300)


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
    fl, unfl = _flat_ops(ortho[0], sorted(defl[0]))
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
    """Solve ``A x = b`` with a preconditioned Krylov method on the
    equilibrated, BC-reduced system (``method``: ``"cg"``, ``"bicgstab"``,
    ``"gmres"``: left-preconditioned, restart 50, ``maxiter`` counts
    cycles, iterations reported as -1; ``"fgmres"``: flexible, restart 20,
    for a nonstationary preconditioner such as p-multigrid, iterations in
    whole cycles), or directly: ``method="dense"`` (host least squares,
    small systems) and ``method="sparse"`` (host SuperLU of the active
    submatrix, cached on the operator).  ``precond`` is a preconditioner of
    the unscaled system (e.g. a :class:`phifem_tpu_torch.mg.VCycle`); the
    reported residual is the equilibrated one, relative to the equilibrated
    RHS.

    ``deflate``: vectors (dicts in the system's layout) spanning a known
    null space of the reduced operator, e.g. the collective rigid modes of
    S5.  The Krylov methods then solve ``P A P + Q Q^T`` (see
    :func:`_eq_context`): the solution has no component along the basis and
    the reported residual is the deflated one.  The sparse path solves the
    bordered system ``[[A, Q], [Q^T, 0]]`` instead."""
    if method not in ("cg", "bicgstab", "gmres", "fgmres", "dense", "sparse"):
        raise ValueError(f"Unknown method {method!r}.")
    if method in ("dense", "sparse"):
        matvec, _, active = masked_operator(op, bcs)
        b_l = lift_rhs(op, b, bcs, active, raw_matvec=matvec.raw)
        if method == "dense":
            return _dense_solve(op, b_l, active)
        return _sparse_solve(op, b_l, bcs, active, deflate)
    runners = {"cg": _pcg, "bicgstab": _pbicgstab, "gmres": _pgmres, "fgmres": _pfgmres}
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
    if method == "gmres":
        it = -1  # the count of restart cycles is not reported, as in the JAX package
    r = {k: b_eq[k] - v for k, v in mv_eq(x).items()}
    rel = float(torch.sqrt(tree_dot(r, r)) / torch.clamp(torch.sqrt(tree_dot(b_eq, b_eq)), min=1e-300))
    if proj is not None:
        x = proj(x)  # zero null-component gauge
    x = {k: v * dinv_sqrt[k] for k, v in x.items()}  # undo x = D^-1/2 y
    return SolveResult(
        x=x, residual=rel, iterations=it, converged=rel <= 10 * tol, recurrence=rec
    )


def solve_ir(
    op: Operator,
    b: Vec,
    bcs: Tuple[DirichletBC, ...] = (),
    precond: Optional[Callable] = None,
    method: str = "cg",
    tol: float = 1e-10,
    inner_tol: float = 1e-6,
    inner_maxiter: int = 100,
    max_outer: int = 6,
    inner_dtype: torch.dtype = torch.float32,
) -> SolveResult:
    """Mixed-precision iterative refinement: ``inner_dtype`` (float32)
    equilibrated CG or BiCGStab corrections inside a full-precision residual
    loop, as :func:`phifem_tpu.solvers.solve_ir`::

        r_k = b - A x_k            (full precision, one matvec a round)
        solve A e ~= r_k           (float32, preconditioned, to inner_tol)
        x_{k+1} = x_k + e

    at most ``max_outer`` rounds, until ``||r|| / ||b||`` (the lifted,
    unequilibrated system) reaches ``tol``.  Each round contracts the
    residual by about ``max(inner_tol, kappa(A) eps_f32)``: the right tool
    up to ~1M DoF of 2D Poisson.  ``precond`` should compute in float32
    (e.g. ``mg_preconditioner(dtype=torch.float32)``).  The inner vectors
    are float32 and their dots float64 (JAX's ``jax.scipy`` cg / bicgstab
    reduce in float32).  ``iterations`` counts the rounds."""
    from .mg import _masked_matvec

    matvec_f, diag, active = masked_operator(op, bcs)
    b = lift_rhs(op, b, bcs, active, raw_matvec=matvec_f.raw)
    matvec_i, _, _ = _masked_matvec(op, bcs, inner_dtype)
    # symmetric diagonal equilibration of the inner system (see solve())
    dsqrt_i = {
        k: torch.sqrt(torch.where(torch.abs(d) > 1e-30, torch.abs(d), 1.0)).to(inner_dtype)
        for k, d in diag.items()
    }
    dinv_i = {k: 1.0 / d for k, d in dsqrt_i.items()}

    def matvec_eq(y: Vec) -> Vec:
        z = matvec_i({k: v * dinv_i[k] for k, v in y.items()})
        return {k: v * dinv_i[k] for k, v in z.items()}

    if precond is None:
        M = lambda r: r
    else:
        def M(r: Vec) -> Vec:
            z = precond({k: v * dsqrt_i[k] for k, v in r.items()})
            return {k: v * dsqrt_i[k] for k, v in z.items()}

    inner = {"cg": _pcg, "bicgstab": _pbicgstab}[method]
    bnorm = float(torch.sqrt(tree_dot(b, b)))

    def resid(x: Vec):
        r = {k: b[k] - v for k, v in matvec_f(x).items()}
        return r, float(torch.sqrt(tree_dot(r, r))) / max(bnorm, 1e-300)

    x = {k: torch.zeros_like(v) for k, v in b.items()}
    r, rel = resid(x)
    it = 0
    while rel > tol and it < max_outer:
        rs = {k: v.to(inner_dtype) * dinv_i[k] for k, v in r.items()}
        zero = {k: torch.zeros_like(v) for k, v in rs.items()}
        es, _, _ = inner(
            matvec_eq, rs, zero, tol=inner_tol, atol=0.0, maxiter=inner_maxiter, M=M, dot=tree_dot64
        )
        x = {k: x[k] + (es[k] * dinv_i[k]).to(x[k].dtype) for k in x}
        r, rel = resid(x)
        it += 1
    return SolveResult(x=x, residual=rel, iterations=it, converged=rel <= tol, recurrence=rel)


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
