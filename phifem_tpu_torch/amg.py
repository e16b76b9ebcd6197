"""Smoothed-aggregation algebraic multigrid for the bulk of imported-mesh
phi-FEM systems.

Counterpart of :mod:`phifem_tpu.amg`.  An imported mesh has no lattice, so
the degree-1 bulk block gets a classical smoothed-aggregation AMG hierarchy
(Vanek, Mandel, Brezina 1996), built once on the host from the assembled
sparse operator and cycled on the device.

* Host set-up per level (numpy / scipy, copied from the JAX package so that
  the aggregates and tables are the same): the strength graph
  ``|a_ij| >= theta sqrt(|a_ii a_jj|)``, greedy MIS aggregation, the
  tentative piecewise-constant P, Jacobi smoothing
  ``P = (I - omega D^-1 A) T`` with ``omega = 4/3 / rho(D^-1 A)``, and the
  Galerkin product ``R A P``; the coarsest level's dense pseudo-inverse.
* Device data per level: the operator, P and R = P^T as slot-major ELL
  tables (``(width, n)``; see :mod:`phifem_tpu_torch.ops.cuda_amg`), the
  lanes per row of each table's launches, the inverse diagonal and its
  damped form ``omega * inv_diag``.  Every ELL product, residual, Jacobi
  sweep and prolongation (with its add) of the V-cycle is one launch of the
  hand-written kernel on the card (its plain version on the CPU); the first
  pre-smoothing sweep from zero is its closed form ``omega D^-1 b``, and
  the coarse ``coarse_inv @ b`` is ``torch.matmul``.
* :func:`amg_preconditioner` cycles the BULK rows of each scalar field (the
  active DoFs no data-dependent batch touches), Jacobi on the rest, and the
  multiplicative cut-band solve of :func:`phifem_tpu_torch.mg.
  attach_interface_solve` on the penalty block, as the lattice
  preconditioner does.  Vector fields get Jacobi and the band solve only.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .mg import VCycle
from .ops.cuda_amg import APPLY, JACOBI, PROLONG_ADD, RESIDUAL, amg_ell_sweep, lanes_for

__all__ = ["build_amg", "AMG", "AMGVCycle", "amg_preconditioner"]


def _csr_to_ell(A, pad_row: Optional[int] = None):
    """(cols, vals) ELL arrays, row-major ``(n, nnzmax)``, of a scipy CSR
    matrix; the padded column is ``pad_row`` (default n)."""
    n = A.shape[0]
    pad = n if pad_row is None else pad_row
    nnz_row = np.diff(A.indptr)
    nnzmax = max(1, int(nnz_row.max()) if n else 1)
    cols = np.full((n, nnzmax), pad, np.int64)
    vals = np.zeros((n, nnzmax))
    rr = np.repeat(np.arange(n), nnz_row)
    oo = np.arange(A.nnz) - np.repeat(A.indptr[:-1], nnz_row)
    cols[rr, oo] = A.indices
    vals[rr, oo] = A.data
    return cols, vals


def _aggregate(A, theta: float = 0.08) -> Tuple[np.ndarray, int]:
    """Greedy MIS aggregation on the strength graph
    ``|a_ij| >= theta * sqrt(|a_ii a_jj|)``.  Returns (aggregate id per
    node, number of aggregates)."""
    import scipy.sparse as sp

    n = A.shape[0]
    d = np.abs(A.diagonal())
    Ac = A.tocoo()
    off = Ac.row != Ac.col
    strong = off & (np.abs(Ac.data) >= theta * np.sqrt(np.maximum(d[Ac.row] * d[Ac.col], 1e-300)))
    S = sp.csr_matrix((np.ones(int(strong.sum())), (Ac.row[strong], Ac.col[strong])), shape=(n, n))
    indptr, indices = S.indptr, S.indices
    agg = np.full(n, -1, np.int64)
    na = 0
    # pass 1: roots whose strong neighbourhood is untouched become new
    # aggregates with all their neighbours
    for i in range(n):
        if agg[i] >= 0:
            continue
        nb = indices[indptr[i] : indptr[i + 1]]
        if nb.size and (agg[nb] >= 0).any():
            continue
        agg[i] = na
        agg[nb] = na
        na += 1
    # pass 2: attach leftovers to the aggregate of any strong neighbour
    for i in range(n):
        if agg[i] >= 0:
            continue
        nb = indices[indptr[i] : indptr[i + 1]]
        cand = nb[agg[nb] >= 0] if nb.size else nb
        if cand.size:
            agg[i] = agg[cand[0]]
    # pass 3: isolated nodes become singletons
    for i in range(n):
        if agg[i] < 0:
            agg[i] = na
            na += 1
    return agg, na


def _spectral_radius(A, Dinv, iters: int = 12) -> float:
    """Power-iteration estimate of rho(D^-1 A) (the prolongator smoothing
    weight is 4/3 / rho)."""
    n = A.shape[0]
    rng = np.random.default_rng(0)
    v = rng.standard_normal(n)
    v /= np.linalg.norm(v) + 1e-300
    lam = 1.0
    for _ in range(iters):
        w = Dinv * (A @ v)
        lam = np.linalg.norm(w)
        if lam < 1e-300:
            return 1.0
        v = w / lam
    return float(lam)


def _slot_major(cols: np.ndarray, vals: np.ndarray, dtype: torch.dtype, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-major ELL arrays ``(n, w)`` as the kernel's slot-major
    ``(w, n)`` tensors: int32 columns, values in ``dtype``."""
    c = torch.as_tensor(np.ascontiguousarray(np.asarray(cols).T), dtype=torch.int32, device=device)
    v = torch.as_tensor(np.ascontiguousarray(np.asarray(vals).T), dtype=dtype, device=device)
    return c, v


@dataclasses.dataclass
class AMGLevel:
    """One level's device tables.  ``ecols`` / ``evals`` (w, n): the
    operator, pad column n; ``p_*`` (pw, n): the rows of P (gathering the
    coarse vector, pad nc); ``r_*`` (rw, nc): the rows of R = P^T (pad n);
    ``p_*`` and ``r_*`` are None on the coarsest level.  ``jac_diag`` is
    ``omega * inv_diag`` in the cycle's dtype; ``e_lanes`` / ``p_lanes`` /
    ``r_lanes`` are the kernel's lanes per row for each table
    (:func:`~phifem_tpu_torch.ops.cuda_amg.lanes_for`), set with it."""

    n: int
    ecols: torch.Tensor
    evals: torch.Tensor
    inv_diag: torch.Tensor
    p_cols: Optional[torch.Tensor] = None
    p_vals: Optional[torch.Tensor] = None
    r_cols: Optional[torch.Tensor] = None
    r_vals: Optional[torch.Tensor] = None
    jac_diag: Optional[torch.Tensor] = None
    e_lanes: Optional[int] = None
    p_lanes: Optional[int] = None
    r_lanes: Optional[int] = None


@dataclasses.dataclass
class AMG:
    """Device-resident SA-AMG V-cycle on a flat vector (one field's bulk
    block): ``amg(b) ~ A^-1 b``, computed in ``dtype``."""

    levels: List[AMGLevel]
    coarse_inv: torch.Tensor
    dtype: torch.dtype = torch.float32
    omega: float = 0.67
    pre_smooth: int = 1
    post_smooth: int = 1

    def __post_init__(self):
        for lvl in self.levels:
            om = torch.tensor(self.omega, dtype=self.dtype, device=lvl.inv_diag.device)
            lvl.jac_diag = om * lvl.inv_diag.to(self.dtype)
            lvl.e_lanes = lanes_for(*lvl.ecols.shape[::-1])
            if lvl.p_cols is not None:
                lvl.p_lanes = lanes_for(*lvl.p_cols.shape[::-1])
                lvl.r_lanes = lanes_for(*lvl.r_cols.shape[::-1])

    def _smooth(self, lvl: AMGLevel, x: torch.Tensor, b: torch.Tensor, sweeps: int) -> torch.Tensor:
        for _ in range(sweeps):
            x = amg_ell_sweep(JACOBI, lvl.ecols, lvl.evals, x, b, lvl.jac_diag, lanes=lvl.e_lanes)
        return x

    def _cycle(self, k: int, b: torch.Tensor) -> torch.Tensor:
        lvl = self.levels[k]
        if k == len(self.levels) - 1:
            return self.coarse_inv @ b
        if self.pre_smooth > 0:
            # the first sweep from x = 0: 0 + d (b - A 0) is d b, since A 0
            # is a signed zero (only the sign of an exact zero can differ),
            # so it needs no read of A
            x = self._smooth(lvl, lvl.jac_diag * b, b, self.pre_smooth - 1)
        else:
            x = torch.zeros_like(b)
        r = amg_ell_sweep(RESIDUAL, lvl.ecols, lvl.evals, x, b, lanes=lvl.e_lanes)
        rc = amg_ell_sweep(APPLY, lvl.r_cols, lvl.r_vals, r, lanes=lvl.r_lanes)
        ec = self._cycle(k + 1, rc)
        x = amg_ell_sweep(PROLONG_ADD, lvl.p_cols, lvl.p_vals, ec, x, lanes=lvl.p_lanes)
        return self._smooth(lvl, x, b, self.post_smooth)

    def __call__(self, b: torch.Tensor) -> torch.Tensor:
        in_dt = b.dtype
        return self._cycle(0, b.to(self.dtype)).to(in_dt)


def build_amg(
    A,
    dtype: torch.dtype = torch.float32,
    theta: float = 0.08,
    max_coarse: int = 400,
    max_levels: int = 12,
    omega_p: Optional[float] = None,
    device="cuda",
    **kw,
) -> AMG:
    """Build the SA-AMG hierarchy of a scipy sparse matrix on the host and
    return the V-cycle on ``device``.  ``amg.setup_levels`` lists each
    level's rows and ELL widths ``(n, w_A, w_P, w_R)``."""
    import scipy.sparse as sp

    A = A.tocsr()
    levels: List[AMGLevel] = []
    shapes = []
    while True:
        n = A.shape[0]
        d = A.diagonal()
        dinv = np.where(np.abs(d) > 1e-300, 1.0 / np.where(d == 0, 1.0, d), 1.0)
        ecols, evals = _csr_to_ell(A)
        c, v = _slot_major(ecols, evals, dtype, device)
        lvl = AMGLevel(n, c, v, torch.as_tensor(dinv, dtype=dtype, device=device))
        levels.append(lvl)
        shapes.append([n, ecols.shape[1], 0, 0])
        if n <= max_coarse or len(levels) >= max_levels:
            break
        agg, na = _aggregate(A, theta)
        if na >= n:  # no coarsening progress
            break
        # tentative prolongator: piecewise constant over the aggregates,
        # columns normalized (the near-null space of a Laplacian bulk is the
        # constant vector)
        cnt = np.bincount(agg, minlength=na).astype(np.float64)
        T = sp.csr_matrix((1.0 / np.sqrt(cnt[agg]), (np.arange(n), agg)), shape=(n, na))
        rho = _spectral_radius(A, dinv)
        om = (4.0 / 3.0) / max(rho, 1e-300) if omega_p is None else omega_p
        P = (T - sp.diags(om * dinv) @ (A @ T)).tocsr()
        pcols, pvals = _csr_to_ell(P, pad_row=na)
        R = P.T.tocsr()
        rcols, rvals = _csr_to_ell(R, pad_row=n)
        lvl.p_cols, lvl.p_vals = _slot_major(pcols, pvals, dtype, device)
        lvl.r_cols, lvl.r_vals = _slot_major(rcols, rvals, dtype, device)
        shapes[-1][2:] = [pcols.shape[1], rcols.shape[1]]
        A = (R @ A @ P).tocsr()
        A.eliminate_zeros()
    coarse_inv = np.linalg.pinv(np.asarray(A.todense()), rcond=1e-12)
    amg = AMG(levels, torch.as_tensor(coarse_inv, dtype=dtype, device=device), dtype=dtype, **kw)
    amg.setup_levels = [tuple(s) for s in shapes]
    return amg


@dataclasses.dataclass
class AMGVCycle(VCycle):
    """One-level :class:`~phifem_tpu_torch.mg.VCycle` whose cycle is the AMG
    V-cycle on each AMG field's bulk rows and damped Jacobi elsewhere (the
    band solve, when attached, follows in :meth:`VCycle._apply`)."""

    amgs: Dict[str, AMG] = dataclasses.field(default_factory=dict)
    bulk_masks: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    bulk_ids: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)

    def _cycle(self, k: int, b):
        lvl = self.levels[0]
        out = {}
        for f, v in b.items():
            a = lvl.active[f]
            jac = self.omega * v * lvl.inv_diag[f]
            amg = self.amgs.get(f)
            if amg is None:
                out[f] = torch.where(a, jac, torch.zeros_like(v))
                continue
            ids = self.bulk_ids[f]
            z = amg(v.reshape(-1)[ids])
            zf = torch.zeros(v.numel(), dtype=v.dtype, device=v.device).index_copy(0, ids, z.to(v.dtype))
            out[f] = torch.where(self.bulk_masks[f], zf.reshape(v.shape), torch.where(a, jac, torch.zeros_like(v)))
        return out


def amg_preconditioner(
    op,
    bcs=(),
    dtype: torch.dtype = torch.float32,
    theta: float = 0.08,
    interface: bool = True,
    **interface_kw,
) -> AMGVCycle:
    """The imported-mesh phi-FEM preconditioner: SA-AMG on each scalar
    field's bulk block (at least 32 DoFs), Jacobi on the rest, and the
    multiplicative cut-band solve.  Plugs into ``solve(..., precond=...)``
    as ``SchemeBase.lattice_preconditioner`` does.  ``vc.setup_seconds``
    holds the host wall of each part, ``vc.amg_levels`` each AMG's level
    shapes."""
    import time

    from .mg import Level, _masked_matvec, attach_interface_solve, data_dependent_selection
    from .solvers import masked_operator

    t0 = time.perf_counter()
    matvec, inv_diag, active = _masked_matvec(op, bcs, dtype)
    _, _, active_full = masked_operator(op, bcs)
    sel = data_dependent_selection(op, active_full)
    device = next(iter(active.values())).device

    amgs, bulk_masks, bulk_ids = {}, {}, {}
    t_csr = t_amg = 0.0
    for name, sp_ in op.system.fields.items():
        if sp_.value_size != 1:
            continue  # vector fields: Jacobi + band (scalar-only AMG)
        act = np.broadcast_to(active_full[name].cpu().numpy(), sp_.dof_shape).reshape(-1)
        bulk = act & ~np.asarray(sel[name]).reshape(-1)
        if bulk.sum() < 32:
            continue
        sel_one = {
            f: bulk.reshape(op.system.fields[f].dof_shape) if f == name
            else np.zeros(op.system.fields[f].dof_shape, bool)
            for f in op.system.fields
        }
        t1 = time.perf_counter()
        A_bb, _ = op.restricted_csr(sel_one)
        t2 = time.perf_counter()
        amgs[name] = build_amg(A_bb, dtype=dtype, theta=theta, device=device)
        t_csr, t_amg = t_csr + (t2 - t1), t_amg + (time.perf_counter() - t2)
        bulk_masks[name] = torch.as_tensor(bulk.reshape(sp_.dof_shape[0]), device=device)
        bulk_ids[name] = torch.as_tensor(np.where(bulk)[0], dtype=torch.int64, device=device)

    lvl = Level(None, matvec, inv_diag, active)
    vc = AMGVCycle([lvl], tuple(amgs), dtype=dtype, amgs=amgs, bulk_masks=bulk_masks, bulk_ids=bulk_ids)
    t3 = time.perf_counter()
    if interface:
        vc = attach_interface_solve(vc, op, active_full, **interface_kw)
    vc.setup_seconds = {"bulk csr": t_csr, "amg build": t_amg, "band": time.perf_counter() - t3,
                        "total": time.perf_counter() - t0}
    vc.amg_levels = {f: a.setup_levels for f, a in amgs.items()}
    return vc
