"""p-multigrid: preconditioning of degree >= 2 phi-FEM systems.

Counterpart of :mod:`phifem_tpu.pmg`.  Plain Jacobi-preconditioned Krylov
floors on penalized high-degree systems (~1e-6 relative residual at degree
3); the p-multigrid / low-order-refined design instead uses

* smoother: damped Jacobi on the high-degree system (the intra-cell error
  modes);
* coarse space: the SAME scheme re-discretized at degree 1 on the SAME grid
  (its "P1 twin"), corrected by its own lattice preconditioner (bulk
  lattice MG + cut-band solve), wrapped in a few inner BiCGStab iterations;
* transfers: the degree-1 -> degree-k nodal interpolation P (exact and
  local: each high-degree node interpolates the low-degree basis of its
  cell) and its transpose as restriction;
* cut band: the h^-3 penalty block of the HIGH-degree operator gets the
  multiplicative interface solve of every phi-FEM preconditioner here
  (:func:`phifem_tpu_torch.mg.attach_interface_solve`).

The inner iterations make the preconditioner nonstationary: pair it with
``solve(method="fgmres")``.  Use
:meth:`phifem_tpu_torch.models.base.SchemeBase.p_multigrid_preconditioner`.

The restriction ``P^T`` sums many contributions into each shared low-degree
DoF; it runs as an ordered scatter (:func:`phifem_tpu_torch.ops.scatter.
scatter_plan`, one plan per transfer) where the JAX package scatter-adds,
so every sum has a fixed order on the card too.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .mg import VCycle
from .ops.scatter import scatter_plan

__all__ = ["p_transfer", "PMGVCycle", "build_p_preconditioner"]

Vec = Dict[str, torch.Tensor]


def p_transfer(space_high, space_low) -> Tuple[np.ndarray, np.ndarray]:
    """ELL form ``(idx, wts)`` of the nodal prolongation P: low -> high.

    Row i of P holds the low-degree basis values at high node i, supported
    on that node's cell: the same reference-element tabulation for every
    cell, so no geometry is touched.  Nodes shared by several cells receive
    identical values from each (FE continuity), so a per-cell overwrite is
    well defined.  Returns ``idx (Nh, nloc_low) int32`` and ``wts (Nh,
    nloc_low)`` float64, as the JAX package's."""
    el_h, el_l = space_high.element, space_low.element
    if el_h.cell != el_l.cell:
        raise ValueError("p_transfer requires matching cell types")
    T = el_l.tabulate(el_h.nodes)  # (nloc_h, nloc_l)
    cd_h = np.asarray(space_high.cell_dofs_np)
    cd_l = np.asarray(space_low.cell_dofs_np)
    Nh = space_high.num_scalar_dofs
    idx = np.zeros((Nh, cd_l.shape[1]), np.int32)
    wts = np.zeros((Nh, cd_l.shape[1]))
    for l in range(cd_h.shape[1]):
        g = cd_h[:, l]
        idx[g] = cd_l
        wts[g] = T[l]
    return idx, wts


@dataclasses.dataclass
class Transfer:
    """One field's P on the device: ``idx`` / ``wts`` (Nh, K) and the
    ordered-scatter plan ``(uniq, pos)`` of ``P^T`` over ``idx``."""

    idx: torch.Tensor
    wts: torch.Tensor
    nl: int
    uniq: torch.Tensor
    pos: torch.Tensor

    @staticmethod
    def build(idx: np.ndarray, wts: np.ndarray, nl: int, device) -> "Transfer":
        idx_t = torch.as_tensor(idx, dtype=torch.int64, device=device)
        uniq, pos = scatter_plan(idx_t)
        return Transfer(idx_t, torch.as_tensor(wts, dtype=torch.float64, device=device), nl, uniq, pos)


def _apply_P(tr: Transfer, v: torch.Tensor) -> torch.Tensor:
    """(Nl, *vs) -> (Nh, *vs): ``vh[i] = sum_k wts[i,k] v[idx[i,k]]``."""
    w = tr.wts.to(v.dtype).reshape(tr.wts.shape + (1,) * (v.ndim - 1))
    return (w * v[tr.idx]).sum(dim=1)


def _apply_PT(tr: Transfer, r: torch.Tensor) -> torch.Tensor:
    """(Nh, *vs) -> (Nl, *vs): the transpose of :func:`_apply_P`, each low
    DoF's contributions summed in entity order (no atomics)."""
    tail = tuple(r.shape[1:])
    w = tr.wts.to(r.dtype).reshape(tr.wts.shape + (1,) * len(tail))
    upd = (w * r[:, None]).reshape((-1,) + tail)
    upd = torch.cat([upd, upd.new_zeros((1,) + tail)])  # row Nh*K: padding
    out = r.new_zeros((tr.nl,) + tail)
    return out.index_add_(0, tr.uniq, upd[tr.pos].sum(dim=1))


@dataclasses.dataclass
class PMGVCycle(VCycle):
    """Two-level p-multigrid cycle usable anywhere a V-cycle is.

    ``levels[0]`` is the high-degree system (masked matvec / inv_diag /
    active from :func:`phifem_tpu_torch.mg._masked_matvec`); the degree-1
    correction is delegated to ``low_apply``.  The inherited ``_apply``
    adds the identity on inactive rows and the multiplicative cut-band
    solve (:func:`~phifem_tpu_torch.mg.attach_interface_solve` attaches to
    this class unchanged)."""

    transfers: Optional[Dict[str, Transfer]] = None
    low_active: Optional[Dict[str, torch.Tensor]] = None
    low_apply: Optional[Callable] = None
    setup_seconds: Optional[Dict[str, float]] = None  # wall of each set-up part

    def _cycle(self, k: int, b: Vec) -> Vec:
        lvl = self.levels[0]
        zero = {n: torch.zeros_like(v) for n, v in b.items()}
        x = self._smooth(lvl, zero, b, self.pre_smooth)
        ax = lvl.matvec(x)
        r = {n: torch.where(lvl.active[n], b[n] - ax[n], 0.0) for n in b}
        rc = {f: torch.where(self.low_active[f], _apply_PT(self.transfers[f], r[f]), 0.0) for f in r}
        ec = self.low_apply(rc)
        for f in b:
            corr = _apply_P(self.transfers[f], ec[f])
            x[f] = torch.where(lvl.active[f], x[f] + corr, x[f])
        return self._smooth(lvl, x, b, self.post_smooth)


def _clock(device: torch.device) -> float:
    """Wall clock once the work queued on ``device`` has run."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def build_p_preconditioner(
    scheme,
    min_n: int = 16,
    dtype: torch.dtype = torch.float32,
    low_iters: int = 10,
    low_tol: float = 1e-2,
    **interface_kw,
) -> PMGVCycle:
    """Assemble the p-multigrid preconditioner of a degree >= 2 scheme.

    The degree-1 twin (``scheme._p1_twin()``) is set up with the scheme's
    own ``_setup_args`` and assembled on the same grid.  Its correction is
    ``low_iters`` iterations of equilibrated BiCGStab (float64 dots, exit at
    ``low_tol``) preconditioned by the twin's ``lattice_preconditioner(
    min_n, dtype)``, or that preconditioner alone when ``low_iters == 0``.
    ``interface_kw`` go to the interface solve of the high-degree band.
    The cycle's ``setup_seconds`` holds the wall of each part of this call."""
    from .mg import Level, _masked_matvec, attach_interface_solve
    from .solvers import _pbicgstab, masked_operator

    device = scheme.grid.device
    t0 = _clock(device)
    low = scheme._p1_twin()
    low.setup(*scheme._setup_args)
    low.assemble(rhs=False)

    bcs = getattr(scheme, "bcs", ())
    low_bcs = getattr(low, "bcs", ())
    matvec, inv_diag, active = _masked_matvec(scheme.op, bcs, None)
    low_mv, low_inv_diag, low_active = _masked_matvec(low.op, low_bcs, None)
    t1 = _clock(device)
    M_low = low.lattice_preconditioner(min_n=min_n, dtype=dtype) if hasattr(low, "lattice_preconditioner") else None

    # symmetric equilibration of the low system (its penalty rows scale
    # h^-3 too); dsqrt from the masked inverse diagonal (1 on inactive)
    dsqrt = {k: 1.0 / torch.sqrt(torch.abs(d)) for k, d in low_inv_diag.items()}
    dinv = {k: 1.0 / d for k, d in dsqrt.items()}

    def mv_eq(y: Vec) -> Vec:
        z = low_mv({k: v * dinv[k] for k, v in y.items()})
        return {k: v * dinv[k] for k, v in z.items()}

    if M_low is not None:
        def M(r: Vec) -> Vec:
            z = M_low({k: v * dsqrt[k] for k, v in r.items()})
            return {k: v * dsqrt[k] for k, v in z.items()}
    else:
        M = lambda r: r  # the equilibrated system has a unit diagonal

    def low_apply(rc: Vec) -> Vec:
        if low_iters == 0:
            return M_low(rc) if M_low is not None else {k: v * low_inv_diag[k] for k, v in rc.items()}
        beq = {k: v * dinv[k] for k, v in rc.items()}
        x0 = {k: torch.zeros_like(v) for k, v in beq.items()}
        x, _, _ = _pbicgstab(mv_eq, beq, x0, tol=low_tol, atol=0.0, maxiter=low_iters, M=M)
        return {k: v * dinv[k] for k, v in x.items()}

    t2 = _clock(device)
    transfers, built = {}, {}
    for f, sp in scheme.system.fields.items():
        sl = low.system.fields[f]
        key = (id(sp), id(sl))  # S1's u and p share one transfer
        if key not in built:
            idx, wts = p_transfer(sp, sl)
            built[key] = Transfer.build(idx, wts, sl.num_scalar_dofs, device)
        transfers[f] = built[key]

    lvl = Level(scheme.grid, matvec, inv_diag, active)
    vc = PMGVCycle([lvl], vertex_fields=(), transfers=transfers, low_active=low_active, low_apply=low_apply)
    _, _, active_full = masked_operator(scheme.op, bcs)
    t3 = _clock(device)
    vc = attach_interface_solve(vc, scheme.op, active_full, **interface_kw)
    vc.setup_seconds = {"twin build": t1 - t0, "twin lattice_preconditioner": t2 - t1,
                        "transfers": t3 - t2, "band tables": _clock(device) - t3}
    return vc
