"""Geometric multigrid on the structured background grid.

Counterpart of :mod:`phifem_tpu.mg`: the bulk V-cycles, the interface band
solve, the rank-k Galerkin coarse correction and the coupled multilevel
hierarchy of interface-transmission systems, and the Ritz-mode harvest of
:func:`attach_ritz_modes`.

* hierarchy: grids ``n, n/2, n/4, ...``, each level *re-discretized* by a
  level factory;
* transfers on P1 vertex lattices: prolongation = bilinear interpolation,
  restriction = its transpose (full weighting);
* smoother: damped Jacobi with the assembled diagonal, inactive DoFs held;
* coarse solve: a dense pseudo-inverse on the coarsest level when it is
  small, else extra smoothing sweeps;
* :class:`LatticeBulkVCycle`: the full-box lattice V-cycle of
  :mod:`phifem_tpu_torch.ops.lattice` as the bulk smoother of a phi-FEM
  preconditioner, with the multiplicative solve on the cut band
  (:func:`attach_interface_solve`) and, optionally, a rank-k Galerkin
  correction over near-null modes (:func:`attach_coarse_correction`);
* :class:`CoupledVCycle`: the whole scheme re-discretized on halved grids,
  each level smoothed by its own lattice preconditioner, the coarsest one
  solved by a dense pseudo-inverse (S5's default).

Every level's matvec goes through its operator's batches, so on the card
each stencil matvec runs the hand-written kernel.

Deviation from the JAX package: the interface tables (dense inverse,
Schwarz block inverses, ELL band values) are stored in float64 whatever the
cycle's dtype, and applied to the residual cast to float64; the JAX package
stores them in the cycle's dtype (float32 by default).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .grid import Grid

Vec = Dict[str, torch.Tensor]

__all__ = [
    "VCycle",
    "LatticeBulkVCycle",
    "CoupledVCycle",
    "Level",
    "build_hierarchy",
    "attach_interface_solve",
    "attach_coarse_correction",
    "attach_coarse_correction_device",
    "attach_ritz_modes",
    "data_dependent_selection",
    "prolong",
    "restrict",
]

#: dtype of the interface tables (see the module docstring)
TABLE_DTYPE = torch.float64


def prolong(coarse: torch.Tensor, gc: Grid, gf: Grid) -> torch.Tensor:
    """Bilinear prolongation between vertex lattices (gc -> gf = gc.refine()).
    Fine vertex (2i, 2j) copies coarse (i, j); odd points average.  Trailing
    axes (vector components) are transferred each on its own."""
    tail = tuple(coarse.shape[1:])
    X = coarse.reshape((gc.ny + 1, gc.nx + 1) + tail)
    out = torch.zeros((gf.ny + 1, gf.nx + 1) + tail, dtype=coarse.dtype, device=coarse.device)
    out[::2, ::2] = X
    out[::2, 1::2] = 0.5 * (X[:, :-1] + X[:, 1:])
    out[1::2, ::2] = 0.5 * (X[:-1, :] + X[1:, :])
    out[1::2, 1::2] = 0.25 * (X[:-1, :-1] + X[:-1, 1:] + X[1:, :-1] + X[1:, 1:])
    return out.reshape((-1,) + tail)


def restrict(fine: torch.Tensor, gf: Grid, gc: Grid) -> torch.Tensor:
    """Full-weighting restriction (transpose of :func:`prolong`)."""
    tail = tuple(fine.shape[1:])
    Y = fine.reshape((gf.ny + 1, gf.nx + 1) + tail)
    out = Y[::2, ::2].clone()
    h = 0.5 * Y[::2, 1::2]  # horizontal odd neighbours
    out[:, :-1] += h
    out[:, 1:] += h
    v = 0.5 * Y[1::2, ::2]  # vertical odd neighbours
    out[:-1, :] += v
    out[1:, :] += v
    q = 0.25 * Y[1::2, 1::2]  # diagonal odd-odd
    out[:-1, :-1] += q
    out[:-1, 1:] += q
    out[1:, :-1] += q
    out[1:, 1:] += q
    return out.reshape((-1,) + tail)


def _band_bicgstab(mv, M, b: torch.Tensor, iters: int) -> torch.Tensor:
    """Fixed-iteration preconditioned BiCGStab on a flat vector: the inner
    band solver of the multiplicative interface correction.  Bounded work,
    no exit test and no host read; divisions are guarded and the BEST
    iterate (smallest residual seen) is returned.  Dots in b's dtype."""
    tiny = torch.tensor(1e-300, dtype=b.dtype, device=b.device)

    def safe(d):
        return torch.where(torch.abs(d) > 1e-300, d, tiny)

    x = torch.zeros_like(b)
    r, rhat = b, b
    p = v = torch.zeros_like(b)
    rho = alpha = omega = torch.ones((), dtype=b.dtype, device=b.device)
    xb, rrb = x, torch.dot(b, b)
    for i in range(int(iters)):
        rho_new = torch.dot(rhat, r)
        if i == 0:
            p = r
        else:
            p = r + ((rho_new / safe(rho)) * (alpha / safe(omega))) * (p - omega * v)
        ph = M(p)
        v = mv(ph)
        alpha = rho_new / safe(torch.dot(rhat, v))
        s = r - alpha * v
        sh = M(s)
        t = mv(sh)
        omega = torch.dot(t, s) / safe(torch.dot(t, t))
        x = x + alpha * ph + omega * sh
        r = s - omega * t
        rho = rho_new
        rr = torch.dot(r, r)
        better = torch.isfinite(rr) & (rr < rrb)
        xb = torch.where(better, x, xb)
        rrb = torch.where(better, rr, rrb)
    return xb


@dataclasses.dataclass
class Level:
    grid: Grid
    matvec: Callable  # masked operator matvec on this level
    inv_diag: Vec
    active: Dict[str, torch.Tensor]
    coarse_inv: Optional[torch.Tensor] = None  # dense pseudo-inverse (coarsest only)
    field_shapes: Optional[Dict[str, Tuple[int, ...]]] = None

    def pack(self, x: Vec) -> torch.Tensor:
        return torch.cat([x[k].reshape(-1) for k in sorted(x)])

    def unpack(self, v: torch.Tensor) -> Vec:
        out, cur = {}, 0
        for k in sorted(self.field_shapes):
            sh = self.field_shapes[k]
            n = int(np.prod(sh))
            out[k] = v[cur : cur + n].reshape(sh)
            cur += n
        return out


@dataclasses.dataclass
class VCycle:
    """V-cycle preconditioner M^{-1} ~ A^{-1} over a grid hierarchy.

    ``dtype``: optional compute dtype of the whole cycle (e.g. float32
    inside a float64 outer Krylov solve).  Inputs are cast on entry and the
    correction is cast back on exit.
    """

    levels: List[Level]  # fine -> coarse
    vertex_fields: Tuple[str, ...]
    pre_smooth: int = 2
    post_smooth: int = 2
    coarse_sweeps: int = 12
    omega: float = 0.67
    dtype: Optional[torch.dtype] = None

    def _smooth(self, lvl: Level, x: Vec, b: Vec, sweeps: int) -> Vec:
        for _ in range(sweeps):
            ax = lvl.matvec(x)
            x = {
                k: torch.where(
                    lvl.active[k], x[k] + self.omega * (b[k] - ax[k]) * lvl.inv_diag[k], x[k]
                )
                for k in x
            }
        return x

    def _cycle(self, k: int, b: Vec) -> Vec:
        lvl = self.levels[k]
        zero = {n: torch.zeros_like(v) for n, v in b.items()}
        if k == len(self.levels) - 1:
            if lvl.coarse_inv is not None:
                return lvl.unpack(lvl.coarse_inv @ lvl.pack(b))
            return self._smooth(lvl, zero, b, self.coarse_sweeps)
        x = self._smooth(lvl, zero, b, self.pre_smooth)
        ax = lvl.matvec(x)
        # only active-row residuals take part in the coarse-grid correction:
        # identity (BC) rows carry b - x, which must not restrict
        r = {n: torch.where(lvl.active[n], b[n] - ax[n], 0.0) for n in b}
        coarse_lvl = self.levels[k + 1]
        # P1 vertex fields (scalar or vector) restrict; other fields (DG0)
        # live on the fine level only and see a zero coarse right-hand side
        rc = {
            name: restrict(v, lvl.grid, coarse_lvl.grid)
            if name in self.vertex_fields
            else torch.zeros_like(coarse_lvl.inv_diag[name])
            for name, v in r.items()
        }
        ec = self._cycle(k + 1, rc)
        for name in self.vertex_fields:
            corr = prolong(ec[name], coarse_lvl.grid, lvl.grid)
            x[name] = torch.where(lvl.active[name], x[name] + corr, x[name])
        return self._smooth(lvl, x, b, self.post_smooth)

    # optional multiplicative interface (cut-band) correction: an exact
    # dense inverse on the whole band (small bands) or an inner BiCGStab on
    # the ELL band matrix preconditioned by restricted additive Schwarz
    # blocks; the tables are float64 (TABLE_DTYPE)
    interface_ids: Optional[torch.Tensor] = None  # global flat DoF ids
    interface_inv: Optional[torch.Tensor] = None  # dense inverse on those DoFs
    schwarz_ids: Optional[torch.Tensor] = None  # (nb, K) compact band ids, pad -> m
    schwarz_inv: Optional[torch.Tensor] = None  # (nb, K, K) block inverses
    # RAS ownership: per band DoF, the flat (nb * K) slot of the one block
    # entry that corrects it (nb * K: none).  The JAX package keeps an
    # (nb, K) mask and scatter-adds the masked block outputs; with one owner
    # per DoF that sum is this gather, exactly and without atomics
    schwarz_owner: Optional[torch.Tensor] = None
    schwarz_sweeps: int = 10  # inner Krylov iterations on the band system
    band_ids: Optional[torch.Tensor] = None  # (m,) global flat band DoF ids
    band_ell_cols: Optional[torch.Tensor] = None  # (m, nnz) compact cols, pad -> m
    band_ell_vals: Optional[torch.Tensor] = None  # (m, nnz)
    # optional rank-k Galerkin coarse correction (attach_coarse_correction):
    # near-null modes that both the bulk cycle and the band solve miss, e.g.
    # the rigid motions of a floating subdomain
    coarse_Z: Optional[torch.Tensor] = None  # (k, n_flat) masked mode basis
    coarse_Ginv: Optional[torch.Tensor] = None  # (k, k) pseudo-inverse of Z A Z^T
    coarse_AZ: Optional[torch.Tensor] = None  # (k, n_flat) rows of A Z^T
    ritz_lambdas: Optional[np.ndarray] = None  # |lambda| of the kept Ritz modes (attach_ritz_modes)
    _flat_meta: Optional[Tuple] = None  # (names, shapes, sizes) in system order

    def _flatten(self, x: Vec) -> torch.Tensor:
        names, _, _ = self._flat_meta
        return torch.cat([x[n].reshape(-1) for n in names])

    def _unflatten(self, v: torch.Tensor) -> Vec:
        out, cur = {}, 0
        for n, sh, sz in zip(*self._flat_meta):
            out[n] = v[cur : cur + sz].reshape(sh)
            cur += sz
        return out

    def __call__(self, b: Vec) -> Vec:
        in_dtype = next(iter(b.values())).dtype
        cast = self.dtype is not None and in_dtype != self.dtype
        if cast:
            b = {k: v.to(self.dtype) for k, v in b.items()}
        x = self._apply(b)
        if cast:
            x = {k: v.to(in_dtype) for k, v in x.items()}
        return x

    def _apply(self, b: Vec) -> Vec:
        x = self._cycle(0, b)
        # identity on inactive/BC rows: the cycle never writes them, and M
        # must be SPD on the FULL space or outer CG cannot correct nonzero
        # Dirichlet components
        x = {k: torch.where(self.levels[0].active[k], v, b[k]) for k, v in x.items()}
        has_coarse = self.coarse_Z is not None
        has_band = self.interface_inv is not None or self.schwarz_inv is not None
        if not (has_coarse or has_band):
            return x
        # one residual for both multiplicative corrections: the coarse
        # update keeps it current through the rows A Z^T (no second matvec).
        # The rank-k correction goes first: the modes' residual lies almost
        # entirely in the band, which the band solve then re-slaves to the
        # corrected bulk
        r = {k: b[k] - v for k, v in self.levels[0].matvec(x).items()}
        rf, xf = self._flatten(r), self._flatten(x)
        if has_coarse:
            c = self.coarse_Ginv.to(rf.dtype) @ (self.coarse_Z.to(rf.dtype) @ rf)
            xf = xf + self.coarse_Z.to(rf.dtype).T @ c
            if not has_band:
                return self._unflatten(xf)
            rf = rf - self.coarse_AZ.to(rf.dtype).T @ c
        return self._band_correct_flat(xf, rf)

    def _band_ops(self):
        """``(band_mv, band_ras)`` of the Schwarz branch on flat band vectors
        in ``TABLE_DTYPE``: the ELL band matvec and the RAS block apply (each
        band DoF takes its owning block's entry)."""
        zero = self.band_ell_vals.new_zeros(1)

        def band_mv(v):
            vpad = torch.cat([v, zero])
            return (self.band_ell_vals * vpad[self.band_ell_cols]).sum(dim=1)

        def band_ras(v):
            vpad = torch.cat([v, zero])
            cb = torch.einsum("bkl,bl->bk", self.schwarz_inv, vpad[self.schwarz_ids])
            return torch.cat([cb.reshape(-1), zero])[self.schwarz_owner]

        return band_mv, band_ras

    def _band_correct_flat(self, xf: torch.Tensor, rf: torch.Tensor) -> Vec:
        """Multiplicative solve on the cut-cell / ghost-facet DoF block, the
        modes pointwise smoothing cannot contract, given the current flat
        iterate and residual."""
        if self.interface_inv is not None:
            corr = self.interface_inv @ rf[self.interface_ids].to(TABLE_DTYPE)
            xf.index_add_(0, self.interface_ids, corr.to(xf.dtype))
        elif self.schwarz_inv is not None:
            # inner Krylov solve of A_II e = r_I on the ELL band matrix,
            # preconditioned by the per-entity RAS block inverses: one-level
            # RAS sweeps alone stall on smooth error along the band
            band_mv, band_ras = self._band_ops()
            e = _band_bicgstab(band_mv, band_ras, rf[self.band_ids].to(TABLE_DTYPE), self.schwarz_sweeps)
            xf.index_add_(0, self.band_ids, e.to(xf.dtype))
        return self._unflatten(xf)


@dataclasses.dataclass
class LatticeBulkVCycle(VCycle):
    """Full-box 2D lattice V-cycle as the bulk smoother of a phi-FEM
    preconditioner.

    Each scalar-P1 field with a uniform stencil batch is cycled on the FULL
    background box (its aggregated vertex stencil; no tagging, no
    per-level assembly); ``bulk_masks`` (active and not in the interface
    band) project the input and output.  Band DoFs carry h^-3 penalty
    couplings a Laplacian-sized correction would blow up, so they get
    damped Jacobi here and the multiplicative interface solve after.
    Fields without a lattice cycle (phi-FEM auxiliary fields live on cut
    cells only) get damped Jacobi.  A vector field whose cycle is a
    :class:`~phifem_tpu_torch.ops.lattice.LatticeVarMG` (S5's displacements)
    or :class:`~phifem_tpu_torch.ops.lattice.LatticeBlockMG` is cycled on its
    channels-first block lattice."""

    mgs: Optional[Dict[str, object]] = None  # field -> ops.lattice.LatticeMG, LatticeBlockMG or LatticeVarMG
    lattice_shapes: Optional[Dict[str, Tuple[int, int]]] = None
    bulk_masks: Optional[Dict[str, torch.Tensor]] = None

    def _cycle(self, k: int, b: Vec) -> Vec:
        from .ops.lattice import LatticeBlockMG, LatticeVarMG

        lvl = self.levels[0]
        out = {}
        for f, v in b.items():
            mg2 = self.mgs.get(f) if self.mgs else None
            a = lvl.active[f]
            jac = self.omega * v * lvl.inv_diag[f]
            if mg2 is None:
                out[f] = torch.where(a, jac, 0.0)
                continue
            bulk = self.bulk_masks[f] if self.bulk_masks and f in self.bulk_masks else a
            R, C = self.lattice_shapes[f]
            rmask = torch.where(bulk, v, 0.0)
            if isinstance(mg2, (LatticeBlockMG, LatticeVarMG)):
                # vector P1 field: channels-first block lattice
                vsz = mg2.vsz
                rp = torch.zeros((vsz, R + 2, C + 2), dtype=v.dtype, device=v.device)
                rp[:, 1 : 1 + R, 1 : 1 + C] = torch.movedim(rmask.reshape(R, C, vsz), -1, 0)
                z = torch.movedim(mg2(rp)[:, 1 : 1 + R, 1 : 1 + C], 0, -1).reshape(v.shape)
            else:
                rp = torch.zeros((R + 2, C + 2), dtype=v.dtype, device=v.device)
                rp[1 : 1 + R, 1 : 1 + C] = rmask.reshape(R, C)
                z = mg2(rp)[1 : 1 + R, 1 : 1 + C].reshape(v.shape)
            out[f] = torch.where(bulk, z, torch.where(a, jac, 0.0))
        return out


@dataclasses.dataclass
class CoupledVCycle:
    """Multilevel coupled hierarchy of interface-coupled phi-FEM systems
    (S5 two-material elasticity).

    The bulk / band splitting alone is h-dependent for interface
    transmission: the two material bulks communicate only through the
    O(h)-thin band.  So the WHOLE coupled scheme is re-discretized on
    halved grids; each level is smoothed (before and after the coarse
    correction) by its own lattice preconditioner (bulk lattice MG + rank-k
    coarse modes + band solve), vertex fields move by bilinear restriction
    and prolongation, cut-only fields are handled per level by that level's
    band solve (their coarse right-hand side is zero), and the coarsest
    coupled operator is solved by a dense pseudo-inverse."""

    levels: List[Dict]  # per level: grid, matvec, active, M (the smoother)
    coarse_level: Level  # pack / unpack and pinv of the coarsest coupled operator
    vertex_fields: Tuple[str, ...]
    dtype: Optional[torch.dtype] = torch.float32

    def __call__(self, b: Vec) -> Vec:
        in_dtype = next(iter(b.values())).dtype
        cast = self.dtype is not None and in_dtype != self.dtype
        if cast:
            b = {k: v.to(self.dtype) for k, v in b.items()}
        x = self._cycle(0, b)
        if cast:
            x = {k: v.to(in_dtype) for k, v in x.items()}
        return x

    def _cycle(self, k: int, b: Vec) -> Vec:
        if k == len(self.levels):
            cl = self.coarse_level
            return cl.unpack(cl.coarse_inv.to(next(iter(b.values())).dtype) @ cl.pack(b))
        lvl = self.levels[k]
        x = lvl["M"]._apply(b)
        ax = lvl["matvec"](x)
        # only active-row residuals drive the coarse correction
        r = {n: torch.where(lvl["active"][n], b[n] - ax[n], 0.0) for n in b}
        gf = lvl["grid"]
        nxt = self.levels[k + 1] if k + 1 < len(self.levels) else None
        gc = nxt["grid"] if nxt is not None else self.coarse_level.grid
        cactive = nxt["active"] if nxt is not None else self.coarse_level.active
        rc = {}
        for name, v in r.items():
            if name in self.vertex_fields:
                rc[name] = torch.where(cactive[name], restrict(v, gf, gc), 0.0)
            else:
                rc[name] = torch.zeros(cactive[name].shape, dtype=v.dtype, device=v.device)
        ec = self._cycle(k + 1, rc)
        for name in x:
            if name in self.vertex_fields:
                x[name] = torch.where(lvl["active"][name], x[name] + prolong(ec[name], gc, gf), x[name])
        # post-smooth: a second full smoother application on the corrected
        # residual (without it the V-recursion loses the two-grid rate)
        ax = lvl["matvec"](x)
        dx = lvl["M"]._apply({n: b[n] - ax[n] for n in b})
        return {n: torch.where(lvl["active"][n], x[n] + dx[n], x[n]) for n in x}


def _masked_matvec(op, bcs, dtype: Optional[torch.dtype]):
    """``(matvec, inv_diag, active)`` like ``solvers.masked_operator``,
    optionally computing in a reduced ``dtype`` (the cycle's dtype): the
    tap form cast to ``dtype`` where the operator has one, else its batches
    cast."""
    from .solvers import masked_operator

    matvec, diag, active = masked_operator(op, bcs)
    inv_diag = {k: 1.0 / d for k, d in diag.items()}
    if dtype is None:
        return matvec, inv_diag, active
    lat = op.lattice_form()
    if lat is not None:
        raw = lat.make_matvec(op, dtype)
    else:
        batches = [b.astype(dtype) for b in op.batches]

        def raw(x: Vec) -> Vec:
            y = {k: torch.zeros_like(v) for k, v in x.items()}
            for bt in batches:
                y = bt.matvec_into(x, y)
            return y

    def mv(x: Vec) -> Vec:
        y = raw({k: torch.where(active[k], v, 0.0) for k, v in x.items()})
        return {k: torch.where(active[k], v, x[k]) for k, v in y.items()}

    return mv, {k: v.to(dtype) for k, v in inv_diag.items()}, active


def _coarse_pinv(op, active) -> torch.Tensor:
    """Masked dense pseudo-inverse of the coarsest operator, rows and
    columns in sorted-field-name order (the pack/unpack layout)."""
    A = op.to_dense()
    off = op.system.offsets()
    n = op.system.num_dofs
    act = np.zeros(n, bool)
    for name, s in op.system.fields.items():
        sl = slice(off[name], off[name] + s.num_dofs)
        act[sl] = np.broadcast_to(active[name].cpu().numpy(), s.dof_shape).reshape(-1)
    A[~act, :] = 0.0
    A[:, ~act] = 0.0
    A[~act, ~act] = 1.0
    perm = np.concatenate(
        [
            np.arange(off[name], off[name] + op.system.fields[name].num_dofs)
            for name in sorted(op.system.fields)
        ]
    )
    A = A[np.ix_(perm, perm)]
    g = next(iter(op.system.fields.values())).grid
    return g._tensor(np.linalg.pinv(A, rcond=1e-12))


def data_dependent_selection(op, active) -> Dict[str, np.ndarray]:
    """Host boolean masks (per field, dof_shape) of the active DoFs touched
    by any data-dependent batch: the cut-cell / ghost / boundary block that
    carries the h^-3 penalty couplings."""
    from .assembly import _is_dynamic

    sel = {n: np.zeros(s.dof_shape, bool) for n, s in op.system.fields.items()}
    for b in op.batches:
        if not _is_dynamic(b):
            continue
        for name, dofs, vs in b.segments:
            m = sel[name]
            m.reshape(m.shape[0], -1)[dofs.cpu().numpy().reshape(-1)] = True
    for n in sel:
        sel[n] &= np.broadcast_to(active[n].cpu().numpy(), op.system.fields[n].dof_shape)
    return sel


def blocks_from_csr(A_csr, bids: np.ndarray, m: int, chunk: int = 1 << 22) -> np.ndarray:
    """Batched dense submatrices ``A[bl][:, bl]`` of the (nb, K) blocks
    ``bids`` (padded with ``m``: zero rows and columns), looked up in the
    sorted (row, column) keys of the canonical CSR matrix: O(nb K^2 log nnz)
    in chunks of about ``chunk`` entries, whatever the row lengths (the
    JAX package slices the CSR matrix once per block)."""
    A = A_csr.tocsr(copy=True)
    A.sum_duplicates()
    A.sort_indices()
    rows = np.repeat(np.arange(A.shape[0], dtype=np.int64), np.diff(A.indptr))
    keys = rows * (m + 1) + A.indices
    nb, K = bids.shape
    out = np.zeros((nb, K, K))
    if keys.size == 0:
        return out
    step = max(1, chunk // max(1, K * K))
    for s in range(0, nb, step):
        b = bids[s : s + step].astype(np.int64)
        q = (b[:, :, None] * (m + 1) + b[:, None, :]).reshape(-1)
        pos = np.minimum(np.searchsorted(keys, q), keys.size - 1)
        out[s : s + step] = np.where(keys[pos] == q, A.data[pos], 0.0).reshape(b.shape[0], K, K)
    return out


def _ell(A_csr, m: int):
    """(m+1, nnzmax) ELL columns (pad -> m) and values of a CSR matrix;
    row m is the zero padding row."""
    nnz_row = np.diff(A_csr.indptr)
    nnzmax = max(1, int(nnz_row.max())) if m else 1
    cols = np.full((m + 1, nnzmax), m, np.int64)
    vals = np.zeros((m + 1, nnzmax))
    rows = np.repeat(np.arange(m), nnz_row)
    offs = np.arange(A_csr.nnz) - np.repeat(A_csr.indptr[:-1], nnz_row)
    cols[rows, offs] = A_csr.indices
    vals[rows, offs] = A_csr.data
    return cols, vals, nnz_row


def ras_owner(bids: np.ndarray, own: np.ndarray, m: int) -> np.ndarray:
    """(m,) flat (nb * K) slot of each band DoF's owning block entry, from
    the block ids and the (nb, K) ownership mask; nb * K where a DoF has no
    owner."""
    nb, K = bids.shape
    out = np.full(m, nb * K, np.int64)
    i, j = np.nonzero(own)
    out[bids[i, j]] = i * K + j
    return out


def set_schwarz_tables(vc: VCycle, A_csr, ids: np.ndarray, bids: np.ndarray, sweeps: int, device) -> VCycle:
    """Fill the Schwarz branch of ``vc``'s band solve (float64 tables on
    ``device``): ``A_csr`` is the (m, m) canonical CSR band matrix over the
    global flat ids ``ids``, ``bids`` the (nb, K) overlapping RAS blocks in
    compact ids padded with m, ``sweeps`` the inner BiCGStab iterations.
    Shared by :func:`attach_interface_solve` and the 3D lattice schemes."""
    m = ids.shape[0]
    nb, K = bids.shape
    tab = lambda a, dtype=TABLE_DTYPE: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    # RAS ownership: each band DoF is corrected from the first block that
    # holds it
    valid = bids < m
    blk = np.broadcast_to(np.arange(nb)[:, None], bids.shape)
    owner = np.full(m + 1, nb, np.int64)
    np.minimum.at(owner, bids[valid], blk[valid])
    own = valid & (owner[bids] == blk)
    ecols, evals, nnz_row = _ell(A_csr, m)
    mats = blocks_from_csr(A_csr, bids, m)
    # identity on padded slots and numerically null diagonals
    d = np.arange(K)
    dvals = mats[:, d, d]
    mats[:, d, d] = np.where((np.abs(dvals) < 1e-300) | ~valid, 1.0, dvals)
    vc.schwarz_ids = tab(bids, torch.int64)
    vc.schwarz_inv = tab(np.linalg.inv(mats))
    vc.schwarz_owner = tab(ras_owner(bids, own, m), torch.int64)
    vc.schwarz_sweeps = int(sweeps)
    # the band matrix itself, ELL rows 0..m-1; identity on empty rows
    cols, vals = ecols[:m].copy(), evals[:m].copy()
    zr = np.where(nnz_row == 0)[0]
    cols[zr, 0] = zr
    vals[zr, 0] = 1.0
    vc.band_ids = tab(ids, torch.int64)
    vc.band_ell_cols = tab(cols, torch.int64)
    vc.band_ell_vals = tab(vals)
    return vc


def entity_blocks(entity_dofs, idx_of: np.ndarray, m: int) -> np.ndarray:
    """(nb, K) compact ids of one overlapping block per entity (its
    selected DoFs, ascending and unique), padded with ``m``: ``entity_dofs``
    is a sequence of (ne, r) global id arrays, ``idx_of`` maps a global id
    to its compact one (-1: not selected).  Families in the order given and
    entities in their order; entities with no selected DoF make no block.
    The vectorized form of the JAX package's per-entity ``np.unique`` loop."""
    rows = []
    for dofs in entity_dofs:
        if dofs.shape[0] == 0:
            continue
        l = idx_of[np.asarray(dofs)]
        l = np.sort(np.where(l >= 0, l, m), axis=1)
        dup = np.zeros_like(l, bool)
        dup[:, 1:] = l[:, 1:] == l[:, :-1]
        rows.append(np.sort(np.where(dup, m, l), axis=1))
    if not rows:
        return np.zeros((0, 1), np.int64)
    K = max(r.shape[1] for r in rows)
    bl = np.concatenate([np.pad(r, ((0, 0), (0, K - r.shape[1])), constant_values=m) for r in rows])
    bl = bl[(bl < m).any(axis=1)]
    K = max(1, int((bl < m).sum(axis=1).max())) if bl.shape[0] else 1
    return bl[:, :K]


def attach_interface_solve(
    vc: VCycle,
    op,
    active,
    dense_max: int = 4000,
    sweeps: Optional[int] = None,
    kind: str = "auto",
    sweeps_coef: float = 0.2,
) -> VCycle:
    """Equip a V-cycle with a solve on the data-dependent DoF block (all
    DoFs touched by cut-cell penalty / ghost-facet / boundary batches).

    * ``m <= dense_max`` (or ``kind="dense"``): exact dense inverse on the
      whole block, O(m^2) memory;
    * beyond (or ``kind="schwarz"``): an inner BiCGStab on the ELL band
      matrix, preconditioned by restricted additive Schwarz over the cut
      entities (one overlapping dense block per data-dependent entity,
      inverted on the host).  O(m) memory.  It runs ``sweeps`` iterations,
      by default ``max(10, sweeps_coef * sqrt(m))``.

    The tables are float64 on the cycle's device."""
    sel = data_dependent_selection(op, active)
    total = sum(int(m.sum()) for m in sel.values())
    if total == 0:
        return vc
    dev = next(iter(active.values())).device
    names = list(op.system.fields)
    shapes = [tuple(op.system.fields[n].dof_shape) for n in names]
    vc._flat_meta = (names, shapes, [int(np.prod(sh)) for sh in shapes])

    def tab(a, dtype=TABLE_DTYPE):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    if kind == "dense" or (kind == "auto" and total <= dense_max):
        A_II, ids = op.restricted_dense(sel)
        # identity on rows whose diagonal vanished within the block, plus a
        # tiny Tikhonov shift (a preconditioner need not be exact)
        dz = np.abs(np.diag(A_II)) < 1e-300
        A_II[dz, dz] = 1.0
        A_II[np.diag_indices_from(A_II)] += 1e-12 * np.abs(np.diag(A_II)).max()
        vc.interface_inv = tab(np.linalg.inv(A_II))
        vc.interface_ids = tab(ids, torch.int64)
        return vc

    # ---- Schwarz block path
    from .assembly import _is_dynamic

    A_csr, ids = op.restricted_csr(sel)
    off, _, idx_of = op._selection_ids(sel)
    bids = entity_blocks([b.entity_global_dofs(off) for b in op.batches if _is_dynamic(b)], idx_of, total)
    # inner-iteration demand grows slowly with the band size: ~sqrt(m)
    n_sweeps = sweeps if sweeps is not None else max(10, int(sweeps_coef * total**0.5))
    return set_schwarz_tables(vc, A_csr, ids, bids, n_sweeps, dev)


def _flat_layout(vc: VCycle, op):
    names = list(op.system.fields)
    shapes = [tuple(op.system.fields[n].dof_shape) for n in names]
    sizes = [int(np.prod(sh)) for sh in shapes]
    if vc._flat_meta is None:
        vc._flat_meta = (names, shapes, sizes)
    return names, shapes, sizes


def _set_coarse(vc: VCycle, Z: torch.Tensor, AZ: torch.Tensor) -> VCycle:
    """Store the basis, ``A Z^T`` and the pseudo-inverse of the Galerkin
    matrix ``Z A Z^T``, computed on the host in float64 with ``rcond=1e-10``
    (an enriched basis may be near-dependent after masking, and pairs of
    modes may sum to an exact null direction)."""
    G = (Z @ AZ.T).cpu().numpy()
    vc.coarse_Z, vc.coarse_AZ = Z, AZ
    vc.coarse_Ginv = torch.as_tensor(np.linalg.pinv(G, rcond=1e-10), dtype=Z.dtype, device=Z.device)
    return vc


def attach_coarse_correction(vc: VCycle, op, active, vectors, bcs=()) -> VCycle:
    """Equip a V-cycle with a rank-k multiplicative Galerkin correction
    ``x += Z G^+ Z^T (b - A x)``, ``G = Z A Z^T``, over the mode dicts
    ``vectors`` (system field layout), each masked to the active DoFs and
    normalized.  The coarse space of substructuring methods: without it the
    near-null modes of a floating block are reduced only through their
    O(h)-thin trace next to the band, and outer iterations grow like 1/h.
    The basis and ``A Z^T`` are float64 on the operator's device."""
    from .solvers import masked_operator

    if not vectors:
        return vc
    matvec, _, _ = masked_operator(op, bcs)
    names, shapes, _ = _flat_layout(vc, op)
    Zs, AZs = [], []
    for v in vectors:
        vm = {n: torch.where(active[n], torch.broadcast_to(v[n], sh), 0.0) for n, sh in zip(names, shapes)}
        nrm = float(torch.sqrt(sum((w * w).sum() for w in vm.values())))
        vm = {n: w / max(nrm, 1e-300) for n, w in vm.items()}
        Zs.append(torch.cat([vm[n].reshape(-1) for n in names]))
        Av = matvec(vm)
        AZs.append(torch.cat([Av[n].reshape(-1) for n in names]))
    return _set_coarse(vc, torch.stack(Zs), torch.stack(AZs))


def attach_coarse_correction_device(vc: VCycle, op, active, z_builder, bcs=()) -> VCycle:
    """:func:`attach_coarse_correction` with the raw ``(k, n_flat)`` basis
    built on the operator's device by ``z_builder()`` (closed-form modes
    from the grid's coordinate lattice, e.g. the S5 interface Fourier
    modes): masking, normalization and the k matvecs for ``A Z^T`` stay on
    the device; only the (k, k) Galerkin matrix goes to the host for its
    pseudo-inverse."""
    from .solvers import masked_operator

    matvec, _, _ = masked_operator(op, bcs)
    names, shapes, sizes = _flat_layout(vc, op)
    act = torch.cat([torch.broadcast_to(active[n], sh).reshape(-1) for n, sh in zip(names, shapes)])

    def unflat(z):
        out, cur = {}, 0
        for n, sh, sz in zip(names, shapes, sizes):
            out[n] = z[cur : cur + sz].reshape(sh)
            cur += sz
        return out

    Z = torch.where(act[None, :], z_builder(), 0.0)
    Z = Z / torch.clamp(torch.sqrt(torch.sum(Z * Z, dim=1, keepdim=True)), min=1e-300)
    AZ = torch.empty_like(Z)
    for i in range(Z.shape[0]):
        Az = matvec(unflat(Z[i]))
        AZ[i] = torch.cat([Az[n].reshape(-1) for n in names])
    return _set_coarse(vc, Z, AZ)


def attach_ritz_modes(
    vc: VCycle,
    op,
    active,
    bcs=(),
    deflate=(),
    n_arnoldi: int = 30,
    n_keep: int = 8,
    tol_lam: float = 0.5,
    seed: int = 0,
) -> VCycle:
    """Append the dominant Ritz vectors of the preconditioned error
    propagator ``E = I - M A`` to the rank-k Galerkin coarse space (a
    GenEO-like spectral coarse space from one global Arnoldi iteration of
    ``n_arnoldi`` steps, each one matvec and one application of the cycle).

    ``deflate``: mode dicts spanning the operator's known null space (S5's
    collective rigid motions); E has eigenvalue ~1 on them, so the Krylov
    space is kept orthogonal to them.  Ritz vectors with ``|lambda| <
    tol_lam`` are dropped (the cycle already contracts them).  The start
    vector is ``numpy.random.default_rng(seed).standard_normal`` on the
    active DoFs, as in the JAX package, with two modified Gram-Schmidt
    passes per step, the small Hessenberg eigenproblem on the host, the
    new modes after any closed-form ones, and ``G = Z (A Z)^T`` inverted
    on the host.  The Krylov vectors are float64 on the operator's device;
    ``M`` is the cycle as the solve calls it (in its own dtype).  One host
    read per step."""
    from .solvers import masked_operator

    matvec, _, _ = masked_operator(op, bcs)
    names, shapes, sizes = _flat_layout(vc, op)
    dev = next(iter(active.values())).device
    f64 = torch.float64
    act = torch.cat([torch.broadcast_to(active[n], sh).reshape(-1) for n, sh in zip(names, shapes)])
    act_f = act.to(f64)

    def unflat(z):
        out, cur = {}, 0
        for n, sh, sz in zip(names, shapes, sizes):
            out[n] = z[cur : cur + sz].reshape(sh)
            cur += sz
        return out

    def flat(d):
        return torch.cat([d[n].reshape(-1).to(f64) for n in names])

    def A_(z):
        return flat(matvec(unflat(z)))

    # orthonormal null basis (masked) for the projection
    Q = []
    for v in deflate:
        q = flat({n: torch.broadcast_to(v[n], sh) for n, sh in zip(names, shapes)}) * act_f
        for o in Q:
            q = q - (o @ q) * o
        nq = float(torch.linalg.vector_norm(q))
        if nq > 1e-12:
            Q.append(q / nq)

    def proj(v):
        for o in Q:
            v = v - (o @ v) * o
        return v

    n_flat = int(act.shape[0])
    start = np.random.default_rng(seed).standard_normal(n_flat)
    v = proj(torch.as_tensor(start, dtype=f64, device=dev) * act_f)
    V = [v / torch.linalg.vector_norm(v)]
    H = torch.zeros((n_arnoldi + 1, n_arnoldi), dtype=f64, device=dev)
    for j in range(n_arnoldi):
        w = V[j] - flat(vc(unflat(A_(V[j]))))  # E v = v - M A v
        w = proj(w * act_f)
        for _pass in range(2):  # MGS, two passes for orthogonality
            for i in range(j + 1):
                c = V[i] @ w
                H[i, j] += c
                w = w - c * V[i]
        H[j + 1, j] = torch.linalg.vector_norm(w)
        h = float(H[j + 1, j])
        if h < 1e-12:
            break
        V.append(w / h)
    m = len(V) - 1
    lam, Y = np.linalg.eig(H[:m, :m].cpu().numpy())
    order = np.argsort(-np.abs(lam))
    keep = [i for i in order[:n_keep] if np.abs(lam[i]) >= tol_lam]
    if not keep:
        return vc
    Vm = torch.stack(V[:m], dim=1)  # (n_flat, m)
    Zs, AZs = [], []
    for i in keep:
        z = Vm @ torch.as_tensor(np.real(Y[:, i]).copy(), dtype=f64, device=dev)
        nz = float(torch.linalg.vector_norm(z))
        if nz < 1e-12:
            continue
        z = z / nz
        Zs.append(z)
        AZs.append(A_(z))
    if not Zs:
        return vc
    Z, AZ = torch.stack(Zs), torch.stack(AZs)
    if vc.coarse_Z is not None:
        Z = torch.cat([vc.coarse_Z.to(f64), Z])
        AZ = torch.cat([vc.coarse_AZ.to(f64), AZ])
    # the Galerkin test space Z A Z^T: near-null slow modes have a tiny
    # ||A z||, which a residual-minimizing one (AZ AZ^T) would weight least
    vc.ritz_lambdas = np.abs(lam[keep])
    return _set_coarse(vc, Z, AZ)


def build_hierarchy(
    fine_grid: Grid,
    make_level: Callable[[Grid], Tuple],
    min_n: int = 8,
    dense_coarse: bool = True,
    max_coarse_dofs: int = 6000,
    dtype: Optional[torch.dtype] = None,
    **vcycle_kw,
) -> VCycle:
    """Build a V-cycle from a level factory ``make_level(grid) -> (op,
    bcs)`` that re-discretizes the problem on each coarser grid.
    Coarsening stops when nx or ny would drop below ``min_n`` or become
    odd.  The coarsest level gets an exact dense (pseudo-inverse) solve
    when small enough.  ``dtype`` sets the cycle's compute dtype."""
    grids = [fine_grid]
    g = fine_grid
    while g.nx % 2 == 0 and g.ny % 2 == 0 and g.nx // 2 >= min_n and g.ny // 2 >= min_n:
        g = dataclasses.replace(g, nx=g.nx // 2, ny=g.ny // 2)
        grids.append(g)

    levels = []
    vertex_fields: Optional[Tuple[str, ...]] = None
    for i, g in enumerate(grids):
        op, bcs = make_level(g)
        matvec, inv_diag, active = _masked_matvec(op, bcs, dtype)
        if vertex_fields is None:
            vertex_fields = tuple(n for n, v in active.items() if v.shape[0] == g.num_vertices)
        lvl = Level(
            g, matvec, inv_diag, active,
            field_shapes={k: tuple(v.shape) for k, v in active.items()},
        )
        if i == len(grids) - 1 and dense_coarse and op.system.num_dofs <= max_coarse_dofs:
            ci = _coarse_pinv(op, active)
            lvl.coarse_inv = ci if dtype is None else ci.to(dtype)
        levels.append(lvl)
    return VCycle(levels, vertex_fields, dtype=dtype, **vcycle_kw)
