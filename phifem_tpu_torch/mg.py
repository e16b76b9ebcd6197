"""Geometric multigrid on the structured background grid.

Counterpart of :mod:`phifem_tpu.mg` (the bulk V-cycles and the interface
band solve; coarse-space corrections come with slice D).

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
  (:func:`attach_interface_solve`).

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
    "Level",
    "build_hierarchy",
    "attach_interface_solve",
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
        if self.interface_inv is None and self.schwarz_inv is None:
            return x
        r = {k: b[k] - v for k, v in self.levels[0].matvec(x).items()}
        return self._band_correct_flat(self._flatten(x), self._flatten(r))

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
            rb = rf[self.band_ids].to(TABLE_DTYPE)
            zero = rb.new_zeros(1)

            def band_mv(v):
                vpad = torch.cat([v, zero])
                return (self.band_ell_vals * vpad[self.band_ell_cols]).sum(dim=1)

            def band_ras(v):
                vpad = torch.cat([v, zero])
                blocks = vpad[self.schwarz_ids]  # (nb, K)
                cb = torch.einsum("bkl,bl->bk", self.schwarz_inv, blocks)
                return torch.cat([cb.reshape(-1), zero])[self.schwarz_owner]

            e = _band_bicgstab(band_mv, band_ras, rb, self.schwarz_sweeps)
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
    cells only) get damped Jacobi."""

    mgs: Optional[Dict[str, object]] = None  # field -> ops.lattice.LatticeMG
    lattice_shapes: Optional[Dict[str, Tuple[int, int]]] = None
    bulk_masks: Optional[Dict[str, torch.Tensor]] = None

    def _cycle(self, k: int, b: Vec) -> Vec:
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
            rp = torch.zeros((R + 2, C + 2), dtype=v.dtype, device=v.device)
            rp[1 : 1 + R, 1 : 1 + C] = torch.where(bulk, v, 0.0).reshape(R, C)
            z = mg2(rp)[1 : 1 + R, 1 : 1 + C].reshape(v.shape)
            out[f] = torch.where(bulk, z, torch.where(a, jac, 0.0))
        return out


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


def _blocks_from_ell(
    ecols: np.ndarray, evals: np.ndarray, bids: np.ndarray, pad: int, chunk: int = 256
) -> np.ndarray:
    """Batched dense submatrices ``A[bl][:, bl]`` for the RAS blocks,
    gathered from the (m+1, nnzmax) ELL layout (row ``pad`` is the zero
    padding row); vectorized over blocks in chunks."""
    nb, K = bids.shape
    out = np.zeros((nb, K, K))
    for s in range(0, nb, chunk):
        b = bids[s : s + chunk]  # (B, K)
        rc = ecols[b]  # (B, K, nnzmax)
        rv = evals[b]
        for j in range(K):
            out[s : s + chunk, :, j] = (rv * (rc == b[:, None, j, None])).sum(axis=-1)
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


def _entity_blocks(op, off, idx_of: np.ndarray, total: int) -> np.ndarray:
    """(nb, K) compact band ids of one overlapping block per data-dependent
    entity (its selected DoFs, ascending, unique), padded with ``total``;
    entities with no selected DoF make no block."""
    from .assembly import _is_dynamic

    rows = []
    for b in op.batches:
        if not _is_dynamic(b):
            continue
        l = idx_of[b.entity_global_dofs(off)]
        l = np.sort(np.where(l >= 0, l, total), axis=1)
        dup = np.zeros_like(l, bool)
        dup[:, 1:] = l[:, 1:] == l[:, :-1]
        rows.append(np.sort(np.where(dup, total, l), axis=1))
    K = max(r.shape[1] for r in rows)
    bl = np.concatenate([np.pad(r, ((0, 0), (0, K - r.shape[1])), constant_values=total) for r in rows])
    bl = bl[(bl < total).any(axis=1)]
    K = int((bl < total).sum(axis=1).max())
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
    A_csr, ids = op.restricted_csr(sel)
    off, _, idx_of = op._selection_ids(sel)
    bids = _entity_blocks(op, off, idx_of, total)
    nb, K = bids.shape
    # RAS ownership: each band DoF is corrected from the first block that
    # holds it
    valid = bids < total
    blk = np.broadcast_to(np.arange(nb)[:, None], bids.shape)
    owner = np.full(total + 1, nb, np.int64)
    np.minimum.at(owner, bids[valid], blk[valid])
    own = valid & (owner[bids] == blk)
    ecols, evals, nnz_row = _ell(A_csr, total)
    mats = _blocks_from_ell(ecols, evals, bids, total)
    # identity on padded slots and numerically null diagonals
    d = np.arange(K)
    dvals = mats[:, d, d]
    mats[:, d, d] = np.where((np.abs(dvals) < 1e-300) | ~valid, 1.0, dvals)
    vc.schwarz_ids = tab(bids, torch.int64)
    vc.schwarz_inv = tab(np.linalg.inv(mats))
    vc.schwarz_owner = tab(ras_owner(bids, own, total), torch.int64)
    # inner-iteration demand grows slowly with the band size: ~sqrt(m)
    vc.schwarz_sweeps = sweeps if sweeps is not None else max(10, int(sweeps_coef * total**0.5))
    # the band matrix itself, ELL rows 0..m-1; identity on empty rows
    cols, vals = ecols[:total].copy(), evals[:total].copy()
    zr = np.where(nnz_row == 0)[0]
    cols[zr, 0] = zr
    vals[zr, 0] = 1.0
    vc.band_ids = tab(ids, torch.int64)
    vc.band_ell_cols = tab(cols, torch.int64)
    vc.band_ell_vals = tab(vals)
    return vc


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
