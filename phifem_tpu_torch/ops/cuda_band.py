"""The interface band solve: CUDA kernel wrappers, their plain versions and
the fixed-sweep inner solves built from them.

Replaces the XLA-fused loops of the JAX package's band solve
(``phifem_tpu/mg.py``: ``_band_bicgstab``, and ``band_mv`` / ``band_ras`` in
``VCycle._band_correct_flat``), which the port's
``VCycle._band_correct_flat`` and ``lattice_core.make_interface_apply`` call
through :func:`band_bicgstab` and :func:`band_richardson`.  The kernels
(``phifem_tpu_torch/csrc/band_solve.cu``) are built with ``nvcc`` at first use
(:mod:`phifem_tpu_torch.ops.nvcc_build`) and loaded with ``ctypes``:

* :func:`band_ras`: the restricted additive Schwarz block apply as an ELL
  product of width K over the band DoFs: each DoF takes the one row of its
  owning block's inverse, stored with that row's K column ids slot-major
  (``BandTables.ras_cols`` / ``ras_vals``, built by :func:`ras_table`), so
  ``y[i] = sum_l vals[l, i] x[cols[l, i]]`` (ascending l, from -0; the pad
  id m reads 0, an unowned DoF gives +0), optionally scaled and added to a
  vector;
* :func:`band_ras_p` / :func:`band_ras_s`: the same launch with a BiCGStab
  step folded in: it gathers the new p (or s) computed from r, the old p
  (or nothing) and v at each column it reads, writes its own row of it (p
  into the other of two buffers) and the RAS result; P also takes the
  previous sweep's best-iterate select, S writes alpha;
* :func:`band_ell`: the band's ELL product ``A x`` (or ``b - A x``), one
  thread a row on the band matrix stored as a sliced ELL table (rows
  sorted by length within windows of ``WINDOW`` rows, then slices of
  ``SLICE`` rows, each padded only to its own longest row, slot-major
  inside the slice; :func:`band_tables` builds it);
* :func:`band_dots`: up to three dot products in one launch, summed by a
  fixed tree (:func:`band_dots_ref` defines it), the results left on the
  device;
* :func:`band_update`: the BiCGStab steps no RAS launch takes (XR: x and r;
  SEL: the last best-iterate select), two values a thread, the
  coefficients computed once a CTA from the dot results in the solve's
  scalar slots.

An inner sweep of :func:`band_bicgstab` is 8 launches: RAS+P, ELL, dots,
RAS+S, ELL, dots, XR, dots.  On the card the loop checks and packs what is
fixed per band (table pointers and shapes, kept on the :class:`BandTables`)
and per solve (its vectors, the stream, the library functions) once, and
launches without further checks; :func:`band_bicgstab_ref` is the plain
unfused loop (P update, RAS, ..., 10 steps a sweep), which the fused one
equals bit for bit.

Everything is float64 (:data:`phifem_tpu_torch.mg.TABLE_DTYPE`).  Each
wrapper dispatches on the tensor's device: a CPU tensor goes to the plain
version, a CUDA tensor to the kernel, anything else raises; there is no
fallback from the card to the plain version.  Every product, quotient and
sum is rounded on its own in the order the plain versions take, so each
kernel, and the whole inner solve, equals its plain version bit for bit.
``launches`` counts every kernel launch made here; ``ras_launches`` (every
RAS launch, fused or not), ``ell_launches``, ``dot_launches`` and
``update_launches`` count them by kernel, ``tables_built`` the band table
sets built.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import nvcc_build

__all__ = [
    "BandTables",
    "band_tables",
    "band_ras",
    "band_ras_ref",
    "band_ras_p",
    "band_ras_p_ref",
    "band_ras_s",
    "band_ras_s_ref",
    "band_ell",
    "band_ell_ref",
    "band_dots",
    "band_dots_ref",
    "band_update",
    "band_update_ref",
    "band_bicgstab",
    "band_bicgstab_ref",
    "band_richardson",
    "band_richardson_ref",
    "dot_stages",
    "dot_work",
    "dot_scratch",
    "ras_table",
    "build",
]

#: number of kernel launches made here (all four kernels), and by kernel
launches = 0
ras_launches = 0
ell_launches = 0
dot_launches = 0
update_launches = 0
#: number of band table sets built (:func:`band_tables`)
tables_built = 0

SOURCE = nvcc_build.PKG / "csrc" / "band_solve.cu"
#: the kernels' CTA size, the values one CTA of the dot kernel sums and
#: the rows of an ELL slice
THREADS = 256
CHUNK = 1024
SLICE = 32
#: rows sorted by length (longest first) within each window of this many
#: before slicing, so that a slice's rows are alike and its padding small
WINDOW = 256
F64 = torch.float64

#: RAS modes: y = acc, y = om acc, y = c + om acc, and the two folded
#: BiCGStab steps (:func:`band_ras_p`, :func:`band_ras_s`)
RAS_APPLY, RAS_SCALE, RAS_ADD, RAS_P, RAS_S = 0, 1, 2, 3, 4
#: BiCGStab steps (see ``csrc/band_solve.cu``): P and S run inside the RAS
#: launches on the card (their plain versions in :func:`band_update_ref`),
#: XR and SEL in the update kernel
P, S, XR, SEL = 0, 1, 2, 3
#: the solve's scalar slots: the dot results r.r, rhat.r (the next rho),
#: rhat.v, t.s, t.t; rho, alpha, omega; the best residual, in two slots
#: that alternate by sweep
RR, RHO_NEW, RV, TS, TT, RHO, ALPHA, OMEGA, RRB0, RRB1 = range(10)
SLOTS = 10
TINY = 1e-300


@dataclasses.dataclass(frozen=True)
class BandTables:
    """The Schwarz branch's tables as the kernels read them: ``inv`` (nb, K,
    K) block inverses, ``ids`` (nb, K) int32 compact ids padded with m,
    ``owner`` (m,) int32 owner slots (nb K: none), and from them the RAS
    apply's table, slot-major: ``ras_cols`` (K, m) int32 and ``ras_vals``
    (K, m) float64, column i the ids and the inverse's row of the one block
    entry that corrects DoF i (:func:`ras_table`); the band matrix as a
    sliced ELL table: stored row p is row ``row_perm[p]`` (int32), its slot
    k at ``sell_off[p // SLICE] + SLICE k + p % SLICE`` of ``sell_cols``
    (int32) and ``sell_vals``, ``row_len`` (m,) int32 the slots of each
    stored row (its host row with the trailing pads dropped), ``sell_off``
    (ceil(m / SLICE) + 1,) int64, each slice as wide as its longest row;
    ``width`` the host table's padded width.  The RAS and ELL tables are on
    the band's device (:meth:`tensors`); ``inv``, ``ids`` and ``owner``,
    which no kernel reads, stay on the host, for tables carried back and
    for the PyTorch call that measures the RAS apply (``einsum`` over every
    block)."""

    inv: torch.Tensor
    ids: torch.Tensor
    owner: torch.Tensor
    ras_cols: torch.Tensor
    ras_vals: torch.Tensor
    sell_cols: torch.Tensor
    sell_vals: torch.Tensor
    sell_off: torch.Tensor
    row_len: torch.Tensor
    row_perm: torch.Tensor
    width: int

    @property
    def m(self) -> int:
        return self.owner.shape[0]

    @property
    def nb(self) -> int:
        return self.ids.shape[0]

    @property
    def K(self) -> int:
        return self.ids.shape[1]

    def tensors(self) -> tuple:
        """The tables the kernels read, all on the band's device."""
        return (self.ras_cols, self.ras_vals, self.sell_cols, self.sell_vals, self.sell_off, self.row_len,
                self.row_perm)

    @functools.cached_property
    def packed(self) -> tuple:
        """(device, RAS table pointers, ELL table pointers), checked once
        per band: every table the kernels read on one device."""
        dev = self.ras_cols.device
        if any(t.device != dev for t in self.tensors()):
            raise ValueError("cuda_band: the band tables are not on one device")
        return (dev, (self.ras_cols.data_ptr(), self.ras_vals.data_ptr()),
                tuple(t.data_ptr() for t in (self.sell_cols, self.sell_vals, self.sell_off, self.row_len,
                                             self.row_perm)))

    @functools.cached_property
    def plain_ell(self) -> tuple:
        """The sliced table's nonzeros regrouped for :func:`band_ell_ref`,
        once per band: the stored rows ordered by length, longest first
        (stable), then slot-major, slot k holding the rows longer than k.
        (int32 columns, values, [(start, count)] by slot, the row each
        position of that order is, whether it is shorter than the host
        table.)"""
        n = self.row_len.long()
        order = torch.argsort(-n, stable=True)
        ns = n[order]
        width = int(ns[0]) if ns.numel() else 0
        counts = torch.searchsorted(-ns, -torch.arange(width, device=n.device), side="left")
        starts = torch.cumsum(counts, 0) - counts
        k = torch.repeat_interleave(torch.arange(width, device=n.device), counts)
        p = order[torch.arange(k.numel(), device=n.device) - starts[k]]
        pos = self.sell_off[p // SLICE] + SLICE * k + p % SLICE
        return (self.sell_cols[pos], self.sell_vals[pos], list(zip(starts.tolist(), counts.tolist())),
                self.row_perm.long()[order], ns < self.width)

    def ell_rows(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The band matrix row-major on the host, as :func:`band_tables`
        was given it: (m, width) int64 columns (pad column m) and float64
        values (pad 0)."""
        m, w = self.m, self.width
        n, off, perm = self.row_len.cpu().long(), self.sell_off.cpu(), self.row_perm.cpu().long()
        p, k = (torch.arange(w)[None, :] < n[:, None]).nonzero(as_tuple=True)
        pos = off[p // SLICE] + SLICE * k + p % SLICE
        cols = torch.full((m, w), m, dtype=torch.int64)
        vals = torch.zeros((m, w), dtype=F64)
        cols[perm[p], k] = self.sell_cols.cpu()[pos].long()
        vals[perm[p], k] = self.sell_vals.cpu()[pos]
        return cols, vals


def ras_table(ids: np.ndarray, inv: np.ndarray, owner: np.ndarray, m: int) -> Tuple[np.ndarray, np.ndarray]:
    """The RAS apply's slot-major table: (K, m) columns and (K, m) values,
    column i holding ``ids[b]`` and ``inv[b, k]`` for DoF i's owner slot s
    = b K + k (a pad id m stays in place); a DoF with no owner (s outside
    [0, nb K)) K slots of column m and value 0."""
    nb, K = ids.shape
    own = (owner >= 0) & (owner < nb * K)
    s = owner[own]
    cols = np.full((K, m), m, np.int64)
    vals = np.zeros((K, m))
    cols[:, own] = ids[s // K].T
    vals[:, own] = inv[s // K, s % K].T
    return cols, vals


def sliced_ell(cols: np.ndarray, vals: np.ndarray, m: int, window: int):
    """The sliced ELL table of a row-major (m, w) ELL table: (stored
    columns, values, slice offsets, stored row lengths, the row each stored
    row is).  A row's trailing slots of column m and value +0 are dropped;
    every other slot, a pad inside a row included, is kept in place.  The
    rows are sorted by length, longest first, within each ``window`` rows
    (stable; 1: not at all)."""
    w = cols.shape[1]
    real = ~((cols == m) & (vals == 0.0) & ~np.signbit(vals))
    n = np.where(real.any(axis=1), w - np.argmax(real[:, ::-1], axis=1), 0)
    perm = np.lexsort((-n, np.arange(m) // max(1, window)))
    ns = -(-m // SLICE)
    lens = np.zeros(ns * SLICE, np.int64)  # stored rows' lengths, the last slice's spare rows 0
    lens[:m] = n[perm]
    off = np.zeros(ns + 1, np.int64)
    np.cumsum(SLICE * lens.reshape(ns, SLICE).max(axis=1), out=off[1:])
    p, k = np.nonzero(np.arange(w)[None, :] < lens[:m, None])
    pos = off[p // SLICE] + SLICE * k + p % SLICE
    scols = np.full(int(off[-1]), m, np.int64)
    svals = np.zeros(int(off[-1]))
    scols[pos] = cols[perm[p], k]
    svals[pos] = vals[perm[p], k]
    return scols, svals, off, lens[:m], perm


def band_tables(ids, inv, owner, ell_cols, ell_vals, device) -> BandTables:
    """:class:`BandTables` on ``device`` from host arrays (numpy, or CPU
    tensors): ``ids`` (nb, K) compact block ids padded with m, ``inv`` (nb,
    K, K) block inverses, ``owner`` (m,) owner slots, from which the RAS
    table is built (:func:`ras_table`; the three stay on the host), the
    band matrix row-major as ``ell_cols`` / ``ell_vals`` (m, w), pads
    trailing each row (column m, value 0), stored as its sliced ELL table,
    rows sorted by length within each ``WINDOW`` rows (:func:`sliced_ell`).
    Adds one to ``tables_built``."""
    global tables_built
    ids, inv, owner, ell_cols, ell_vals = (np.asarray(a) for a in (ids, inv, owner, ell_cols, ell_vals))
    m, w = ell_cols.shape
    nb, K = ids.shape
    if inv.shape != (nb, K, K) or owner.shape != (m,) or ell_vals.shape != (m, w):
        raise ValueError("band_tables: inconsistent Schwarz table shapes")
    if m < 1 or m >= 2**31 or nb * K * K >= 2**31 or K * m >= 2**31 or w >= 2**26:
        raise ValueError("band_tables: tables too large for 32-bit indexing")
    rcols, rvals = ras_table(ids, inv, owner, m)
    scols, svals, off, n, perm = sliced_ell(ell_cols, ell_vals, m, WINDOW)
    dev = torch.device(device)
    t = lambda a, dtype, d=dev: torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=d)  # a copy, never a view
    tables_built += 1
    host = torch.device("cpu")
    return BandTables(inv=t(inv, F64, host), ids=t(ids, torch.int32, host), owner=t(owner, torch.int32, host),
                      ras_cols=t(rcols, torch.int32), ras_vals=t(rvals, F64), sell_cols=t(scols, torch.int32),
                      sell_vals=t(svals, F64), sell_off=t(off, torch.int64), row_len=t(n, torch.int32),
                      row_perm=t(perm, torch.int32), width=int(w))


# ------------------------------------------------------------ plain versions
def band_ras_ref(tab: BandTables, x: torch.Tensor, out: Optional[torch.Tensor] = None, *, mode: int = RAS_APPLY,
                 om: float = 1.0, c: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain RAS apply on the slot-major table: from ``acc = -0``, ``acc =
    acc + v x`` over each DoF's K slots in ascending order (a pad id reads
    0; an unowned DoF's slots are 0 x 0, so it ends at +0), then ``om acc``
    or ``c + om acc`` by ``mode``."""
    xp = torch.cat([x, x.new_zeros(1)])
    prod = torch.index_select(xp, 0, tab.ras_cols.view(-1)).view(tab.K, tab.m).mul_(tab.ras_vals)
    y = x.new_zeros(tab.m).neg_()
    for row in prod:
        y = y + row
    if mode == RAS_SCALE:
        y = om * y
    elif mode == RAS_ADD:
        y = c + om * y
    if out is None:
        return y
    return out.copy_(y)


def band_ras_p_ref(tab: BandTables, sweep: int, sc: torch.Tensor, r: torch.Tensor, p: torch.Tensor,
                   v: torch.Tensor, x: torch.Tensor, xb: torch.Tensor, pout: torch.Tensor, ph: torch.Tensor) -> None:
    """Plain RAS+P: the plain P update of ``sweep`` (the previous sweep's
    select, then ``pout = r + beta (p - omega v)``, or ``pout = r`` at sweep
    0), then ``ph = RAS(pout)``."""
    pout.copy_(p)
    band_update_ref(P, sweep, sc, r=r, p=pout, v=v, x=x, xb=xb)
    band_ras_ref(tab, pout, ph)


def band_ras_s_ref(tab: BandTables, sc: torch.Tensor, r: torch.Tensor, v: torch.Tensor, s: torch.Tensor,
                   sh: torch.Tensor) -> None:
    """Plain RAS+S: the plain S update (``alpha = rho_new / (rhat.v)``, ``s
    = r - alpha v``), then ``sh = RAS(s)``."""
    band_update_ref(S, 0, sc, r=r, v=v, s=s)
    band_ras_ref(tab, s, sh)


def band_ell_ref(tab: BandTables, x: torch.Tensor, out: Optional[torch.Tensor] = None, *,
                 b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain band product ``A x`` (or ``b - A x``) on the sliced table: from
    ``acc = -0``, ``acc = acc + v x`` over each row's slots in ascending
    order, then ``acc + 0`` for a row shorter than the host table's width
    (the trailing pads' ``0 x 0``): the padded row's ascending sum bit for
    bit.  The rows are summed side by side in :attr:`BandTables.plain_ell`'s
    order, longest first, so that slot k adds to a prefix of them: the rows
    longer than k (a slice's stored pads, 0 x 0 = +0, only ever turn a -0
    into the +0 that the row's final ``acc + 0`` gives it anyway)."""
    cols, vals, spans, rows, short = tab.plain_ell
    prod = torch.index_select(torch.cat([x, x.new_zeros(1)]), 0, cols).mul_(vals)
    acc = x.new_zeros(tab.m).neg_()
    for start, count in spans:
        acc[:count] += prod[start : start + count]
    acc = torch.where(short, acc + 0.0, acc)
    y = torch.empty_like(acc).index_copy_(0, rows, acc)
    if b is not None:
        y = b - y
    return y if out is None else out.copy_(y)


def _tree(v: torch.Tensor) -> torch.Tensor:
    """(q, L) -> (q, L / CHUNK): each chunk of CHUNK values summed by halving
    (``v[:h] + v[h:2h]`` for h = CHUNK / 2, ..., 1)."""
    v = v.reshape(v.shape[0], -1, CHUNK)
    h = CHUNK // 2
    while h >= 1:
        v = v[..., :h] + v[..., h : 2 * h]
        h //= 2
    return v[..., 0]


def band_dots_ref(pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]], out: Optional[torch.Tensor] = None,
                  work: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain ordered dots ``a . b`` of up to three pairs: the products cut
    into chunks of CHUNK values (the last padded with zeros), each chunk
    summed by the halving tree, and the chunk sums again the same way until
    one value is left.  ``work`` is the kernel's scratch, unused here."""
    v = torch.stack([a * b for a, b in pairs])
    while True:
        n = v.shape[1]
        nc = -(-n // CHUNK)
        if nc * CHUNK != n:
            v = torch.cat([v, v.new_zeros((v.shape[0], nc * CHUNK - n))], dim=1)
        v = _tree(v)
        if nc == 1:
            break
    y = v[:, 0]
    return y if out is None else out.copy_(y)


def _safe(d: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.abs(d) > TINY, d, torch.full_like(d, TINY))


def _select_ref(sc: torch.Tensor, j: int, x: torch.Tensor, xb: torch.Tensor) -> None:
    rr, rrb = sc[RR], sc[RRB0 + (j & 1)]
    better = torch.isfinite(rr) & (rr < rrb)
    sc[RRB0 + ((j + 1) & 1)] = torch.where(better, rr, rrb)
    xb.copy_(torch.where(better, x, xb))


def band_update_ref(mode: int, sweep: int, sc: torch.Tensor, r=None, p=None, v=None, s=None, t=None, x=None,
                    ph=None, sh=None, xb=None, rout=None) -> None:
    """Plain BiCGStab update of ``mode`` at ``sweep`` (see the head of
    ``csrc/band_solve.cu``), in place on the vectors named and the scalar
    slots ``sc``."""
    if mode == P:
        if sweep == 0:
            sc[RRB0] = sc[RR]
            p.copy_(r)
            return
        _select_ref(sc, sweep - 1, x, xb)
        omega = sc[OMEGA]
        beta = (sc[RHO_NEW] / _safe(sc[RHO])) * (sc[ALPHA] / _safe(omega))
        p.copy_(r + beta * (p - omega * v))
    elif mode == S:
        alpha = sc[RHO_NEW] / _safe(sc[RV])
        sc[ALPHA] = alpha
        s.copy_(r - alpha * v)
    elif mode == XR:
        alpha = sc[ALPHA]
        omega = sc[TS] / _safe(sc[TT])
        sc[OMEGA] = omega
        sc[RHO] = sc[RHO_NEW]
        x.copy_((x + alpha * ph) + omega * sh)
        rout.copy_(s - omega * t)
    elif mode == SEL:
        _select_ref(sc, sweep, x, xb)
    else:
        raise ValueError(f"band_update: unknown mode {mode}")


# ------------------------------------------------------------ wrappers
def _device(x: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel for device {x.device}")


def _vec(t: torch.Tensor, n: int, dev: torch.device, name: str) -> int:
    if t.dtype is not F64 or t.shape != (n,) or t.device != dev or not t.is_contiguous():
        raise ValueError(f"{name}: every vector must be a contiguous float64 ({n},) tensor on {dev}")
    return t.data_ptr()


def _on(tab: BandTables, dev: torch.device, name: str) -> tuple:
    """The band's packed table pointers (:attr:`BandTables.packed`), which
    must be on ``dev``."""
    packed = tab.packed
    if packed[0] != dev:
        raise ValueError(f"{name}: the band tables are not on {dev}")
    return packed


def _call(dev: torch.device, fn, *args) -> None:
    idx = dev.index
    _, raw_stream, current = _LAUNCH.get("bound") or _bind()
    if idx == current():
        err = fn(*args, raw_stream(idx))
    else:
        with torch.cuda.device(dev):
            err = fn(*args, raw_stream(idx))
    if err:
        _raise(fn, err)


def _raise(fn, err: int) -> None:
    msg = _library().phifem_band_error_string(err).decode()
    raise RuntimeError(f"{fn.__name__} kernel launch failed: CUDA error {err} ({msg})")


def _count_ras() -> None:
    global launches, ras_launches
    launches += 1
    ras_launches += 1


def band_ras(tab: BandTables, x: torch.Tensor, out: Optional[torch.Tensor] = None, *, mode: int = RAS_APPLY,
             om: float = 1.0, c: Optional[torch.Tensor] = None) -> torch.Tensor:
    """RAS apply (see :func:`band_ras_ref`) into ``out`` (a new vector when
    None; ``out`` may be ``c``, not ``x``)."""
    if mode not in (RAS_APPLY, RAS_SCALE, RAS_ADD) or (mode == RAS_ADD and c is None):
        raise ValueError(f"band_ras: bad mode {mode} (RAS_ADD needs c)")
    if not _device(x, "band_ras"):
        return band_ras_ref(tab, x, out, mode=mode, om=om, c=c)
    dev, m = x.device, tab.m
    _, ras, _ = _on(tab, dev, "band_ras")
    y = torch.empty(m, dtype=F64, device=dev) if out is None else out
    if y is x:
        raise ValueError("band_ras: out must not be x")
    _call(dev, _library().phifem_band_ras, *ras, _vec(x, m, dev, "band_ras"), None, None,
          None if c is None else _vec(c, m, dev, "band_ras"), _vec(y, m, dev, "band_ras"), None, None, None, None,
          m, tab.K, 0, float(om), mode)
    _count_ras()
    return y


def _distinct(name: str, outs: Sequence[torch.Tensor], ins: Sequence[torch.Tensor]) -> None:
    if len({id(t) for t in (*outs, *ins)}) != len(outs) + len(ins):
        raise ValueError(f"{name}: every output must be another vector than the inputs and the other outputs")


def band_ras_p(tab: BandTables, sweep: int, sc: torch.Tensor, r: torch.Tensor, p: torch.Tensor, v: torch.Tensor,
               x: torch.Tensor, xb: torch.Tensor, pout: torch.Tensor, ph: torch.Tensor) -> None:
    """RAS+P in one launch (see :func:`band_ras_p_ref`): the select of
    sweep - 1 into ``xb`` and the scalar slots ``sc``, the new p into
    ``pout`` (another buffer than ``p``), ``ph = RAS(pout)``."""
    if sweep < 0:
        raise ValueError(f"band_ras_p: sweep {sweep}")
    _distinct("band_ras_p", (pout, ph, xb), (r, p, v, x))
    if not _device(sc, "band_ras_p"):
        return band_ras_p_ref(tab, sweep, sc, r, p, v, x, xb, pout, ph)
    dev, m = sc.device, tab.m
    _, ras, _ = _on(tab, dev, "band_ras_p")
    _vec(sc, SLOTS, dev, "band_ras_p")
    r_, p_, v_, x_, xb_, po_, ph_ = (_vec(t, m, dev, "band_ras_p") for t in (r, p, v, x, xb, pout, ph))
    _call(dev, _library().phifem_band_ras, *ras, r_, p_, v_, None, ph_, po_, sc.data_ptr(), x_, xb_, m, tab.K,
          sweep, 1.0, RAS_P)
    _count_ras()


def band_ras_s(tab: BandTables, sc: torch.Tensor, r: torch.Tensor, v: torch.Tensor, s: torch.Tensor,
               sh: torch.Tensor) -> None:
    """RAS+S in one launch (see :func:`band_ras_s_ref`): ``s``, ``sh =
    RAS(s)`` and alpha into the scalar slots ``sc``."""
    _distinct("band_ras_s", (s, sh), (r, v))
    if not _device(sc, "band_ras_s"):
        return band_ras_s_ref(tab, sc, r, v, s, sh)
    dev, m = sc.device, tab.m
    _, ras, _ = _on(tab, dev, "band_ras_s")
    _vec(sc, SLOTS, dev, "band_ras_s")
    r_, v_, s_, sh_ = (_vec(t, m, dev, "band_ras_s") for t in (r, v, s, sh))
    _call(dev, _library().phifem_band_ras, *ras, r_, None, v_, None, sh_, s_, sc.data_ptr(), None, None, m, tab.K,
          0, 1.0, RAS_S)
    _count_ras()


def band_ell(tab: BandTables, x: torch.Tensor, out: Optional[torch.Tensor] = None, *,
             b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The band product ``A x``, or ``b - A x``, into ``out`` (a new vector
    when None; not ``x`` or ``b``): see :func:`band_ell_ref`."""
    global launches, ell_launches
    if not _device(x, "band_ell"):
        return band_ell_ref(tab, x, out, b=b)
    dev, m = x.device, tab.m
    _, _, ell = _on(tab, dev, "band_ell")
    y = torch.empty(m, dtype=F64, device=dev) if out is None else out
    if y is x or y is b:
        raise ValueError("band_ell: out must be another vector than x and b")
    _call(dev, _library().phifem_band_ell, *ell, _vec(x, m, dev, "band_ell"),
          None if b is None else _vec(b, m, dev, "band_ell"), _vec(y, m, dev, "band_ell"), m, tab.width,
          0 if b is None else 1)
    launches += 1
    ell_launches += 1
    return y


def dot_stages(n: int) -> int:
    """Launches of one :func:`band_dots` call over ``n`` values: one, the
    chunk sums summed by the CTA that finishes last."""
    return 1


def dot_work(n: int, np_: int) -> int:
    """Values of scratch one :func:`band_dots` call of ``np_`` pairs over
    ``n`` values needs: the arrival counter and the chunk sums (none up to
    CHUNK values)."""
    nc = -(-n // CHUNK)
    return 0 if nc == 1 else 1 + np_ * (nc + -(-nc // CHUNK))


def dot_scratch(n: int, np_: int, device) -> torch.Tensor:
    """Zeroed scratch for :func:`band_dots` calls of up to ``np_`` pairs
    over ``n`` values: its first word is the kernel's arrival counter,
    which must start at 0 (every launch leaves it at 0)."""
    return torch.zeros(max(1, dot_work(n, np_)), dtype=F64, device=device)


def band_dots(pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]], out: Optional[torch.Tensor] = None,
              work: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Up to three ordered dots (see :func:`band_dots_ref`) into ``out`` (a
    contiguous float64 vector of ``len(pairs)`` values on the device, e.g. a
    slice of the solve's scalar slots; new when None), in one launch.
    ``work``: scratch from :func:`dot_scratch` of at least :func:`dot_work`
    values (made when None)."""
    global launches, dot_launches
    q = len(pairs)
    if not 1 <= q <= 3:
        raise ValueError(f"band_dots: 1 to 3 pairs, got {q}")
    a0 = pairs[0][0]
    if not _device(a0, "band_dots"):
        return band_dots_ref(pairs, out)
    dev, n = a0.device, a0.shape[0]
    if n < 1 or n >= 2**31:
        raise ValueError(f"band_dots: {n} values")
    ptrs = [_vec(t, n, dev, "band_dots") for pair in pairs for t in pair] + [None] * (6 - 2 * q)
    y = torch.empty(q, dtype=F64, device=dev) if out is None else out
    _vec(y, q, dev, "band_dots")
    need = dot_work(n, q)
    if need and work is None:
        work = dot_scratch(n, q, dev)
    if need and (work.dtype is not F64 or work.device != dev or not work.is_contiguous() or work.numel() < need):
        raise ValueError(f"band_dots: work must be a contiguous float64 tensor of {need} values on the vectors' "
                         "device")
    _call(dev, _library().phifem_band_dots, *ptrs, q, n, work.data_ptr() if need else None, y.data_ptr())
    launches += 1
    dot_launches += 1
    return y


_UPDATE_VECS = ("x", "ph", "sh", "s", "t", "rout", "xb")
#: the vectors each update mode of the kernel takes (P and S: inside the
#: RAS launches)
MODE_VECS = {XR: ("x", "ph", "sh", "s", "t", "rout"), SEL: ("x", "xb")}


def _vec16(t: torch.Tensor, n: int, dev: torch.device, name: str) -> int:
    ptr = _vec(t, n, dev, name)
    if ptr % 16:
        raise ValueError(f"{name}: every vector must be 16-byte aligned")
    return ptr


def band_update(mode: int, sweep: int, sc: torch.Tensor, **vecs) -> None:
    """One BiCGStab step outside the RAS launches (``XR`` or ``SEL``; see
    :func:`band_update_ref`) on the vectors named in ``vecs`` (16-byte
    aligned on the card) and the scalar slots ``sc`` (``SLOTS`` float64
    values), in place."""
    global launches, update_launches
    if mode not in MODE_VECS:
        raise ValueError(f"band_update: mode {mode} (XR or SEL; P and S run in band_ras_p / band_ras_s)")
    need = MODE_VECS[mode]
    if any(vecs.get(k) is None for k in need) or any(k not in need for k in vecs):
        raise ValueError(f"band_update: mode {mode} takes the vectors {need}")
    if sweep < 0:
        raise ValueError(f"band_update: sweep {sweep}")
    if not _device(sc, "band_update"):
        return band_update_ref(mode, sweep, sc, **vecs)
    dev = sc.device
    _vec(sc, SLOTS, dev, "band_update")
    n = vecs[need[0]].shape[0]
    ptrs = [_vec16(vecs[k], n, dev, "band_update") if k in vecs else None for k in _UPDATE_VECS]
    _call(dev, _library().phifem_band_update, mode, sweep, n, sc.data_ptr(), *ptrs)
    launches += 1
    update_launches += 1


# ------------------------------------------------------------ inner solves
def _kernel_ops(tab: BandTables, dev: torch.device) -> tuple:
    """The fused loop's five operations as launches on ``dev``, bound once
    per solve: the library functions, the current stream, the band's packed
    tables.  Their vectors are the loop's own (made by it, contiguous,
    float64, (m,), 16-byte aligned, on ``dev``) and are not checked again;
    each operation launches its kernel and counts it."""
    lib, stream = _library(), _raw_stream(dev.index)
    _, ras, ell = _on(tab, dev, "band_bicgstab")
    f_ras, f_ell, f_dots, f_up = lib.phifem_band_ras, lib.phifem_band_ell, lib.phifem_band_dots, lib.phifem_band_update
    m, K, w = tab.m, tab.K, tab.width

    def ras_p(_, sweep, sc, r, p, v, x, xb, pout, ph):
        err = f_ras(*ras, r.data_ptr(), p.data_ptr(), v.data_ptr(), None, ph.data_ptr(), pout.data_ptr(), sc.data_ptr(),
                    x.data_ptr(), xb.data_ptr(), m, K, sweep, 1.0, RAS_P, stream)
        if err:
            _raise(f_ras, err)
        _count_ras()

    def ras_s(_, sc, r, v, s, sh):
        err = f_ras(*ras, r.data_ptr(), None, v.data_ptr(), None, sh.data_ptr(), s.data_ptr(), sc.data_ptr(), None,
                    None, m, K, 0, 1.0, RAS_S, stream)
        if err:
            _raise(f_ras, err)
        _count_ras()

    def ell_(_, x, y):
        global launches, ell_launches
        err = f_ell(*ell, x.data_ptr(), None, y.data_ptr(), m, w, 0, stream)
        if err:
            _raise(f_ell, err)
        launches += 1
        ell_launches += 1

    def dots(pairs, out, work):
        global launches, dot_launches
        ptrs = [t.data_ptr() for pair in pairs for t in pair] + [None] * (6 - 2 * len(pairs))
        err = f_dots(*ptrs, len(pairs), m, work.data_ptr(), out.data_ptr(), stream)
        if err:
            _raise(f_dots, err)
        launches += 1
        dot_launches += 1

    def update(mode, sweep, sc, x=None, ph=None, sh=None, s=None, t=None, rout=None, xb=None):
        global launches, update_launches
        ptrs = (None if a is None else a.data_ptr() for a in (x, ph, sh, s, t, rout, xb))
        err = f_up(mode, sweep, m, sc.data_ptr(), *ptrs, stream)
        if err:
            _raise(f_up, err)
        launches += 1
        update_launches += 1

    return ras_p, ell_, dots, ras_s, update


def _fused_bicgstab(ops, tab: BandTables, rb: torch.Tensor, sweeps: int) -> torch.Tensor:
    """The fixed-sweep BiCGStab of :func:`band_bicgstab` on the operations
    ``ops`` = (ras_p, ell, dots, ras_s, update): 8 a sweep."""
    ras_p, ell, dots, ras_s, update = ops
    x = torch.zeros_like(rb)
    xb = torch.zeros_like(rb)
    if sweeps <= 0:
        return xb
    p = (torch.empty_like(rb), torch.empty_like(rb))
    v, s, t, ph, sh, rbuf = (torch.empty_like(rb) for _ in range(6))
    sc = rb.new_zeros(SLOTS)
    rr, rv, ts = sc[RR : RHO_NEW + 1], sc[RV : RV + 1], sc[TS : TT + 1]
    work = dot_scratch(tab.m, 2, rb.device)
    r = rb
    dots([(r, r), (rb, r)], rr, work)
    for i in range(int(sweeps)):
        ras_p(tab, i, sc, r, p[i % 2], v, x, xb, p[(i + 1) % 2], ph)
        ell(tab, ph, v)
        dots([(rb, v)], rv, work)
        ras_s(tab, sc, r, v, s, sh)
        ell(tab, sh, t)
        dots([(t, s), (t, t)], ts, work)
        update(XR, i, sc, x=x, ph=ph, sh=sh, s=s, t=t, rout=rbuf)
        r = rbuf
        dots([(r, r), (rb, r)], rr, work)
    update(SEL, int(sweeps) - 1, sc, x=x, xb=xb)
    return xb


def _bicgstab(ops, tab: BandTables, rb: torch.Tensor, sweeps: int) -> torch.Tensor:
    """The plain unfused loop of :func:`band_bicgstab_ref` on the operations
    ``ops`` = (ras, ell, dots, update): 10 steps a sweep."""
    ras, ell, dots, update = ops
    x = torch.zeros_like(rb)
    xb = torch.zeros_like(rb)
    if sweeps <= 0:
        return xb
    p, v, s, t, ph, sh, rbuf = (torch.empty_like(rb) for _ in range(7))
    sc = rb.new_zeros(SLOTS)
    work = dot_scratch(tab.m, 2, rb.device)
    r = rb
    dots([(r, r), (rb, r)], sc[RR : RHO_NEW + 1], work)
    for i in range(int(sweeps)):
        update(P, i, sc, r=r, p=p, v=v, x=x, xb=xb)
        ras(tab, p, ph)
        ell(tab, ph, v)
        dots([(rb, v)], sc[RV : RV + 1], work)
        update(S, i, sc, r=r, v=v, s=s)
        ras(tab, s, sh)
        ell(tab, sh, t)
        dots([(t, s), (t, t)], sc[TS : TT + 1], work)
        update(XR, i, sc, x=x, ph=ph, sh=sh, s=s, t=t, rout=rbuf)
        r = rbuf
        dots([(r, r), (rb, r)], sc[RR : RHO_NEW + 1], work)
    update(SEL, int(sweeps) - 1, sc, x=x, xb=xb)
    return xb


def _check_rb(tab: BandTables, rb: torch.Tensor) -> None:
    m = tab.m
    if rb.shape != (m,) or rb.dtype is not F64 or not rb.is_contiguous():
        raise ValueError(f"band_bicgstab: rb must be a contiguous float64 ({m},) vector")


def band_bicgstab(tab: BandTables, rb: torch.Tensor, sweeps: int) -> torch.Tensor:
    """``sweeps`` fixed iterations of BiCGStab on the band system ``A e =
    rb``, preconditioned by the RAS blocks, from ``e = 0``: no exit test and
    no host read; divisions guarded (``|d| > 1e-300``), the BEST iterate (the
    smallest finite ``||r||^2`` seen, ``rb`` itself to start) returned.  The
    JAX package's ``_band_bicgstab`` with float64 dots summed by a fixed
    tree.  Per sweep 8 launches: RAS+P, ELL, dots, RAS+S, ELL, dots, XR,
    dots; one select after the last.  On the card the launches are bound
    and checked once for the solve (:func:`_kernel_ops`); a CPU ``rb`` takes
    the same loop through the wrappers' plain versions."""
    _check_rb(tab, rb)
    if not _device(rb, "band_bicgstab"):
        return _fused_bicgstab((band_ras_p, band_ell, band_dots, band_ras_s, band_update), tab, rb, sweeps)
    with torch.cuda.device(rb.device):
        return _fused_bicgstab(_kernel_ops(tab, rb.device), tab, rb, sweeps)


def band_bicgstab_ref(tab: BandTables, rb: torch.Tensor, sweeps: int) -> torch.Tensor:
    """Plain :func:`band_bicgstab`: the unfused loop on the plain versions
    (the P update, RAS, ELL, dots, the S update, RAS, ELL, dots, XR, dots),
    on whatever device ``rb`` is (the kernels' reference on the card)."""
    _check_rb(tab, rb)
    return _bicgstab((band_ras_ref, band_ell_ref, band_dots_ref, band_update_ref), tab, rb, sweeps)


def _richardson(ras, ell, tab: BandTables, rb: torch.Tensor, sweeps: int, omega: float) -> torch.Tensor:
    om = float(omega)
    z = ras(tab, rb, mode=RAS_SCALE, om=om)
    res = torch.empty_like(rb)
    for _ in range(int(sweeps)):
        ell(tab, z, res, b=rb)
        ras(tab, res, z, mode=RAS_ADD, om=om, c=z)
    return z


def band_richardson(tab: BandTables, rb: torch.Tensor, sweeps: int, omega: float = 1.0) -> torch.Tensor:
    """``sweeps`` damped RAS-Richardson steps ``z += omega RAS(rb - A z)`` from
    ``z = omega RAS(rb)``: a fixed linear operator.  Per sweep one ELL
    residual and one RAS launch."""
    return _richardson(band_ras, band_ell, tab, rb, sweeps, omega)


def band_richardson_ref(tab: BandTables, rb: torch.Tensor, sweeps: int, omega: float = 1.0) -> torch.Tensor:
    """Plain :func:`band_richardson` on whatever device ``rb`` is."""
    return _richardson(band_ras_ref, band_ell_ref, tab, rb, sweeps, omega)


# ------------------------------------------------------------ the library
#: the library, the current raw stream of a device and the current device,
#: bound at the first launch
_LAUNCH = {}


def _bind():
    torch.cuda.init()
    _LAUNCH["bound"] = (_library(), torch._C._cuda_getCurrentRawStream, torch._C._cuda_getDevice)
    return _LAUNCH["bound"]


def _raw_stream(idx: int) -> int:
    """The current raw stream of device ``idx``."""
    return (_LAUNCH.get("bound") or _bind())[1](idx)


def build() -> dict:
    """Compile the kernel library if it is not built yet (see
    :func:`phifem_tpu_torch.ops.nvcc_build.build`)."""
    return nvcc_build.build(SOURCE)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build()["path"])
    vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.phifem_band_ras.argtypes = [vp] * 11 + [ci, ci, ci, cd, ci, vp]
    lib.phifem_band_ell.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, vp]
    lib.phifem_band_dots.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, vp, vp, vp]
    lib.phifem_band_update.argtypes = [ci, ci, ci, vp] + [vp] * 7 + [vp]
    for fn in (lib.phifem_band_ras, lib.phifem_band_ell, lib.phifem_band_dots, lib.phifem_band_update):
        fn.restype = ci
    lib.phifem_band_error_string.argtypes = [ci]
    lib.phifem_band_error_string.restype = ctypes.c_char_p
    for name in ("phifem_band_threads", "phifem_band_chunk", "phifem_band_slots", "phifem_band_slice"):
        getattr(lib, name).restype = ci
    got = (lib.phifem_band_threads(), lib.phifem_band_chunk(), lib.phifem_band_slots(), lib.phifem_band_slice())
    if got != (THREADS, CHUNK, SLOTS, SLICE):
        raise RuntimeError(f"cuda_band: the library's CTA size, chunk, slots and slice {got} are not "
                           f"{(THREADS, CHUNK, SLOTS, SLICE)}")
    return lib
