"""The interface band solve: CUDA kernel wrappers, their plain versions and
the fixed-sweep inner solves built from them.

Replaces the XLA-fused loops of the JAX package's band solve
(``phifem_tpu/mg.py``: ``_band_bicgstab``, and ``band_mv`` / ``band_ras`` in
``VCycle._band_correct_flat``), which the port's
``VCycle._band_correct_flat`` and ``lattice_core.make_interface_apply`` call
through :func:`band_bicgstab` and :func:`band_richardson`.  The kernels
(``phifem_tpu_torch/csrc/band_solve.cu``) are built with ``nvcc`` at first use
(:mod:`phifem_tpu_torch.ops.nvcc_build`) and loaded with ``ctypes``:

* :func:`band_ras`: the restricted additive Schwarz block apply, each band
  DoF taking the one row of its owning block's inverse
  (``y[i] = sum_l inv[b, k, l] x[ids[b, l]]``, ascending l), optionally
  scaled and added to a vector;
* :func:`band_dots`: up to three dot products in one pass, summed by a fixed
  tree (:func:`band_dots_ref` defines it), the results left on the device;
* :func:`band_update`: the BiCGStab vector updates, one mode per launch,
  their coefficients computed from the dot results in the solve's scalar
  slots;
* :func:`band_ell`: the band's ELL product ``A x`` (or ``b - A x``), run by
  the AMG cycle's ELL kernel (:mod:`phifem_tpu_torch.ops.cuda_amg`) on the
  band matrix stored slot-major; counted here, not in ``cuda_amg.launches``.

Everything is float64 (:data:`phifem_tpu_torch.mg.TABLE_DTYPE`).  Each
wrapper dispatches on the tensor's device: a CPU tensor goes to the plain
version, a CUDA tensor to the kernel, anything else raises; there is no
fallback from the card to the plain version.  Every product, quotient and
sum is rounded on its own in the order the plain versions take, so each
kernel, and the whole inner solve, equals its plain version bit for bit.
``launches`` counts every kernel launch made here; ``ras_launches``,
``ell_launches``, ``dot_launches`` and ``update_launches`` count them by
kernel, ``tables_built`` the band table sets built.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import cuda_amg, nvcc_build

__all__ = [
    "BandTables",
    "band_tables",
    "band_ras",
    "band_ras_ref",
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
#: the kernels' CTA size and the values one CTA of the dot kernel sums
THREADS = 256
CHUNK = 1024
F64 = torch.float64

#: RAS modes: y = acc, y = om acc, y = c + om acc
RAS_APPLY, RAS_SCALE, RAS_ADD = 0, 1, 2
#: update modes (see ``csrc/band_solve.cu``)
P, S, XR, SEL = 0, 1, 2, 3
#: the solve's scalar slots: the dot results r.r, rhat.r (the next rho),
#: rhat.v, t.s, t.t; rho, alpha, omega; the best residual, in two slots
#: that alternate by sweep
RR, RHO_NEW, RV, TS, TT, RHO, ALPHA, OMEGA, RRB0, RRB1 = range(10)
SLOTS = 10
TINY = 1e-300


@dataclasses.dataclass
class BandTables:
    """The Schwarz branch's tables as the kernels read them: ``inv`` (nb, K,
    K) block inverses, ``ids`` (nb, K) int32 compact ids padded with m,
    ``owner`` (m,) int32 owner slots (nb K: none), the band matrix
    slot-major as ``ell_cols`` (w, m) int32 (pad column m) and ``ell_vals``
    (w, m), and the ELL kernel's group size ``lanes``."""

    inv: torch.Tensor
    ids: torch.Tensor
    owner: torch.Tensor
    ell_cols: torch.Tensor
    ell_vals: torch.Tensor
    lanes: int

    @property
    def m(self) -> int:
        return self.owner.shape[0]

    @property
    def nb(self) -> int:
        return self.ids.shape[0]

    @property
    def K(self) -> int:
        return self.ids.shape[1]


def band_tables(ids, inv, owner, ell_cols, ell_vals, device) -> BandTables:
    """:class:`BandTables` on ``device`` from host arrays (numpy, or CPU
    tensors): ``ids`` (nb, K) compact block ids padded with m, ``inv`` (nb,
    K, K) block inverses, ``owner`` (m,) owner slots, the band matrix
    row-major as ``ell_cols`` / ``ell_vals`` (m, w).  Adds one to
    ``tables_built``."""
    global tables_built
    ids, inv, owner, ell_cols, ell_vals = (np.asarray(a) for a in (ids, inv, owner, ell_cols, ell_vals))
    m, w = ell_cols.shape
    nb, K = ids.shape
    if inv.shape != (nb, K, K) or owner.shape != (m,) or ell_vals.shape != (m, w):
        raise ValueError("band_tables: inconsistent Schwarz table shapes")
    if m < 1 or m >= 2**31 or nb * K * K >= 2**31 or m * w >= 2**31:
        raise ValueError("band_tables: tables too large for 32-bit indexing")
    dev = torch.device(device)
    t = lambda a, dtype: torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)  # a copy: never a view of a
    tables_built += 1
    return BandTables(inv=t(inv, F64), ids=t(ids, torch.int32), owner=t(owner, torch.int32),
                      ell_cols=t(ell_cols.T, torch.int32), ell_vals=t(ell_vals.T, F64),
                      lanes=cuda_amg.lanes_for(m, w))


# ------------------------------------------------------------ plain versions
def band_ras_ref(tab: BandTables, x: torch.Tensor, out: Optional[torch.Tensor] = None, *, mode: int = RAS_APPLY,
                 om: float = 1.0, c: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain RAS apply: each DoF's owning row of its block inverse against
    the block's entries of ``x`` (a pad id reads 0), summed in ascending
    order; 0 where a DoF has no owner; then ``om acc`` or ``c + om acc`` by
    ``mode``."""
    K = tab.K
    valid = tab.owner < tab.nb * K
    s = torch.where(valid, tab.owner, 0).long()
    xv = torch.cat([x, x.new_zeros(1)])[tab.ids.long()[torch.div(s, K, rounding_mode="floor")]]
    prod = (tab.inv.reshape(-1, K)[s] * xv).T
    acc = prod[0]
    for l in range(1, K):
        acc = acc + prod[l]
    y = torch.where(valid, acc, 0.0)
    if mode == RAS_SCALE:
        y = om * y
    elif mode == RAS_ADD:
        y = c + om * y
    if out is None:
        return y
    return out.copy_(y)


def band_ell_ref(tab: BandTables, x: torch.Tensor, out: Optional[torch.Tensor] = None, *,
                 b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain band product ``A x`` (or ``b - A x``): the AMG ELL kernel's plain
    version on the slot-major band matrix."""
    mode = cuda_amg.APPLY if b is None else cuda_amg.RESIDUAL
    y = cuda_amg.amg_ell_sweep_ref(mode, tab.ell_cols, tab.ell_vals, x, b)
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


def _on(tab: BandTables, dev: torch.device, name: str) -> None:
    if any(t.device != dev for t in (tab.inv, tab.ids, tab.owner, tab.ell_cols, tab.ell_vals)):
        raise ValueError(f"{name}: the band tables are not on {dev}")


def _call(dev: torch.device, fn, *args) -> None:
    idx = dev.index
    _, raw_stream, current = _LAUNCH.get("bound") or _bind()
    if idx == current():
        err = fn(*args, raw_stream(idx))
    else:
        with torch.cuda.device(dev):
            err = fn(*args, raw_stream(idx))
    if err:
        msg = _library().phifem_band_error_string(err).decode()
        raise RuntimeError(f"{fn.__name__} kernel launch failed: CUDA error {err} ({msg})")


def band_ras(tab: BandTables, x: torch.Tensor, out: Optional[torch.Tensor] = None, *, mode: int = RAS_APPLY,
             om: float = 1.0, c: Optional[torch.Tensor] = None) -> torch.Tensor:
    """RAS apply (see :func:`band_ras_ref`) into ``out`` (a new vector when
    None; ``out`` may be ``c``, not ``x``)."""
    global launches, ras_launches
    if mode not in (RAS_APPLY, RAS_SCALE, RAS_ADD) or (mode == RAS_ADD and c is None):
        raise ValueError(f"band_ras: bad mode {mode} (RAS_ADD needs c)")
    if not _device(x, "band_ras"):
        return band_ras_ref(tab, x, out, mode=mode, om=om, c=c)
    dev, m = x.device, tab.m
    _on(tab, dev, "band_ras")
    y = torch.empty(m, dtype=F64, device=dev) if out is None else out
    if y is x:
        raise ValueError("band_ras: out must not be x")
    args = (tab.inv.data_ptr(), tab.ids.data_ptr(), tab.owner.data_ptr(), _vec(x, m, dev, "band_ras"),
            None if c is None else _vec(c, m, dev, "band_ras"), _vec(y, m, dev, "band_ras"), m, tab.nb, tab.K,
            float(om), mode)
    _call(dev, _library().phifem_band_ras, *args)
    launches += 1
    ras_launches += 1
    return y


def band_ell(tab: BandTables, x: torch.Tensor, out: Optional[torch.Tensor] = None, *,
             b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The band product ``A x``, or ``b - A x``, by the AMG ELL kernel
    (:func:`band_ell_ref` on the CPU)."""
    global launches, ell_launches
    if not _device(x, "band_ell"):
        return band_ell_ref(tab, x, out, b=b)
    dev, m = x.device, tab.m
    _on(tab, dev, "band_ell")
    y = torch.empty(m, dtype=F64, device=dev) if out is None else out
    if y is x or y is b:
        raise ValueError("band_ell: out must be another vector than x and b")
    _vec(x, m, dev, "band_ell")
    _vec(y, m, dev, "band_ell")
    if b is not None:
        _vec(b, m, dev, "band_ell")
    mode = cuda_amg.APPLY if b is None else cuda_amg.RESIDUAL
    cuda_amg.launch(mode, tab.ell_cols, tab.ell_vals, x, b, None, y, tab.lanes)
    launches += 1
    ell_launches += 1
    return y


def dot_stages(n: int) -> int:
    """Launches of one :func:`band_dots` call over ``n`` values."""
    stages, nc = 1, -(-n // CHUNK)
    while nc > 1:
        nc = -(-nc // CHUNK)
        stages += 1
    return stages


def dot_work(n: int, np_: int) -> int:
    """Values of scratch one :func:`band_dots` call of ``np_`` pairs over
    ``n`` values needs."""
    nc = -(-n // CHUNK)
    return 0 if nc == 1 else np_ * (nc + -(-nc // CHUNK))


def band_dots(pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]], out: Optional[torch.Tensor] = None,
              work: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Up to three ordered dots (see :func:`band_dots_ref`) into ``out`` (a
    contiguous float64 vector of ``len(pairs)`` values on the device, e.g. a
    slice of the solve's scalar slots; new when None).  ``work``: scratch of
    at least :func:`dot_work` values (allocated when None)."""
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
    if need and (work is None or work.numel() < need):
        work = torch.empty(need, dtype=F64, device=dev)
    if need and (work.dtype is not F64 or work.device != dev or not work.is_contiguous()):
        raise ValueError("band_dots: work must be a contiguous float64 tensor on the vectors' device")
    _call(dev, _library().phifem_band_dots, *ptrs, q, n, work.data_ptr() if need else None, y.data_ptr())
    k = dot_stages(n)
    launches += k
    dot_launches += k
    return y


_UPDATE_VECS = ("r", "p", "v", "s", "t", "x", "ph", "sh", "xb", "rout")
#: the vectors each update mode takes (P at sweep 0 only r and p)
MODE_VECS = {P: ("r", "p", "v", "x", "xb"), S: ("r", "v", "s"), XR: ("x", "ph", "sh", "s", "t", "rout"),
              SEL: ("x", "xb")}


def band_update(mode: int, sweep: int, sc: torch.Tensor, **vecs) -> None:
    """One BiCGStab update (``P``, ``S``, ``XR`` or ``SEL``; see
    :func:`band_update_ref`) on the vectors named in ``vecs`` and the scalar
    slots ``sc`` (``SLOTS`` float64 values), in place."""
    global launches, update_launches
    if mode not in MODE_VECS:
        raise ValueError(f"band_update: unknown mode {mode}")
    need = MODE_VECS[mode] if not (mode == P and sweep == 0) else ("r", "p")
    if any(vecs.get(k) is None for k in need) or any(k not in _UPDATE_VECS for k in vecs):
        raise ValueError(f"band_update: mode {mode} takes the vectors {need}")
    if sweep < 0:
        raise ValueError(f"band_update: sweep {sweep}")
    if not _device(sc, "band_update"):
        return band_update_ref(mode, sweep, sc, **vecs)
    dev = sc.device
    _vec(sc, SLOTS, dev, "band_update")
    n = vecs[need[0]].shape[0]
    ptrs = [_vec(vecs[k], n, dev, "band_update") if vecs.get(k) is not None else None for k in _UPDATE_VECS]
    _call(dev, _library().phifem_band_update, mode, sweep, n, sc.data_ptr(), *ptrs)
    launches += 1
    update_launches += 1


# ------------------------------------------------------------ inner solves
def _bicgstab(ops, tab: BandTables, rb: torch.Tensor, sweeps: int) -> torch.Tensor:
    """The fixed-sweep BiCGStab of :func:`band_bicgstab` on the operations
    ``ops`` = (ras, ell, dots, update)."""
    ras, ell, dots, update = ops
    m = tab.m
    if rb.shape != (m,) or rb.dtype is not F64:
        raise ValueError(f"band_bicgstab: rb must be a float64 ({m},) vector")
    x = torch.zeros_like(rb)
    xb = torch.zeros_like(rb)
    if sweeps <= 0:
        return xb
    p, v, s, t, ph, sh, rbuf = (torch.empty_like(rb) for _ in range(7))
    sc = rb.new_zeros(SLOTS)
    work = rb.new_empty(max(1, dot_work(m, 2)))
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


def band_bicgstab(tab: BandTables, rb: torch.Tensor, sweeps: int) -> torch.Tensor:
    """``sweeps`` fixed iterations of BiCGStab on the band system ``A e =
    rb``, preconditioned by the RAS blocks, from ``e = 0``: no exit test and
    no host read; divisions guarded (``|d| > 1e-300``), the BEST iterate (the
    smallest finite ``||r||^2`` seen, ``rb`` itself to start) returned.  The
    JAX package's ``_band_bicgstab`` with float64 dots summed by a fixed
    tree.  Per sweep: 2 RAS, 2 ELL, 3 dots (one launch each up to CHUNK
    values, two up to CHUNK^2) and 3 updates; one select after the last."""
    return _bicgstab((band_ras, band_ell, band_dots, band_update), tab, rb, sweeps)


def band_bicgstab_ref(tab: BandTables, rb: torch.Tensor, sweeps: int) -> torch.Tensor:
    """Plain :func:`band_bicgstab`: the same loop on the plain versions, on
    whatever device ``rb`` is (the kernels' reference on the card)."""
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
#: the library's three entry points, the current raw stream of a device and
#: the current device, bound at the first launch
_LAUNCH = {}


def _bind():
    torch.cuda.init()
    _LAUNCH["bound"] = (_library(), torch._C._cuda_getCurrentRawStream, torch._C._cuda_getDevice)
    return _LAUNCH["bound"]


def build() -> dict:
    """Compile the kernel library if it is not built yet (see
    :func:`phifem_tpu_torch.ops.nvcc_build.build`)."""
    return nvcc_build.build(SOURCE)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build()["path"])
    vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.phifem_band_ras.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, cd, ci, vp]
    lib.phifem_band_dots.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, vp, vp, vp]
    lib.phifem_band_update.argtypes = [ci, ci, ci, vp] + [vp] * 10 + [vp]
    for fn in (lib.phifem_band_ras, lib.phifem_band_dots, lib.phifem_band_update):
        fn.restype = ci
    lib.phifem_band_error_string.argtypes = [ci]
    lib.phifem_band_error_string.restype = ctypes.c_char_p
    for name in ("phifem_band_threads", "phifem_band_chunk", "phifem_band_slots"):
        getattr(lib, name).restype = ci
    got = (lib.phifem_band_threads(), lib.phifem_band_chunk(), lib.phifem_band_slots())
    if got != (THREADS, CHUNK, SLOTS):
        raise RuntimeError(f"cuda_band: the library's CTA size, chunk and slots {got} are not "
                           f"{(THREADS, CHUNK, SLOTS)}")
    return lib
