"""The tap-form matvec: CUDA kernel wrapper and its plain version.

Replaces the per-tap loop of ``phifem_tpu/ops/taps.py:TapOperator.
make_matvec`` (``taps.py:305-320``; XLA-fused there, not a Pallas kernel).
The kernel (``phifem_tpu_torch/csrc/tap_matvec.cu``) is built with ``nvcc``
at first use (:mod:`phifem_tpu_torch.ops.nvcc_build`) and loaded with
``ctypes``.

:func:`tap_matvec` dispatches on the tensors' device: CPU tensors go to
:func:`tap_matvec_ref` (one shifted slice and product per tap), CUDA
tensors to the kernel, anything else raises.  There is no fallback from
the card to the plain version.  ``launches`` counts kernel launches.

The kernel reads only the weights the cut band can fill: from
``TapOperator.support`` :func:`tile_table` lists, per output tile of
``TILE`` lattice points, the taps with a supported weight there, and
:func:`zero_runs` the runs of the field tensors outside the tiles with
such a tap, which the kernel zeros; both are built once per operator and
device and cached with the tap table (a few MB at S1 n=3200).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List

import numpy as np
import torch

from . import nvcc_build

__all__ = ["tap_matvec", "tap_matvec_ref", "tile_table", "build"]

#: number of kernel launches made by :func:`tap_matvec`
launches = 0

SOURCE = nvcc_build.PKG / "csrc" / "tap_matvec.cu"
# the kernel's compile-time shape; _library() checks it against the built
# kernel's (phifem_tap_constants)
_MAX_BLOCKS = 16  # kMaxBlocks
_MAX_CH = 4  # kMaxCh
TILE = (8, 32)  # (TR, TC) lattice points per output tile: kTileR, kTileC
_STAGE = 256  # kStage: most zero runs per work item
_DESC = 11  # kDescFields: int64 fields per block of the launch's descriptor
_RUN = 8192  # most elements per zero run, and per work item


def tap_matvec_ref(top, W: torch.Tensor, x: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version: ``y[bi] = sum_t W_t * x[bj]`` shifted, tap by
    tap.  Each source block is zero-padded by ``pad`` rows and columns
    before and ``pad + 1`` after, so a slice never clamps, also where the
    target lattice is one larger than the source (P1 target, DG0
    source)."""
    P = top.pad
    blocks = top._decompose(x)
    padded: List = [None] * len(blocks)
    y: List = [None] * len(blocks)
    off = top.tap_offsets
    for t, (bi, bj, dr, dc) in enumerate(top.taps):
        Ri, Ci = top.blk_shapes[bi]
        vi, vj = top.blk_ch[bi], top.blk_ch[bj]
        if padded[bj] is None:
            padded[bj] = torch.nn.functional.pad(blocks[bj], (0, 0, P, P + 1, P, P + 1))
        xs = padded[bj][P + dr : P + dr + Ri, P + dc : P + dc + Ci, :]
        w = W[int(off[t]) : int(off[t + 1])].reshape(Ri, Ci, vi, vj)
        if vi == 1 and vj == 1:
            part = w[:, :, 0, :] * xs
        else:
            part = torch.einsum("rcij,rcj->rci", w, xs)
        y[bi] = part if y[bi] is None else y[bi] + part
    for i in range(len(y)):
        if y[i] is None:
            y[i] = W.new_zeros(top.blk_shapes[i] + (top.blk_ch[i],))
    return top._recompose(y)


def tile_table(top):
    """The active ``(tap, tile)`` pairs of ``top`` on the host.

    Each block lattice ``(R, C)`` is cut into ``TILE = (TR, TC)`` tiles of
    lattice points (ragged at the last row and column of tiles), numbered
    block by block, row-major inside a block.  A tap is active on a tile of
    its target block when one of its weights there lies in ``top.support``
    (every tap on every tile of its target block where ``support`` is None).
    Returns ``(base, ptr, taps)``: ``base[b]`` the first tile of block ``b``
    (``base[-1]`` the number of tiles); per tile ``i`` the CSR range
    ``ptr[i]:ptr[i + 1]`` of ``taps``, the positions of its active taps in
    the kernel's tap table (sorted by target block, stable in ``t``), in
    ascending order, as int32."""
    TR, TC = TILE
    ntaps = top.num_taps
    order = sorted(range(ntaps), key=lambda t: top.taps[t][0])
    rank = np.empty(ntaps, np.int64)
    rank[order] = np.arange(ntaps)
    ntc = np.asarray([-(-C // TC) for _, C in top.blk_shapes], np.int64)
    ntiles = np.asarray([-(-R // TR) for R, _ in top.blk_shapes], np.int64) * ntc
    base = np.concatenate([[0], np.cumsum(ntiles)]).astype(np.int64)
    t_bi = np.asarray([t[0] for t in top.taps], np.int64).reshape(-1)
    if top.support is None:
        reps = ntiles[t_bi]
        tiles = np.concatenate([np.arange(base[b], base[b + 1]) for b in t_bi] + [np.zeros(0, np.int64)])
        keys = tiles * ntaps + np.repeat(rank, reps)
    else:
        ids = np.asarray(top.support, np.int64)
        t = np.searchsorted(top.tap_offsets, ids, side="right") - 1
        bi = t_bi[t]
        C = np.asarray([c for _, c in top.blk_shapes], np.int64)[bi]
        ch = np.asarray(top.blk_ch, np.int64)
        per = ch[bi] * ch[np.asarray([tp[1] for tp in top.taps], np.int64)[t]]
        rc = (ids - top.tap_offsets[t]) // per
        keys = (base[bi] + (rc // C) // TR * ntc[bi] + (rc % C) // TC) * ntaps + rank[t]
    keys = np.unique(keys)
    ptr = np.zeros(int(base[-1]) + 1, np.int64)
    np.cumsum(np.bincount(keys // ntaps, minlength=int(base[-1])), out=ptr[1:])
    return base, ptr.astype(np.int32), (keys % ntaps).astype(np.int32)


def zero_runs(top, base, ptr):
    """The runs of the fields' tensors that no active tile writes, which the
    kernel zeros: ``(runs, work)``, ``runs`` (nruns, 3) int64 rows (first
    block of the field, start element, length <= _RUN) in the fields'
    order, ``work`` the int32 CSR pointers of the work items, each at most
    _STAGE runs and about _RUN elements."""
    TR, TC = TILE
    active = np.diff(ptr) > 0
    rows = []
    for sp in top.specs:
        R, C = sp.shape
        stride = sp.nblocks * sp.vsz
        hit = np.zeros(R * C * stride, bool)
        for o in range(sp.nblocks):
            b = sp.base + o
            ntc = -(-C // TC)
            tiles = np.flatnonzero(active[base[b] : base[b + 1]])
            r = (tiles // ntc * TR)[:, None, None] + np.arange(TR)[None, :, None]
            c = (tiles % ntc * TC)[:, None, None] + np.arange(TC)[None, None, :]
            ok = (r < R) & (c < C)
            pts = (r * C + c)[ok]
            hit[(pts[:, None] * stride + o * sp.vsz + np.arange(sp.vsz)).reshape(-1)] = True
        edges = np.flatnonzero(np.diff(np.concatenate([[1], hit.view(np.int8), [1]])))
        start, end = edges[0::2], edges[1::2]
        npieces = -(-(end - start) // _RUN)
        first = np.repeat(start, npieces) + _RUN * (
            np.arange(npieces.sum()) - np.repeat(np.cumsum(npieces) - npieces, npieces))
        length = np.minimum(np.repeat(end, npieces) - first, _RUN)
        rows.append(np.stack([np.full_like(first, sp.base), first, length], axis=1))
    runs = np.concatenate(rows + [np.zeros((0, 3), np.int64)]).astype(np.int64)
    work, size = [0], 0
    for j, n in enumerate(runs[:, 2].tolist()):
        if j > work[-1] and (size + n > _RUN or j - work[-1] == _STAGE):
            work.append(j)
            size = 0
        size += n
    if len(runs):
        work.append(len(runs))
    return runs, np.asarray(work, np.int32)


def _kernel_table(top, device) -> dict:
    """What a launch needs beyond ``W`` and the fields, made once per
    operator and device: the (ntaps, 4) int64 tap rows (bj, dr, dc, woff)
    sorted by target block, the tile table, the ids of the tiles with an
    active tap and the zero runs (:func:`zero_runs`) on ``device``; the
    launch's per-block descriptor with every field but the x and y pointers
    (first tile, tiles per row, source-block mask, offset of the block's x
    window in shared memory, ...); per field its name, shape and blocks; and
    the launch's trailing arguments, which depend on the operator alone."""
    cache = top.__dict__.setdefault("_kernel_tables", {})
    if device not in cache:
        nb = len(top.blk_shapes)
        if nb > _MAX_BLOCKS:
            raise ValueError(f"tap_matvec: {nb} block lattices, the kernel takes at most {_MAX_BLOCKS}")
        if max(top.blk_ch) > _MAX_CH:
            raise ValueError(f"tap_matvec: {max(top.blk_ch)} channels, the kernel takes at most {_MAX_CH}")
        order = sorted(range(top.num_taps), key=lambda t: top.taps[t][0])
        rows = np.asarray(
            [[top.taps[t][1], top.taps[t][2], top.taps[t][3], top.tap_offsets[t]] for t in order],
            np.int64,
        ).reshape(-1, 4)
        base, ptr, tile_taps = tile_table(top)
        TR, TC = TILE
        src_mask = [0] * nb
        for bi, bj, _, _ in top.taps:
            src_mask[bi] |= 1 << bj
        win = (TR + 2 * top.pad) * (TC + 2 * top.pad)
        win_off, total = [-1] * nb, 0
        for b in range(nb):
            if any((m >> b) & 1 for m in src_mask):
                win_off[b] = total
                total += win * top.blk_ch[b]
        runs, work = zero_runs(top, base, ptr)
        desc = np.zeros((nb, _DESC), np.int64)
        fields = []
        for sp in top.specs:
            R, C = sp.shape
            fields.append((sp.name, torch.Size((R * C * sp.nblocks,) + sp.vshape), sp.base, sp.nblocks))
            for o in range(sp.nblocks):
                b = sp.base + o
                desc[b, 2:] = [R, C, sp.vsz, sp.nblocks * sp.vsz, o * sp.vsz, base[b], -(-C // TC),
                               src_mask[b], win_off[b]]
        tab = {
            "runs": torch.as_tensor(runs, device=device),
            "work": torch.as_tensor(work, device=device),
            "taps": torch.as_tensor(rows, device=device),
            "ptr": torch.as_tensor(ptr, device=device),
            "tile_taps": torch.as_tensor(tile_taps, device=device),
            "active": torch.as_tensor(np.flatnonzero(np.diff(ptr) > 0).astype(np.int32), device=device),
            "desc": desc.tobytes(),
            "Desc": ctypes.c_longlong * desc.size,
            "fields": fields,
        }
        tab["args"] = (
            nb, top.pad, tab["taps"].data_ptr(), tab["ptr"].data_ptr(), tab["tile_taps"].data_ptr(),
            tab["active"].data_ptr(), tab["active"].numel(), tab["runs"].data_ptr(),
            tab["work"].data_ptr(), tab["work"].numel() - 1, total,
        )
        cache[device] = tab
    return cache[device]


def active_tile_fraction(top) -> float:
    """Share of the ``(tap, tile)`` pairs (each tap on every tile of its
    target block) that the kernel walks."""
    base, _, tile_taps = tile_table(top)
    ntiles = np.diff(base)
    return len(tile_taps) / max(1, int(sum(ntiles[bi] for bi, _, _, _ in top.taps)))


def tap_matvec(top, W: torch.Tensor, x: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``y = A_taps x`` over every field of ``top`` (fresh tensors).

    CPU tensors take the plain version; CUDA tensors the kernel, which
    takes float32 or float64, ``W`` and every field in one dtype on one
    card.  Everything but the x, y and W pointers is made at the first call
    on an operator and device (:func:`_kernel_table`), so a call costs the
    host little more than the launch."""
    global launches
    dev = W.device
    if dev.type == "cpu":
        return tap_matvec_ref(top, W, x)
    if dev.type != "cuda":
        raise ValueError(f"tap_matvec: no kernel for device {dev}")
    dt = W.dtype
    if dt is not torch.float64 and dt is not torch.float32:
        raise TypeError(f"tap_matvec: W must be float32 or float64, got {dt}")
    if W.numel() != top.num_weights or not W.is_contiguous():
        raise ValueError("tap_matvec: W must be the operator's contiguous flat weight buffer")
    tab = _kernel_table(top, dev)
    desc = tab["Desc"].from_buffer_copy(tab["desc"])
    xs, ys = [], {}
    for name, shape, b0, nblocks in tab["fields"]:
        v = x[name]
        if v.shape != shape:
            raise ValueError(f"tap_matvec: field {name!r} must have shape {tuple(shape)}, got {tuple(v.shape)}")
        if v.dtype != dt or v.device != dev:
            raise ValueError(f"tap_matvec: field {name!r} must be on {dev} in {dt}")
        v = v.contiguous()
        y = ys[name] = torch.empty(shape, dtype=dt, device=dev)
        xp, yp = v.data_ptr(), y.data_ptr()
        for b in range(b0, b0 + nblocks):
            desc[_DESC * b] = xp
            desc[_DESC * b + 1] = yp
        xs.append(v)
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if dev.index == torch.cuda.current_device():
        err = lib.phifem_tap_matvec(desc, W.data_ptr(), dt is torch.float64, stream, *tab["args"])
    else:
        with torch.cuda.device(dev):
            err = lib.phifem_tap_matvec(desc, W.data_ptr(), dt is torch.float64, stream, *tab["args"])
    if err:
        msg = lib.phifem_tap_cuda_error_string(err).decode()
        raise RuntimeError(f"tap_matvec kernel launch failed: CUDA error {err} ({msg})")
    launches += 1
    return ys


def build() -> dict:
    """Compile the kernel library if it is not built yet (see
    :func:`phifem_tpu_torch.ops.nvcc_build.build`)."""
    return nvcc_build.build(SOURCE)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build()["path"])
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.phifem_tap_matvec.argtypes = [
        ctypes.POINTER(ctypes.c_longlong), vp, ci, vp, ci, ci, vp, vp, vp, vp, ci, vp, vp, ci, ci]
    lib.phifem_tap_matvec.restype = ci
    lib.phifem_tap_cuda_error_string.argtypes = [ci]
    lib.phifem_tap_cuda_error_string.restype = ctypes.c_char_p
    got = (ctypes.c_int * 6)()
    lib.phifem_tap_constants(got)
    want = (*TILE, _STAGE, _MAX_CH, _MAX_BLOCKS, _DESC)
    if tuple(got) != want:
        raise RuntimeError(f"{SOURCE.name} is built for (kTileR, kTileC, kStage, kMaxCh, kMaxBlocks, "
                           f"kDescFields) = {tuple(got)}, the wrapper's tables for {want}")
    return lib
