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
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List

import numpy as np
import torch

from . import nvcc_build

__all__ = ["tap_matvec", "tap_matvec_ref", "build"]

#: number of kernel launches made by :func:`tap_matvec`
launches = 0

SOURCE = nvcc_build.PKG / "csrc" / "tap_matvec.cu"
_MAX_BLOCKS = 16  # kMaxBlocks of the kernel


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


def _kernel_table(top, device) -> torch.Tensor:
    """(ntaps, 4) int64 rows (bj, dr, dc, woff) sorted by target block, on
    ``device``, with the per-block tap ranges; made once per operator and
    device."""
    cache = top.__dict__.setdefault("_kernel_tables", {})
    if device not in cache:
        order = sorted(range(top.num_taps), key=lambda t: top.taps[t][0])
        rows = np.asarray(
            [[top.taps[t][1], top.taps[t][2], top.taps[t][3], top.tap_offsets[t]] for t in order],
            np.int64,
        ).reshape(-1, 4)
        targets = np.asarray([top.taps[t][0] for t in order], np.int64)
        nb = len(top.blk_shapes)
        begin = np.searchsorted(targets, np.arange(nb), side="left")
        end = np.searchsorted(targets, np.arange(nb), side="right")
        cache[device] = (torch.as_tensor(rows, device=device), begin, end)
    return cache[device]


def tap_matvec(top, W: torch.Tensor, x: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``y = A_taps x`` over every field of ``top`` (fresh tensors).

    CPU tensors take the plain version; CUDA tensors the kernel, which
    takes float32 or float64, ``W`` and every field in one dtype on one
    card."""
    global launches
    dev = W.device
    if dev.type == "cpu":
        return tap_matvec_ref(top, W, x)
    if dev.type != "cuda":
        raise ValueError(f"tap_matvec: no kernel for device {dev}")
    if W.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"tap_matvec: W must be float32 or float64, got {W.dtype}")
    nb = len(top.blk_shapes)
    if nb > _MAX_BLOCKS:
        raise ValueError(f"tap_matvec: {nb} block lattices, the kernel takes at most {_MAX_BLOCKS}")
    if W.numel() != top.num_weights or not W.is_contiguous():
        raise ValueError("tap_matvec: W must be the operator's contiguous flat weight buffer")
    xs, ys = {}, {}
    for sp in top.specs:
        v = x[sp.name]
        shape = (sp.shape[0] * sp.shape[1] * sp.nblocks,) + sp.vshape
        if tuple(v.shape) != shape:
            raise ValueError(f"tap_matvec: field {sp.name!r} must have shape {shape}, got {tuple(v.shape)}")
        if v.dtype != W.dtype or v.device != dev:
            raise ValueError(f"tap_matvec: field {sp.name!r} must be on {dev} in {W.dtype}")
        xs[sp.name] = v.contiguous()
        ys[sp.name] = torch.empty(shape, dtype=W.dtype, device=dev)
    table, begin, end = _kernel_table(top, dev)
    desc = np.zeros((nb, 10), np.int64)
    out = 0
    for sp in top.specs:
        R, C = sp.shape
        for o in range(sp.nblocks):
            b = sp.base + o
            desc[b] = [
                xs[sp.name].data_ptr(), ys[sp.name].data_ptr(), R, C, sp.vsz,
                sp.nblocks * sp.vsz, o * sp.vsz, begin[b], end[b], out,
            ]
            out += R * C * sp.vsz
    lib = _library()
    args = (
        desc.ctypes.data, nb, table.data_ptr(), W.data_ptr(), out,
        int(W.dtype == torch.float64), torch.cuda.current_stream(dev).cuda_stream,
    )
    if dev.index == torch.cuda.current_device():
        err = lib.phifem_tap_matvec(*args)
    else:
        with torch.cuda.device(dev):
            err = lib.phifem_tap_matvec(*args)
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
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.phifem_tap_matvec.argtypes = [vp, ci, vp, vp, cll, ci, vp]
    lib.phifem_tap_matvec.restype = ci
    lib.phifem_tap_cuda_error_string.argtypes = [ci]
    lib.phifem_tap_cuda_error_string.restype = ctypes.c_char_p
    return lib
