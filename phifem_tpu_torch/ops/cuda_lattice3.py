"""The 27-point lattice sweep of the 3D lattice multigrid: CUDA kernel
wrapper and its plain version.

Replaces the XLA-fused ``_conv_interior3`` loops of
``phifem_tpu/ops/lattice3.py`` (the matvec of ``lattice3_cg``, the residual
of ``Lattice3MG._cycle`` and the damped-Jacobi sweep of
``Lattice3MG._smooth``).  The kernel (``phifem_tpu_torch/csrc/
lattice3_sweep.cu``) is built with ``nvcc`` at first use
(:mod:`phifem_tpu_torch.ops.nvcc_build`) and loaded with ``ctypes``.

:func:`lattice3_sweep` dispatches on the tensor's device: a CPU tensor goes
to :func:`lattice3_sweep_ref` (shifted slices), a CUDA tensor to the kernel,
anything else raises; there is no fallback from the card to the plain
version.  ``launches`` counts kernel launches.  All three modes write a new
padded array: ``MATVEC`` ``A x``, ``RESIDUAL`` ``(b - A x) * m`` and
``JACOBI`` ``x + (s (b - A x)) * m`` on the logical interior, and zero
(``x`` for ``JACOBI``) elsewhere.

:func:`lattice3_block_sweep` is the 3-channel block form
(``_conv_interior3_block`` of ``phifem_tpu/ops/lattice3.py:381`` in
``Lattice3BlockMG``): channels-first ``(3, D+2, R+2, C+2)`` arrays, a 3 x 3
block per stencil position, the block Jacobi update
``x + (omega Dinv (b - A x)) * m``; the same source's second kernel,
``block_launches`` counts its launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import nvcc_build

__all__ = ["MATVEC", "RESIDUAL", "JACOBI", "lattice3_sweep", "lattice3_sweep_ref", "pack_terms",
           "lattice3_block_sweep", "lattice3_block_sweep_ref", "pack_block_terms", "build"]

MATVEC, RESIDUAL, JACOBI = 0, 1, 2

#: number of kernel launches made by :func:`lattice3_sweep`
launches = 0
#: number of kernel launches made by :func:`lattice3_block_sweep`
block_launches = 0

SOURCE = nvcc_build.PKG / "csrc" / "lattice3_sweep.cu"
MAX_TERMS = 27

#: the kernel's tiling per value type, passed to nvcc as -D defines (see the
#: source's note): a CTA of ``BX`` x ``BY`` threads, each owning ``RX``
#: consecutive (x, y) columns of the padded array and a run of ``RZ`` planes
TILE = {"BX_F32": 32, "BY_F32": 4, "RX_F32": 1, "RZ_F32": 8, "BX_F64": 16, "BY_F64": 8, "RX_F64": 2, "RZ_F64": 2}
#: the block kernel's tiling: a CTA of ``BX`` x ``BY`` threads owns a tile
#: of the logical interior, each thread one column and a run of ``RZ``
#: planes of it (the CTAs on the array's faces also write the shell beyond
#: their tiles); ``ROLL``: the run's plane loop is a loop, not unrolled;
#: ``BY``, ``RZ`` and ``ROLL`` per value type
BLOCK_TILE = {"BX": 32, "BY_F32": 4, "RZ_F32": 8, "ROLL_F32": 1, "BY_F64": 8, "RZ_F64": 2, "ROLL_F64": 0}
#: channels of the block kernel's field
VSZ = 3


def defines(tile: dict = TILE, block_tile: dict = BLOCK_TILE) -> tuple:
    """The ``-DPHIFEM_L3_*`` / ``-DPHIFEM_L3B_*`` flags of the tilings."""
    return tuple(f"-DPHIFEM_L3_{k}={v}" for k, v in tile.items()) + tuple(
        f"-DPHIFEM_L3B_{k}={v}" for k, v in block_tile.items())


def tile_grid(D: int, R: int, C: int, dtype: torch.dtype, tile: dict = TILE) -> Tuple[int, int, int, dict]:
    """``(CTAs along x, along y, along z, shape)`` of the launch on the padded
    ``(D+2, R+2, C+2)`` array, ``shape`` the dtype's ``BX``, ``BY``, ``RX``,
    ``RZ``."""
    sfx = "_F64" if dtype == torch.float64 else "_F32"
    sh = {k: tile[k + sfx] for k in ("BX", "BY", "RX", "RZ")}
    cdiv = lambda a, b: -(-a // b)
    return cdiv(C + 2, sh["BX"] * sh["RX"]), cdiv(R + 2, sh["BY"]), cdiv(D + 2, sh["RZ"]), sh


def block_tile_grid(D: int, R: int, C: int, dtype: torch.dtype,
                    block_tile: dict = BLOCK_TILE) -> Tuple[int, int, int, dict]:
    """``(CTAs along x, along y, along z, shape)`` of the block kernel's
    launch: tiles of the logical interior's ``C - 2`` x ``R - 2`` x ``D - 2``
    nodes, at least one along each axis; ``shape`` the dtype's ``BX``,
    ``BY``, ``RZ``."""
    sfx = "_F64" if dtype == torch.float64 else "_F32"
    sh = {"BX": block_tile["BX"], "BY": block_tile["BY" + sfx], "RZ": block_tile["RZ" + sfx]}
    tiles = lambda n, t: -(-(n - 2) // t) if n - 2 > t else 1
    return tiles(C, sh["BX"]), tiles(R, sh["BY"]), tiles(D, sh["RZ"]), sh


def lattice3_sweep_ref(
    mode: int,
    x: torch.Tensor,
    terms: Sequence[Tuple[int, int, int, float]],
    b: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    scale: float = 0.0,
) -> torch.Tensor:
    """Plain PyTorch version on padded ``(D+2, R+2, C+2)`` arrays, by the
    shifted slices of :func:`~phifem_tpu_torch.ops.lattice3._conv_interior3`.
    ``mask``: logical ``(D, R, C)`` or None; ``scale``: the Jacobi factor
    ``omega / w_center``."""
    from .lattice3 import _conv_interior3

    D, R, C = (s - 2 for s in x.shape)
    ax = _conv_interior3(x, terms, D, R, C)
    if mode == MATVEC:
        val = ax
    else:
        val = b[2:D, 2:R, 2:C] - ax
        if mode == JACOBI:
            val = scale * val
        if mask is not None:
            val = val * mask[1 : D - 1, 1 : R - 1, 1 : C - 1]
        if mode == JACOBI:
            val = x[2:D, 2:R, 2:C] + val
    out = x.clone() if mode == JACOBI else torch.zeros_like(x)
    out[2:D, 2:R, 2:C] = val
    return out


class PackedTerms(tuple):
    """A stencil's terms with their kernel form: ``offs`` (n, 3) int32 and
    ``w`` (n,) float64 host arrays and their addresses (``offs_ptr``,
    ``w_ptr``), made once by :func:`pack_terms`."""

    offs: np.ndarray
    w: np.ndarray
    offs_ptr: int
    w_ptr: int


def pack_terms(terms: Sequence[Tuple[int, int, int, float]]) -> PackedTerms:
    """The terms as a tuple that also carries the kernel's host arrays.  The
    kernel walks the 27 positions in ascending ``(oz, oy, ox)``, the order of
    :func:`~phifem_tpu_torch.ops.lattice3._terms3`, so the terms must come in
    that order, each position once."""
    if not 1 <= len(terms) <= MAX_TERMS:
        raise ValueError(f"lattice3_sweep: 1 to {MAX_TERMS} terms, got {len(terms)}")
    p = PackedTerms(tuple((int(a), int(b), int(c), float(w)) for a, b, c, w in terms))
    p.offs = np.ascontiguousarray([t[:3] for t in p], dtype=np.int32)
    p.w = np.ascontiguousarray([t[3] for t in p], dtype=np.float64)
    if p.offs.min() < 0 or p.offs.max() > 2:
        raise ValueError("lattice3_sweep: term offsets must lie in {0, 1, 2}")
    pos = (p.offs[:, 0] * 3 + p.offs[:, 1]) * 3 + p.offs[:, 2]
    if (np.diff(pos) <= 0).any():
        raise ValueError("lattice3_sweep: terms must be in strictly ascending (oz, oy, ox) order")
    p.offs_ptr, p.w_ptr = p.offs.ctypes.data, p.w.ctypes.data
    return p


def lattice3_sweep(
    mode: int,
    x: torch.Tensor,
    terms: Sequence[Tuple[int, int, int, float]],
    b: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    scale: float = 0.0,
) -> torch.Tensor:
    """One sweep (see the module docstring) on padded ``(D+2, R+2, C+2)``
    arrays; returns a new array.  CPU tensors take the plain version; CUDA
    tensors the kernel, which takes float32 or float64, contiguous tensors
    on one card, ``b`` in modes ``RESIDUAL`` / ``JACOBI`` and the mask in
    x's dtype.  ``terms`` may be a :class:`PackedTerms` (what a cycle
    keeps per level) or any sequence of ``(oz, oy, ox, w)``."""
    global launches
    if mode not in (MATVEC, RESIDUAL, JACOBI):
        raise ValueError(f"lattice3_sweep: unknown mode {mode}")
    if mode != MATVEC and b is None:
        raise ValueError("lattice3_sweep: the residual and Jacobi modes need b")
    dev = x.device
    if dev.type == "cpu":
        return lattice3_sweep_ref(mode, x, terms, b, mask, scale)
    if dev.type != "cuda":
        raise ValueError(f"lattice3_sweep: no kernel for device {dev}")
    if not isinstance(terms, PackedTerms):
        terms = pack_terms(terms)
    dt = x.dtype
    if dt is not torch.float32 and dt is not torch.float64:
        raise TypeError(f"lattice3_sweep: x must be float32 or float64, got {dt}")
    shape = x.shape
    if len(shape) != 3 or min(shape) < 3 or not x.is_contiguous():
        raise ValueError(f"lattice3_sweep: x must be a contiguous padded 3D array, got {tuple(shape)}")
    if x.numel() >= 2**31:
        raise ValueError("lattice3_sweep: array too large for 32-bit indexing")
    D, R, C = shape[0] - 2, shape[1] - 2, shape[2] - 2
    bp = mp = None
    if mode != MATVEC:
        if b.shape != shape or b.dtype is not dt or b.device != dev or not b.is_contiguous():
            raise ValueError("lattice3_sweep: b must be contiguous and match x in shape, dtype and device")
        bp = b.data_ptr()
        if mask is not None:
            if mask.shape != (D, R, C) or mask.dtype is not dt or mask.device != dev or not mask.is_contiguous():
                raise ValueError(f"lattice3_sweep: the mask must be a contiguous {(D, R, C)} tensor in x's dtype "
                                 "on x's device")
            mp = mask.data_ptr()
    out = torch.empty_like(x)
    fn, raw_stream, current = _LAUNCH.get("phifem_lattice3_sweep") or _bind("phifem_lattice3_sweep")
    idx = dev.index
    args = (x.data_ptr(), bp, mp, out.data_ptr(), D, R, C, terms.offs_ptr, terms.w_ptr, len(terms), float(scale),
            mode, dt is torch.float64, raw_stream(idx))
    if idx == current():
        err = fn(*args)
    else:
        with torch.cuda.device(dev):
            err = fn(*args)
    if err:
        msg = _library().phifem_lattice3_error_string(err).decode()
        raise RuntimeError(f"lattice3_sweep kernel launch failed: CUDA error {err} ({msg})")
    launches += 1
    return out


class PackedBlockTerms(tuple):
    """A block stencil's terms ``(oz, oy, ox, W)`` (W a nested vsz x vsz
    list of floats) with their kernel form: ``offs`` (n, 3) int32, ``w``
    (n, vsz, vsz) float64 and the Jacobi block ``dinv`` (vsz, vsz) float64 or
    None, host arrays, and their addresses; made once by
    :func:`pack_block_terms`."""

    offs: np.ndarray
    w: np.ndarray
    dinv: Optional[np.ndarray]
    offs_ptr: int
    w_ptr: int
    dinv_ptr: Optional[int]
    vsz: int


def pack_block_terms(terms, dinv=None) -> PackedBlockTerms:
    """The block terms ``(oz, oy, ox, W)`` (W (vsz, vsz)), in strictly
    ascending ``(oz, oy, ox)``, each position once (the order of
    :func:`~phifem_tpu_torch.ops.lattice3._block_terms3`), and the Jacobi
    centre-block inverse ``dinv`` (vsz, vsz) or None."""
    if not 1 <= len(terms) <= MAX_TERMS:
        raise ValueError(f"lattice3_block_sweep: 1 to {MAX_TERMS} terms, got {len(terms)}")
    w = np.ascontiguousarray([np.asarray(t[3], np.float64) for t in terms])
    p = PackedBlockTerms(tuple((int(a), int(b), int(c), Wb.tolist()) for (a, b, c, _), Wb in zip(terms, w)))
    p.vsz = int(w.shape[1])
    if w.shape[1:] != (p.vsz, p.vsz):
        raise ValueError(f"lattice3_block_sweep: blocks must be square, got {w.shape[1:]}")
    p.offs = np.ascontiguousarray([t[:3] for t in p], dtype=np.int32)
    p.w = w
    if p.offs.min() < 0 or p.offs.max() > 2:
        raise ValueError("lattice3_block_sweep: term offsets must lie in {0, 1, 2}")
    pos = (p.offs[:, 0] * 3 + p.offs[:, 1]) * 3 + p.offs[:, 2]
    if (np.diff(pos) <= 0).any():
        raise ValueError("lattice3_block_sweep: terms must be in strictly ascending (oz, oy, ox) order")
    p.dinv = None if dinv is None else np.ascontiguousarray(np.asarray(dinv, np.float64).reshape(p.vsz, p.vsz))
    p.offs_ptr, p.w_ptr = p.offs.ctypes.data, p.w.ctypes.data
    p.dinv_ptr = None if p.dinv is None else p.dinv.ctypes.data
    return p


def lattice3_block_sweep_ref(
    mode: int,
    x: torch.Tensor,
    terms: PackedBlockTerms,
    b: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    omega: float = 0.0,
) -> torch.Tensor:
    """Plain PyTorch version on channels-first padded ``(vsz, D+2, R+2, C+2)``
    arrays, by the shifted slices of
    :func:`~phifem_tpu_torch.ops.lattice3._conv_interior3_block`; the Jacobi
    update ``omega * (Dinv (b - A x))``, then the mask, then ``x +``."""
    from .lattice3 import _conv_interior3_block

    D, R, C = (s - 2 for s in x.shape[1:])
    ax = _conv_interior3_block(x, terms, terms.w, D, R, C)
    m = None if mask is None else mask[1 : D - 1, 1 : R - 1, 1 : C - 1]
    out = x.clone() if mode == JACOBI else torch.zeros_like(x)
    if mode == MATVEC:
        out[:, 2:D, 2:R, 2:C] = ax
        return out
    res = b[:, 2:D, 2:R, 2:C] - ax
    vsz = x.shape[0]
    for i in range(vsz):
        if mode == RESIDUAL:
            v = res[i]
        else:
            dv = terms.dinv[i]
            d = float(dv[0]) * res[0]
            for j in range(1, vsz):
                d = d + float(dv[j]) * res[j]
            v = omega * d
        if m is not None:
            v = v * m
        out[i, 2:D, 2:R, 2:C] = x[i, 2:D, 2:R, 2:C] + v if mode == JACOBI else v
    return out


def lattice3_block_sweep(
    mode: int,
    x: torch.Tensor,
    terms: PackedBlockTerms,
    b: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    omega: float = 0.0,
) -> torch.Tensor:
    """One block sweep (see the module docstring) on channels-first padded
    ``(3, D+2, R+2, C+2)`` arrays; returns a new array.  ``terms`` from
    :func:`pack_block_terms` (with ``dinv`` in mode ``JACOBI``).  CPU tensors
    take the plain version; CUDA tensors the kernel, which takes float32 or
    float64, contiguous tensors on one card, ``b`` in modes ``RESIDUAL`` /
    ``JACOBI`` and the logical ``(D, R, C)`` mask in x's dtype."""
    global block_launches
    if mode not in (MATVEC, RESIDUAL, JACOBI):
        raise ValueError(f"lattice3_block_sweep: unknown mode {mode}")
    if mode != MATVEC and b is None:
        raise ValueError("lattice3_block_sweep: the residual and Jacobi modes need b")
    if mode == JACOBI and terms.dinv is None:
        raise ValueError("lattice3_block_sweep: the Jacobi mode needs the terms' dinv")
    dev = x.device
    if dev.type == "cpu":
        return lattice3_block_sweep_ref(mode, x, terms, b, mask, omega)
    if dev.type != "cuda":
        raise ValueError(f"lattice3_block_sweep: no kernel for device {dev}")
    dt = x.dtype
    if dt is not torch.float32 and dt is not torch.float64:
        raise TypeError(f"lattice3_block_sweep: x must be float32 or float64, got {dt}")
    shape = x.shape
    if len(shape) != 4 or shape[0] != VSZ or terms.vsz != VSZ or min(shape[1:]) < 3 or not x.is_contiguous():
        raise ValueError(f"lattice3_block_sweep: x must be a contiguous ({VSZ}, D+2, R+2, C+2) array with "
                         f"{VSZ} x {VSZ} blocks, got {tuple(shape)}")
    if x.numel() >= 2**31:
        raise ValueError("lattice3_block_sweep: array too large for 32-bit indexing")
    D, R, C = shape[1] - 2, shape[2] - 2, shape[3] - 2
    bp = mp = None
    if mode != MATVEC:
        if b.shape != shape or b.dtype is not dt or b.device != dev or not b.is_contiguous():
            raise ValueError("lattice3_block_sweep: b must be contiguous and match x in shape, dtype and device")
        bp = b.data_ptr()
        if mask is not None:
            if mask.shape != (D, R, C) or mask.dtype is not dt or mask.device != dev or not mask.is_contiguous():
                raise ValueError(f"lattice3_block_sweep: the mask must be a contiguous {(D, R, C)} tensor in x's "
                                 "dtype on x's device")
            mp = mask.data_ptr()
    out = torch.empty_like(x)
    fn, raw_stream, current = _LAUNCH.get("phifem_lattice3_block_sweep") or _bind("phifem_lattice3_block_sweep")
    idx = dev.index
    args = (x.data_ptr(), bp, mp, out.data_ptr(), D, R, C, terms.offs_ptr, terms.w_ptr, len(terms), terms.dinv_ptr,
            float(omega), mode, dt is torch.float64, raw_stream(idx))
    if idx == current():
        err = fn(*args)
    else:
        with torch.cuda.device(dev):
            err = fn(*args)
    if err:
        msg = _library().phifem_lattice3_error_string(err).decode()
        raise RuntimeError(f"lattice3_block_sweep kernel launch failed: CUDA error {err} ({msg})")
    block_launches += 1
    return out


#: C entry name -> (the entry point, current raw stream of a device, current
#: device), bound at the kernel's first launch so that a call reads no
#: attribute chain
_LAUNCH = {}


def _bind(entry: str):
    torch.cuda.init()
    _LAUNCH[entry] = (getattr(_library(), entry), torch._C._cuda_getCurrentRawStream, torch._C._cuda_getDevice)
    return _LAUNCH[entry]


def build() -> dict:
    """Compile the kernel library if it is not built yet (see
    :func:`phifem_tpu_torch.ops.nvcc_build.build`)."""
    return nvcc_build.build(SOURCE, defines())


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build()["path"])
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.phifem_lattice3_sweep.argtypes = [vp, vp, vp, vp, ci, ci, ci, vp, vp, ci, ctypes.c_double, ci, ci, vp]
    lib.phifem_lattice3_sweep.restype = ci
    lib.phifem_lattice3_block_sweep.argtypes = [vp, vp, vp, vp, ci, ci, ci, vp, vp, ci, vp, ctypes.c_double, ci, ci,
                                                vp]
    lib.phifem_lattice3_block_sweep.restype = ci
    lib.phifem_lattice3_error_string.argtypes = [ci]
    lib.phifem_lattice3_error_string.restype = ctypes.c_char_p
    got = (ctypes.c_int * 8)()
    lib.phifem_lattice3_constants(got)
    if tuple(got) != tuple(TILE.values()):
        raise RuntimeError(f"lattice3_sweep: the library's tile {tuple(got)} is not TILE {tuple(TILE.values())}")
    got = (ctypes.c_int * 7)()
    lib.phifem_lattice3_block_constants(got)
    if tuple(got) != tuple(BLOCK_TILE.values()):
        raise RuntimeError(f"lattice3_block_sweep: the library's tile {tuple(got)} is not BLOCK_TILE "
                           f"{tuple(BLOCK_TILE.values())}")
    return lib
