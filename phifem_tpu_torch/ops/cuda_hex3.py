"""The masked hex-cell stencil of the 3D lattice schemes: CUDA kernel
wrapper and its plain version.

Replaces the XLA-fused ``_masked_stencil_apply`` of
``phifem_tpu/models/weak_dirichlet3.py`` (and its twin in ``neumann3.py``):
``y[n] = sum over cells c containing n of mask[c] * sum_j A[i(n,c), j]
x[node(c, j)]`` on the degree-d node lattice ``(d nz + 1, d ny + 1,
d nx + 1)``, d = 1, 2, 3.  The kernel (``phifem_tpu_torch/csrc/
hex_stencil3.cu``) is built with ``nvcc`` at first use
(:mod:`phifem_tpu_torch.ops.nvcc_build`) and loaded with ``ctypes``.

:func:`hex_stencil3` dispatches on the tensor's device: a CPU tensor goes to
:func:`hex_stencil3_ref` (stride-d shifted slices, as the JAX package), a
CUDA tensor to the kernel, anything else raises; there is no fallback from
the card to the plain version.  ``launches`` counts kernel launches.

:func:`hex_block_stencil3` is the 3-channel block form of the degree-1
stencil (``phifem_tpu/models/interface_elasticity3.py:122``,
``_masked_block_stencil_apply``): a (24, 24) channel-major cell matrix on a
channels-first ``(3, D, R, C)`` field, the same source's second kernel;
``block_launches`` counts its launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import nvcc_build

__all__ = ["hex_stencil3", "hex_stencil3_ref", "hex_block_stencil3", "hex_block_stencil3_ref", "hex_offsets", "build"]

#: number of kernel launches made by :func:`hex_stencil3`
launches = 0
#: number of kernel launches made by :func:`hex_block_stencil3`
block_launches = 0
#: device index -> the raw stream of the first :func:`hex_block_stencil3`
#: launch there: the kernel's cell matrix lives in one constant array per
#: device, so every launch must be ordered on that stream
_block_stream = {}

SOURCE = nvcc_build.PKG / "csrc" / "hex_stencil3.cu"

#: the kernels' tilings, passed to nvcc as -D defines (see the source's
#: note).  d = 1: a CTA of ``BX1`` x ``BY1`` threads, each one (x, y) node
#: column and a run of ``RZ1[dtype]`` nodes in each of the ``ZCH1`` blocks its
#: CTA marches over along z (``MB1`` CTAs per SM bound its registers).  d = 2, 3: a CTA of
#: ``NT<d>`` threads (``MB<d>`` CTAs per SM bound its registers) owns a tile of
#: ``TC<d>``^3 cells, and a thread computes the row dots of ``ROWS[d]`` rows by
#: ``KC`` cells at a time
TILE = {"BX1": 16, "BY1": 8, "RZ1_F32": 4, "RZ1_F64": 2, "ZCH1": 4, "TC2": 4, "TC3": 4, "NT2": 128, "NT3": 512, "KC": 4,
        "MB2": 2, "MB3": 1, "MB1": 4}
ROWS = {2: 3, 3: 4}
#: the block kernel's tiling: a CTA of ``BX`` x ``BY`` threads, each a node
#: column and a run of ``RZ`` nodes along z, for all three output channels
#: or, with ``SPLIT`` (per value type), one (three CTAs per tile)
BLOCK_TILE = {"BX": 16, "BY": 8, "RZ": 4, "SPLIT_F32": 0, "SPLIT_F64": 1}
#: channels of the block kernel's field
VSZ = 3


def defines(tile: dict = TILE, block_tile: dict = BLOCK_TILE) -> tuple:
    """The ``-DPHIFEM_HEX3_*`` / ``-DPHIFEM_HEX3B_*`` flags of the tilings."""
    return tuple(f"-DPHIFEM_HEX3_{k}={v}" for k, v in tile.items()) + tuple(
        f"-DPHIFEM_HEX3B_{k}={v}" for k, v in block_tile.items())


def hex_offsets(degree: int):
    """Local node offsets ``(ox, oy, oz)`` of the Q_degree hex, x fastest."""
    r = range(degree + 1)
    return tuple((ox, oy, oz) for oz in r for oy in r for ox in r)


def hex_stencil3_ref(x: torch.Tensor, mask: torch.Tensor, A: torch.Tensor, degree: int) -> torch.Tensor:
    """Plain PyTorch version: ``x`` the ``(D, R, C)`` node lattice, ``mask``
    the ``(nz, ny, nx)`` cells, ``A`` the ``(nloc, nloc)`` cell matrix (read
    on the host).  Returns a new ``(D, R, C)`` tensor."""
    nz, ny, nx = mask.shape
    d = degree
    offs = hex_offsets(d)
    Am = A.to(torch.float64).tolist()
    Y = torch.zeros_like(x)
    xl = [x[oz : oz + d * nz : d, oy : oy + d * ny : d, ox : ox + d * nx : d] for (ox, oy, oz) in offs]
    for i, (oxi, oyi, ozi) in enumerate(offs):
        zi = sum(Am[i][j] * xl[j] for j in range(len(offs)))
        Y[ozi : ozi + d * nz : d, oyi : oyi + d * ny : d, oxi : oxi + d * nx : d] += mask * zi
    return Y


def hex_stencil3(x: torch.Tensor, mask: torch.Tensor, A: torch.Tensor, degree: int) -> torch.Tensor:
    """``y = A x`` over the cells of ``mask`` on the degree-``degree`` node
    lattice; returns a new ``(D, R, C)`` tensor.  CPU tensors take the plain
    version; CUDA tensors the kernel, which takes float32 or float64 and
    contiguous ``x``, ``mask`` and ``A`` on one card in one dtype."""
    global launches
    dev = x.device
    if dev.type == "cpu":
        return hex_stencil3_ref(x, mask, A, degree)
    if dev.type != "cuda":
        raise ValueError(f"hex_stencil3: no kernel for device {dev}")
    if degree not in (1, 2, 3):
        raise ValueError(f"hex_stencil3: degree must be 1, 2 or 3, got {degree}")
    dt = x.dtype
    if dt is not torch.float32 and dt is not torch.float64:
        raise TypeError(f"hex_stencil3: x must be float32 or float64, got {dt}")
    if mask.dim() != 3:
        raise ValueError(f"hex_stencil3: mask must be (nz, ny, nx), got {tuple(mask.shape)}")
    nz, ny, nx = mask.shape
    shape = (degree * nz + 1, degree * ny + 1, degree * nx + 1)
    nloc = (degree + 1) ** 3
    if tuple(x.shape) != shape or not x.is_contiguous():
        raise ValueError(f"hex_stencil3: x must be a contiguous {shape} tensor, got {tuple(x.shape)}")
    for name, t, sh in (("mask", mask, (nz, ny, nx)), ("A", A, (nloc, nloc))):
        if tuple(t.shape) != sh or t.dtype is not dt or t.device != dev or not t.is_contiguous():
            raise ValueError(f"hex_stencil3: {name} must be a contiguous {sh} tensor in x's dtype on x's device")
    if x.numel() >= 2**31:
        raise ValueError("hex_stencil3: lattice too large for 32-bit indexing")
    y = torch.empty_like(x)
    fn, raw_stream, current = _LAUNCH.get("phifem_hex_stencil3") or _bind("phifem_hex_stencil3")
    idx = dev.index
    args = (x.data_ptr(), y.data_ptr(), mask.data_ptr(), A.data_ptr(), nx, ny, nz, degree,
            dt is torch.float64, raw_stream(idx))
    if idx == current():
        err = fn(*args)
    else:
        with torch.cuda.device(dev):
            err = fn(*args)
    if err:
        msg = _library().phifem_hex3_error_string(err).decode()
        raise RuntimeError(f"hex_stencil3 kernel launch failed: CUDA error {err} ({msg})")
    launches += 1
    return y


def hex_block_stencil3_ref(x: torch.Tensor, mask: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the block stencil: ``x`` the channels-first
    ``(vsz, D, R, C)`` Q1 field, ``mask`` the ``(nz, ny, nx)`` cells, ``K``
    the ``(8 vsz, 8 vsz)`` channel-major cell matrix (local dof ``8 c + i``;
    read on the host).  Per output channel and local node i the row dot sums
    ascending ``(c', j)``, and each node adds its cells in ascending i, the
    order of the JAX package's slice loop.  Returns a new tensor."""
    nz, ny, nx = mask.shape
    vsz = x.shape[0]
    offs = hex_offsets(1)
    Km = K.to(torch.float64).tolist()
    Y = torch.zeros_like(x)
    xl = [[x[c, oz : oz + nz, oy : oy + ny, ox : ox + nx] for (ox, oy, oz) in offs] for c in range(vsz)]
    for ci in range(vsz):
        for i, (ox, oy, oz) in enumerate(offs):
            zi = sum(Km[8 * ci + i][8 * cj + j] * xl[cj][j] for cj in range(vsz) for j in range(8))
            Y[ci, oz : oz + nz, oy : oy + ny, ox : ox + nx] += mask * zi
    return Y


def hex_block_stencil3(x: torch.Tensor, mask: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """``y = K x`` over the cells of ``mask`` for a channels-first
    ``(3, D, R, C)`` Q1 field; returns a new tensor.  CPU tensors take the
    plain version; CUDA tensors the kernel, which takes float32 or float64
    and contiguous ``x``, ``mask`` and ``K`` (24, 24) on one card in one
    dtype.  Each launch first copies ``K`` into a constant array that is one
    per device, on the launch's stream; so every launch on a device must be
    on one stream (the current stream of the first), and a launch on
    another raises rather than race a concurrent one for the array."""
    global block_launches
    dev = x.device
    if dev.type == "cpu":
        return hex_block_stencil3_ref(x, mask, K)
    if dev.type != "cuda":
        raise ValueError(f"hex_block_stencil3: no kernel for device {dev}")
    dt = x.dtype
    if dt is not torch.float32 and dt is not torch.float64:
        raise TypeError(f"hex_block_stencil3: x must be float32 or float64, got {dt}")
    if mask.dim() != 3:
        raise ValueError(f"hex_block_stencil3: mask must be (nz, ny, nx), got {tuple(mask.shape)}")
    nz, ny, nx = mask.shape
    shape = (VSZ, nz + 1, ny + 1, nx + 1)
    if tuple(x.shape) != shape or not x.is_contiguous():
        raise ValueError(f"hex_block_stencil3: x must be a contiguous {shape} tensor, got {tuple(x.shape)}")
    for name, t, sh in (("mask", mask, (nz, ny, nx)), ("K", K, (8 * VSZ, 8 * VSZ))):
        if tuple(t.shape) != sh or t.dtype is not dt or t.device != dev or not t.is_contiguous():
            raise ValueError(f"hex_block_stencil3: {name} must be a contiguous {sh} tensor in x's dtype on x's device")
    y = torch.empty_like(x)
    fn, raw_stream, current = _LAUNCH.get("phifem_hex_block_stencil3") or _bind("phifem_hex_block_stencil3")
    idx = dev.index
    stream = raw_stream(idx)
    if _block_stream.setdefault(idx, stream) != stream:
        raise RuntimeError(f"hex_block_stencil3: launched on stream {stream:#x} of cuda:{idx} after stream "
                           f"{_block_stream[idx]:#x}; its cell matrix lives in one constant array per device, "
                           "so its launches must stay on one stream")
    args = (x.data_ptr(), y.data_ptr(), mask.data_ptr(), K.data_ptr(), nx, ny, nz, dt is torch.float64, stream)
    if idx == current():
        err = fn(*args)
    else:
        with torch.cuda.device(dev):
            err = fn(*args)
    if err:
        msg = _library().phifem_hex3_error_string(err).decode()
        raise RuntimeError(f"hex_block_stencil3 kernel launch failed: CUDA error {err} ({msg})")
    block_launches += 1
    return y


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
    lib.phifem_hex_stencil3.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, vp]
    lib.phifem_hex_stencil3.restype = ci
    lib.phifem_hex_block_stencil3.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, vp]
    lib.phifem_hex_block_stencil3.restype = ci
    lib.phifem_hex3_error_string.argtypes = [ci]
    lib.phifem_hex3_error_string.restype = ctypes.c_char_p
    got = (ctypes.c_int * 13)()
    lib.phifem_hex3_constants(got)
    if tuple(got) != tuple(TILE.values()):
        raise RuntimeError(f"hex_stencil3: the library's tiling {tuple(got)} is not TILE {tuple(TILE.values())}")
    got = (ctypes.c_int * 5)()
    lib.phifem_hexblock_constants(got)
    if tuple(got) != tuple(BLOCK_TILE.values()):
        raise RuntimeError(f"hex_block_stencil3: the library's tiling {tuple(got)} is not BLOCK_TILE "
                           f"{tuple(BLOCK_TILE.values())}")
    return lib
