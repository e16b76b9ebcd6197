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
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import nvcc_build

__all__ = ["hex_stencil3", "hex_stencil3_ref", "hex_offsets", "build"]

#: number of kernel launches made by :func:`hex_stencil3`
launches = 0

SOURCE = nvcc_build.PKG / "csrc" / "hex_stencil3.cu"


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
    lib = _library()
    args = (x.data_ptr(), y.data_ptr(), mask.data_ptr(), A.data_ptr(), nx, ny, nz, degree,
            dt is torch.float64, torch._C._cuda_getCurrentRawStream(dev.index))
    if dev.index == torch.cuda.current_device():
        err = lib.phifem_hex_stencil3(*args)
    else:
        with torch.cuda.device(dev):
            err = lib.phifem_hex_stencil3(*args)
    if err:
        msg = lib.phifem_hex3_error_string(err).decode()
        raise RuntimeError(f"hex_stencil3 kernel launch failed: CUDA error {err} ({msg})")
    launches += 1
    return y


def build() -> dict:
    """Compile the kernel library if it is not built yet (see
    :func:`phifem_tpu_torch.ops.nvcc_build.build`)."""
    return nvcc_build.build(SOURCE)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build()["path"])
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.phifem_hex_stencil3.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, vp]
    lib.phifem_hex_stencil3.restype = ci
    lib.phifem_hex3_error_string.argtypes = [ci]
    lib.phifem_hex3_error_string.restype = ctypes.c_char_p
    return lib
