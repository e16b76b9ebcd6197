"""The P1 cell-stencil matvec: CUDA kernel wrapper and its plain version.

Replaces ``phifem_tpu/ops/pallas_stencil.py:stencil_matvec_pallas``.  The
kernel (``phifem_tpu_torch/csrc/stencil_matvec.cu``) is built with ``nvcc``
at first use (:mod:`phifem_tpu_torch.ops.nvcc_build`) and loaded with
``ctypes``.

:func:`stencil_matvec` dispatches on the tensor's device: a CPU tensor goes
to :func:`stencil_matvec_ref` (shifted slices), a CUDA tensor to the kernel,
and anything else raises.  There is no fallback from the card to the plain
version.  ``launches`` counts kernel launches, ``masked_launches`` those
of the masked body.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from ..grid import Grid
from . import nvcc_build
from .stencil import orientation_offsets

__all__ = ["stencil_matvec", "stencil_matvec_ref", "pack_matrices", "build"]

#: number of kernel launches made by :func:`stencil_matvec`
launches = 0
#: of those, launches of the masked body (``masks`` given)
masked_launches = 0

SOURCE = nvcc_build.PKG / "csrc" / "stencil_matvec.cu"


def stencil_matvec_ref(
    grid: Grid,
    x: torch.Tensor,
    masks: Optional[torch.Tensor],
    mats: torch.Tensor,
    y: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version: ``y += A x`` by shifted slices of the
    ``(ny+1, nx+1)`` lattice (``y`` updated in place; zeros when None).
    On any device; the matrices are read on the host."""
    ny, nx = grid.ny, grid.nx
    if y is None:
        y = torch.zeros_like(x)
    X = x.reshape(ny + 1, nx + 1)
    Y = y.view(ny + 1, nx + 1)
    A = mats.to(torch.float64).tolist()
    for o, offs in enumerate(orientation_offsets(grid)):
        xl = [X[dy : dy + ny, dx : dx + nx] for (dx, dy) in offs]
        for i, (dxi, dyi) in enumerate(offs):
            zi = sum(A[o][i][j] * xl[j] for j in range(len(offs)))
            if masks is not None:
                zi = masks[o].to(x.dtype) * zi
            Y[dyi : dyi + ny, dxi : dxi + nx] += zi
    return y


def pack_matrices(grid: Grid, mats: torch.Tensor) -> np.ndarray:
    """The kernel's form of ``mats``: a CPU ``(norient, nloc, nloc)``
    tensor as contiguous row-major float64.  A batch packs its matrices
    once, so a launch does no conversion."""
    no, nl = grid.num_orientations, grid.num_vertices_per_cell
    if tuple(mats.shape) != (no, nl, nl) or mats.device.type != "cpu":
        raise ValueError(
            f"stencil_matvec: mats must be a CPU tensor of shape {(no, nl, nl)}, "
            f"got {tuple(mats.shape)} on {mats.device}"
        )
    return np.ascontiguousarray(mats.to(torch.float64).numpy().reshape(-1))


def stencil_matvec(
    grid: Grid,
    x: torch.Tensor,
    masks: Optional[torch.Tensor],
    mats: torch.Tensor,
    y: Optional[torch.Tensor] = None,
    *,
    packed: Optional[np.ndarray] = None,
) -> torch.Tensor:
    """``y += A x`` for a uniform single-scalar-P1 term (``y`` updated in
    place; zeros when None).  Returns ``y``.

    x, y: ``(num_vertices,)``; masks: ``(norient, ny, nx)`` or None for a
    term covering every cell; mats: ``(norient, nloc, nloc)`` on the CPU,
    and ``packed`` its :func:`pack_matrices` form when the caller keeps one.
    CPU tensors take the plain version; CUDA tensors the kernel, which
    takes float32 or float64, contiguous tensors on one card, and masks in
    the dtype of x.
    """
    global launches, masked_launches
    if x.device.type == "cpu":
        return stencil_matvec_ref(grid, x, masks, mats, y)
    if x.device.type != "cuda":
        raise ValueError(f"stencil_matvec: no kernel for device {x.device}")
    if packed is None:
        packed = pack_matrices(grid, mats)
    if y is None:
        y = torch.zeros_like(x)
    _check(grid, x, masks, y)
    lib = _library()
    args = (
        x.data_ptr(),
        y.data_ptr(),
        None if masks is None else masks.data_ptr(),
        packed.ctypes.data,
        grid.nx,
        grid.ny,
        int(grid.is_simplex),
        int(x.dtype == torch.float64),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if x.device.index == torch.cuda.current_device():
        err = lib.phifem_stencil_matvec(*args)
    else:
        with torch.cuda.device(x.device):
            err = lib.phifem_stencil_matvec(*args)
    if err:
        msg = lib.phifem_cuda_error_string(err).decode()
        raise RuntimeError(f"stencil_matvec kernel launch failed: CUDA error {err} ({msg})")
    launches += 1
    masked_launches += masks is not None
    return y


def _check(grid: Grid, x, masks, y) -> None:
    """Raise on any vector or mask the kernel does not take."""
    nv = grid.num_vertices
    no = grid.num_orientations
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"stencil_matvec: x must be float32 or float64, got {x.dtype}")
    if tuple(x.shape) != (nv,) or tuple(y.shape) != (nv,):
        raise ValueError(
            f"stencil_matvec: x and y must have shape ({nv},), got "
            f"{tuple(x.shape)} and {tuple(y.shape)}"
        )
    if y.dtype != x.dtype or y.device != x.device:
        raise ValueError("stencil_matvec: y must match x in dtype and device")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("stencil_matvec: x and y must be contiguous")
    if x.data_ptr() == y.data_ptr():
        raise ValueError("stencil_matvec: x and y must not alias")
    if masks is not None:
        if tuple(masks.shape) != (no, grid.ny, grid.nx):
            raise ValueError(
                f"stencil_matvec: masks must have shape {(no, grid.ny, grid.nx)}, "
                f"got {tuple(masks.shape)}"
            )
        if masks.dtype != x.dtype or masks.device != x.device or not masks.is_contiguous():
            raise ValueError(
                "stencil_matvec: masks must be contiguous, on x's device, in x's dtype"
            )
    if max(nv, no * grid.ny * grid.nx) >= 2**31:
        raise ValueError("stencil_matvec: lattice too large for 32-bit indexing")


def build() -> dict:
    """Compile the kernel library if it is not built yet (see
    :func:`phifem_tpu_torch.ops.nvcc_build.build`)."""
    return nvcc_build.build(SOURCE)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build()["path"])
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.phifem_stencil_matvec.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, vp]
    lib.phifem_stencil_matvec.restype = ci
    lib.phifem_cuda_error_string.argtypes = [ci]
    lib.phifem_cuda_error_string.restype = ctypes.c_char_p
    return lib
