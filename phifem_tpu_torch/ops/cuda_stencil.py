"""The P1 cell-stencil matvec: CUDA kernel wrapper and its plain version.

Replaces ``phifem_tpu/ops/pallas_stencil.py:stencil_matvec_pallas``.  The
kernel (``phifem_tpu_torch/csrc/stencil_matvec.cu``) is built with ``nvcc``
at first use (:mod:`phifem_tpu_torch.ops.nvcc_build`) and loaded with
``ctypes``.

:func:`stencil_matvec` dispatches on the tensor's device: a CPU tensor goes
to :func:`stencil_matvec_ref` (shifted slices), a CUDA tensor to the kernel,
and anything else raises.  There is no fallback from the card to the plain
version.  ``launches`` counts kernel launches, ``masked_launches`` those
of the masked body, ``shape_launches`` the launches per lattice shape.
What a launch needs of the grid and the matrices is made once per batch
(:class:`PackedMatrices`), so a call costs the host little more than the
checks of x, y and the masks and the launch itself.

The kernel gives each thread one lattice column and a vertical run of
``ROWS[dtype]`` rows, and each CTA a tile of ``BLOCK[0]`` columns by
``BLOCK[1] * ROWS[dtype]`` rows; tiles that touch no lattice edge run a
body without bounds checks.  :func:`tile_grid` and :func:`tile_is_interior`
mirror the kernel's launch geometry and that choice for the tests.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..grid import Grid
from . import nvcc_build
from .stencil import orientation_offsets

__all__ = ["stencil_matvec", "stencil_matvec_ref", "pack_matrices", "tile_grid", "tile_is_interior", "build"]

#: number of kernel launches made by :func:`stencil_matvec`
launches = 0
#: of those, launches of the masked body (``masks`` given)
masked_launches = 0
#: launches per lattice shape ``(ny + 1, nx + 1)``
shape_launches: collections.Counter = collections.Counter()

SOURCE = nvcc_build.PKG / "csrc" / "stencil_matvec.cu"
# the kernel's compile-time tile shape; _library() checks it against the
# built kernel's (phifem_stencil_constants)
BLOCK = (128, 2)  # (kBX, kBY): threads of a CTA along a lattice row, thread rows
ROWS = {torch.float32: 8, torch.float64: 2}  # consecutive lattice rows per thread


def tile_grid(nx: int, ny: int, dtype: torch.dtype) -> Tuple[int, int, int, int]:
    """``(tiles_y, tiles_x, tile_rows, tile_cols)`` of the kernel's launch on
    the ``(ny+1, nx+1)`` lattice: tile ``(ty, tx)`` is the CTA that computes
    rows ``ty * tile_rows ...`` and columns ``tx * tile_cols ...``."""
    tr, tc = BLOCK[1] * ROWS[dtype], BLOCK[0]
    return (ny + tr) // tr, (nx + tc) // tc, tr, tc


def tile_is_interior(ty: int, tx: int, nx: int, ny: int, dtype: torch.dtype) -> bool:
    """Whether every output of tile ``(ty, tx)`` lies in rows ``1 .. ny-1``
    and columns ``1 .. nx-1``: the kernel then checks no bound."""
    _, _, tr, tc = tile_grid(nx, ny, dtype)
    return tx * tc >= 1 and (tx + 1) * tc <= nx and ty * tr >= 1 and (ty + 1) * tr <= ny


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


class PackedMatrices(np.ndarray):
    """A batch's matrices in the kernel's form, contiguous row-major
    float64, with the launch arguments that are fixed for the batch in
    ``static``: the address of the numbers, nx, ny, the triangle flag, the
    number of vertices and whether the lattice fits 32-bit indexing.  Only
    :func:`pack_matrices` sets ``static``; an array derived from this one
    (a slice, a copy) has none."""

    static: Optional[tuple]

    def __array_finalize__(self, obj):
        self.static = None


def pack_matrices(grid: Grid, mats: torch.Tensor) -> PackedMatrices:
    """The kernel's form of ``mats``: a CPU ``(norient, nloc, nloc)``
    tensor as contiguous row-major float64.  A batch packs its matrices
    once, so a launch converts nothing and looks up nothing of the grid."""
    no, nl = grid.num_orientations, grid.num_vertices_per_cell
    if tuple(mats.shape) != (no, nl, nl) or mats.device.type != "cpu":
        raise ValueError(
            f"stencil_matvec: mats must be a CPU tensor of shape {(no, nl, nl)}, "
            f"got {tuple(mats.shape)} on {mats.device}"
        )
    packed = np.ascontiguousarray(mats.to(torch.float64).numpy().reshape(-1)).view(PackedMatrices)
    # an edge tile forms (and never uses) indices up to one tile past the lattice
    fits = no * (grid.ny + 1 + BLOCK[1] * max(ROWS.values())) * (grid.nx + 1 + BLOCK[0]) < 2**31
    packed.static = (packed.ctypes.data, grid.nx, grid.ny, int(grid.is_simplex), grid.num_vertices, fits)
    return packed


def stencil_matvec(
    grid: Grid,
    x: torch.Tensor,
    masks: Optional[torch.Tensor],
    mats: torch.Tensor,
    y: Optional[torch.Tensor] = None,
    *,
    packed: Optional[PackedMatrices] = None,
) -> torch.Tensor:
    """``y += A x`` for a uniform single-scalar-P1 term (``y`` updated in
    place; zeros when None).  Returns ``y``.

    x, y: ``(num_vertices,)``; masks: ``(norient, ny, nx)`` or None for a
    term covering every cell; mats: ``(norient, nloc, nloc)`` on the CPU,
    and ``packed`` its :func:`pack_matrices` form when the caller keeps one.
    CPU tensors take the plain version; CUDA tensors the kernel, which
    takes float32 or float64, contiguous tensors on one card, and masks in
    the dtype of x.  A call checks x, y and the masks and reads the current
    stream; everything else of the launch comes from ``packed.static``.
    """
    global launches, masked_launches
    dev = x.device
    if dev.type == "cpu":
        return stencil_matvec_ref(grid, x, masks, mats, y)
    if dev.type != "cuda":
        raise ValueError(f"stencil_matvec: no kernel for device {dev}")
    if packed is None or packed.static is None:
        packed = pack_matrices(grid, mats)
    if y is None:
        y = torch.zeros_like(x)
    ptr, nx, ny, tri, nv, fits = packed.static
    dt = x.dtype
    if dt is not torch.float32 and dt is not torch.float64:
        raise TypeError(f"stencil_matvec: x must be float32 or float64, got {dt}")
    if x.shape != (nv,) or y.shape != (nv,):
        raise ValueError(
            f"stencil_matvec: x and y must have shape ({nv},), got {tuple(x.shape)} and {tuple(y.shape)}")
    if y.dtype is not dt or y.device != dev:
        raise ValueError("stencil_matvec: y must match x in dtype and device")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("stencil_matvec: x and y must be contiguous")
    xp, yp, mp = x.data_ptr(), y.data_ptr(), None
    if xp == yp:
        raise ValueError("stencil_matvec: x and y must not alias")
    if masks is not None:
        if masks.shape != (1 + tri, ny, nx):
            raise ValueError(
                f"stencil_matvec: masks must have shape {(1 + tri, ny, nx)}, got {tuple(masks.shape)}")
        if masks.dtype is not dt or masks.device != dev or not masks.is_contiguous():
            raise ValueError("stencil_matvec: masks must be contiguous, on x's device, in x's dtype")
        mp = masks.data_ptr()
    if not fits:
        raise ValueError("stencil_matvec: lattice too large for 32-bit indexing")
    lib = _library()
    # the raw handle of torch.cuda.current_stream(dev), without building a Stream object
    args = (xp, yp, mp, ptr, nx, ny, tri, dt is torch.float64, torch._C._cuda_getCurrentRawStream(dev.index))
    if dev.index == torch.cuda.current_device():
        err = lib.phifem_stencil_matvec(*args)
    else:
        with torch.cuda.device(dev):
            err = lib.phifem_stencil_matvec(*args)
    if err:
        msg = lib.phifem_cuda_error_string(err).decode()
        raise RuntimeError(f"stencil_matvec kernel launch failed: CUDA error {err} ({msg})")
    launches += 1
    masked_launches += masks is not None
    shape_launches[ny + 1, nx + 1] += 1
    return y


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
    got = (ctypes.c_int * 4)()
    lib.phifem_stencil_constants(got)
    want = (*BLOCK, ROWS[torch.float32], ROWS[torch.float64])
    if tuple(got) != want:
        raise RuntimeError(f"{SOURCE.name} is built for (kBX, kBY, rows f32, rows f64) = {tuple(got)}, "
                           f"the wrapper mirrors {want}")
    return lib
