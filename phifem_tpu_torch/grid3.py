"""Structured 3D hexahedral background grid (z-axis extension of the 2D grid).

Counterpart of :mod:`phifem_tpu.grid3`.  All connectivity is closed-form
index arithmetic; vertex coordinates are built on the grid's device from
aranges, ``x0 + h * arange`` exactly as the JAX package computes them (the
tags depend on the rounding of these coordinates).

Vertex raveling: ``index = (z * (ny+1) + y) * (nx+1) + x``, the
``(nz+1, ny+1, nx+1)`` lattice, x fastest (as :mod:`.ops.lattice3`).  Cells
ravel likewise with the cell counts.  ``device`` and ``dtype`` place every
tensor built from the grid (default the card and float64; pass
``device="cpu"`` for the CPU).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple, Union

import numpy as np
import torch

__all__ = ["Grid3"]


@dataclasses.dataclass(frozen=True)
class Grid3:
    """``nx x ny x nz`` hexahedral cells over an axis-aligned box."""

    nx: int
    ny: int
    nz: int
    bbox: Tuple[Tuple[float, float, float], Tuple[float, float, float]] = (
        (0.0, 0.0, 0.0),
        (1.0, 1.0, 1.0),
    )
    device: Union[str, torch.device] = "cuda"
    dtype: torch.dtype = torch.float64

    def __post_init__(self):
        object.__setattr__(self, "device", torch.device(self.device))
        if self.dtype not in (torch.float32, torch.float64):
            raise ValueError(f"Grid3 dtype must be float32 or float64, got {self.dtype}.")

    @property
    def spacing(self) -> Tuple[float, float, float]:
        (x0, y0, z0), (x1, y1, z1) = self.bbox
        return ((x1 - x0) / self.nx, (y1 - y0) / self.ny, (z1 - z0) / self.nz)

    @property
    def lattice_shape(self) -> Tuple[int, int, int]:
        return (self.nz + 1, self.ny + 1, self.nx + 1)

    @property
    def num_vertices(self) -> int:
        return (self.nx + 1) * (self.ny + 1) * (self.nz + 1)

    @property
    def num_cells(self) -> int:
        return self.nx * self.ny * self.nz

    def vertex_coords_lattice(self, dtype=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Per-axis coordinate lattices, broadcastable ``(D, R, C)`` aranges
        on the grid's device (combine as needed; no (N, 3) table)."""
        dt = self.dtype if dtype is None else dtype
        (x0, y0, z0), _ = self.bbox
        hx, hy, hz = self.spacing
        D, R, C = self.lattice_shape
        kw = dict(dtype=dt, device=self.device)
        z = z0 + hz * torch.arange(D, **kw)[:, None, None]
        y = y0 + hy * torch.arange(R, **kw)[None, :, None]
        x = x0 + hx * torch.arange(C, **kw)[None, None, :]
        return x, y, z

    def eval_at_vertices(self, fn: Callable, dtype=None) -> torch.Tensor:
        """``fn((..., 3) coords) -> (...)`` on the whole vertex lattice,
        returned in lattice shape ``(D, R, C)``."""
        x, y, z = self.vertex_coords_lattice(dtype)
        shape = self.lattice_shape
        pts = torch.stack([x.expand(shape), y.expand(shape), z.expand(shape)], dim=-1)
        return fn(pts)

    def refine(self) -> "Grid3":
        """Uniform refinement (same box, device and dtype)."""
        return dataclasses.replace(self, nx=2 * self.nx, ny=2 * self.ny, nz=2 * self.nz)

    def boundary_mask_lattice(self) -> np.ndarray:
        """(D, R, C) bool: True on the box-boundary shell (Dirichlet)."""
        m = np.zeros(self.lattice_shape, bool)
        m[0], m[-1] = True, True
        m[:, 0], m[:, -1] = True, True
        m[:, :, 0], m[:, :, -1] = True, True
        return m
