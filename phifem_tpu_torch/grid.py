"""Structured Cartesian background grids for phi-FEM, in PyTorch.

Counterpart of :mod:`phifem_tpu.grid`.  phi-FEM solves PDEs on a simple
*background* mesh that does not fit the physical boundary; on a structured
grid every connectivity query is closed-form index arithmetic, and all
entity counts are static functions of ``(nx, ny, cell_type)``.

Connectivity/geometry *tables* (the ``*_np`` maps) are host-side numpy,
unchanged from the JAX package.  The tensor properties live on
``grid.device`` in ``grid.dtype``; the grid owns its device and dtype
explicitly and never touches torch's global defaults.

Entity numbering (the JAX package's convention):

* cells: a block ``(ix, iy)`` (``ix`` fastest) is one quadrilateral cell, or
  two triangles (``lower`` = 2*block, ``upper`` = 2*block+1).  The lower
  triangle is ``(v00, v10, v11)`` and the upper ``(v00, v11, v01)``.
* vertices: ``v(ix, iy) = iy*(nx+1) + ix`` with ``ix in [0, nx]``.
* facets: vertical facets first (``(nx+1)*ny``), then horizontal
  (``nx*(ny+1)``), then (triangles only) diagonal (``nx*ny``).

Each facet stores its two adjacent cells as ``(cell_minus, cell_plus)`` and
a *base* unit normal pointing from minus to plus (``+x`` vertical, ``+y``
horizontal, ``(-hy, hx)/l`` diagonal); a missing neighbour is ``-1``.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from functools import cached_property
from typing import Tuple, Union

import numpy as np
import torch

__all__ = ["CellType", "Grid"]


class CellType(str, enum.Enum):
    """Cell type of the background grid."""

    triangle = "triangle"
    quadrilateral = "quadrilateral"


def _as_cell_type(cell_type) -> CellType:
    if isinstance(cell_type, CellType):
        return cell_type
    return CellType(str(cell_type))


@dataclasses.dataclass(frozen=True)
class Grid:
    """A uniform rectangular background grid on ``bbox`` with ``nx * ny``
    blocks.  ``device``/``dtype`` place every tensor built from it (default
    CPU, float64); the host ``*_np`` tables use the matching numpy float."""

    nx: int
    ny: int
    bbox: Tuple[Tuple[float, float], Tuple[float, float]] = ((0.0, 0.0), (1.0, 1.0))
    cell_type: CellType = CellType.triangle
    device: Union[str, torch.device] = "cpu"
    dtype: torch.dtype = torch.float64

    def __post_init__(self):
        object.__setattr__(self, "cell_type", _as_cell_type(self.cell_type))
        object.__setattr__(self, "device", torch.device(self.device))
        if self.dtype not in (torch.float32, torch.float64):
            raise ValueError(f"Grid dtype must be float32 or float64, got {self.dtype}.")
        if self.nx < 1 or self.ny < 1:
            raise ValueError("Grid needs nx >= 1 and ny >= 1.")
        (x0, y0), (x1, y1) = self.bbox
        if not (x1 > x0 and y1 > y0):
            raise ValueError("bbox must be ((x0, y0), (x1, y1)) with x1 > x0, y1 > y0.")

    # ------------------------------------------------------------------ sizes
    @property
    def is_simplex(self) -> bool:
        return self.cell_type == CellType.triangle

    @property
    def cells_per_block(self) -> int:
        return 2 if self.is_simplex else 1

    @property
    def num_blocks(self) -> int:
        return self.nx * self.ny

    @property
    def num_cells(self) -> int:
        return self.cells_per_block * self.num_blocks

    @property
    def num_vertices(self) -> int:
        return (self.nx + 1) * (self.ny + 1)

    @property
    def num_vfacets(self) -> int:
        return (self.nx + 1) * self.ny

    @property
    def num_hfacets(self) -> int:
        return self.nx * (self.ny + 1)

    @property
    def num_dfacets(self) -> int:
        return self.nx * self.ny if self.is_simplex else 0

    @property
    def num_facets(self) -> int:
        return self.num_vfacets + self.num_hfacets + self.num_dfacets

    @property
    def num_vertices_per_cell(self) -> int:
        return 3 if self.is_simplex else 4

    @property
    def num_facets_per_cell(self) -> int:
        return 3 if self.is_simplex else 4

    @property
    def num_orientations(self) -> int:
        return 2 if self.is_simplex else 1

    # --------------------------------------------------------------- geometry
    @property
    def x0(self) -> float:
        return float(self.bbox[0][0])

    @property
    def y0(self) -> float:
        return float(self.bbox[0][1])

    @property
    def hx(self) -> float:
        return (float(self.bbox[1][0]) - float(self.bbox[0][0])) / self.nx

    @property
    def hy(self) -> float:
        return (float(self.bbox[1][1]) - float(self.bbox[0][1])) / self.ny

    @property
    def cell_volume(self) -> float:
        """Area of one cell (uniform across the grid)."""
        a = self.hx * self.hy
        return a / 2.0 if self.is_simplex else a

    @property
    def cell_diameter(self) -> float:
        """UFL ``CellDiameter`` analogue (largest vertex distance), uniform."""
        return math.hypot(self.hx, self.hy)

    @property
    def diag_length(self) -> float:
        return math.hypot(self.hx, self.hy)

    def refine(self) -> "Grid":
        """Uniform refinement: halve h (same device and dtype)."""
        return dataclasses.replace(self, nx=self.nx * 2, ny=self.ny * 2)

    @property
    def _np_float(self):
        return np.float64 if self.dtype == torch.float64 else np.float32

    def _tensor(self, a) -> torch.Tensor:
        """Host table -> tensor on the grid's device (floats in its dtype)."""
        t = torch.tensor(np.asarray(a))  # a copy: host tables may be read-only
        if t.is_floating_point():
            t = t.to(self.dtype)
        return t.to(self.device)

    # --------------------------------------------- numpy index arithmetic
    def _block_ij_np(self, cells: np.ndarray):
        if self.is_simplex:
            block, which = cells // 2, cells % 2
        else:
            block, which = cells, np.zeros_like(cells)
        return block % self.nx, block // self.nx, which

    def _vid(self, ix, iy):
        return iy * (self.nx + 1) + ix

    def _vf(self, ix, iy):
        return iy * (self.nx + 1) + ix

    def _hf(self, ix, iy):
        return self.num_vfacets + iy * self.nx + ix

    def _df(self, ix, iy):
        return self.num_vfacets + self.num_hfacets + iy * self.nx + ix

    # ----------------------------------------------------- host-side tables
    @cached_property
    def vertex_coords_np(self) -> np.ndarray:
        ft = self._np_float
        ii = np.arange(self.num_vertices, dtype=np.int64)
        ix, iy = ii % (self.nx + 1), ii // (self.nx + 1)
        return np.stack(
            [self.x0 + ix.astype(ft) * ft(self.hx), self.y0 + iy.astype(ft) * ft(self.hy)],
            axis=-1,
        ).astype(ft)

    def cell_vertices_of_np(self, cells) -> np.ndarray:
        """(len(cells), nv) int64 vertex ids of the given cells, closed
        form (the rows of ``cell_vertices_np``)."""
        cells = np.asarray(cells, dtype=np.int64)
        ix, iy, which = self._block_ij_np(cells)
        v00 = self._vid(ix, iy)
        v10 = self._vid(ix + 1, iy)
        v01 = self._vid(ix, iy + 1)
        v11 = self._vid(ix + 1, iy + 1)
        if self.is_simplex:
            lower = np.stack([v00, v10, v11], axis=-1)
            upper = np.stack([v00, v11, v01], axis=-1)
            return np.where(which[:, None] == 0, lower, upper)
        return np.stack([v00, v10, v01, v11], axis=-1)

    @cached_property
    def cell_vertices_np(self) -> np.ndarray:
        return self.cell_vertices_of_np(np.arange(self.num_cells)).astype(np.int32)

    @cached_property
    def cell_orientations_np(self) -> np.ndarray:
        cells = np.arange(self.num_cells, dtype=np.int64)
        return (cells % 2 if self.is_simplex else np.zeros_like(cells)).astype(np.int32)

    @cached_property
    def cell_origins_np(self) -> np.ndarray:
        ft = self._np_float
        cells = np.arange(self.num_cells, dtype=np.int64)
        ix, iy, _ = self._block_ij_np(cells)
        return np.stack(
            [self.x0 + ix.astype(ft) * ft(self.hx), self.y0 + iy.astype(ft) * ft(self.hy)],
            axis=-1,
        ).astype(ft)

    def c2f_of_np(self, cells) -> np.ndarray:
        """(len(cells), nfpc) int64 facet ids of the given cells, closed
        form (the rows of ``c2f_np``)."""
        cells = np.asarray(cells, dtype=np.int64)
        ix, iy, which = self._block_ij_np(cells)
        if self.is_simplex:
            lower = np.stack(
                [self._hf(ix, iy), self._vf(ix + 1, iy), self._df(ix, iy)], axis=-1
            )
            upper = np.stack(
                [self._df(ix, iy), self._hf(ix, iy + 1), self._vf(ix, iy)], axis=-1
            )
            return np.where(which[:, None] == 0, lower, upper)
        return np.stack(
            [self._vf(ix, iy), self._vf(ix + 1, iy), self._hf(ix, iy), self._hf(ix, iy + 1)],
            axis=-1,
        )

    @cached_property
    def c2f_np(self) -> np.ndarray:
        return self.c2f_of_np(np.arange(self.num_cells)).astype(np.int32)

    def f2c_of_np(self, facets) -> np.ndarray:
        """(len(facets), 2) int64 ``(cell_minus, cell_plus)`` of the given
        facets, closed form (the rows of ``f2c_np``; -1 = no neighbour)."""
        f = np.asarray(facets, dtype=np.int64)
        nx, ny, nvf, nhf = self.nx, self.ny, self.num_vfacets, self.num_hfacets
        out = np.empty(f.shape + (2,), np.int64)

        v = f < nvf  # vertical
        ix, iy = f[v] % (nx + 1), f[v] // (nx + 1)
        if self.is_simplex:
            left = 2 * (iy * nx + (ix - 1))  # lower tri owns the right edge
            right = 2 * (iy * nx + ix) + 1  # upper tri owns the left edge
        else:
            left = iy * nx + (ix - 1)
            right = iy * nx + ix
        out[v, 0] = np.where(ix > 0, left, -1)
        out[v, 1] = np.where(ix < nx, right, -1)

        h = (f >= nvf) & (f < nvf + nhf)  # horizontal
        g = f[h] - nvf
        ix, iy = g % nx, g // nx
        if self.is_simplex:
            below = 2 * ((iy - 1) * nx + ix) + 1  # upper tri owns the top edge
            above = 2 * (iy * nx + ix)  # lower tri owns the bottom edge
        else:
            below = (iy - 1) * nx + ix
            above = iy * nx + ix
        out[h, 0] = np.where(iy > 0, below, -1)
        out[h, 1] = np.where(iy < ny, above, -1)

        d = f >= nvf + nhf  # diagonal (triangles only)
        block = f[d] - nvf - nhf
        out[d, 0] = 2 * block
        out[d, 1] = 2 * block + 1
        return out

    @cached_property
    def f2c_np(self) -> np.ndarray:
        return self.f2c_of_np(np.arange(self.num_facets)).astype(np.int32)

    def boundary_facets_np(self) -> np.ndarray:
        """Ascending ids of the facets on the background box boundary,
        closed form (``np.where(boundary_facet_mask_np)[0]``)."""
        nx, ny = self.nx, self.ny
        rows = np.arange(ny, dtype=np.int64) * (nx + 1)
        vert = np.stack([rows, rows + nx], axis=-1).reshape(-1)
        cols = np.arange(nx, dtype=np.int64)
        horiz = self.num_vfacets + np.concatenate([cols, ny * nx + cols])
        return np.concatenate([vert, horiz])

    @cached_property
    def facet_kind_np(self) -> np.ndarray:
        kinds = [
            np.zeros(self.num_vfacets, np.int32),
            np.ones(self.num_hfacets, np.int32),
        ]
        if self.is_simplex:
            kinds.append(np.full(self.num_dfacets, 2, np.int32))
        return np.concatenate(kinds)

    @cached_property
    def facet_base_normals_np(self) -> np.ndarray:
        ft = self._np_float
        normals = [
            np.tile(np.array([1.0, 0.0], ft), (self.num_vfacets, 1)),
            np.tile(np.array([0.0, 1.0], ft), (self.num_hfacets, 1)),
        ]
        if self.is_simplex:
            l = self.diag_length
            nd = np.array([-self.hy / l, self.hx / l], ft)
            normals.append(np.tile(nd, (self.num_dfacets, 1)))
        return np.concatenate(normals, axis=0).astype(ft)

    @cached_property
    def facet_lengths_np(self) -> np.ndarray:
        ft = self._np_float
        lens = [
            np.full(self.num_vfacets, self.hy, ft),
            np.full(self.num_hfacets, self.hx, ft),
        ]
        if self.is_simplex:
            lens.append(np.full(self.num_dfacets, self.diag_length, ft))
        return np.concatenate(lens)

    @cached_property
    def facet_endpoints_np(self) -> np.ndarray:
        """(num_facets, 2, 2): start/end coordinates.  Parametrization t in
        [0,1]: vertical bottom->top, horizontal left->right, diagonal
        v00->v11."""
        ft = self._np_float
        hx, hy = ft(self.hx), ft(self.hy)

        f = np.arange(self.num_vfacets, dtype=np.int64)
        ix, iy = f % (self.nx + 1), f // (self.nx + 1)
        x = self.x0 + ix.astype(ft) * hx
        y = self.y0 + iy.astype(ft) * hy
        segs = [np.stack([np.stack([x, y], -1), np.stack([x, y + hy], -1)], axis=1)]

        f = np.arange(self.num_hfacets, dtype=np.int64)
        ix, iy = f % self.nx, f // self.nx
        x = self.x0 + ix.astype(ft) * hx
        y = self.y0 + iy.astype(ft) * hy
        segs.append(np.stack([np.stack([x, y], -1), np.stack([x + hx, y], -1)], axis=1))

        if self.is_simplex:
            f = np.arange(self.num_dfacets, dtype=np.int64)
            ix, iy = f % self.nx, f // self.nx
            x = self.x0 + ix.astype(ft) * hx
            y = self.y0 + iy.astype(ft) * hy
            segs.append(
                np.stack([np.stack([x, y], -1), np.stack([x + hx, y + hy], -1)], axis=1)
            )
        return np.concatenate(segs, axis=0).astype(ft)

    @cached_property
    def boundary_facet_mask_np(self) -> np.ndarray:
        """Facets on the boundary of the background box."""
        return np.any(self.f2c_np < 0, axis=1)

    def local_facet_index_np(self, cells: np.ndarray, facets: np.ndarray) -> np.ndarray:
        """For pairs (cell, facet) return the local index k with
        ``c2f[cell, k] == facet``."""
        rows = self.c2f_of_np(cells)
        return np.argmax(rows == np.asarray(facets)[:, None], axis=1).astype(np.int32)

    # ------------------------------------------------------- device tensors
    @cached_property
    def vertex_coords(self) -> torch.Tensor:
        """(num_vertices, 2) built on the device from aranges (no host
        table upload; same ops and order as ``vertex_coords_np``)."""
        kw = dict(dtype=self.dtype, device=self.device)
        xs = self.x0 + torch.arange(self.nx + 1, **kw) * self.hx
        ys = self.y0 + torch.arange(self.ny + 1, **kw) * self.hy
        X = xs[None, :].expand(self.ny + 1, self.nx + 1)
        Y = ys[:, None].expand(self.ny + 1, self.nx + 1)
        return torch.stack([X, Y], dim=-1).reshape(-1, 2)

    @cached_property
    def cell_vertices(self) -> torch.Tensor:
        return self._tensor(self.cell_vertices_np)

    @cached_property
    def cell_orientations(self) -> torch.Tensor:
        return self._tensor(self.cell_orientations_np)

    # ------------------------------------------------------ closed-form maps
    def orientation_of(self, cells: torch.Tensor) -> torch.Tensor:
        """Per-cell orientation, closed form (no table)."""
        cells = torch.as_tensor(cells, device=self.device)
        if self.is_simplex:
            return (cells % 2).to(torch.int32)
        return torch.zeros(cells.shape, dtype=torch.int32, device=self.device)

    def cell_vertex_coords_of(self, cells: torch.Tensor) -> torch.Tensor:
        """(len(cells), nv, 2) vertex coordinates from closed-form index
        arithmetic, never a gather from a (num_cells, nv, 2) table."""
        cells = torch.as_tensor(cells, device=self.device).to(torch.int64)
        if self.is_simplex:
            block, which = cells // 2, cells % 2
        else:
            block, which = cells, torch.zeros_like(cells)
        ix, iy = block % self.nx, block // self.nx

        def vc(jx, jy):
            return torch.stack(
                [
                    self.x0 + jx.to(self.dtype) * self.hx,
                    self.y0 + jy.to(self.dtype) * self.hy,
                ],
                dim=-1,
            )

        v00, v10 = vc(ix, iy), vc(ix + 1, iy)
        v01, v11 = vc(ix, iy + 1), vc(ix + 1, iy + 1)
        if not self.is_simplex:
            return torch.stack([v00, v10, v01, v11], dim=1)
        lower = torch.stack([v00, v10, v11], dim=1)
        upper = torch.stack([v00, v11, v01], dim=1)
        return torch.where((which == 0)[:, None, None], lower, upper)

    def _facet_kind_of(self, facets: torch.Tensor):
        """(facets int64 on the device, vertical mask, horizontal mask)."""
        f = torch.as_tensor(facets, device=self.device).to(torch.int64)
        nvf = self.num_vfacets
        return f, f < nvf, (f >= nvf) & (f < nvf + self.num_hfacets)

    def facet_base_normals_of(self, facets: torch.Tensor) -> torch.Tensor:
        """(len(facets), 2) base unit normals, closed form (the rows of
        ``facet_base_normals_np``)."""
        f, v, h = self._facet_kind_of(facets)
        c, l = self._scalar, self.diag_length
        nx = torch.where(v, c(1.0), torch.where(h, c(0.0), c(-self.hy / l)))
        ny = torch.where(v, c(0.0), torch.where(h, c(1.0), c(self.hx / l)))
        return torch.stack([nx, ny], dim=-1)

    def facet_lengths_of(self, facets: torch.Tensor) -> torch.Tensor:
        """(len(facets),) facet lengths, closed form."""
        f, v, h = self._facet_kind_of(facets)
        c = self._scalar
        return torch.where(v, c(self.hy), torch.where(h, c(self.hx), c(self.diag_length)))

    def _scalar(self, val: float) -> torch.Tensor:
        return torch.tensor(val, dtype=self.dtype, device=self.device)

    def facet_endpoints_of(self, facets: torch.Tensor) -> torch.Tensor:
        """(len(facets), 2, 2) start/end coordinates, closed form with the
        arithmetic of ``facet_endpoints_np``."""
        f, v, h = self._facet_kind_of(facets)
        nx = self.nx
        g = torch.where(v, f, torch.where(h, f - self.num_vfacets, f - self.num_vfacets - self.num_hfacets))
        ix = torch.where(v, g % (nx + 1), g % nx)
        iy = torch.where(v, g // (nx + 1), g // nx)
        x = self.x0 + ix.to(self.dtype) * self.hx
        y = self.y0 + iy.to(self.dtype) * self.hy
        x1 = torch.where(v, x, x + self.hx)
        y1 = torch.where(h, y, y + self.hy)
        return torch.stack([torch.stack([x, y], -1), torch.stack([x1, y1], -1)], dim=1)

    def map_to_physical(self, cells: torch.Tensor, ref_pts) -> torch.Tensor:
        """Map reference-cell points ``(npts, 2)`` to physical space,
        batched over cells: ``(len(cells), npts, 2)``.  Barycentric /
        bilinear combination, the same arithmetic as the JAX package."""
        ref_pts = torch.as_tensor(ref_pts, dtype=self.dtype, device=self.device)
        r, s = ref_pts[None, :, 0:1], ref_pts[None, :, 1:2]
        verts = self.cell_vertex_coords_of(cells)  # (nc, nv, 2)
        if not self.is_simplex:
            return (
                (1 - r) * (1 - s) * verts[:, 0, None, :]
                + r * (1 - s) * verts[:, 1, None, :]
                + (1 - r) * s * verts[:, 2, None, :]
                + r * s * verts[:, 3, None, :]
            )
        return (
            (1 - r - s) * verts[:, 0, None, :]
            + r * verts[:, 1, None, :]
            + s * verts[:, 2, None, :]
        )

    def cell_jacobians(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-orientation affine Jacobian J (norient, 2, 2) and |det J|;
        on this uniform grid J depends on the orientation only."""
        kw = dict(dtype=self.dtype, device=self.device)
        hx, hy = self.hx, self.hy
        if not self.is_simplex:
            J = torch.tensor([[[hx, 0.0], [0.0, hy]]], **kw)
            return J, torch.tensor([hx * hy], **kw)
        # lower (v00,v10,v11): e1=(hx,0), e2=(hx,hy); upper (v00,v11,v01):
        # e1=(hx,hy), e2=(0,hy).  Columns of J are e1, e2.
        J = torch.tensor([[[hx, hx], [0.0, hy]], [[hx, 0.0], [hy, hy]]], **kw)
        return J, torch.abs(torch.linalg.det(J))
