"""Stencil specialization of uniform P1 cell terms.

Counterpart of :mod:`phifem_tpu.ops.stencil`.  A geometry-uniform term
(stiffness, mass) on a structured grid has ONE element matrix per cell
orientation; its matvec is a fixed-coefficient stencil on the
``(ny+1, nx+1)`` vertex lattice with an optional per-cell region mask:
``y[v_i] += mask_cell * sum_j A[i,j] x[v_j]`` for the cell's local nodes
``v_i``.  The matvec itself is :func:`~phifem_tpu_torch.ops.cuda_stencil.
stencil_matvec`: the hand-written CUDA kernel for tensors on the card, its
plain shifted-slice version for tensors on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..grid import Grid

# local-node lattice offsets (dx, dy) matching Grid.cell_vertices order
_QUAD_OFFS = ((0, 0), (1, 0), (0, 1), (1, 1))  # v00, v10, v01, v11
_TRI_OFFS = (
    ((0, 0), (1, 0), (1, 1)),  # lower: v00, v10, v11
    ((0, 0), (1, 1), (0, 1)),  # upper: v00, v11, v01
)


def orientation_offsets(grid: Grid):
    """Per-orientation local-node lattice offsets of ``grid``'s cells."""
    return _TRI_OFFS if grid.is_simplex else (_QUAD_OFFS,)


@dataclasses.dataclass
class StencilCellBatch:
    """Batch of a single-scalar-P1-field uniform cell term.

    ``matrices`` is a small host (CPU) tensor: the kernel takes its
    entries by value at launch, so reading them never waits on the card.
    ``masks is None`` means the term covers EVERY cell (the full-box
    case): the matvec then reads no masks and rebuilds lattice-boundary
    validity from indices.  Simplex cells interleave orientations
    (``0::2`` lower, ``1::2`` upper), so the masks are
    ``(norient, ny, nx)`` on ``grid.device``.
    """

    grid: Grid
    field: str
    matrices: torch.Tensor  # (norient, nloc, nloc), CPU
    masks: Optional[torch.Tensor]  # (norient, ny, nx) region masks, or None
    packed: np.ndarray = dataclasses.field(init=False, repr=False, compare=False)

    def __post_init__(self):
        from .cuda_stencil import pack_matrices

        self.packed = pack_matrices(self.grid, self.matrices)  # the kernel's form

    @staticmethod
    def build(grid: Grid, field: str, mats, cell_tags, region) -> "StencilCellBatch":
        ny, nx = grid.ny, grid.nx
        mats = torch.as_tensor(np.asarray(mats), dtype=grid.dtype)
        if region is None:
            sel = np.ones(grid.num_cells, bool)
        else:
            sel = np.isin(np.asarray(cell_tags), np.asarray(region))
        if sel.all():
            return StencilCellBatch(grid, field, mats, None)
        if grid.is_simplex:
            masks = np.stack([sel[0::2].reshape(ny, nx), sel[1::2].reshape(ny, nx)])
        else:
            masks = sel.reshape(1, ny, nx)
        return StencilCellBatch(grid, field, mats, grid._tensor(masks.astype(np.float64)))

    def astype(self, dtype: torch.dtype) -> "StencilCellBatch":
        """Copy with the matrices and masks cast to ``dtype`` (repacked)."""
        return dataclasses.replace(
            self,
            matrices=self.matrices.to(dtype),
            masks=None if self.masks is None else self.masks.to(dtype),
        )

    def masks_or_ones(self) -> np.ndarray:
        """Materialized region masks (host numpy)."""
        if self.masks is not None:
            return self.masks.cpu().numpy()
        return np.ones((self.grid.num_orientations, self.grid.ny, self.grid.nx))

    def matvec_into(self, x: Dict[str, torch.Tensor], y: Dict[str, torch.Tensor]):
        """``y[field] += A x[field]``, in place; returns ``y``."""
        from .cuda_stencil import stencil_matvec

        stencil_matvec(
            self.grid, x[self.field], self.masks, self.matrices, y=y[self.field], packed=self.packed
        )
        return y

    def diagonal_into(self, d: Dict[str, torch.Tensor]):
        """``d[field] += diag(A)``, in place; returns ``d``."""
        g = self.grid
        ny, nx = g.ny, g.nx
        D = d[self.field].view(ny + 1, nx + 1)
        mats = self.matrices.to(torch.float64).tolist()
        for o, offs in enumerate(orientation_offsets(g)):
            for i, (dxi, dyi) in enumerate(offs):
                part = D[dyi : dyi + ny, dxi : dxi + nx]
                if self.masks is None:
                    part += mats[o][i][i]
                else:
                    part += self.masks[o].to(D.dtype) * mats[o][i][i]
        return d

    def restricted_entities(self, offsets: Dict[str, int], idx_of: np.ndarray):
        """Compact local ids and element matrices of the cells of this term
        (mask set) with a vertex among the selected DoFs (see
        ``assembly.Batch.restricted_entities``): only the cells around the
        selected vertices are visited, never the whole grid."""
        g = self.grid
        nx, ny = g.nx, g.ny
        off = offsets[self.field]
        selv = np.where(idx_of[off : off + g.num_vertices] >= 0)[0]
        ix, iy = selv % (nx + 1), selv // (nx + 1)
        blocks = []
        for dx in (-1, 0):
            for dy in (-1, 0):
                bx, by = ix + dx, iy + dy
                ok = (bx >= 0) & (bx < nx) & (by >= 0) & (by < ny)
                blocks.append(by[ok] * nx + bx[ok])
        blocks = np.unique(np.concatenate(blocks))
        if g.is_simplex:
            cells = np.stack([2 * blocks, 2 * blocks + 1], axis=-1).reshape(-1)
        else:
            cells = blocks
        orient = cells % 2 if g.is_simplex else np.zeros_like(cells)
        if self.masks is not None:
            masks = self.masks_or_ones().reshape(g.num_orientations, -1)
            act = masks[orient, cells // g.cells_per_block] > 0.0
            cells, orient = cells[act], orient[act]
        l = idx_of[off + g.cell_vertices_of_np(cells)]
        keep = (l >= 0).any(axis=1)
        return l[keep], self.matrices.to(torch.float64).numpy()[orient[keep]]

    def add_dense(self, A: np.ndarray, offsets: Dict[str, int]) -> None:
        """Accumulate this batch into the dense global matrix ``A`` (host;
        builds per-cell tables, so small grids only)."""
        g = self.grid
        orient = g.cell_orientations_np
        block = np.arange(g.num_cells) // g.cells_per_block
        active = self.masks_or_ones().reshape(g.num_orientations, -1)[orient, block] > 0.0
        gidx = offsets[self.field] + g.cell_vertices_np[active].astype(np.int64)
        mats = self.matrices.to(torch.float64).numpy()[orient[active]]
        np.add.at(A, (gidx[:, :, None], gidx[:, None, :]), mats)
