"""Level-set detection: quadrature lattices and sign classification.

Counterpart of :mod:`phifem_tpu.levelset`.  A cell is classified by which
signs the level set takes at N+1 evenly spaced points per edge of the cell
(the reference's detection lattice): only negative -> inside (1), only
positive -> outside (3), otherwise cut (2), including the all-zero
degenerate case.

The level set is a callable ``phi(x: (n, 2) tensor) -> (n,)`` or a discrete
:class:`~phifem_tpu_torch.spaces.Function`, evaluated cell-locally through
its basis.  There is one batched path: the ``(ncells, npts)`` values for
every cell at once (about 1 GB in float64 at n=3200, which the card holds).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from .grid import CellType, Grid
from .spaces import Function

LevelSet = Union[Callable, Function]

__all__ = [
    "reference_segment_points",
    "reference_triangle_boundary_points",
    "reference_square_boundary_points",
    "detection_points",
    "facet_ref_points",
    "evaluate_on_cells",
    "evaluate_at_cell_points",
    "sign_flags",
    "sign_flags_on_cells",
    "classify",
]


def reference_segment_points(N: int) -> np.ndarray:
    """(npts, 1) evenly spaced points on [0,1]; N=0 -> the midpoint."""
    if N > 0:
        pts = np.linspace(0.0, 1.0, N + 1)
    else:
        pts = np.array([0.5])
    return np.atleast_2d(pts.astype(np.float64)).T


def reference_triangle_boundary_points(N: int) -> np.ndarray:
    """(3N or 1, 2) boundary lattice of the reference triangle: the 3
    vertices plus N-1 interior points per edge; N=0 -> the centroid."""
    if N == 0:
        return np.array([[1.0 / 3.0, 1.0 / 3.0]])
    t = np.linspace(0.0, 1.0, N + 1)
    edge1 = np.stack([t, np.zeros_like(t)], -1)  # p0 -> p1, both ends
    t2 = t[1:]
    edge2 = np.stack([1.0 - t2, t2], -1)  # p1 -> p2, without p1
    t3 = t[1:-1]
    edge3 = np.stack([np.zeros_like(t3), 1.0 - t3], -1)  # p2 -> p0, open
    return np.concatenate([edge1, edge2, edge3], axis=0)


def reference_square_boundary_points(N: int) -> np.ndarray:
    """(4N or 1, 2) boundary lattice of the reference square."""
    if N == 0:
        return np.array([[0.5, 0.5]])
    t = np.linspace(0.0, 1.0, N + 1)
    edge1 = np.stack([t, np.zeros_like(t)], -1)
    t2 = t[1:]
    edge2 = np.stack([np.ones_like(t2), t2], -1)
    t3 = t[1:]
    edge3 = np.stack([1.0 - t3, np.ones_like(t3)], -1)
    t4 = t[1:-1]
    edge4 = np.stack([np.zeros_like(t4), 1.0 - t4], -1)
    return np.concatenate([edge1, edge2, edge3, edge4], axis=0)


def detection_points(cell_type: CellType, N: int) -> np.ndarray:
    if cell_type == CellType.triangle:
        return reference_triangle_boundary_points(N)
    return reference_square_boundary_points(N)


def facet_ref_points(cell_type: CellType, N: int) -> np.ndarray:
    """(nfpc, npts, 2) reference coordinates of the segment detection
    points on each local facet (triangles: r0r1, r1r2, r0r2; quads: left,
    right, bottom, top)."""
    t = reference_segment_points(N)[:, 0]
    z = np.zeros_like(t)
    o = np.ones_like(t)
    if cell_type == CellType.triangle:
        return np.stack(
            [np.stack([t, z], -1), np.stack([1.0 - t, t], -1), np.stack([z, t], -1)]
        )
    return np.stack(
        [np.stack([z, t], -1), np.stack([o, t], -1), np.stack([t, z], -1), np.stack([t, o], -1)]
    )


def evaluate_on_cells(
    grid: Grid, levelset: LevelSet, ref_pts: np.ndarray, cells: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """(ncells, npts) level-set values at the same reference points of
    every cell (all cells when ``cells`` is None)."""
    if cells is None:
        cells = torch.arange(grid.num_cells, device=grid.device)
    if isinstance(levelset, Function):
        sp = levelset.space
        tab = sp.grid._tensor(sp.element.tabulate(np.asarray(ref_pts)))  # (npts, nloc)
        nodal = levelset.data[sp.cell_dofs_of(cells)]  # (nc, nloc)
        return nodal @ tab.T
    phys = grid.map_to_physical(cells, ref_pts)  # (nc, npts, 2)
    vals = levelset(phys.reshape(-1, 2))
    return vals.reshape(phys.shape[:2])


def evaluate_at_cell_points(
    grid: Grid, levelset: LevelSet, cells: torch.Tensor, ref_pts: torch.Tensor
) -> torch.Tensor:
    """Like :func:`evaluate_on_cells` with per-cell reference points
    ``ref_pts`` of shape (ncells, npts, 2) (facet traces)."""
    if isinstance(levelset, Function):
        sp = levelset.space
        tab = sp._basis(ref_pts)  # (nc, npts, nloc)
        nodal = levelset.data[sp.cell_dofs_of(cells)]  # (nc, nloc)
        return torch.einsum("cpl,cl->cp", tab, nodal)
    verts = grid.cell_vertex_coords_of(cells)
    r, s = ref_pts[..., 0:1], ref_pts[..., 1:2]
    # the push-forward of Grid.map_to_physical
    if not grid.is_simplex:
        phys = (
            (1 - r) * (1 - s) * verts[:, None, 0, :]
            + r * (1 - s) * verts[:, None, 1, :]
            + (1 - r) * s * verts[:, None, 2, :]
            + r * s * verts[:, None, 3, :]
        )
    else:
        phys = (1 - r - s) * verts[:, None, 0, :] + r * verts[:, None, 1, :] + s * verts[:, None, 2, :]
    vals = levelset(phys.reshape(-1, 2))
    return vals.reshape(phys.shape[:2])


def sign_flags(values: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(has_pos, has_neg) along the last axis."""
    return torch.any(values > 0.0, dim=-1), torch.any(values < 0.0, dim=-1)


def sign_flags_on_cells(
    grid: Grid, levelset: LevelSet, ref_pts: np.ndarray, cells: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """OR-reduced detection sign flags per cell (one batched evaluation)."""
    return sign_flags(evaluate_on_cells(grid, levelset, ref_pts, cells))


def classify(has_pos: torch.Tensor, has_neg: torch.Tensor) -> torch.Tensor:
    """Sign flags -> int8 tags: 1 inside, 2 cut, 3 outside (all-zero is
    cut)."""
    inside = has_neg & ~has_pos
    outside = has_pos & ~has_neg
    tags = torch.full(has_pos.shape, 2, dtype=torch.int8, device=has_pos.device)
    tags[inside] = 1
    tags[outside] = 3
    return tags
