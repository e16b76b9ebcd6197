"""3D cell / face tagging on the structured hex lattice.

Counterpart of :mod:`phifem_tpu.tagging3`.  Vertex-sign classification
(detection degree 1): a cell is *inside* (tag 1) when phi < 0 at all 8
corners, *outside* (tag 3) when phi >= 0 at all of them, *cut* (tag 2)
otherwise.  The int8 cell tags are computed on the grid's device by shifted
slices of the vertex phi lattice and fetched once; the faces are classified
on the host from the tag lattice:

* ghost faces: interior faces whose two cells both lie in Omega_h {1, 2},
  at least one of them cut;
* Gamma_h faces (the one-sided boundary measure): faces between a cell in
  {1, 2} and a cell in {3}, integrated from the Omega_h side.  Omega_h must
  lie strictly inside the box; :func:`compute_tags3` warns otherwise.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Tuple

import numpy as np
import torch

from .grid3 import Grid3

__all__ = ["Tags3", "compute_tags3"]


def _cell_tags_from_phi(phi_lat: torch.Tensor) -> torch.Tensor:
    """(D, R, C) vertex phi -> (nz, ny, nx) int8 cell tags 1 / 2 / 3."""
    neg = phi_lat < 0.0
    D, R, C = phi_lat.shape
    all_neg = any_neg = None
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                c = neg[dz : D - 1 + dz, dy : R - 1 + dy, dx : C - 1 + dx]
                all_neg = c if all_neg is None else (all_neg & c)
                any_neg = c if any_neg is None else (any_neg | c)
    one, two, three = (torch.tensor(v, dtype=torch.int8, device=phi_lat.device) for v in (1, 2, 3))
    return torch.where(all_neg, one, torch.where(any_neg, two, three))


def _axis_slices(ax: int):
    lo = [slice(None)] * 3
    hi = [slice(None)] * 3
    lo[ax] = slice(None, -1)
    hi[ax] = slice(1, None)
    return tuple(lo), tuple(hi)


@dataclasses.dataclass(frozen=True)
class Tags3:
    """Host tagging result: the cell-tag lattice and per-orientation face
    lists (static shapes for the assembly and solve)."""

    grid: Grid3
    cell_tags: np.ndarray  # (nz, ny, nx) int8
    # per slicing axis k (0 = z, 1 = y, 2 = x): ghost interior faces as the
    # (iz, iy, ix) of the LOWER cell (the face lies between cell and cell + e_k)
    ghost_faces: Tuple[np.ndarray, np.ndarray, np.ndarray]
    # Gamma_h faces per axis and side: (plus, minus) inside-cell lists; plus:
    # outward normal +e_k (inside cell below the face), minus: -e_k
    boundary_faces: Tuple[Tuple[np.ndarray, np.ndarray], ...]

    @property
    def num_cut_cells(self) -> int:
        return int((self.cell_tags == 2).sum())

    def cut_cells(self) -> np.ndarray:
        """(ne, 3) int32 (iz, iy, ix) of the cut cells."""
        return np.argwhere(self.cell_tags == 2).astype(np.int32)

    def region_mask(self, tags=(1, 2)) -> np.ndarray:
        return np.isin(self.cell_tags, np.asarray(tags))

    def faces_between(self, tags_a, tags_b):
        """Per slicing axis, the ONE-SIDED interior faces between region A
        and region B: ``(cells_plus, cells_minus)``, each the (iz, iy, ix) of
        the A-side cell, with outward (A -> B) normal +e_ax for the plus list
        and -e_ax for the minus list."""
        A = np.isin(self.cell_tags, np.asarray(tags_a))
        B = np.isin(self.cell_tags, np.asarray(tags_b))
        out = []
        for ax in (0, 1, 2):
            lo, hi = _axis_slices(ax)
            plus = np.argwhere(A[lo] & B[hi]).astype(np.int32)
            minus = np.argwhere(B[lo] & A[hi]).astype(np.int32)
            minus[:, ax] += 1  # the A-side (upper) cell
            out.append((plus, minus))
        return tuple(out)

    def jump_faces_between(self, tags_a, tags_b):
        """Per slicing axis, the LOWER-cell lists of interior faces whose
        two cells lie one in region A and one in region B (either way)."""
        A = np.isin(self.cell_tags, np.asarray(tags_a))
        B = np.isin(self.cell_tags, np.asarray(tags_b))
        out = []
        for ax in (0, 1, 2):
            lo, hi = _axis_slices(ax)
            m = (A[lo] & B[hi]) | (B[lo] & A[hi])
            out.append(np.argwhere(m).astype(np.int32))
        return tuple(out)


def compute_tags3(grid: Grid3, levelset: Callable) -> Tags3:
    """Tag the 3D grid: the cell tags on the device, one int8 fetch, then
    the faces on the host."""
    phi_lat = grid.eval_at_vertices(levelset)
    ct = _cell_tags_from_phi(phi_lat).cpu().numpy()  # the single fetch

    in_h = (ct == 1) | (ct == 2)  # Omega_h cells
    n_border = int(
        in_h[0].sum() + in_h[-1].sum()
        + in_h[:, 0].sum() + in_h[:, -1].sum()
        + in_h[:, :, 0].sum() + in_h[:, :, -1].sum()
    )
    if n_border > 0:
        warnings.warn(
            f"{n_border} Omega_h cell(s) touch the background-box boundary:"
            " the box must contain Omega_h strictly (phi-FEM containment"
            " assumption) or the Gamma_h face set is incomplete there and"
            " the scheme loses consistency. Enlarge the box or refine.",
            RuntimeWarning,
            stacklevel=2,
        )
    cut = ct == 2
    out = ct == 3
    ghost, bdry = [], []
    for ax in (0, 1, 2):
        lo, hi = _axis_slices(ax)
        both_in = in_h[lo] & in_h[hi]
        a_cut = cut[lo] | cut[hi]
        ghost.append(np.argwhere(both_in & a_cut).astype(np.int32))
        # inside below / outside above: outward normal +e_ax
        plus = np.argwhere(in_h[lo] & out[hi]).astype(np.int32)
        # outside below / inside above: the inside cell is the upper one
        minus = np.argwhere(out[lo] & in_h[hi]).astype(np.int32)
        minus[:, ax] += 1
        bdry.append((plus, minus))
    return Tags3(grid, ct, tuple(ghost), tuple(bdry))
