"""Cell/facet classification from a level set, the core of phi-FEM.

Counterpart of :mod:`phifem_tpu.tagging` (box mode):

* cell tags: 1 = strictly inside, 2 = cut, 3 = strictly outside, from the
  signs of the level set on each cell's detection lattice;
* ``single_layer_cut``: cut cells that share no vertex with an interior
  cell become outside, by a vertex max-pool in lattice form (shifted pads
  and maxima, no scatter);
* facet tags: 1 interior, 2 cut, 3 interior boundary (ghost-penalty set),
  4 boundary Gamma_h, 5 exterior, 6 direct interface -- a rule table on
  the two adjacent cell tags, plus a boundary-trace flag for facets on the
  background box;
* :func:`compute_tags_measures` with ``box_mode=True``: the one-sided
  boundary measures with ids 100 and 101; with ``box_mode=False`` the
  submesh mode: a :class:`Submesh` (the active cells 1|2 as a view of the
  background grid) and its exterior boundary as measure id 0.

The tags are computed on ``grid.device``; :class:`EntityTags` holds the
tensor and a host copy on demand.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import levelset as lsmod
from .grid import Grid
from .measures import BoundaryMeasure, FacetSideList, one_sided_facets_multi

LevelSet = lsmod.LevelSet

__all__ = [
    "EntityTags",
    "Submesh",
    "TagsMeasures",
    "tag_cells",
    "tag_facets",
    "overwrite_tags",
    "compute_tags_measures",
]


def _debug_mode() -> bool:
    # the reference's switch
    return os.environ.get("MODE", "") == "debug"


class EntityTags:
    """Dense per-entity int8 tags (dolfinx ``MeshTags`` analogue): a
    tensor, with its host copy made once on first :meth:`as_numpy`."""

    __slots__ = ("dim", "values", "_host")

    def __init__(self, dim: str, values: torch.Tensor):
        self.dim = dim  # "cell" | "facet"
        self.values = values
        self._host: Optional[np.ndarray] = None

    def __repr__(self) -> str:
        return f"EntityTags(dim={self.dim!r}, n={self.values.shape[0]})"

    def as_numpy(self) -> np.ndarray:
        if self._host is None:
            self._host = self.values.cpu().numpy()
        return self._host

    def find(self, tag: int) -> np.ndarray:
        """Host indices of the entities with ``tag``."""
        return np.where(self.as_numpy() == tag)[0].astype(np.int32)

    @property
    def indices(self) -> np.ndarray:
        return np.arange(self.values.shape[0], dtype=np.int32)


# --------------------------------------------------------------------- cells
def tag_cells(
    grid: Grid,
    levelset: LevelSet,
    detection_degree: int,
    single_layer_cut: bool = False,
    return_degenerate: bool = False,
):
    """Cell tags 1/2/3 as a dense int8 tensor.  ``return_degenerate=True``
    also returns the number of cells whose detection values are all zero
    (or NaN), which are tagged cut, as a 0-d tensor."""
    pts = lsmod.detection_points(grid.cell_type, detection_degree)
    has_pos, has_neg = lsmod.sign_flags_on_cells(grid, levelset, pts)
    tags = lsmod.classify(has_pos, has_neg)
    n_degenerate = (~has_pos & ~has_neg).sum() if return_degenerate else None

    if single_layer_cut:
        # a cut cell stays cut only if it shares a vertex with an interior
        # cell: vertex max-pool of the interior indicator, then back
        ny, nx = grid.ny, grid.nx
        interior = (tags == 1).to(torch.int8)

        def padm(a, dy, dx):
            return F.pad(a, (dx, 1 - dx, dy, 1 - dy))

        mx = torch.maximum
        if grid.is_simplex:
            I2 = interior.reshape(ny, nx, 2)
            Lf, Uf = I2[:, :, 0], I2[:, :, 1]
            A = mx(Lf, Uf)
            # lower (ix, iy) touches vertices (iy,ix), (iy,ix+1), (iy+1,ix+1);
            # upper touches (iy,ix), (iy+1,ix+1), (iy+1,ix)
            V = mx(mx(padm(A, 0, 0), padm(Lf, 0, 1)), mx(padm(A, 1, 1), padm(Uf, 1, 0)))
            conn_l = mx(mx(V[:ny, :nx], V[:ny, 1:]), V[1:, 1:])
            conn_u = mx(mx(V[:ny, :nx], V[1:, 1:]), V[1:, :nx])
            connected = torch.stack([conn_l, conn_u], dim=-1).reshape(-1) > 0
        else:
            I2 = interior.reshape(ny, nx)
            V = mx(mx(padm(I2, 0, 0), padm(I2, 0, 1)), mx(padm(I2, 1, 1), padm(I2, 1, 0)))
            connected = (
                mx(mx(V[:ny, :nx], V[:ny, 1:]), mx(V[1:, :nx], V[1:, 1:])).reshape(-1) > 0
            )
        tags = torch.where((tags == 2) & ~connected, torch.tensor(3, dtype=torch.int8, device=tags.device), tags)

    if return_degenerate:
        return tags, n_degenerate
    return tags


def _boundary_trace_cut(grid: Grid, levelset: LevelSet, detection_degree: int) -> torch.Tensor:
    """Per-cell flag: does the level set on the cell's background-boundary
    facets change sign (or vanish identically)?  False off the box
    boundary."""
    bf = grid.boundary_facets_np()
    owner = grid.f2c_of_np(bf).max(axis=1)  # the single adjacent cell
    local = grid.local_facet_index_np(owner, bf)
    dev = grid.device
    ref_table = grid._tensor(lsmod.facet_ref_points(grid.cell_type, detection_degree))
    ref_pts = ref_table[torch.as_tensor(local, dtype=torch.int64, device=dev)]  # (nbf, npts, 2)
    owner_t = torch.as_tensor(owner, device=dev)
    vals = lsmod.evaluate_at_cell_points(grid, levelset, owner_t, ref_pts)
    fpos, fneg = lsmod.sign_flags(vals)  # per boundary facet
    cpos = torch.zeros(grid.num_cells, dtype=torch.bool, device=dev)
    cneg = torch.zeros_like(cpos)
    is_boundary_cell = torch.zeros_like(cpos)
    cpos[owner_t[fpos]] = True
    cneg[owner_t[fneg]] = True
    is_boundary_cell[owner_t] = True
    return (cpos == cneg) & is_boundary_cell  # mixed signs OR identically zero


# -------------------------------------------------------------------- facets
def tag_facets(
    grid: Grid, cell_tags: torch.Tensor, levelset: LevelSet, detection_degree: int
) -> torch.Tensor:
    """Facet tags 1..6 as dense int8.  With (a, b) the tags of the two
    adjacent cells and t the boundary-trace flag of the owning cell:

      interior facets: (1,1)->1, (1,2)->3, (1,3)->6, (2,2)->2, (2,3)->4,
                       (3,3)->5
      box-boundary facets, if any cell is exterior:
                       a==1 -> 1, a==2 -> (t ? 2 : 4), a==3 -> 5
      box-boundary facets, no exterior cell:
                       a==1 -> 4, a==2 -> (t ? 2 : 4)

    Per facet family the two neighbour tags are shifted slices of the
    cell-tag lattice."""
    trace_cut = _boundary_trace_cut(grid, levelset, detection_degree)
    ny, nx = grid.ny, grid.nx
    dev = cell_tags.device
    has_exterior = torch.any(cell_tags == 3)
    trc = trace_cut.to(torch.int8)
    if grid.is_simplex:
        T2 = cell_tags.reshape(ny, nx, 2)
        R2 = trc.reshape(ny, nx, 2)
        L, U = T2[:, :, 0], T2[:, :, 1]  # lower / upper triangle tags
        Ltr, Utr = R2[:, :, 0], R2[:, :, 1]
    else:
        L = U = cell_tags.reshape(ny, nx)
        Ltr = Utr = trc.reshape(ny, nx)

    def k(v):
        return torch.tensor(v, dtype=torch.int8, device=dev)

    def pair(lo_, hi_):
        return torch.where(
            (lo_ == 1) & (hi_ == 1), k(1),
            torch.where(
                (lo_ == 1) & (hi_ == 2), k(3),
                torch.where(
                    (lo_ == 1) & (hi_ == 3), k(6),
                    torch.where(
                        (lo_ == 2) & (hi_ == 2), k(2),
                        torch.where((lo_ == 2) & (hi_ == 3), k(4), k(5)),
                    ),
                ),
            ),
        )

    def family(t0, t1, valid0, valid1, t_owner, a_owner):
        interior_tag = pair(torch.minimum(t0, t1), torch.maximum(t0, t1))
        cut_or_bdry = torch.where(t_owner > 0, k(2), k(4))
        bdry_with_ext = torch.where(a_owner == 1, k(1), torch.where(a_owner == 2, cut_or_bdry, k(5)))
        bdry_no_ext = torch.where(a_owner == 1, k(4), cut_or_bdry)
        bdry_tag = torch.where(has_exterior, bdry_with_ext, bdry_no_ext)
        return torch.where(~valid0 | ~valid1, bdry_tag, interior_tag)

    zc = torch.zeros((ny, 1), dtype=torch.int8, device=dev)
    zr = torch.zeros((1, nx), dtype=torch.int8, device=dev)
    col = torch.arange(nx + 1, device=dev)[None, :]
    row = torch.arange(ny + 1, device=dev)[:, None]

    # vertical facets (ny, nx+1): left = lower tri of block ix-1 (c0),
    # right = upper tri of block ix (c1, the larger cell id -> owner)
    tl = torch.cat([zc, L], dim=1)
    tr = torch.cat([U, zc], dim=1)
    t_own_v = torch.where(col < nx, torch.cat([Utr, zc], dim=1), torch.cat([zc, Ltr], dim=1))
    a_v = torch.where(col > 0, tl, tr)  # c0 (left) tag if valid, else c1
    fv = family(tl, tr, col > 0, col < nx, t_own_v, a_v)

    # horizontal facets (ny+1, nx): below = upper tri of block iy-1 (c0),
    # above = lower tri of block iy (c1, the larger cell id -> owner)
    tb = torch.cat([zr, U], dim=0)
    ta = torch.cat([L, zr], dim=0)
    t_own_h = torch.where(row < ny, torch.cat([Ltr, zr], dim=0), torch.cat([zr, Utr], dim=0))
    a_h = torch.where(row > 0, tb, ta)
    fh = family(tb, ta, row > 0, row < ny, t_own_h, a_h)

    parts = [fv.reshape(-1), fh.reshape(-1)]
    if grid.is_simplex:
        # diagonal facets (ny, nx): lower | upper of one block, never on
        # the background boundary
        parts.append(pair(torch.minimum(L, U), torch.maximum(L, U)).reshape(-1))
    return torch.cat(parts)


# ----------------------------------------------------------------- overwrite
def overwrite_tags(
    tags: EntityTags, new: Dict[int, np.ndarray], reserved: Tuple[int, ...]
) -> EntityTags:
    """Merge user tags (tag value -> entity indices) over computed ones;
    user tags win, reserved values are refused."""
    vals = tags.as_numpy().copy()
    for tag, idx in new.items():
        if int(tag) in reserved:
            raise ValueError(f"Cannot overwrite {tags.dim} tags with reserved value {tag}.")
        vals[np.asarray(idx, np.int64)] = np.int8(tag)
    return EntityTags(tags.dim, torch.as_tensor(vals, device=tags.values.device))


# ----------------------------------------------------------------- submesh
@dataclasses.dataclass(frozen=True)
class Submesh:
    """Active-cell view of the background grid (Omega_h = cells tagged
    1|2): gather lists into the parent grid instead of a new mesh."""

    parent: Grid
    cells: np.ndarray  # (n_active,) parent cell ids, ascending
    facets: np.ndarray  # (n_facets,) parent facet ids touched by active cells
    cell_tags: EntityTags  # over `cells` (submesh numbering)
    facet_tags: EntityTags  # over `facets` (submesh numbering)
    exterior: FacetSideList  # exterior boundary of the submesh

    @property
    def num_cells(self) -> int:
        return len(self.cells)


def _build_submesh(grid: Grid, cell_tags: np.ndarray, facet_tags: np.ndarray) -> Submesh:
    """The submesh of the cells tagged 1|2 (host tags in, host entity lists
    out; the exterior facet list lives on ``grid.device``).  An exterior
    facet has exactly one active adjacent cell, which is its chosen side."""
    ct = np.asarray(cell_tags)
    ftags = np.asarray(facet_tags)
    active = np.where((ct == 1) | (ct == 2))[0].astype(np.int32)
    facets = np.unique(grid.c2f_of_np(active).reshape(-1)).astype(np.int32)
    f2c = grid.f2c_of_np(facets)
    act = np.zeros(grid.num_cells, bool)
    act[active] = True
    a0 = (f2c[:, 0] >= 0) & act[np.maximum(f2c[:, 0], 0)]
    a1 = (f2c[:, 1] >= 0) & act[np.maximum(f2c[:, 1], 0)]
    ext = np.logical_xor(a0, a1)
    ext_facets = facets[ext].astype(np.int64)
    chosen = np.where(a0[ext], f2c[ext, 0], f2c[ext, 1]).astype(np.int64)
    signs = np.where(a0[ext], 1.0, -1.0)
    dev = grid.device
    exterior = FacetSideList(
        grid,
        torch.as_tensor(ext_facets, device=dev),
        torch.as_tensor(chosen, device=dev),
        torch.as_tensor(grid.local_facet_index_np(chosen, ext_facets), dtype=torch.int64, device=dev),
        grid._tensor(signs),
    )
    return Submesh(
        parent=grid,
        cells=active,
        facets=facets,
        cell_tags=EntityTags("cell", torch.as_tensor(ct[active], device=dev)),
        facet_tags=EntityTags("facet", torch.as_tensor(ftags[facets], device=dev)),
        exterior=exterior,
    )


# ------------------------------------------------------------------- public
@dataclasses.dataclass(frozen=True)
class TagsMeasures:
    """Return value of :func:`compute_tags_measures`: the reference's
    ``(cells_tags, facets_tags, submesh, boundaries_measure,
    submesh_maps)``; the submesh entries are None in box mode."""

    cells_tags: EntityTags
    facets_tags: EntityTags
    submesh: Optional[Submesh]
    boundaries_measure: BoundaryMeasure
    submesh_maps: Optional[List[np.ndarray]]

    def __iter__(self):
        return iter(
            (self.cells_tags, self.facets_tags, self.submesh, self.boundaries_measure, self.submesh_maps)
        )


def box_measure(grid: Grid, cells_tags: EntityTags, facets_tags: EntityTags) -> BoundaryMeasure:
    """The box-mode measure, built on first use: id 100 = Gamma_h (tag-4
    facets) seen from inside Omega_h (cells 1|2), id 101 = interior
    boundary facets (tag 3) seen from the cut side (cells 2|3)."""

    def build():
        ct, ft = cells_tags.as_numpy(), facets_tags.as_numpy()
        return one_sided_facets_multi(
            grid, {100: (np.where(ft == 4)[0], (1, 2)), 101: (np.where(ft == 3)[0], (2, 3))}, ct
        )

    return BoundaryMeasure(build=build)


def compute_tags_measures(
    grid: Grid,
    levelset: LevelSet,
    detection_degree: int,
    box_mode: bool = False,
    single_layer_cut: bool = False,
    overwrite: Optional[Dict[str, Dict[int, np.ndarray]]] = None,
) -> TagsMeasures:
    """Tag cells and facets of ``grid`` and build the boundary measures.

    ``levelset``: a callable ``phi(x)`` on torch tensors or a discrete
    :class:`~phifem_tpu_torch.spaces.Function`; ``overwrite`` optionally
    maps ``{"cells": {tag: indices}, "facets": {tag: indices}}``.  Cells
    whose level set is zero (or NaN) at every detection point are tagged
    cut, with a ``RuntimeWarning``.  ``box_mode=False`` returns the
    submesh's tags (in submesh numbering), the submesh, its exterior as
    measure id 0 and the maps ``[cells, facets]`` to parent ids."""
    cells, ndeg = tag_cells(grid, levelset, detection_degree, single_layer_cut, return_degenerate=True)
    facets = tag_facets(grid, cells, levelset, detection_degree)
    ndeg = int(ndeg)
    if ndeg > 0:
        warnings.warn(
            f"{ndeg} cell(s) have an identically-zero (or NaN) level set at every "
            "detection point; they are classified as cut.",
            RuntimeWarning,
            stacklevel=2,
        )
    cells_tags = EntityTags("cell", cells)
    facets_tags = EntityTags("facet", facets)
    if overwrite:
        if "cells" in overwrite:
            cells_tags = overwrite_tags(cells_tags, overwrite["cells"], (1, 2, 3))
        if "facets" in overwrite:
            facets_tags = overwrite_tags(
                facets_tags, overwrite["facets"], (1, 2, 3, 4, 5, 6, 100, 101)
            )
    if _debug_mode():
        _check_invariants(cells_tags, facets_tags)
    if box_mode:
        return TagsMeasures(cells_tags, facets_tags, None, box_measure(grid, cells_tags, facets_tags), None)
    sub = _build_submesh(grid, cells_tags.as_numpy(), facets_tags.as_numpy())
    return TagsMeasures(
        sub.cell_tags, sub.facet_tags, sub, BoundaryMeasure({0: sub.exterior}), [sub.cells, sub.facets]
    )


def _check_invariants(cells_tags: EntityTags, facets_tags: EntityTags) -> None:
    """Debug-mode invariants: the dense tags are disjoint by construction,
    so the checks are non-emptiness."""
    ct = cells_tags.as_numpy()
    ft = facets_tags.as_numpy()
    if not np.any(ct == 1):
        raise ValueError("No interior cells (1)!")
    if not np.any(ct == 2):
        warnings.warn("no cut cells computed in the partition.", RuntimeWarning)
    if not np.any(ft == 1):
        raise ValueError("No interior facets (1)!")
    if not np.any(ft == 4):
        raise ValueError("No boundary facets (4)!")
