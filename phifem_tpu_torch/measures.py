"""Integration entity lists: one-sided boundary measures.

Counterpart of :mod:`phifem_tpu.measures`.  A one-sided facet set is a
struct of arrays: facet ids, the chosen side's cell ids, the local facet
index within that cell, and the sign that turns the facet's base normal
into the outward normal of the chosen cell (box-mode subdomain ids 100 =
Gamma_h seen from inside Omega_h, 101 = seen from outside).  The lists are
built on the host from the tags; the arrays live on ``grid.device``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .grid import Grid

__all__ = [
    "FacetSideList",
    "BoundaryMeasure",
    "one_sided_facets",
    "one_sided_facets_multi",
]


@dataclasses.dataclass(frozen=True)
class FacetSideList:
    """A set of facets, each integrated from one chosen adjacent cell."""

    grid: Grid
    facets: torch.Tensor  # (n,) int64 facet ids
    cells: torch.Tensor  # (n,) int64 chosen-side cell ids
    local_facets: torch.Tensor  # (n,) int64 local index of the facet in the cell
    signs: torch.Tensor  # (n,) +1 if the chosen cell is the minus side, else -1

    @property
    def num_facets(self) -> int:
        return int(self.facets.shape[0])

    @property
    def normals(self) -> torch.Tensor:
        """(n, 2) unit normals, outward for the chosen cells."""
        return self.grid.facet_base_normals_of(self.facets) * self.signs[:, None]

    @property
    def lengths(self) -> torch.Tensor:
        return self.grid.facet_lengths_of(self.facets)

    def integration_entities(self) -> np.ndarray:
        """Raveled ``[c0, f0, c1, f1, ...]`` (cell, local facet) pairs."""
        pairs = np.column_stack([self.cells.cpu().numpy(), self.local_facets.cpu().numpy()])
        return np.ravel(pairs).astype(np.int32)


def _one_sided_facets_host(grid: Grid, facet_ids, cell_tags: np.ndarray, side_tags: tuple):
    """Choose for each facet the adjacent cell whose tag is in
    ``side_tags`` (the minus side when both qualify); returns the host
    arrays ``(cells, facets, local_facets, signs)``."""
    facet_ids = np.asarray(facet_ids, np.int64)
    f2c = grid.f2c_of_np(facet_ids)
    tags = np.asarray(cell_tags)
    t0 = np.where(f2c[:, 0] >= 0, tags[np.maximum(f2c[:, 0], 0)], -1)
    t1 = np.where(f2c[:, 1] >= 0, tags[np.maximum(f2c[:, 1], 0)], -1)
    in0 = np.isin(t0, side_tags) & (f2c[:, 0] >= 0)
    in1 = np.isin(t1, side_tags) & (f2c[:, 1] >= 0)
    keep = in0 | in1
    facet_ids = facet_ids[keep]
    chosen = np.where(in0[keep], f2c[keep, 0], f2c[keep, 1])
    signs = np.where(in0[keep], 1.0, -1.0)
    local = grid.local_facet_index_np(chosen, facet_ids)
    return chosen, facet_ids, local, signs


def _to_list(grid: Grid, host) -> FacetSideList:
    cells, facets, local, signs = host
    dev = grid.device
    return FacetSideList(
        grid,
        torch.as_tensor(facets, dtype=torch.int64, device=dev),
        torch.as_tensor(cells, dtype=torch.int64, device=dev),
        torch.as_tensor(local, dtype=torch.int64, device=dev),
        grid._tensor(signs),
    )


def one_sided_facets(
    grid: Grid, facet_ids, cell_tags: np.ndarray, side_tags: tuple
) -> FacetSideList:
    """:class:`FacetSideList` choosing, for each facet, the adjacent cell
    whose tag is in ``side_tags``."""
    return _to_list(grid, _one_sided_facets_host(grid, facet_ids, cell_tags, side_tags))


def one_sided_facets_multi(
    grid: Grid, specs: Dict[int, tuple], cell_tags: np.ndarray
) -> Dict[int, FacetSideList]:
    """Several one-sided facet sets: ``specs`` maps subdomain id ->
    ``(facet_ids, side_tags)``."""
    return {
        ind: one_sided_facets(grid, fids, cell_tags, side) for ind, (fids, side) in specs.items()
    }


@dataclasses.dataclass(frozen=True)
class BoundaryMeasure:
    """Subdomain id -> one-sided facet set, the analogue of the
    reference's ``ds`` with subdomain data.  ``build`` defers the host
    work until a facet set is asked for: a re-tag inside a convergence
    loop that keeps the operator's facet lists never reads it."""

    entries: Optional[Dict[int, FacetSideList]] = None
    build: Optional[Callable[[], Dict[int, FacetSideList]]] = None

    def _resolved(self) -> Dict[int, FacetSideList]:
        if self.entries is None:
            object.__setattr__(self, "entries", self.build())
        return self.entries

    def __call__(self, ind: int) -> FacetSideList:
        return self._resolved()[ind]

    def ids(self):
        return tuple(self._resolved().keys())
