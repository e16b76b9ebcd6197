"""Function spaces, DoF maps, functions and interpolation on structured grids.

Counterpart of :mod:`phifem_tpu.spaces`: Lagrange spaces of any degree
and the DG0 space of the mixed schemes (S3, S4).

* A scalar Lagrange space of degree k numbers DoFs vertices first, then
  (k-1) nodes per facet, then interior nodes per cell — closed-form index
  arithmetic, so the cell->dof map is computed vectorized on the host.
* A DG0 space numbers one DoF per cell, in cell order (on triangles the
  two orientations of a block interleave, ``2 * block + o``).
* Vector/tensor spaces share the scalar DoF map; components are trailing
  axes of the coefficient tensor.
* Coefficient tensors live on ``grid.device`` in ``grid.dtype``.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Callable, Tuple, Union

import numpy as np
import torch

from .elements import Element, classify_nodes, dg0_element, lagrange_element
from .grid import Grid

__all__ = ["Space", "Function", "interpolate", "locate_dofs", "boundary_dof_mask"]


@dataclasses.dataclass(frozen=True)
class Space:
    """A (possibly vector/tensor-valued) Lagrange or DG0 space."""

    grid: Grid
    element: Element
    value_shape: Tuple[int, ...] = ()

    @staticmethod
    def lagrange(grid: Grid, degree: int, value_shape: Tuple[int, ...] = ()) -> "Space":
        return Space(grid, lagrange_element(grid.cell_type.value, degree), value_shape)

    @staticmethod
    def dg0(grid: Grid, value_shape: Tuple[int, ...] = ()) -> "Space":
        return Space(grid, dg0_element(grid.cell_type.value), value_shape)

    # ------------------------------------------------------------------ sizes
    @property
    def degree(self) -> int:
        return self.element.degree

    @property
    def nloc(self) -> int:
        return self.element.nloc

    @property
    def value_size(self) -> int:
        return int(np.prod(self.value_shape)) if self.value_shape else 1

    @property
    def num_scalar_dofs(self) -> int:
        g, k = self.grid, self.degree
        if self.element.family == "DG":
            return g.num_cells
        n_int = {
            "triangle": (k - 1) * (k - 2) // 2,
            "quadrilateral": (k - 1) ** 2,
        }[self.element.cell]
        return g.num_vertices + g.num_facets * (k - 1) + g.num_cells * n_int

    @property
    def num_dofs(self) -> int:
        return self.num_scalar_dofs * self.value_size

    @property
    def dof_shape(self) -> Tuple[int, ...]:
        return (self.num_scalar_dofs,) + tuple(self.value_shape)

    # --------------------------------------------------------------- dof maps
    @cached_property
    def cell_dofs_np(self) -> np.ndarray:
        """(num_cells, nloc) int32 global scalar-DoF ids per local node.
        Edge nodes follow the *global* facet parametrization; the only flip
        on this grid is the upper triangle's top edge (local facet 1)."""
        g, k = self.grid, self.degree
        if self.element.family == "DG":
            return np.arange(g.num_cells, dtype=np.int32)[:, None]
        kind, entity, param = classify_nodes(self.element)
        edge_base = g.num_vertices
        cell_base = g.num_vertices + g.num_facets * (k - 1)
        n_int = int(np.sum(kind == 2))

        cols = []
        cells = np.arange(g.num_cells, dtype=np.int64)
        orient = g.cell_orientations_np
        cv = g.cell_vertices_np
        c2f = g.c2f_np
        for m in range(self.nloc):
            if kind[m] == 0:
                col = cv[:, int(entity[m])]
            elif kind[m] == 1:
                lf = int(entity[m])
                facet = c2f[:, lf]
                idx_local = int(round(float(param[m]) * k)) - 1
                idx_rev = (k - 1) - 1 - idx_local
                if g.is_simplex and lf == 1:
                    idx = np.where(orient == 1, idx_rev, idx_local)
                else:
                    idx = np.full_like(cells, idx_local)
                col = edge_base + facet * (k - 1) + idx
            else:
                col = cell_base + cells * n_int + int(entity[m])
            cols.append(col.astype(np.int32))
        return np.stack(cols, axis=-1)

    @cached_property
    def cell_dofs(self) -> torch.Tensor:
        return torch.as_tensor(self.cell_dofs_np, dtype=torch.int64, device=self.grid.device)

    def cell_dofs_of(self, cells: torch.Tensor) -> torch.Tensor:
        """(len(cells), nloc) int64 DoF ids of the given cells on
        ``grid.device``.  P1 DoFs are the cell vertices, computed in closed
        form, so a batch of a few cells never builds the whole-grid table."""
        g = self.grid
        cells = torch.as_tensor(cells, device=g.device).to(torch.int64)
        if self.element.family == "DG":
            return cells[:, None]
        if self.degree != 1:
            return self.cell_dofs[cells]
        if g.is_simplex:
            block, which = cells // 2, cells % 2
        else:
            block, which = cells, torch.zeros_like(cells)
        ix, iy = block % g.nx, block // g.nx
        v00 = iy * (g.nx + 1) + ix
        v10, v01, v11 = v00 + 1, v00 + g.nx + 1, v00 + g.nx + 2
        if not g.is_simplex:
            return torch.stack([v00, v10, v01, v11], dim=-1)
        lower = torch.stack([v00, v10, v11], dim=-1)
        upper = torch.stack([v00, v11, v01], dim=-1)
        return torch.where((which == 0)[:, None], lower, upper)

    @cached_property
    def dof_coords_np(self) -> np.ndarray:
        """(num_scalar_dofs, 2) physical coordinates of scalar DoFs."""
        g, k = self.grid, self.degree
        if self.element.family == "DG":
            return g.vertex_coords_np[g.cell_vertices_np].mean(axis=1)
        coords = [g.vertex_coords_np]
        if k > 1:
            ends = g.facet_endpoints_np  # (nf, 2, 2)
            ts = np.asarray([(m + 1) / k for m in range(k - 1)])
            fac = (
                ends[:, None, 0, :] * (1 - ts)[None, :, None]
                + ends[:, None, 1, :] * ts[None, :, None]
            )
            coords.append(fac.reshape(-1, 2))
            kind, _, _ = classify_nodes(self.element)
            int_nodes = self.element.nodes[kind == 2]
            if len(int_nodes):
                verts = g.vertex_coords_np[g.cell_vertices_np]  # (nc, nv, 2)
                if g.is_simplex:
                    p0 = verts[:, 0, :]
                    e1 = verts[:, 1, :] - p0
                    e2 = verts[:, 2, :] - p0
                    pts = (
                        p0[:, None, :]
                        + int_nodes[None, :, 0:1] * e1[:, None, :]
                        + int_nodes[None, :, 1:2] * e2[:, None, :]
                    )
                else:
                    scale = np.array([g.hx, g.hy])
                    pts = g.cell_origins_np[:, None, :] + int_nodes[None] * scale
                coords.append(pts.reshape(-1, 2))
        return np.concatenate(coords, axis=0)

    @cached_property
    def dof_coords(self) -> torch.Tensor:
        if self.element.family == "Lagrange" and self.degree == 1:
            # P1 scalar DoFs ARE the vertices: reuse the device-built lattice
            return self.grid.vertex_coords
        return self.grid._tensor(self.dof_coords_np)

    # --------------------------------------------------------- basis values
    def _basis(self, ref_pts: torch.Tensor) -> torch.Tensor:
        """(npts, nloc) basis values at reference points.  Powers by
        repeated multiplication, so ``0**0 == 1`` exactly (as
        ``_basis_jnp``)."""
        e = self.element
        exps = np.asarray(e._exps)
        coeffs = torch.as_tensor(e._coeffs, dtype=ref_pts.dtype, device=ref_pts.device)

        def powers(base):  # (..., 1) -> (..., kmax+1)
            cols = [torch.ones_like(base)]
            for _ in range(int(exps.max())):
                cols.append(cols[-1] * base)
            return torch.cat(cols, dim=-1)

        rpow, spow = powers(ref_pts[..., 0:1]), powers(ref_pts[..., 1:2])
        return (rpow[..., exps[:, 0].tolist()] * spow[..., exps[:, 1].tolist()]) @ coeffs

    def locate(self, pts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Point location on the structured grid: points -> (cell, ref_pt)."""
        g = self.grid
        x = (pts[..., 0] - g.x0) / g.hx
        y = (pts[..., 1] - g.y0) / g.hy
        bx = torch.clamp(torch.floor(x), 0, g.nx - 1).to(torch.int64)
        by = torch.clamp(torch.floor(y), 0, g.ny - 1).to(torch.int64)
        r = x - bx
        s = y - by
        block = by * g.nx + bx
        if not g.is_simplex:
            return block, torch.stack([r, s], dim=-1)
        lower = s <= r
        cell = torch.where(lower, 2 * block, 2 * block + 1)
        ref = torch.where(
            lower[..., None],
            torch.stack([r - s, s], dim=-1),
            torch.stack([r, s - r], dim=-1),
        )
        return cell, ref


@dataclasses.dataclass
class Function:
    """A discrete field: coefficients of shape ``space.dof_shape``."""

    space: Space
    data: torch.Tensor

    def eval(self, pts: torch.Tensor) -> torch.Tensor:
        """Evaluate at arbitrary physical points (n, 2); points outside the
        bbox extrapolate from the nearest edge cell."""
        cells, ref = self.space.locate(pts)
        basis = self.space._basis(ref)  # (n, nloc)
        nodal = self.data[self.space.cell_dofs[cells]]  # (n, nloc, *vs)
        return torch.einsum("nl,nl...->n...", basis, nodal)


def locate_dofs(space: Space, predicate: Callable) -> torch.Tensor:
    """Boolean mask over scalar DoFs where ``predicate(x: (n,2)) -> bool``
    holds at the DoF coordinate."""
    return torch.as_tensor(predicate(space.dof_coords), dtype=torch.bool)


def boundary_dof_mask(space: Space, tol: float = 1e-12) -> torch.Tensor:
    """Mask of scalar DoFs on the background-box boundary."""
    (x0, y0), (x1, y1) = space.grid.bbox

    def pred(x):
        return (
            (torch.abs(x[:, 0] - x0) < tol)
            | (torch.abs(x[:, 0] - x1) < tol)
            | (torch.abs(x[:, 1] - y0) < tol)
            | (torch.abs(x[:, 1] - y1) < tol)
        )

    return locate_dofs(space, pred)


def interpolate(f: Union[Callable, Function], space: Space) -> Function:
    """Interpolate a callable ``f(x: (n,2)) -> (n, *value_shape)`` (torch
    in, torch out) or another :class:`Function` onto ``space``."""
    coords = space.dof_coords
    g = space.grid
    if isinstance(f, Function):
        vals = f.eval(coords)
    else:
        vals = torch.as_tensor(f(coords), dtype=g.dtype, device=g.device)
        if space.value_shape and vals.shape[: len(space.value_shape)] == tuple(
            space.value_shape
        ):
            # tolerate reference-style (*value_shape, n) returns
            vals = torch.movedim(vals, -1, 0)
    expected = (coords.shape[0],) + tuple(space.value_shape)
    if vals.shape != expected:
        vals = torch.broadcast_to(vals, expected).clone()
    return Function(space, vals)
