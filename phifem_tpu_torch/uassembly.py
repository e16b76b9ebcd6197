"""Assembly on imported meshes: the solve path for a ``UMesh`` or ``UMesh3``.

Counterpart of :mod:`phifem_tpu.uassembly`.  The same term DSL as
:mod:`phifem_tpu_torch.assembly` (:class:`CellTerm`, :class:`FacetTerm`,
:class:`BoundaryTerm`, the same integrand signatures) is assembled on a
:class:`~phifem_tpu_torch.umesh.UMesh` (triangles or quadrilaterals) or a
:class:`~phifem_tpu_torch.umesh3.UMesh3` (tetrahedra) into a standard
:class:`~phifem_tpu_torch.assembly.Operator` of entity batches, so the
whole downstream stack (the Krylov solvers, reassembly, restricted CSR
extraction, the AMG and band preconditioners) works unchanged.

* An imported mesh has no orientation classes: every cell carries its own
  geometry (``Jinv``, ``|det J|``, the diameter ``h``), computed on the host
  in float64 and moved to ``mesh.device`` once.  ``term.uniform`` is
  ignored.  Element matrices come from
  ``torch.func.jacfwd(torch.func.grad(local))`` under ``vmap`` over the
  entities, as in the structured path's cut batches.
* Simplices are affine: one ``Jinv`` per cell, ``h`` the longest edge.  A
  quadrilateral is the bilinear image of the unit square (its VTK ring at
  (0,0), (1,0), (1,1), (0,1)): ``Jinv`` and ``|det J|`` are taken at every
  quadrature point, ``h`` is the largest vertex distance (a diagonal).
* Reference-domain basis tables are shared constants; physical gradients
  and Hessians are formed inside the local energy (``g_phys = g_ref Jinv``).
  ``ctx.h`` is the per-cell diameter.
* Facet terms find each side's reference coordinates of the facet's
  quadrature points by inverting the cell map (affine inverse, or a Newton
  inversion of the bilinear map), so no local-facet orientation bookkeeping
  is needed.  Edges take Gauss-Legendre points, tetrahedron faces the
  symmetric triangle rule of matching exactness.
* A batch is rebuildable (data-dependent, see
  :meth:`~phifem_tpu_torch.assembly.Operator.reassemble`) exactly when its
  term reads a discrete function, as in the JAX package: the interface band
  of the preconditioners is the DoFs those batches touch.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import grad, jacfwd, vmap

from .assembly import (
    Batch,
    BoundaryTerm,
    CellTerm,
    Ctx,
    FacetTerm,
    FieldEval,
    Operator,
    System,
    _entity_map,
    _eval_field,
    _layout,
    _normalize_data,
    _prune_batch,
    _unpack,
)
from .elements import TET_EDGES, Element, classify_nodes, classify_nodes_tet, dg0_element, lagrange_element
from .quadrature import cell_rule, segment_rule
from .spaces import Function
from .umesh import UMesh, USideList, _unique_rows

__all__ = [
    "USpace",
    "UFunction",
    "interpolate",
    "boundary_dof_mask",
    "assemble_operator",
    "assemble_vector",
    "assemble_scalar",
]

# classify_nodes local-facet ids (0: p0-p1, 1: p1-p2, 2: p0-p2) -> UMesh
# local-edge rows (dolfinx order [[1,2],[0,2],[0,1]]); directions agree.
_CLS2MESH_TRI = np.array([2, 0, 1])
# quad element-local tensor vertex order (v00, v10, v01, v11) -> the VTK ring
# position in UMesh quad cells (ring v0..v3 at (0,0), (1,0), (1,1), (0,1))
_QUADV2RING = np.array([0, 1, 3, 2])
# classify_nodes quad facet ids (0 left, 1 right, 2 bottom, 3 top) -> (UMesh
# c2f column of the VTK ring edge, the ring vertex where the parameter
# starts, the one where it ends); the parameter runs bottom -> top / left ->
# right
_QUAD_CLS_EDGE = np.array([[3, 0, 3], [1, 1, 2], [0, 0, 1], [2, 3, 2]])


# ------------------------------------------------------------------ spaces
@dataclasses.dataclass(frozen=True)
class USpace:
    """Lagrange (degree 1-3) or DG0 space on an imported mesh (triangles,
    quadrilaterals or tetrahedra), scalar or with a ``value_shape``: the :class:`~phifem_tpu_torch.spaces.
    Space` contract that :class:`System`, :class:`Batch` and the solvers
    read (``nloc``, ``value_shape``, ``num_dofs``, ``dof_shape``,
    ``cell_dofs``, ``grid.device`` / ``grid.dtype``)."""

    mesh: UMesh
    element: Element
    value_shape: Tuple[int, ...] = ()

    @staticmethod
    def lagrange(mesh: UMesh, degree: int, value_shape: Tuple[int, ...] = ()) -> "USpace":
        return USpace(mesh, lagrange_element(mesh.cell_name, degree), tuple(value_shape))

    @staticmethod
    def dg0(mesh: UMesh, value_shape: Tuple[int, ...] = ()) -> "USpace":
        return USpace(mesh, dg0_element(mesh.cell_name), tuple(value_shape))

    @property
    def grid(self) -> UMesh:
        """The mesh, under the name the port's shared layers read."""
        return self.mesh

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
    def _is_tet(self) -> bool:
        return self.element.cell == "tetrahedron"

    @property
    def num_scalar_dofs(self) -> int:
        m, k = self.mesh, self.degree
        if self.element.family == "DG":
            return m.num_cells
        n = m.num_vertices
        if k > 1 and self._is_tet:
            kind, _, _ = classify_nodes_tet(self.element)
            n += m.edges.shape[0] * (k - 1)
            n += m.num_facets * (int(np.sum(kind == 2)) // 4)  # nodes per face
            n += m.num_cells * int(np.sum(kind == 3))
        elif k > 1:
            n += m.num_facets * (k - 1)
            kind, _, _ = classify_nodes(self.element)
            n += m.num_cells * int(np.sum(kind == 2))
        return n

    @property
    def num_dofs(self) -> int:
        return self.num_scalar_dofs * self.value_size

    @property
    def dof_shape(self) -> Tuple[int, ...]:
        return (self.num_scalar_dofs,) + tuple(self.value_shape)

    @cached_property
    def cell_dofs_np(self) -> np.ndarray:
        """(num_cells, nloc) int32 global scalar-DoF ids.  Edge nodes are
        numbered along the global facet direction (ascending vertex id, the
        ``UMesh.facets`` sort), so neighbouring cells agree."""
        m, k = self.mesh, self.degree
        if self.element.family == "DG":
            return np.arange(m.num_cells, dtype=np.int32)[:, None]
        if self._is_tet:
            return self._cell_dofs_tet()
        kind, entity, param = classify_nodes(self.element)
        edge_base = m.num_vertices
        cell_base = m.num_vertices + m.num_facets * (k - 1)
        n_int = int(np.sum(kind == 2))
        cells = np.arange(m.num_cells, dtype=np.int64)
        le = m._local_edges  # (3, 2) local vertex pairs, dolfinx order

        cols = []
        for loc in range(self.nloc):
            if kind[loc] == 0:
                lv = int(entity[loc])
                col = m.cells[:, lv if m.is_simplex else int(_QUADV2RING[lv])].astype(np.int64)
            elif kind[loc] == 1:
                if m.is_simplex:
                    lf = _CLS2MESH_TRI[int(entity[loc])]
                    va, vb = m.cells[:, le[lf, 0]], m.cells[:, le[lf, 1]]
                else:
                    lf, a_r, b_r = _QUAD_CLS_EDGE[int(entity[loc])]
                    va, vb = m.cells[:, a_r], m.cells[:, b_r]
                facet = m.c2f[:, lf].astype(np.int64)
                idx_local = int(round(float(param[loc]) * k)) - 1
                idx_rev = (k - 1) - 1 - idx_local
                # flip where the local edge runs against the global
                # (ascending-vertex-id) direction
                idx = np.where(va <= vb, idx_local, idx_rev)
                col = edge_base + facet * (k - 1) + idx
            else:
                col = cell_base + cells * n_int + int(entity[loc])
            cols.append(col.astype(np.int32))
        return np.stack(cols, axis=-1)

    def _cell_dofs_tet(self) -> np.ndarray:
        """Tet DoF map: vertices, then the nodes of each global edge
        (numbered along ascending vertex id, as in 2D), then one node per
        face (degree <= 3), then the cell-interior nodes."""
        m, k = self.mesh, self.degree
        kind, entity, param = classify_nodes_tet(self.element)
        n_face = int(np.sum(kind == 2)) // 4
        edge_base = m.num_vertices
        face_base = m.num_vertices + m.edges.shape[0] * (k - 1)
        cell_base = face_base + m.num_facets * n_face
        n_int = int(np.sum(kind == 3))
        cells = np.arange(m.num_cells, dtype=np.int64)

        cols = []
        for loc in range(self.nloc):
            if kind[loc] == 0:
                col = m.cells[:, int(entity[loc])].astype(np.int64)
            elif kind[loc] == 1:
                le = TET_EDGES[int(entity[loc])]
                edge = m.c2e[:, int(entity[loc])].astype(np.int64)
                idx_local = int(round(float(param[loc]) * k)) - 1
                idx_rev = (k - 1) - 1 - idx_local
                idx = np.where(m.cells[:, le[0]] <= m.cells[:, le[1]], idx_local, idx_rev)
                col = edge_base + edge * (k - 1) + idx
            elif kind[loc] == 2:
                col = face_base + m.c2f[:, int(entity[loc])].astype(np.int64) * n_face  # n_face == 1 for k <= 3
            else:
                col = cell_base + cells * n_int + int(entity[loc])
            cols.append(col.astype(np.int32))
        return np.stack(cols, axis=-1)

    @cached_property
    def cell_dofs(self) -> torch.Tensor:
        return torch.as_tensor(self.cell_dofs_np, dtype=torch.int64, device=self.mesh.device)

    def cell_dofs_of(self, cells) -> torch.Tensor:
        cells = torch.as_tensor(cells, device=self.mesh.device).to(torch.int64)
        return self.cell_dofs[cells]

    @cached_property
    def dof_coords_np(self) -> np.ndarray:
        """(num_scalar_dofs, dim) physical DoF coordinates: vertices, then the
        facet (tets: edge, then face) nodes in the global direction, then the
        cell-interior nodes."""
        m, k = self.mesh, self.degree
        if self.element.family == "DG":
            return m.cell_centroids
        if self._is_tet:
            return self._dof_coords_tet()
        coords = [m.verts]
        if k > 1:
            ends = m.facet_endpoints  # (nf, 2, 2), ascending vertex id
            ts = np.asarray([(j + 1) / k for j in range(k - 1)])
            fac = ends[:, None, 0, :] * (1 - ts)[None, :, None] + ends[:, None, 1, :] * ts[None, :, None]
            coords.append(fac.reshape(-1, 2))
            kind, _, _ = classify_nodes(self.element)
            int_nodes = self.element.nodes[kind == 2]
            if len(int_nodes):
                # affine on triangles, bilinear on quads
                coords.append(m.map_to_physical(int_nodes).reshape(-1, 2))
        return np.concatenate(coords, axis=0)

    def _dof_coords_tet(self) -> np.ndarray:
        m, k = self.mesh, self.degree
        coords = [m.verts]
        if k > 1:
            kind, _, _ = classify_nodes_tet(self.element)
            ends = m.verts[m.edges]  # (ne, 2, 3), ascending vertex id
            ts = np.asarray([(j + 1) / k for j in range(k - 1)])
            coords.append((ends[:, None, 0, :] * (1 - ts)[None, :, None]
                           + ends[:, None, 1, :] * ts[None, :, None]).reshape(-1, 3))
            if int(np.sum(kind == 2)):  # one centroid node per face (k == 3)
                coords.append(m.facet_endpoints.mean(axis=1))
            int_nodes = self.element.nodes[kind == 3]
            if len(int_nodes):
                coords.append(m.map_to_physical(int_nodes).reshape(-1, 3))
        return np.concatenate(coords, axis=0)

    @cached_property
    def dof_coords(self) -> torch.Tensor:
        return self.mesh._tensor(self.dof_coords_np)


@dataclasses.dataclass
class UFunction:
    """Discrete field on a :class:`USpace`: coefficients of shape
    ``space.dof_shape`` on the mesh's device, in its dtype."""

    space: USpace
    data: torch.Tensor

    @staticmethod
    def zeros(space: USpace) -> "UFunction":
        m = space.mesh
        return UFunction(space, torch.zeros(space.dof_shape, dtype=m.dtype, device=m.device))


def interpolate(f: Callable, space: USpace) -> UFunction:
    """Nodal interpolation of a callable ``f((n, dim) tensor) -> (n, *vs)``."""
    if isinstance(f, UFunction) and f.space is space:
        return f
    pts = space.dof_coords
    vals = torch.as_tensor(f(pts), dtype=space.mesh.dtype, device=space.mesh.device)
    want = (pts.shape[0],) + tuple(space.value_shape)
    return UFunction(space, torch.reshape(vals, want))


def boundary_dof_mask(space: USpace) -> torch.Tensor:
    """Mask of the scalar DoFs on the mesh's exterior boundary: the
    vertices, edge nodes (and tets' face nodes) of the facets with one
    adjacent cell."""
    if space.element.family == "DG":
        raise ValueError("DG spaces have no boundary DoFs")
    m, k = space.mesh, space.degree
    bf = np.where(m.boundary_facet_mask)[0]
    mask = np.zeros(space.num_scalar_dofs, bool)
    mask[np.unique(m.facets[bf])] = True
    if k > 1 and space._is_tet:
        # the edge nodes of the boundary faces' edges, and the face nodes
        fv = m.facets[bf]  # (nb, 3) sorted vertex triples
        face_edges = np.sort(fv[:, [[0, 1], [0, 2], [1, 2]]].reshape(-1, 2), axis=1)
        keys = m.edges[:, 0].astype(np.int64) * (m.num_vertices + 1) + m.edges[:, 1]
        q = face_edges[:, 0].astype(np.int64) * (m.num_vertices + 1) + face_edges[:, 1]
        edge = m.num_vertices + np.searchsorted(keys, q)[:, None] * (k - 1) + np.arange(k - 1)[None, :]
        mask[edge.reshape(-1)] = True
        kind, _, _ = classify_nodes_tet(space.element)
        n_face = int(np.sum(kind == 2)) // 4
        if n_face:
            mask[m.num_vertices + m.edges.shape[0] * (k - 1) + bf * n_face] = True
    elif k > 1:
        edge = m.num_vertices + bf[:, None] * (k - 1) + np.arange(k - 1)[None, :]
        mask[edge.reshape(-1)] = True
    return torch.as_tensor(mask, device=m.device)


def _is_fn(v) -> bool:
    return isinstance(v, (UFunction, Function))


def _split(data: Dict):
    fn_data = {k: v for k, v in data.items() if _is_fn(v)}
    call_data = {k: v for k, v in data.items() if not _is_fn(v)}
    return fn_data, call_data


# --------------------------------------------------------------- geometry
def _cell_geometry(mesh: UMesh, cells: np.ndarray):
    """Per-cell affine geometry, host float64: ``(p0 (ne, d), Jinv (ne, d,
    d), absdet (ne,), h (ne,))`` with ``Jinv[r, x] = d ref_r / d x`` and
    ``h`` the longest edge (UFL ``CellDiameter``).  Tetrahedra go to
    :func:`~phifem_tpu_torch.umesh3._cell_geometry3`.  On a quadrilateral it
    is the affine map of its ring vertices 0, 1, 2, as in the JAX package:
    only the facet terms without fields read it there (their ``h``)."""
    if mesh.dim == 3:
        from .umesh3 import _cell_geometry3

        return _cell_geometry3(mesh, cells)
    V = mesh.verts[mesh.cells[cells]]  # (ne, 3|4, 2)
    p0 = V[:, 0]
    J = np.stack([V[:, 1] - p0, V[:, 2] - p0], axis=-1)  # J[i, r] = dx_i/dref_r
    det = J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0]
    Jinv = (
        np.stack(
            [
                np.stack([J[:, 1, 1], -J[:, 0, 1]], axis=-1),
                np.stack([-J[:, 1, 0], J[:, 0, 0]], axis=-1),
            ],
            axis=1,
        )
        / det[:, None, None]
    )
    e01 = np.linalg.norm(V[:, 1] - V[:, 0], axis=1)
    e02 = np.linalg.norm(V[:, 2] - V[:, 0], axis=1)
    e12 = np.linalg.norm(V[:, 2] - V[:, 1], axis=1)
    h = np.maximum(np.maximum(e01, e02), e12)
    return p0, Jinv, np.abs(det), h


def _bilinear(V: np.ndarray, r: np.ndarray, s: np.ndarray) -> np.ndarray:
    """The ring bilinear map of quads ``V (ne, 4, 2)`` at ``(r, s)``
    broadcast against ``(ne, nq, 1)``."""
    return (
        (1 - r) * (1 - s) * V[:, None, 0]
        + r * (1 - s) * V[:, None, 1]
        + r * s * V[:, None, 2]
        + (1 - r) * s * V[:, None, 3]
    )


def _bilinear_derivs(V: np.ndarray, r: np.ndarray, s: np.ndarray):
    """``(dx/dr, dx/ds)``, each (ne, nq, 2), of the ring bilinear map."""
    dxr = -(1 - s) * V[:, None, 0] + (1 - s) * V[:, None, 1] + s * V[:, None, 2] - s * V[:, None, 3]
    dxs = -(1 - r) * V[:, None, 0] - r * V[:, None, 1] + r * V[:, None, 2] + (1 - r) * V[:, None, 3]
    return dxr, dxs


def _quad_geometry_at(mesh: UMesh, cells: np.ndarray, ref_pts: np.ndarray):
    """Per-point bilinear geometry of quad cells, host float64: ``(x (ne,
    nq, 2), Jinv (ne, nq, 2, 2), absdet (ne, nq), h (ne,))`` at the given
    reference points (J varies over a quad)."""
    V = mesh.verts[mesh.cells[cells]]  # (ne, 4, 2) ring order
    x = _bilinear(V, ref_pts[None, :, 0, None], ref_pts[None, :, 1, None])
    Jinv, absdet = _quad_jacobian(V, np.broadcast_to(ref_pts[None], (V.shape[0],) + ref_pts.shape))
    return x, Jinv, absdet, _quad_h(V)


def _quad_h(V: np.ndarray) -> np.ndarray:
    """UFL ``CellDiameter`` of quads: the largest vertex distance, a
    diagonal (the structured ``Grid.cell_diameter``)."""
    edges = np.linalg.norm(V - np.roll(V, -1, axis=1), axis=-1)
    d02 = np.linalg.norm(V[:, 2] - V[:, 0], axis=-1)
    d13 = np.linalg.norm(V[:, 3] - V[:, 1], axis=-1)
    return np.maximum(edges.max(axis=1), np.maximum(d02, d13))


def _quad_jacobian(V: np.ndarray, ref: np.ndarray):
    """``(Jinv (ne, nq, 2, 2), absdet (ne, nq))`` of the ring bilinear map
    at per-cell reference points ``ref (ne, nq, 2)``."""
    dxr, dxs = _bilinear_derivs(V, ref[..., 0, None], ref[..., 1, None])
    J = np.stack([dxr, dxs], axis=-1)  # J[..., i, c] = dx_i/dref_c
    det = J[..., 0, 0] * J[..., 1, 1] - J[..., 0, 1] * J[..., 1, 0]
    Jinv = (
        np.stack(
            [
                np.stack([J[..., 1, 1], -J[..., 0, 1]], axis=-1),
                np.stack([-J[..., 1, 0], J[..., 0, 0]], axis=-1),
            ],
            axis=-2,
        )
        / det[..., None, None]
    )
    return Jinv, np.abs(det)


def _quad_invert_map(mesh: UMesh, cells: np.ndarray, x_np: np.ndarray) -> np.ndarray:
    """Reference coordinates of the physical points ``x_np (ne, nq, 2)``
    in each quad cell: 8 Newton steps on the ring bilinear map from the
    cell's centre (2-3 reach machine precision on a non-degenerate quad)."""
    V = mesh.verts[mesh.cells[cells]]  # (ne, 4, 2)
    ref = np.full(x_np.shape, 0.5)
    for _ in range(8):
        r = ref[..., 0, None]
        s = ref[..., 1, None]
        F = _bilinear(V, r, s) - x_np
        dxr, dxs = _bilinear_derivs(V, r, s)
        det = dxr[..., 0] * dxs[..., 1] - dxr[..., 1] * dxs[..., 0]
        dr = (dxs[..., 1] * F[..., 0] - dxs[..., 0] * F[..., 1]) / det
        ds = (-dxr[..., 1] * F[..., 0] + dxr[..., 0] * F[..., 1]) / det
        ref = ref - np.stack([dr, ds], axis=-1)
    return ref


def _is_quad(mesh) -> bool:
    """Bilinear cells: the geometry is taken per point."""
    return mesh.dim == 2 and not mesh.is_simplex


def _phys_evals(u_loc, valq, grefq, hrefq, Jinv) -> FieldEval:
    """FieldEval at one point, gradients and Hessians pushed forward by
    the cell's ``Jinv``."""
    gphys = torch.einsum("lr,rx->lx", grefq, Jinv)
    hphys = torch.einsum("ry,lrs,sx->lyx", Jinv, hrefq, Jinv)
    return _eval_field(u_loc, valq, gphys, hphys)


def _all_points(u_loc, val, gref, href, Jinv, linear: bool):
    """``(value, gradient, Hessian)`` of ``u_loc`` at every point of the
    tables ``val (nq, nloc)``, ``gref``, ``href`` under a constant
    ``Jinv``, each with the points leading; a ``linear`` element (degree <=
    1 on a simplex: ``href`` is 0) gets a zero Hessian, not a contraction."""
    grad = torch.einsum("qlx,l...->q...x", torch.einsum("qlr,rx->qlx", gref, Jinv), u_loc)
    if linear:
        hess = torch.zeros(grad.shape + grad.shape[-1:], dtype=grad.dtype, device=grad.device)
    else:
        hess = torch.einsum("qlxy,l...->q...xy", torch.einsum("ry,qlrs,sx->qlyx", Jinv, href, Jinv), u_loc)
    return torch.einsum("ql,l...->q...", val, u_loc), grad, hess


def _field_evals(tables: Dict) -> Dict:
    return {n: FieldEval(*a) for n, a in tables.items()}


def _sum_points(at, args, batched_u: bool, x, w):
    """``sum_q w_q at(args at q, x_q)``: ``at(V, U, D, C, x)`` is ``vmap``-ed
    over the points (the leading axis of every table in ``args = (V, U, D,
    C)``; ``U`` is None for a linear form), then summed.  Tetrahedra take
    this path: their forms run up to 125 points a cell, where a Python loop
    over the points would issue every operation of the integrand once per
    point."""
    in_dims = (0, 0 if batched_u else None, 0, 0, 0)
    return (vmap(at, in_dims=in_dims)(*args, x) * w).sum(0)


def _region_cells_u(mesh: UMesh, cell_tags, region) -> np.ndarray:
    if region is None or cell_tags is None:
        return np.arange(mesh.num_cells, dtype=np.int32)
    return np.where(np.isin(np.asarray(cell_tags), np.asarray(region)))[0].astype(np.int32)


def _ref_tabs(mesh: UMesh, element: Element, ref_pts: np.ndarray):
    return (
        mesh._tensor(element.tabulate(ref_pts)),
        mesh._tensor(element.tabulate_grad(ref_pts)),
        mesh._tensor(element.tabulate_hess(ref_pts)),
    )


def _index(mesh: UMesh, a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.int64, device=mesh.device)


# -------------------------------------------------------------- cell terms
def _u_cell_local_fn(system: System, term: CellTerm, mesh: UMesh, data: Dict, cells: np.ndarray):
    """``(local, cell_data, ntot, layout, fn_data)``: the per-cell energy
    and the function that builds its per-cell data (geometry, gathered
    coefficients, callables at the quadrature points); ``cell_data(arrays)``
    takes the Functions' coefficient tensors by name."""
    ref_pts, wq = cell_rule(mesh.cell_name, term.degree)
    layout = _layout(system)
    ntot = sum(l[-1] for l in layout)
    tabs = {n: _ref_tabs(mesh, s.element, ref_pts) for n, s in system.fields.items()}
    fn_data, call_data = _split(data)
    degrees = {n: sp.degree for n, sp in system.fields.items()}
    data_degrees = {k: f.space.degree for k, f in fn_data.items()}
    dtabs = {k: _ref_tabs(mesh, v.space.element, ref_pts) for k, v in fn_data.items()}

    per_point = _is_quad(mesh)
    if per_point:
        x_np, Jinv, absdet, h = _quad_geometry_at(mesh, cells, ref_pts)
        wdet = wq[None, :] * absdet
    else:
        _, Jinv, absdet, h = _cell_geometry(mesh, cells)  # constant over a simplex
        lam = np.concatenate([1.0 - ref_pts.sum(axis=1, keepdims=True), ref_pts], axis=1)
        x_np = np.einsum("qk,ckx->cqx", lam, mesh.verts[mesh.cells[cells]])
        wdet = wq[None, :] * absdet[:, None]
    geo = {
        "Jinv": mesh._tensor(Jinv),  # (ne, d, d), or (ne, nq, 2, 2) on quads
        "wdet": mesh._tensor(wdet),
        "x": mesh._tensor(x_np),
        "h": mesh._tensor(h),
    }
    dof_tables = {k: _index(mesh, f.space.cell_dofs_np[cells]) for k, f in fn_data.items()}

    def cell_data(arrays: Optional[Dict] = None) -> Dict:
        cd = dict(geo)
        for k, f in fn_data.items():
            dat = arrays[k] if arrays is not None else f.data
            cd["d_" + k] = dat[dof_tables[k]]
        for k, f in call_data.items():
            vals = f(cd["x"].reshape(-1, mesh.dim))
            cd["c_" + k] = vals.reshape(cd["x"].shape[:2] + vals.shape[1:])
        return cd

    nq = len(wq)

    def local_points(u_locs, v_locs, cd, ctx):
        """Every point at once (tetrahedra)."""
        Ji = cd["Jinv"]
        V = {n: _all_points(v_locs[n], *t, Ji, degrees[n] <= 1) for n, t in tabs.items()}
        U = None if u_locs is None else {n: _all_points(u_locs[n], *t, Ji, degrees[n] <= 1) for n, t in tabs.items()}
        D = {k: _all_points(cd["d_" + k], *t, Ji, data_degrees[k] <= 1) for k, t in dtabs.items()}
        C = {k: cd["c_" + k] for k in call_data}

        def at(V, U, D, C, x):
            d_ev = _field_evals(D)
            d_ev.update({k: FieldEval(c, None, None) for k, c in C.items()})
            if U is None:
                return term.integrand(_field_evals(V), d_ev, x, ctx)
            return term.integrand(_field_evals(U), _field_evals(V), d_ev, x, ctx)

        return _sum_points(at, (V, U, D, C), U is not None, cd["x"], cd["wdet"])

    def local(uflat, vflat, cd):
        ctx = Ctx(h=cd["h"])
        u_locs = _unpack(uflat, layout) if uflat is not None else None
        v_locs = _unpack(vflat, layout)
        if mesh.dim == 3:
            return local_points(u_locs, v_locs, cd, ctx)
        contrib = 0.0
        for q in range(nq):
            Ji = cd["Jinv"][q] if per_point else cd["Jinv"]
            v_ev = {n: _phys_evals(v_locs[n], t[0][q], t[1][q], t[2][q], Ji) for n, t in tabs.items()}
            d_ev = {k: _phys_evals(cd["d_" + k], t[0][q], t[1][q], t[2][q], Ji) for k, t in dtabs.items()}
            for k in call_data:
                d_ev[k] = FieldEval(cd["c_" + k][q], None, None)
            xpt, w = cd["x"][q], cd["wdet"][q]
            if u_locs is not None:
                u_ev = {n: _phys_evals(u_locs[n], t[0][q], t[1][q], t[2][q], Ji) for n, t in tabs.items()}
                contrib = contrib + w * term.integrand(u_ev, v_ev, d_ev, xpt, ctx)
            else:
                contrib = contrib + w * term.integrand(v_ev, d_ev, xpt, ctx)
        return contrib

    return local, cell_data, ntot, layout, fn_data


# ------------------------------------------------------------- facet terms
def _facet_side_tabs(element: Element, mesh: UMesh, cells: np.ndarray, x_np: np.ndarray):
    """One side's basis tables at per-facet physical points ``x_np (nf,
    nq, d)``: the points mapped back into the side's cells (the affine
    inverse, or the Newton inversion of the bilinear map), tabulated on the
    host.  Returns ``(val (nf, nq, nloc), gref (nf, nq, nloc, d), href (nf,
    nq, nloc, d, d))`` tensors, ``Jinv`` (``(nf, d, d)``; per point, ``(nf,
    nq, 2, 2)``, on quads) and host ``h (nf,)``."""
    d = mesh.dim
    nf, nq = x_np.shape[:2]
    if _is_quad(mesh):
        V = mesh.verts[mesh.cells[cells]]
        ref = _quad_invert_map(mesh, cells, x_np)
        Jinv, _ = _quad_jacobian(V, ref)
        h = _quad_h(V)
    else:
        p0, Jinv, _, h = _cell_geometry(mesh, cells)
        ref = np.einsum("frx,fqx->fqr", Jinv, x_np - p0[:, None, :])
    flat = ref.reshape(-1, d)
    rows = slice(None)
    if d == 3:
        # an affine tetrahedron puts a face's points at one of 4 faces x 6
        # vertex orders of reference positions: tabulate one point of each
        # (its rounding apart) and gather
        _, rows = _unique_rows(np.rint(flat * 2.0**20).astype(np.int64) + 1, 2**20 + 3)
        first = np.empty(rows.max() + 1, np.int64)
        first[rows[::-1]] = np.arange(len(rows))[::-1]  # each key's first point
        flat = flat[first]
    val = mesh._tensor(element.tabulate(flat)[rows].reshape(nf, nq, -1))
    gref = mesh._tensor(element.tabulate_grad(flat)[rows].reshape(nf, nq, -1, d))
    href = mesh._tensor(element.tabulate_hess(flat)[rows].reshape(nf, nq, -1, d, d))
    return val, gref, href, mesh._tensor(Jinv), h


def _u_facet_local_fn(system: System, term, mesh: UMesh, data: Dict, facets: np.ndarray,
                      sides: Sequence[np.ndarray], normals: np.ndarray):
    """Facet counterpart of :func:`_u_cell_local_fn`: ``sides`` is
    ``(c0,)`` for a one-sided ``ds`` term and ``(c0, c1)`` for an interior
    ``dS`` term; ``normals`` already carry the term's orientation (outward,
    or side 0 -> side 1).  Gauss-Legendre points on an edge, weights scaled
    by its length; on a tetrahedron's face the symmetric triangle rule of
    degree ``2 npts - 1`` (``npts`` keeps its 2D meaning), scaled by twice
    its area."""
    nsides = len(sides)
    layout = _layout(system)
    ntot1 = sum(l[-1] for l in layout)
    ntot = nsides * ntot1
    per_point = _is_quad(mesh)

    ends = mesh.facet_endpoints[facets]  # (nf, d, d): the facet's vertices
    if mesh.dim == 2:
        t1d, w1d = segment_rule(term.npts)
        x_np = ends[:, None, 0, :] * (1 - t1d)[None, :, None] + ends[:, None, 1, :] * t1d[None, :, None]
        wscale = mesh.facet_lengths[facets]  # the weights sum to 1
    else:
        fq, w1d = cell_rule("triangle", 2 * term.npts - 1)
        lam = np.concatenate([1.0 - fq.sum(axis=1, keepdims=True), fq], axis=1)  # (nq, 3) on the face
        x_np = np.einsum("qk,fkx->fqx", lam, ends)
        wscale = 2.0 * mesh.facet_lengths[facets]  # the weights sum to 1/2

    fn_data, call_data = _split(data)
    degrees = {n: sp.degree for n, sp in system.fields.items()}
    data_degrees = {k: f.space.degree for k, f in fn_data.items()}
    geo, hs, dof_tables = {}, [], []
    for s_i, cells in enumerate(sides):
        Ji = h = None
        for n, sp in system.fields.items():
            val, gref, href, Ji, h = _facet_side_tabs(sp.element, mesh, cells, x_np)
            geo[f"t{s_i}_{n}_v"], geo[f"t{s_i}_{n}_g"], geo[f"t{s_i}_{n}_h"] = val, gref, href
        for k, f in fn_data.items():
            val, gref, href, Ji2, h2 = _facet_side_tabs(f.space.element, mesh, cells, x_np)
            geo[f"dt{s_i}_{k}_v"], geo[f"dt{s_i}_{k}_g"], geo[f"dt{s_i}_{k}_h"] = val, gref, href
            if Ji is None:
                Ji, h = Ji2, h2
        if Ji is None:  # no fields at all (a functional of callables)
            # the affine formula on every cell type, quads included (as in
            # the JAX package): only its h is read
            _, Jinv_np, _, h = _cell_geometry(mesh, cells)
            if per_point:
                Jinv_np = np.repeat(Jinv_np[:, None], x_np.shape[1], axis=1)
            Ji = mesh._tensor(Jinv_np)
        geo[f"Jinv{s_i}"] = Ji
        hs.append(h)
        dof_tables.append({k: _index(mesh, f.space.cell_dofs_np[cells]) for k, f in fn_data.items()})

    h_ctx = np.mean(np.stack(hs), axis=0)  # avg(h) across the sides
    geo.update(
        {
            "x": mesh._tensor(x_np),
            "wlen": mesh._tensor(w1d[None, :] * wscale[:, None]),
            "n": mesh._tensor(normals),
            "h": mesh._tensor(h_ctx),
        }
    )

    def facet_data(arrays: Optional[Dict] = None) -> Dict:
        cd = dict(geo)
        for s_i in range(nsides):
            for k, f in fn_data.items():
                dat = arrays[k] if arrays is not None else f.data
                cd[f"d{s_i}_" + k] = dat[dof_tables[s_i][k]]
        for k, f in call_data.items():
            vals = f(cd["x"].reshape(-1, mesh.dim))
            cd["c_" + k] = vals.reshape(cd["x"].shape[:2] + vals.shape[1:])
        return cd

    nq = len(w1d)

    def local_points(u_sides, v_sides, cd, ctx):
        """Every point at once (tetrahedra' faces)."""

        def side(locs, s_i):
            return {n: _all_points(locs[n], cd[f"t{s_i}_{n}_v"], cd[f"t{s_i}_{n}_g"], cd[f"t{s_i}_{n}_h"],
                                   cd[f"Jinv{s_i}"], degrees[n] <= 1) for n in system.names}

        V = [side(v_sides[s_i], s_i) for s_i in range(nsides)]
        U = None if u_sides is None else [side(u_sides[s_i], s_i) for s_i in range(nsides)]
        D = [{k: _all_points(cd[f"d{s_i}_" + k], cd[f"dt{s_i}_{k}_v"], cd[f"dt{s_i}_{k}_g"], cd[f"dt{s_i}_{k}_h"],
                             cd[f"Jinv{s_i}"], data_degrees[k] <= 1) for k in fn_data} for s_i in range(nsides)]
        C = {k: cd["c_" + k] for k in call_data}
        nrm = cd["n"]

        def at(V, U, D, C, x):
            ds = [dict(_field_evals(Ds), **{k: FieldEval(c, None, None) for k, c in C.items()}) for Ds in D]
            vs = [_field_evals(Vs) for Vs in V]
            us = None if U is None else [_field_evals(Us) for Us in U]
            if nsides == 1:
                if us is None:
                    return term.integrand(vs[0], ds[0], x, nrm, ctx)
                return term.integrand(us[0], vs[0], ds[0], x, nrm, ctx)
            if us is None:
                return term.integrand(vs[0], vs[1], ds[0], ds[1], x, nrm, ctx)
            return term.integrand(us[0], us[1], vs[0], vs[1], ds[0], ds[1], x, nrm, ctx)

        return _sum_points(at, (V, U, D, C), U is not None, cd["x"], cd["wlen"])

    def local(uflat, vflat, cd):
        ctx = Ctx(h=cd["h"])
        u_sides = None
        if uflat is not None:
            u_sides = [_unpack(uflat[s_i * ntot1 : (s_i + 1) * ntot1], layout) for s_i in range(nsides)]
        v_sides = [_unpack(vflat[s_i * ntot1 : (s_i + 1) * ntot1], layout) for s_i in range(nsides)]

        if mesh.dim == 3:
            return local_points(u_sides, v_sides, cd, ctx)

        def side_jinv(s_i, q):
            return cd[f"Jinv{s_i}"][q] if per_point else cd[f"Jinv{s_i}"]

        def side_evals(locs, s_i, q):
            Ji = side_jinv(s_i, q)
            return {
                n: _phys_evals(locs[n], cd[f"t{s_i}_{n}_v"][q], cd[f"t{s_i}_{n}_g"][q], cd[f"t{s_i}_{n}_h"][q], Ji)
                for n in system.names
            }

        def side_data(s_i, q):
            Ji = side_jinv(s_i, q)
            d_ev = {
                k: _phys_evals(cd[f"d{s_i}_" + k], cd[f"dt{s_i}_{k}_v"][q], cd[f"dt{s_i}_{k}_g"][q],
                               cd[f"dt{s_i}_{k}_h"][q], Ji)
                for k in fn_data
            }
            for k in call_data:
                d_ev[k] = FieldEval(cd["c_" + k][q], None, None)
            return d_ev

        contrib = 0.0
        for q in range(nq):
            xpt, w, nrm = cd["x"][q], cd["wlen"][q], cd["n"]
            if nsides == 1:
                d0 = side_data(0, q)
                v0 = side_evals(v_sides[0], 0, q)
                if u_sides is not None:
                    u0 = side_evals(u_sides[0], 0, q)
                    contrib = contrib + w * term.integrand(u0, v0, d0, xpt, nrm, ctx)
                else:
                    contrib = contrib + w * term.integrand(v0, d0, xpt, nrm, ctx)
            else:
                d0, d1 = side_data(0, q), side_data(1, q)
                v0 = side_evals(v_sides[0], 0, q)
                v1 = side_evals(v_sides[1], 1, q)
                if u_sides is not None:
                    u0 = side_evals(u_sides[0], 0, q)
                    u1 = side_evals(u_sides[1], 1, q)
                    contrib = contrib + w * term.integrand(u0, u1, v0, v1, d0, d1, xpt, nrm, ctx)
                else:
                    contrib = contrib + w * term.integrand(v0, v1, d0, d1, xpt, nrm, ctx)
        return contrib

    return local, facet_data, ntot, layout, fn_data


def _interior_facets(mesh: UMesh, facet_tags, region):
    """Host ``(facets, c0, c1, normals)`` of the two-sided facets whose tag
    is in ``region``; ``normals`` point away from c0's centroid."""
    sel = np.isin(np.asarray(facet_tags), np.asarray(region)) & (mesh.f2c[:, 1] >= 0)
    facets = np.where(sel)[0].astype(np.int32)
    c0 = mesh.f2c[facets, 0]
    c1 = mesh.f2c[facets, 1]
    mid = mesh.facet_endpoints[facets].mean(axis=1)
    d = mid - mesh.cell_centroids[c0]
    base = mesh.facet_base_normals[facets]
    signs = np.where((base * d).sum(axis=1) >= 0, 1.0, -1.0)
    return facets, c0, c1, base * signs[:, None]


def _segments_u(system: System, cells: np.ndarray):
    idx = None
    out = []
    for n, s in system.fields.items():
        if idx is None:
            idx = _index(s.mesh, cells)
        out.append((n, s.cell_dofs[idx], tuple(s.value_shape)))
    return out


def _mat_batch(local, data_fn, ntot: int, fn_data, segs, mesh: UMesh) -> Optional[Batch]:
    """One Batch of per-entity element matrices by
    ``jacfwd(grad(local))``; rebuildable when the term reads Functions."""
    zeros = torch.zeros(ntot, dtype=mesh.dtype, device=mesh.device)
    mat_fn = jacfwd(grad(local, argnums=1), argnums=0)
    fn = _entity_map(lambda c: mat_fn(zeros, zeros, c))
    segs, mats, keep = _prune_batch(segs, fn(data_fn()))
    if not segs:
        return None
    if not fn_data:
        return Batch(segs, mats)

    def core(arrays):
        m = fn(data_fn(arrays))
        return m if keep is None else m[:, keep][:, :, keep]

    return Batch(segs, mats, rebuild_core=core, rebuild_data=fn_data)


# ------------------------------------------------------------ entry points
def assemble_operator(
    system: System,
    mesh: UMesh,
    cell_terms: Sequence[Tuple[CellTerm, Dict]] = (),
    facet_terms: Sequence[Tuple[FacetTerm, Dict]] = (),
    boundary_terms: Sequence[Tuple[BoundaryTerm, Dict]] = (),
    cell_tags=None,
    facet_tags=None,
) -> Operator:
    """Assemble a bilinear operator on an imported mesh: the term lists and
    integrand signatures of :func:`phifem_tpu_torch.assembly.
    assemble_operator`; ``cell_tags`` / ``facet_tags`` are host arrays."""
    batches: List[Batch] = []

    for term, data in cell_terms:
        cells = _region_cells_u(mesh, cell_tags, term.region)
        if len(cells) == 0:
            continue
        local, cell_data, ntot, _, fn_data = _u_cell_local_fn(system, term, mesh, _normalize_data(data), cells)
        b = _mat_batch(local, cell_data, ntot, fn_data, _segments_u(system, cells), mesh)
        if b is not None:
            batches.append(b)

    for term, data in facet_terms:
        facets, c0, c1, normals = _interior_facets(mesh, facet_tags, term.region)
        if len(facets) == 0:
            continue
        local, facet_data, ntot, _, fn_data = _u_facet_local_fn(
            system, term, mesh, _normalize_data(data), facets, (c0, c1), normals
        )
        segs = _segments_u(system, c0) + _segments_u(system, c1)
        b = _mat_batch(local, facet_data, ntot, fn_data, segs, mesh)
        if b is not None:
            batches.append(b)

    for term, data in boundary_terms:
        fl: USideList = term.facets
        if fl.num_facets == 0:
            continue
        local, facet_data, ntot, _, fn_data = _u_facet_local_fn(
            system, term, mesh, _normalize_data(data), fl.facets, (fl.cells,), fl.normals
        )
        b = _mat_batch(local, facet_data, ntot, fn_data, _segments_u(system, fl.cells), mesh)
        if b is not None:
            batches.append(b)

    op = Operator(system, batches)
    op._tap_unsupported = True  # no lattice behind an imported mesh
    return op


def assemble_vector(
    system: System,
    mesh: UMesh,
    cell_terms: Sequence[Tuple[CellTerm, Dict]] = (),
    facet_terms: Sequence[Tuple[FacetTerm, Dict]] = (),
    boundary_terms: Sequence[Tuple[BoundaryTerm, Dict]] = (),
    cell_tags=None,
    facet_tags=None,
) -> Dict[str, torch.Tensor]:
    """Assemble a linear form on an imported mesh (the integrand signatures
    of :func:`phifem_tpu_torch.assembly.assemble_vector`)."""
    b = system.zeros()

    def _accumulate(local, data_fn, ntot, segs):
        zeros = torch.zeros(ntot, dtype=mesh.dtype, device=mesh.device)
        vec_fn = grad(lambda v, c: local(None, v, c), argnums=0)
        vecs = _entity_map(lambda c: vec_fn(zeros, c))(data_fn())
        return Batch(segs, None).scatter_add(b, vecs)

    for term, data in cell_terms:
        cells = _region_cells_u(mesh, cell_tags, term.region)
        if len(cells) == 0:
            continue
        local, cell_data, ntot, _, _ = _u_cell_local_fn(system, term, mesh, _normalize_data(data), cells)
        b = _accumulate(local, cell_data, ntot, _segments_u(system, cells))

    for term, data in facet_terms:
        facets, c0, c1, normals = _interior_facets(mesh, facet_tags, term.region)
        if len(facets) == 0:
            continue
        local, facet_data, ntot, _, _ = _u_facet_local_fn(
            system, term, mesh, _normalize_data(data), facets, (c0, c1), normals
        )
        b = _accumulate(local, facet_data, ntot, _segments_u(system, c0) + _segments_u(system, c1))

    for term, data in boundary_terms:
        fl: USideList = term.facets
        if fl.num_facets == 0:
            continue
        local, facet_data, ntot, _, _ = _u_facet_local_fn(
            system, term, mesh, _normalize_data(data), fl.facets, (fl.cells,), fl.normals
        )
        b = _accumulate(local, facet_data, ntot, _segments_u(system, fl.cells))

    return b


def assemble_scalar(
    mesh: UMesh,
    cell_terms: Sequence[Tuple[CellTerm, Dict]] = (),
    boundary_terms: Sequence[Tuple[BoundaryTerm, Dict]] = (),
    cell_tags=None,
) -> torch.Tensor:
    """Assemble a functional on an imported mesh, a 0-d tensor (cell
    integrand ``(data, x, ctx)``, boundary ``(data, x, n, ctx)``)."""
    sys0 = System({})
    total = torch.zeros((), dtype=mesh.dtype, device=mesh.device)
    empty = torch.zeros(0, dtype=mesh.dtype, device=mesh.device)

    for term, data in cell_terms:
        cells = _region_cells_u(mesh, cell_tags, term.region)
        if len(cells) == 0:
            continue
        wrapped = CellTerm(lambda v, d, x, ctx, _t=term: _t.integrand(d, x, ctx), term.region, degree=term.degree)
        local, cell_data, _, _, _ = _u_cell_local_fn(sys0, wrapped, mesh, _normalize_data(data), cells)
        vals = _entity_map(lambda c, _l=local: _l(None, empty, c))(cell_data())
        total = total + vals.sum()

    for term, data in boundary_terms:
        fl: USideList = term.facets
        if fl.num_facets == 0:
            continue
        wrapped = BoundaryTerm(lambda v, d, x, n, ctx, _t=term: _t.integrand(d, x, n, ctx), fl, npts=term.npts)
        local, facet_data, _, _, _ = _u_facet_local_fn(
            sys0, wrapped, mesh, _normalize_data(data), fl.facets, (fl.cells,), fl.normals
        )
        vals = _entity_map(lambda c, _l=local: _l(None, empty, c))(facet_data())
        total = total + vals.sum()

    return total
