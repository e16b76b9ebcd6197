"""Imported (unstructured) 2D meshes: the mesh, its tagging and measures.

Counterpart of :mod:`phifem_tpu.umesh`.  An imported mesh is an explicit
table of vertex coordinates and cell -> vertex ids (triangles in any vertex
order, quadrilaterals in VTK ring order), read from XDMF or copied from a
structured :class:`~phifem_tpu_torch.grid.Grid`.

* Facets are the lexicographically sorted unique vertex pairs (dolfinx's
  entity-numbering rule); every derived table (``c2f``, ``f2c``, normals,
  lengths, centroids) is cached vectorized host numpy, the same arrays as
  the JAX package's.
* Tagging (cells 1/2/3, facets 1..6), the one-sided measures and the
  submesh are host numpy too, for triangles and quadrilaterals alike, and
  for the tetrahedral :class:`~phifem_tpu_torch.umesh3.UMesh3`, which reads
  the same functions: the solve path starts at assembly
  (:mod:`phifem_tpu_torch.uassembly`).
  :func:`~phifem_tpu_torch.tagging.compute_tags_measures` dispatches here
  when it is given a :class:`UMesh` or a ``UMesh3``.
* A callable level set is evaluated on a float64 CPU tensor (the port's
  callables take torch tensors); a :class:`UDiscreteLevelset` by its nodal
  values.
* The mesh owns ``device`` (default ``"cuda"``) and ``dtype`` (default
  float64), as a ``Grid`` does: the tensors that spaces, functions and
  operators build on it are placed there.  Constructing a mesh allocates
  no tensor.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
import xml.etree.ElementTree as ET
from functools import cached_property
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from . import levelset as lsmod
from .elements import lagrange_element
from .grid import CellType

__all__ = [
    "UMesh",
    "UDiscreteLevelset",
    "USideList",
    "USubmesh",
    "u_tag_cells",
    "u_tag_facets",
    "u_one_sided",
    "compute_tags_measures_unstructured",
]

# reference-cell vertex coordinates (tri: dolfinx order; quad: VTK ring)
_TRI_REF = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
_QUAD_REF = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])
# local facet -> local vertex pair.  Triangle: edge i opposite vertex i
# (dolfinx convention); quad: VTK ring edges.
_TRI_EDGES = np.array([[1, 2], [0, 2], [0, 1]])
_QUAD_EDGES = np.array([[0, 1], [1, 2], [2, 3], [3, 0]])


def _unique_rows(rows: np.ndarray, base: int):
    """``np.unique(rows, axis=0, return_inverse=True)`` of non-negative
    integer rows below ``base``: each row read as one int64 number in base
    ``base`` (the same lexicographic order), which sorts as one key instead
    of as a row of several."""
    k = rows.shape[1]
    if float(base) ** k >= 2.0**62:
        uniq, inv = np.unique(rows, axis=0, return_inverse=True)
        return uniq, inv.reshape(-1)
    key = rows[:, 0].astype(np.int64)
    for j in range(1, k):
        key = key * base + rows[:, j]
    uk, inv = np.unique(key, return_inverse=True)
    uniq = np.empty((len(uk), k), np.int64)
    for j in range(k - 1, -1, -1):
        uk, uniq[:, j] = np.divmod(uk, base)
    return uniq, inv.reshape(-1)


class _HostMesh:
    """What the 2D and 3D imported meshes share: the tables derived from
    ``cells`` and ``c2f`` the same way in both, tensors on the mesh's
    device, and the names the port's shared layers read."""

    def _tensor(self, a) -> torch.Tensor:
        """``a`` as a tensor in the mesh's dtype on its device."""
        return torch.as_tensor(np.asarray(a), dtype=self.dtype, device=self.device)

    @cached_property
    def f2c(self) -> np.ndarray:
        """(nf, 2) adjacent cells, ascending, -1 padded."""
        nfpc = self.c2f.shape[1]
        cid = np.repeat(np.arange(self.num_cells, dtype=np.int32), nfpc)
        fid = self.c2f.reshape(-1)
        order = np.argsort(fid, kind="stable")  # stable: cells ascending
        fid, cid = fid[order], cid[order]
        out = np.full((self.num_facets, 2), -1, np.int32)
        first = np.searchsorted(fid, np.arange(self.num_facets))
        counts = np.bincount(fid, minlength=self.num_facets)
        out[:, 0] = cid[np.minimum(first, len(cid) - 1)]
        has2 = counts == 2
        out[has2, 1] = cid[first[has2] + 1]
        if (counts > 2).any() or (counts == 0).any():
            raise ValueError("non-manifold or dangling facets in mesh")
        return out

    @cached_property
    def boundary_facet_mask(self) -> np.ndarray:
        return self.f2c[:, 1] < 0

    @cached_property
    def facet_endpoints(self) -> np.ndarray:
        """(nf, dim, dim) physical coordinates of each facet's vertices."""
        return self.verts[self.facets]

    @cached_property
    def cell_centroids(self) -> np.ndarray:
        return self.verts[self.cells].mean(axis=1)

    def local_facet_index(self, cells: np.ndarray, facets: np.ndarray) -> np.ndarray:
        """Local index of ``facets[i]`` within ``cells[i]``."""
        match = self.c2f[cells] == np.asarray(facets)[:, None]
        if not match.any(axis=1).all():
            raise ValueError("facet not adjacent to cell")
        return np.argmax(match, axis=1).astype(np.int32)

    # ------------------------------------- the names the port's layers read
    @property
    def vertex_coords_np(self) -> np.ndarray:
        return self.verts

    @property
    def cell_vertices_np(self) -> np.ndarray:
        return self.cells

    @property
    def c2f_np(self) -> np.ndarray:
        return self.c2f

    @property
    def f2c_np(self) -> np.ndarray:
        return self.f2c

    def f2c_of_np(self, facets) -> np.ndarray:
        return self.f2c[np.asarray(facets, np.int64)].astype(np.int64)

    @property
    def facet_endpoints_np(self) -> np.ndarray:
        return self.facet_endpoints

    @property
    def facet_lengths_np(self) -> np.ndarray:
        return self.facet_lengths

    @property
    def facet_base_normals_np(self) -> np.ndarray:
        return self.facet_base_normals

    @property
    def boundary_facet_mask_np(self) -> np.ndarray:
        return self.boundary_facet_mask

    def local_facet_index_np(self, cells, facets) -> np.ndarray:
        return self.local_facet_index(np.asarray(cells, np.int64), np.asarray(facets, np.int64))

    def _rows_of(self, table: np.ndarray, ids: torch.Tensor) -> torch.Tensor:
        return self._tensor(table[ids.cpu().numpy()])

    def facet_endpoints_of(self, facets: torch.Tensor) -> torch.Tensor:
        return self._rows_of(self.facet_endpoints, facets)

    def facet_lengths_of(self, facets: torch.Tensor) -> torch.Tensor:
        return self._rows_of(self.facet_lengths, facets)

    def facet_base_normals_of(self, facets: torch.Tensor) -> torch.Tensor:
        return self._rows_of(self.facet_base_normals, facets)


@dataclasses.dataclass(frozen=True, eq=False)
class UMesh(_HostMesh):
    """Explicit 2D mesh: ``verts (nv, 2)`` float64, ``cells (nc, 3|4)``
    int32.  ``device`` / ``dtype`` place the tensors built on it."""

    verts: np.ndarray
    cells: np.ndarray
    device: Union[str, torch.device] = "cuda"
    dtype: torch.dtype = torch.float64

    def __post_init__(self):
        object.__setattr__(self, "verts", np.ascontiguousarray(self.verts, np.float64))
        object.__setattr__(self, "cells", np.ascontiguousarray(self.cells, np.int32))
        object.__setattr__(self, "device", torch.device(self.device))
        if self.cells.ndim != 2 or self.cells.shape[1] not in (3, 4):
            raise ValueError("cells must be (nc, 3) triangles or (nc, 4) quads")
        if self.verts.ndim != 2 or self.verts.shape[1] != 2:
            raise ValueError("verts must be (nv, 2)")
        if self.dtype not in (torch.float32, torch.float64):
            raise ValueError(f"UMesh dtype must be float32 or float64, got {self.dtype}.")

    # ------------------------------------------------------------- basics
    @property
    def dim(self) -> int:
        return 2

    @property
    def is_simplex(self) -> bool:
        return self.cells.shape[1] == 3

    @property
    def cell_name(self) -> str:
        return "triangle" if self.is_simplex else "quadrilateral"

    @property
    def cell_type(self) -> CellType:
        return CellType.triangle if self.is_simplex else CellType.quadrilateral

    @property
    def num_cells(self) -> int:
        return self.cells.shape[0]

    @property
    def num_vertices(self) -> int:
        return self.verts.shape[0]

    @property
    def num_facets(self) -> int:
        return self.facets.shape[0]

    @property
    def _local_edges(self) -> np.ndarray:
        return _TRI_EDGES if self.is_simplex else _QUAD_EDGES

    @property
    def _ref_verts(self) -> np.ndarray:
        return _TRI_REF if self.is_simplex else _QUAD_REF

    # ------------------------------------------------------- connectivity
    @cached_property
    def facets(self) -> np.ndarray:
        """(nf, 2) unique sorted vertex pairs in lexicographic order: the
        dolfinx facet-numbering rule."""
        e = np.sort(self.cells[:, self._local_edges].reshape(-1, 2), axis=1)
        return _unique_rows(e, self.num_vertices)[0].astype(np.int32)

    @cached_property
    def c2f(self) -> np.ndarray:
        """(nc, nfpc) facet id of each local facet."""
        e = np.sort(self.cells[:, self._local_edges].reshape(-1, 2), axis=1)
        f = self.facets
        pos = np.searchsorted(
            f[:, 0].astype(np.int64) * (self.num_vertices + 1) + f[:, 1],
            e[:, 0].astype(np.int64) * (self.num_vertices + 1) + e[:, 1],
        )
        return pos.reshape(self.num_cells, -1).astype(np.int32)

    @cached_property
    def facet_lengths(self) -> np.ndarray:
        d = self.facet_endpoints[:, 1] - self.facet_endpoints[:, 0]
        return np.sqrt((d**2).sum(axis=1))

    @cached_property
    def facet_base_normals(self) -> np.ndarray:
        """(nf, 2) unit normals of a fixed orientation; one-sided measures
        carry the per-entry sign that makes them outward."""
        d = self.facet_endpoints[:, 1] - self.facet_endpoints[:, 0]
        n = np.stack([d[:, 1], -d[:, 0]], axis=1)
        return n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-300)

    # ------------------------------------------------------------ mapping
    def map_to_physical(self, ref_pts: np.ndarray) -> np.ndarray:
        """(nc, npts, 2) physical coordinates of the same reference points
        in every cell (affine for triangles, bilinear for quads)."""
        V = self.verts[self.cells]  # (nc, nverts, 2)
        r = ref_pts[None, :, 0, None]
        s = ref_pts[None, :, 1, None]
        if self.is_simplex:
            return (1 - r - s) * V[:, None, 0] + r * V[:, None, 1] + s * V[:, None, 2]
        return (
            (1 - r) * (1 - s) * V[:, None, 0]
            + r * (1 - s) * V[:, None, 1]
            + r * s * V[:, None, 2]
            + (1 - r) * s * V[:, None, 3]
        )

    # ----------------------------------------------------------- detection
    def detection_ref_points(self, N: int) -> np.ndarray:
        """Reference-cell boundary detection lattice."""
        return lsmod.detection_points(self.cell_type, N)

    def boundary_trace_cut(self, ls: "ULevelSet", detection_degree: int) -> np.ndarray:
        """Per-cell boundary-trace-cut flag (the ds-measure detection
        aggregated per boundary cell)."""
        return _u_boundary_trace_cut(self, ls, detection_degree)

    # ---------------------------------------------------------------- I/O
    @staticmethod
    def from_xdmf(path: str, device="cuda", dtype: torch.dtype = torch.float64) -> "UMesh":
        """Read an XDMF mesh: the meshio layout ``/dataN`` and the dolfinx
        layout ``/Mesh/mesh/{geometry,topology}`` of the HDF5 file.  Needs
        ``h5py``, imported here only."""
        import h5py

        root = ET.parse(path).getroot()
        topo_el = next(root.iter("Topology"), None)
        geo_el = next(root.iter("Geometry"), None)

        def _h5ref(el):
            item = next(el.iter("DataItem"))
            fname, dset = item.text.strip().split(":", 1)
            return os.path.join(os.path.dirname(path), fname), dset

        tf, td = _h5ref(topo_el)
        gf, gd = _h5ref(geo_el)
        with h5py.File(tf) as f:
            cells = np.asarray(f[td]).astype(np.int64)
        with h5py.File(gf) as f:
            verts = np.asarray(f[gd], np.float64)
        if verts.shape[1] == 3:  # 3D-padded 2D geometry
            verts = verts[:, :2]
        ttype = (topo_el.attrib.get("TopologyType") or "").lower()
        if cells.shape[1] == 4 and "quad" not in ttype:
            raise ValueError(f"unsupported topology {ttype}")
        return UMesh(verts, cells, device, dtype)

    @staticmethod
    def from_grid(grid) -> Tuple["UMesh", np.ndarray]:
        """Explicit copy of a structured :class:`~phifem_tpu_torch.grid.Grid`
        (on its device, in its dtype).  Returns ``(umesh, facet_map)`` with
        ``facet_map[u_facet] = grid_facet``: the grid orders facets by
        family, the mesh lexicographically by vertex pair."""
        cells = np.asarray(grid.cell_vertices_np)
        if not grid.is_simplex:
            cells = cells[:, [0, 1, 3, 2]]  # v00,v10,v01,v11 -> VTK ring
        m = UMesh(np.asarray(grid.vertex_coords_np, np.float64), cells, grid.device, grid.dtype)
        ep = np.asarray(grid.facet_endpoints_np)  # (nf, 2, 2) coords
        kx = np.round((ep[..., 0] - grid.x0) / grid.hx).astype(np.int64)
        ky = np.round((ep[..., 1] - grid.y0) / grid.hy).astype(np.int64)
        vid = ky * (grid.nx + 1) + kx  # (nf, 2) vertex ids
        pairs = np.sort(vid, axis=1)
        key = pairs[:, 0] * (m.num_vertices + 1) + pairs[:, 1]
        fkey = m.facets[:, 0].astype(np.int64) * (m.num_vertices + 1) + m.facets[:, 1]
        order = np.argsort(key)
        facet_map = order[np.searchsorted(key[order], fkey)]
        if not (key[facet_map] == fkey).all():
            raise ValueError("from_grid: the grid's facets do not match the mesh's")
        return m, facet_map.astype(np.int32)


# ---------------------------------------------------------------- levelsets
class UDiscreteLevelset:
    """Degree-k Lagrange interpolant of a callable on a :class:`UMesh`:
    per-cell nodal values, the callable at each cell's physical nodes
    (identical across shared nodes), so no global DoF map is needed."""

    def __init__(self, mesh: UMesh, func: Callable, degree: int):
        self.mesh = mesh
        self.degree = degree
        self.element = lagrange_element(mesh.cell_name, degree)
        node_phys = mesh.map_to_physical(self.element.nodes)  # (nc, nloc, d)
        vals = _call_host(func, node_phys.reshape(-1, mesh.dim))
        self.nodal = vals.reshape(mesh.num_cells, -1)  # (nc, nloc)

    def eval_ref(self, ref_pts: np.ndarray) -> np.ndarray:
        """(nc, npts): interpolant at the same reference points per cell."""
        tab = np.asarray(self.element.tabulate(ref_pts))  # (npts, nloc)
        return self.nodal @ tab.T

    def eval_cell_ref(self, cells: np.ndarray, ref_pts: np.ndarray) -> np.ndarray:
        """(n, npts): interpolant at per-cell reference points (n, npts, d)."""
        d = self.mesh.dim
        tab = np.asarray(self.element.tabulate(ref_pts.reshape(-1, d))).reshape(
            ref_pts.shape[0], ref_pts.shape[1], -1
        )
        return np.einsum("cpl,cl->cp", tab, self.nodal[cells])


ULevelSet = Union[Callable, UDiscreteLevelset]


def _call_host(func: Callable, pts: np.ndarray) -> np.ndarray:
    """A callable of torch tensors at host points: float64 CPU in, numpy
    float64 out."""
    vals = func(torch.as_tensor(pts, dtype=torch.float64))
    if isinstance(vals, torch.Tensor):
        vals = vals.detach().cpu().numpy()
    return np.asarray(vals, np.float64)


def _detection_values(mesh: UMesh, ls: ULevelSet, ref_pts: np.ndarray) -> np.ndarray:
    from .umesh3 import UDiscreteLevelset3

    if isinstance(ls, (UDiscreteLevelset, UDiscreteLevelset3)):
        return ls.eval_ref(ref_pts)
    phys = mesh.map_to_physical(ref_pts)
    return _call_host(ls, phys.reshape(-1, mesh.dim)).reshape(mesh.num_cells, -1)


def _sign_flags(vals: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    return (vals > 0).any(axis=-1), (vals < 0).any(axis=-1)


def _classify(has_pos: np.ndarray, has_neg: np.ndarray) -> np.ndarray:
    inside = has_neg & ~has_pos
    outside = has_pos & ~has_neg
    return np.where(inside, 1, np.where(outside, 3, 2)).astype(np.int8)


# ------------------------------------------------------------------ tagging
def u_tag_cells(
    mesh: UMesh,
    ls: ULevelSet,
    detection_degree: int,
    single_layer_cut: bool = False,
    return_degenerate: bool = False,
):
    """Cell tags 1/2/3 on an imported mesh, by the signs of the level set
    at each cell's detection points (the lattice path's semantics)."""
    pts = mesh.detection_ref_points(detection_degree)
    vals = _detection_values(mesh, ls, pts)
    has_pos, has_neg = _sign_flags(vals)
    tags = _classify(has_pos, has_neg)
    n_degenerate = int((~has_pos & ~has_neg).sum())

    if single_layer_cut:
        # a cut cell is kept only if it shares a vertex with an interior cell
        vflag = np.zeros(mesh.num_vertices, bool)
        vflag[mesh.cells[tags == 1].reshape(-1)] = True
        connected = vflag[mesh.cells].any(axis=1)
        tags = np.where((tags == 2) & ~connected, np.int8(3), tags)

    if return_degenerate:
        return tags, n_degenerate
    return tags


def _facet_cell_ref_points(mesh: UMesh, owner: np.ndarray, local: np.ndarray, N: int) -> np.ndarray:
    """(n, npts, 2) owner-cell reference coordinates of the segment
    detection points on each facet."""
    t = lsmod.reference_segment_points(N)[:, 0]  # (npts,)
    lv = mesh._local_edges[local]  # (n, 2) local vertex indices
    ra = mesh._ref_verts[lv[:, 0]]  # (n, 2)
    rb = mesh._ref_verts[lv[:, 1]]
    return ra[:, None, :] * (1.0 - t)[None, :, None] + rb[:, None, :] * t[None, :, None]


def _u_boundary_trace_cut(mesh: UMesh, ls: ULevelSet, detection_degree: int) -> np.ndarray:
    """Per-cell boundary-trace-cut flag: the level set's signs at the
    detection points of each boundary facet, aggregated per owner cell."""
    bf = np.where(mesh.boundary_facet_mask)[0]
    owner = mesh.f2c[bf, 0]
    local = mesh.local_facet_index(owner, bf)
    ref_pts = _facet_cell_ref_points(mesh, owner, local, detection_degree)
    if isinstance(ls, UDiscreteLevelset):
        vals = ls.eval_cell_ref(owner, ref_pts)
    else:
        V = mesh.verts[mesh.facets[bf]]  # (n, 2, 2) endpoints
        t = lsmod.reference_segment_points(detection_degree)[:, 0]
        phys = V[:, None, 0] * (1.0 - t)[None, :, None] + V[:, None, 1] * t[None, :, None]
        vals = _call_host(ls, phys.reshape(-1, 2)).reshape(len(bf), -1)
    fpos, fneg = _sign_flags(vals)
    cpos = np.zeros(mesh.num_cells, bool)
    cneg = np.zeros(mesh.num_cells, bool)
    np.logical_or.at(cpos, owner, fpos)
    np.logical_or.at(cneg, owner, fneg)
    is_bcell = np.zeros(mesh.num_cells, bool)
    is_bcell[owner] = True
    return (cpos == cneg) & is_bcell


def u_tag_facets(mesh: UMesh, cell_tags: np.ndarray, ls: ULevelSet, detection_degree: int) -> np.ndarray:
    """Facet tags 1..6: the lattice path's rule table on the two adjacent
    cell tags, applied over the explicit ``f2c`` map."""
    trace_cut = mesh.boundary_trace_cut(ls, detection_degree)
    f2c = mesh.f2c
    t0 = cell_tags[f2c[:, 0]]
    t1 = np.where(f2c[:, 1] >= 0, cell_tags[np.maximum(f2c[:, 1], 0)], 0)
    is_bdry = mesh.boundary_facet_mask

    lo = np.minimum(t0, t1)
    hi = np.maximum(t0, t1)
    interior_tag = np.select(
        [
            (lo == 1) & (hi == 1),
            (lo == 1) & (hi == 2),
            (lo == 1) & (hi == 3),
            (lo == 2) & (hi == 2),
            (lo == 2) & (hi == 3),
        ],
        [1, 3, 6, 2, 4],
        default=5,
    )

    owner = f2c[:, 0]
    a_owner = cell_tags[owner]
    cut_or_bdry = np.where(trace_cut[owner], 2, 4)
    if bool((cell_tags == 3).any()):
        bdry_tag = np.where(a_owner == 1, 1, np.where(a_owner == 2, cut_or_bdry, 5))
    else:
        bdry_tag = np.where(a_owner == 1, 4, cut_or_bdry)
    return np.where(is_bdry, bdry_tag, interior_tag).astype(np.int8)


# ----------------------------------------------------------------- measures
@dataclasses.dataclass(frozen=True, eq=False)
class USideList:
    """One-sided facet set on a :class:`UMesh`: host arrays of facet ids,
    chosen cells, local facet indices and the signs that make the base
    normals outward for the chosen cells."""

    mesh: UMesh
    facets: np.ndarray
    cells: np.ndarray
    local_facets: np.ndarray
    signs: np.ndarray

    @property
    def num_facets(self) -> int:
        return int(self.facets.shape[0])

    @property
    def normals(self) -> np.ndarray:
        """(n, 2) outward unit normals w.r.t. the chosen cells."""
        return self.mesh.facet_base_normals[self.facets] * self.signs[:, None]

    @property
    def lengths(self) -> np.ndarray:
        return self.mesh.facet_lengths[self.facets]

    def integration_entities(self) -> np.ndarray:
        """dolfinx-style raveled ``[c0, f0, c0, f1, ...]`` pairs."""
        return np.ravel(np.column_stack([self.cells, self.local_facets])).astype(np.int32)


def _outward_signs(mesh: UMesh, facets: np.ndarray, chosen: np.ndarray) -> np.ndarray:
    """+1 where the base normal points away from the chosen cell's
    centroid, else -1."""
    mid = mesh.facet_endpoints[facets].mean(axis=1)
    d = mid - mesh.cell_centroids[chosen]
    dot = (mesh.facet_base_normals[facets] * d).sum(axis=1)
    return np.where(dot >= 0, 1.0, -1.0)


def u_one_sided(mesh: UMesh, facet_ids: np.ndarray, cell_tags: np.ndarray, side_tags: tuple) -> USideList:
    """Choose, per facet, the adjacent cell whose tag is in ``side_tags``
    (the first of ``f2c`` when both qualify)."""
    facet_ids = np.asarray(facet_ids, np.int32)
    f2c = mesh.f2c[facet_ids]
    t0 = cell_tags[f2c[:, 0]]
    t1 = np.where(f2c[:, 1] >= 0, cell_tags[np.maximum(f2c[:, 1], 0)], -1)
    in0 = np.isin(t0, side_tags)
    in1 = np.isin(t1, side_tags) & (f2c[:, 1] >= 0)
    keep = in0 | in1
    facet_ids = facet_ids[keep]
    chosen = np.where(in0[keep], f2c[keep, 0], f2c[keep, 1]).astype(np.int32)
    local = mesh.local_facet_index(chosen, facet_ids)
    return USideList(mesh, facet_ids, chosen, local, _outward_signs(mesh, facet_ids, chosen))


# ------------------------------------------------------------------ submesh
@dataclasses.dataclass(frozen=True, eq=False)
class USubmesh:
    """Active-cell view (Omega_h = cells tagged 1|2) of an imported mesh.
    Its facet order is the ascending parent facet id."""

    parent: UMesh
    cells: np.ndarray
    facets: np.ndarray
    cell_tags: "EntityTags"
    facet_tags: "EntityTags"
    exterior: USideList

    @property
    def num_cells(self) -> int:
        return len(self.cells)


def _host_tags(dim: str, values: np.ndarray):
    from .tagging import EntityTags

    tags = EntityTags(dim, torch.as_tensor(values))
    tags._host = values
    return tags


def _u_build_submesh(mesh: UMesh, ct: np.ndarray, ft: np.ndarray) -> USubmesh:
    active = np.where((ct == 1) | (ct == 2))[0].astype(np.int32)
    facets = np.unique(mesh.c2f[active].reshape(-1)).astype(np.int32)

    f2c = mesh.f2c[facets]
    act = np.zeros(mesh.num_cells, bool)
    act[active] = True
    a0 = act[f2c[:, 0]]
    a1 = (f2c[:, 1] >= 0) & act[np.maximum(f2c[:, 1], 0)]
    ext = np.logical_xor(a0, a1)
    ext_facets = facets[ext]
    chosen = np.where(a0[ext], f2c[ext, 0], f2c[ext, 1]).astype(np.int32)
    local = mesh.local_facet_index(chosen, ext_facets)
    exterior = USideList(mesh, ext_facets, chosen, local, _outward_signs(mesh, ext_facets, chosen))
    return USubmesh(
        parent=mesh,
        cells=active,
        facets=facets,
        cell_tags=_host_tags("cell", ct[active]),
        facet_tags=_host_tags("facet", ft[facets]),
        exterior=exterior,
    )


# ------------------------------------------------------------------- public
def compute_tags_measures_unstructured(
    mesh: UMesh,
    levelset: ULevelSet,
    detection_degree: int,
    box_mode: bool = False,
    single_layer_cut: bool = False,
    overwrite: Optional[Dict[str, Dict[int, np.ndarray]]] = None,
):
    """The imported-mesh branch of
    :func:`phifem_tpu_torch.tagging.compute_tags_measures`: tags and
    measures on the host, tags held as CPU tensors with their host copy."""
    from .measures import BoundaryMeasure
    from .tagging import TagsMeasures, _check_invariants, _debug_mode, overwrite_tags

    ct, ndeg = u_tag_cells(mesh, levelset, detection_degree, single_layer_cut, return_degenerate=True)
    if ndeg > 0:
        warnings.warn(
            f"{ndeg} cell(s) have an identically-zero (or NaN) level set at every detection point; "
            "they are classified as cut.",
            RuntimeWarning,
            stacklevel=2,
        )
    ft = u_tag_facets(mesh, ct, levelset, detection_degree)

    cells_tags = _host_tags("cell", ct)
    facets_tags = _host_tags("facet", ft)
    if overwrite:
        if "cells" in overwrite:
            cells_tags = overwrite_tags(cells_tags, overwrite["cells"], (1, 2, 3))
        if "facets" in overwrite:
            facets_tags = overwrite_tags(facets_tags, overwrite["facets"], (1, 2, 3, 4, 5, 6, 100, 101))
    if _debug_mode():
        _check_invariants(cells_tags, facets_tags)

    ct = cells_tags.as_numpy()
    ft = facets_tags.as_numpy()
    if box_mode:
        measure = BoundaryMeasure(
            {
                100: u_one_sided(mesh, np.where(ft == 4)[0], ct, (1, 2)),
                101: u_one_sided(mesh, np.where(ft == 3)[0], ct, (2, 3)),
            }
        )
        return TagsMeasures(cells_tags, facets_tags, None, measure, None)

    sub = _u_build_submesh(mesh, ct, ft)
    return TagsMeasures(sub.cell_tags, sub.facet_tags, sub, BoundaryMeasure({0: sub.exterior}), [sub.cells, sub.facets])
