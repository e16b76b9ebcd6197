"""Imported tetrahedral meshes: the mesh, its detection lattice and level set.

Counterpart of :mod:`phifem_tpu.umesh3`.  :class:`UMesh3` presents the
surface of :class:`~phifem_tpu_torch.umesh.UMesh`, so the tagging, the
one-sided measures, the submesh (:mod:`phifem_tpu_torch.umesh`) and the
assembly (:mod:`phifem_tpu_torch.uassembly`) take it unchanged:

* ``facets`` are faces, the unique lexicographically sorted vertex triples
  (dolfinx's entity-numbering rule, as in 2D); ``facet_endpoints`` are the
  (nf, 3, 3) face vertex coordinates and ``facet_lengths`` the face areas
  (the facet measure, under the 2D name);
* the detection points of a cell are the boundary lattice of the
  reference tetrahedron, the points of the degree-N barycentric lattice on
  its faces (N = 0: the centroid); a boundary face's own detection points
  are the full triangle lattice on it.

Every table is cached vectorized host numpy, the same arrays as the JAX
package's.  The mesh owns ``device`` (default ``"cuda"``) and ``dtype``
(default float64), as a ``UMesh`` does; constructing it allocates no
tensor.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import xml.etree.ElementTree as ET
from functools import cached_property
from typing import Callable, Union

import numpy as np
import torch

from .elements import TET_EDGES, TET_FACES, lagrange_element
from .umesh import UDiscreteLevelset, _call_host, _HostMesh, _sign_flags, _unique_rows

__all__ = ["UMesh3", "UDiscreteLevelset3", "tet_boundary_points", "triangle_lattice_points"]

# reference-tet vertex coordinates (v0 the origin, then the unit axes)
_TET_REF = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])


def tet_boundary_points(N: int) -> np.ndarray:
    """(npts, 3) boundary lattice of the reference tetrahedron: the points
    (i, j, l) / N of the degree-N barycentric lattice with at least one zero
    barycentric coordinate (on one of the 4 faces); N = 0: the centroid."""
    if N == 0:
        return np.array([[0.25, 0.25, 0.25]])
    pts = []
    for l in range(N + 1):
        for j in range(N + 1 - l):
            for i in range(N + 1 - l - j):
                k0 = N - i - j - l
                if i == 0 or j == 0 or l == 0 or k0 == 0:
                    pts.append((i / N, j / N, l / N))
    return np.asarray(pts, np.float64)


def triangle_lattice_points(N: int) -> np.ndarray:
    """(npts, 2) full barycentric lattice of the reference triangle
    (vertices, edges and interior), N = 0: the centroid; the detection rule
    of a boundary face."""
    if N == 0:
        return np.array([[1.0 / 3.0, 1.0 / 3.0]])
    return np.asarray([(i / N, j / N) for j in range(N + 1) for i in range(N + 1 - j)], np.float64)


@dataclasses.dataclass(frozen=True, eq=False)
class UMesh3(_HostMesh):
    """Explicit tetrahedral mesh: ``verts (nv, 3)`` float64, ``cells (nc,
    4)`` int32 in any vertex order.  ``device`` / ``dtype`` place the
    tensors built on it."""

    verts: np.ndarray
    cells: np.ndarray
    device: Union[str, torch.device] = "cuda"
    dtype: torch.dtype = torch.float64

    def __post_init__(self):
        object.__setattr__(self, "verts", np.ascontiguousarray(self.verts, np.float64))
        object.__setattr__(self, "cells", np.ascontiguousarray(self.cells, np.int32))
        object.__setattr__(self, "device", torch.device(self.device))
        if self.verts.ndim != 2 or self.verts.shape[1] != 3 or self.cells.ndim != 2 or self.cells.shape[1] != 4:
            raise ValueError("UMesh3 needs (nv, 3) verts and (nc, 4) tets")
        if self.dtype not in (torch.float32, torch.float64):
            raise ValueError(f"UMesh3 dtype must be float32 or float64, got {self.dtype}.")

    # ------------------------------------------------------------- basics
    @property
    def dim(self) -> int:
        return 3

    @property
    def is_simplex(self) -> bool:
        return True

    @property
    def cell_name(self) -> str:
        return "tetrahedron"

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
    def _local_faces(self) -> np.ndarray:
        return TET_FACES

    @property
    def _ref_verts(self) -> np.ndarray:
        return _TET_REF

    # ------------------------------------------------------- connectivity
    @cached_property
    def _faces(self):
        """(unique sorted vertex triples, the inverse map of every local
        face)."""
        return _unique_rows(np.sort(self.cells[:, TET_FACES].reshape(-1, 3), axis=1), self.num_vertices)

    @cached_property
    def facets(self) -> np.ndarray:
        """(nf, 3) unique sorted vertex triples in lexicographic order: the
        dolfinx facet-numbering rule."""
        return self._faces[0].astype(np.int32)

    @cached_property
    def c2f(self) -> np.ndarray:
        """(nc, 4) facet id of each local face (face i opposite vertex i)."""
        return self._faces[1].reshape(self.num_cells, 4).astype(np.int32)

    @cached_property
    def _edges(self):
        return _unique_rows(np.sort(self.cells[:, TET_EDGES].reshape(-1, 2), axis=1), self.num_vertices)

    @cached_property
    def edges(self) -> np.ndarray:
        """(ne, 2) unique sorted vertex pairs (lexicographic): the edge
        nodes of degree >= 2 spaces."""
        return self._edges[0].astype(np.int32)

    @cached_property
    def c2e(self) -> np.ndarray:
        """(nc, 6) edge id of each local edge (the rows of ``TET_EDGES``)."""
        return self._edges[1].reshape(self.num_cells, 6).astype(np.int32)

    def _face_cross(self) -> np.ndarray:
        V = self.facet_endpoints
        return np.cross(V[:, 1] - V[:, 0], V[:, 2] - V[:, 0])

    @cached_property
    def facet_lengths(self) -> np.ndarray:
        """Face areas (the facet measure, under the 2D name)."""
        return 0.5 * np.linalg.norm(self._face_cross(), axis=1)

    @cached_property
    def facet_base_normals(self) -> np.ndarray:
        """(nf, 3) unit normals of a fixed orientation; one-sided measures
        carry the per-entry sign that makes them outward."""
        c = self._face_cross()
        return c / np.maximum(np.linalg.norm(c, axis=1, keepdims=True), 1e-300)

    # ------------------------------------------------------------ mapping
    def map_to_physical(self, ref_pts: np.ndarray) -> np.ndarray:
        """(nc, npts, 3) physical coordinates of the same reference points
        in every cell (affine)."""
        V = self.verts[self.cells]  # (nc, 4, 3)
        r = ref_pts[None, :, 0, None]
        s = ref_pts[None, :, 1, None]
        t = ref_pts[None, :, 2, None]
        return (1 - r - s - t) * V[:, None, 0] + r * V[:, None, 1] + s * V[:, None, 2] + t * V[:, None, 3]

    # ----------------------------------------------------------- detection
    def detection_ref_points(self, N: int) -> np.ndarray:
        return tet_boundary_points(N)

    def boundary_trace_cut(self, ls, detection_degree: int) -> np.ndarray:
        """Per-cell boundary-trace-cut flag: the level set's signs on the
        triangle lattice of each boundary face, aggregated per owner cell."""
        bf = np.where(self.boundary_facet_mask)[0]
        owner = self.f2c[bf, 0]
        lam2 = triangle_lattice_points(detection_degree)
        lam = np.concatenate([1.0 - lam2.sum(axis=1, keepdims=True), lam2], axis=1)  # (np, 3) on the face
        phys = np.einsum("pk,nkx->npx", lam, self.verts[self.facets[bf]])
        if isinstance(ls, (UDiscreteLevelset, UDiscreteLevelset3)):
            # the face points in the owner cell's reference coordinates
            p0, Jinv, _, _ = _cell_geometry3(self, owner)
            vals = ls.eval_cell_ref(owner, np.einsum("nrx,npx->npr", Jinv, phys - p0[:, None, :]))
        else:
            vals = _call_host(ls, phys.reshape(-1, 3)).reshape(len(bf), -1)
        fpos, fneg = _sign_flags(vals)
        cpos = np.zeros(self.num_cells, bool)
        cneg = np.zeros(self.num_cells, bool)
        np.logical_or.at(cpos, owner, fpos)
        np.logical_or.at(cneg, owner, fneg)
        is_bcell = np.zeros(self.num_cells, bool)
        is_bcell[owner] = True
        return (cpos == cneg) & is_bcell

    # ---------------------------------------------------------------- I/O
    @staticmethod
    def from_xdmf(path: str, device="cuda", dtype: torch.dtype = torch.float64) -> "UMesh3":
        """Read a tetrahedral XDMF mesh (the HDF5 layouts of
        :meth:`UMesh.from_xdmf`).  Needs ``h5py``, imported here only."""
        import h5py

        root = ET.parse(path).getroot()

        def _h5ref(el):
            item = next(el.iter("DataItem"))
            fname, dset = item.text.strip().split(":", 1)
            return os.path.join(os.path.dirname(path), fname), dset

        tf, td = _h5ref(next(root.iter("Topology")))
        gf, gd = _h5ref(next(root.iter("Geometry")))
        with h5py.File(tf) as f:
            cells = np.asarray(f[td]).astype(np.int64)
        with h5py.File(gf) as f:
            verts = np.asarray(f[gd], np.float64)
        if cells.shape[1] != 4 or verts.shape[1] != 3:
            raise ValueError("not a tetrahedral 3D mesh")
        return UMesh3(verts, cells, device, dtype)

    @staticmethod
    def box(nx: int, ny: int, nz: int, bounds=((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)), device="cuda",
            dtype: torch.dtype = torch.float64) -> "UMesh3":
        """Structured tetrahedral box: each hex cell split into 6 tets by the
        Kuhn (permutation) triangulation, conforming across cells."""
        (x0, y0, z0), (x1, y1, z1) = bounds
        X, Y, Z = np.meshgrid(np.linspace(x0, x1, nx + 1), np.linspace(y0, y1, ny + 1), np.linspace(z0, z1, nz + 1),
                              indexing="ij")
        verts = np.stack([X.reshape(-1), Y.reshape(-1), Z.reshape(-1)], -1)

        def vid(i, j, k):
            return (i * (ny + 1) + j) * (nz + 1) + k

        I, J, K = (a.reshape(-1) for a in np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"))
        # Kuhn: the tets are the chains 0 -> e_p0 -> e_p0 + e_p1 -> (1, 1, 1)
        # over the 6 orderings of the axes
        axes = np.eye(3, dtype=np.int64)
        cells = []
        for perm in itertools.permutations(range(3)):
            s1 = axes[perm[0]]
            s2 = s1 + axes[perm[1]]
            corners = [(0, 0, 0), tuple(s1), tuple(s2), (1, 1, 1)]
            cells.append(np.stack([vid(I + di, J + dj, K + dk) for (di, dj, dk) in corners], axis=-1))
        return UMesh3(verts, np.concatenate(cells, axis=0), device, dtype)


# --------------------------------------------------------------- levelsets
class UDiscreteLevelset3:
    """Degree-k Lagrange interpolant of a callable on a :class:`UMesh3`:
    per-cell nodal values, the callable at each cell's physical nodes."""

    def __init__(self, mesh: UMesh3, func: Callable, degree: int):
        self.mesh = mesh
        self.degree = degree
        self.element = lagrange_element("tetrahedron", degree)
        node_phys = mesh.map_to_physical(self.element.nodes)
        self.nodal = _call_host(func, node_phys.reshape(-1, 3)).reshape(mesh.num_cells, -1)

    def eval_ref(self, ref_pts: np.ndarray) -> np.ndarray:
        """(nc, npts): the interpolant at the same reference points per cell."""
        return self.nodal @ np.asarray(self.element.tabulate(ref_pts)).T

    def eval_cell_ref(self, cells: np.ndarray, ref_pts: np.ndarray) -> np.ndarray:
        """(n, npts): the interpolant at per-cell reference points (n, npts, 3)."""
        tab = np.asarray(self.element.tabulate(ref_pts.reshape(-1, 3))).reshape(ref_pts.shape[0], ref_pts.shape[1], -1)
        return np.einsum("cpl,cl->cp", tab, self.nodal[cells])


def _cell_geometry3(mesh: UMesh3, cells: np.ndarray):
    """Per-cell affine geometry, host float64: ``(p0 (ne, 3), Jinv (ne, 3,
    3), absdet (ne,), h (ne,))`` with ``Jinv[r, x] = d ref_r / d x`` and
    ``h`` the longest of the 6 edges."""
    V = mesh.verts[mesh.cells[cells]]  # (ne, 4, 3)
    p0 = V[:, 0]
    J = np.stack([V[:, 1] - p0, V[:, 2] - p0, V[:, 3] - p0], axis=-1)
    E = V[:, TET_EDGES]  # (ne, 6, 2, 3)
    h = np.linalg.norm(E[:, :, 1] - E[:, :, 0], axis=-1).max(axis=1)
    return p0, np.linalg.inv(J), np.abs(np.linalg.det(J)), h
