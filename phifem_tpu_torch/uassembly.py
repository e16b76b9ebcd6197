"""Assembly on imported triangle meshes: the solve path for a ``UMesh``.

Counterpart of :mod:`phifem_tpu.uassembly`, triangles only.  The same term
DSL as :mod:`phifem_tpu_torch.assembly` (:class:`CellTerm`,
:class:`FacetTerm`, :class:`BoundaryTerm`, the same integrand signatures)
is assembled on a :class:`~phifem_tpu_torch.umesh.UMesh` into a standard
:class:`~phifem_tpu_torch.assembly.Operator` of entity batches, so the
whole downstream stack (the Krylov solvers, reassembly, restricted CSR
extraction, the AMG and band preconditioners) works unchanged.

* An imported mesh has no orientation classes: every cell carries its own
  affine geometry (``Jinv``, ``|det J|``, the diameter ``h`` = the longest
  edge), computed on the host in float64 and moved to ``mesh.device`` once.
  ``term.uniform`` is ignored.  Element matrices come from
  ``torch.func.jacfwd(torch.func.grad(local))`` under ``vmap`` over the
  entities, as in the structured path's cut batches.
* Reference-domain basis tables are shared constants; physical gradients
  and Hessians are formed per cell inside the local energy
  (``g_phys = g_ref Jinv``).  ``ctx.h`` is the per-cell diameter.
* Interior-facet terms find each side's reference coordinates of the
  facet's quadrature points by inverting the affine map
  (``ref = Jinv (x - p0)``), so no local-facet orientation bookkeeping is
  needed.
* A batch is rebuildable (data-dependent, see
  :meth:`~phifem_tpu_torch.assembly.Operator.reassemble`) exactly when its
  term reads a discrete function, as in the JAX package: the interface band
  of the preconditioners is the DoFs those batches touch.
* Quadrilateral meshes (the bilinear geometry) wait for slice G1b and
  tetrahedral meshes for slice G2: :meth:`USpace.lagrange` raises for them.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import grad, jacfwd

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
from .elements import Element, classify_nodes, dg0_element, lagrange_element
from .quadrature import cell_rule, segment_rule
from .spaces import Function
from .umesh import UMesh, USideList

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


def _triangles_only(mesh) -> None:
    if getattr(mesh, "dim", 2) != 2:
        raise NotImplementedError("assembly on imported tetrahedral meshes waits for a later PR (slice G2)")
    if not mesh.is_simplex:
        raise NotImplementedError(
            "assembly on imported quadrilateral meshes (the bilinear geometry) waits for a later PR (slice G1b)"
        )


# ------------------------------------------------------------------ spaces
@dataclasses.dataclass(frozen=True)
class USpace:
    """Lagrange (degree 1-3) or DG0 space on an imported triangle mesh,
    scalar or with a ``value_shape``: the :class:`~phifem_tpu_torch.spaces.
    Space` contract that :class:`System`, :class:`Batch` and the solvers
    read (``nloc``, ``value_shape``, ``num_dofs``, ``dof_shape``,
    ``cell_dofs``, ``grid.device`` / ``grid.dtype``)."""

    mesh: UMesh
    element: Element
    value_shape: Tuple[int, ...] = ()

    @staticmethod
    def lagrange(mesh: UMesh, degree: int, value_shape: Tuple[int, ...] = ()) -> "USpace":
        _triangles_only(mesh)
        return USpace(mesh, lagrange_element(mesh.cell_name, degree), tuple(value_shape))

    @staticmethod
    def dg0(mesh: UMesh, value_shape: Tuple[int, ...] = ()) -> "USpace":
        _triangles_only(mesh)
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
    def num_scalar_dofs(self) -> int:
        m, k = self.mesh, self.degree
        if self.element.family == "DG":
            return m.num_cells
        n = m.num_vertices
        if k > 1:
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
        kind, entity, param = classify_nodes(self.element)
        edge_base = m.num_vertices
        cell_base = m.num_vertices + m.num_facets * (k - 1)
        n_int = int(np.sum(kind == 2))
        cells = np.arange(m.num_cells, dtype=np.int64)
        le = m._local_edges  # (3, 2) local vertex pairs, dolfinx order

        cols = []
        for loc in range(self.nloc):
            if kind[loc] == 0:
                col = m.cells[:, int(entity[loc])].astype(np.int64)
            elif kind[loc] == 1:
                lf = _CLS2MESH_TRI[int(entity[loc])]
                va = m.cells[:, le[lf, 0]]
                vb = m.cells[:, le[lf, 1]]
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

    @cached_property
    def cell_dofs(self) -> torch.Tensor:
        return torch.as_tensor(self.cell_dofs_np, dtype=torch.int64, device=self.mesh.device)

    def cell_dofs_of(self, cells) -> torch.Tensor:
        cells = torch.as_tensor(cells, device=self.mesh.device).to(torch.int64)
        return self.cell_dofs[cells]

    @cached_property
    def dof_coords_np(self) -> np.ndarray:
        """(num_scalar_dofs, 2) physical DoF coordinates: vertices, then the
        facet nodes in the global direction, then the cell-interior nodes."""
        m, k = self.mesh, self.degree
        if self.element.family == "DG":
            return m.cell_centroids
        coords = [m.verts]
        if k > 1:
            ends = m.facet_endpoints  # (nf, 2, 2), ascending vertex id
            ts = np.asarray([(j + 1) / k for j in range(k - 1)])
            fac = ends[:, None, 0, :] * (1 - ts)[None, :, None] + ends[:, None, 1, :] * ts[None, :, None]
            coords.append(fac.reshape(-1, 2))
            kind, _, _ = classify_nodes(self.element)
            int_nodes = self.element.nodes[kind == 2]
            if len(int_nodes):
                coords.append(m.map_to_physical(int_nodes).reshape(-1, 2))
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
    """Nodal interpolation of a callable ``f((n, 2) tensor) -> (n, *vs)``."""
    if isinstance(f, UFunction) and f.space is space:
        return f
    pts = space.dof_coords
    vals = torch.as_tensor(f(pts), dtype=space.mesh.dtype, device=space.mesh.device)
    want = (pts.shape[0],) + tuple(space.value_shape)
    return UFunction(space, torch.reshape(vals, want))


def boundary_dof_mask(space: USpace) -> torch.Tensor:
    """Mask of the scalar DoFs on the mesh's exterior boundary: the
    vertices and edge nodes of the facets with one adjacent cell."""
    if space.element.family == "DG":
        raise ValueError("DG spaces have no boundary DoFs")
    m, k = space.mesh, space.degree
    bf = np.where(m.boundary_facet_mask)[0]
    mask = np.zeros(space.num_scalar_dofs, bool)
    mask[np.unique(m.facets[bf])] = True
    if k > 1:
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
    """Per-cell affine geometry, host float64: ``(p0 (ne, 2), Jinv (ne, 2,
    2), absdet (ne,), h (ne,))`` with ``Jinv[r, x] = d ref_r / d x`` and
    ``h`` the longest edge (UFL ``CellDiameter``)."""
    V = mesh.verts[mesh.cells[cells]]  # (ne, 3, 2)
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


def _phys_evals(u_loc, valq, grefq, hrefq, Jinv) -> FieldEval:
    """FieldEval at one point, gradients and Hessians pushed forward by
    the cell's ``Jinv``."""
    gphys = torch.einsum("lr,rx->lx", grefq, Jinv)
    hphys = torch.einsum("ry,lrs,sx->lyx", Jinv, hrefq, Jinv)
    return _eval_field(u_loc, valq, gphys, hphys)


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
    dtabs = {k: _ref_tabs(mesh, v.space.element, ref_pts) for k, v in fn_data.items()}

    p0, Jinv, absdet, h = _cell_geometry(mesh, cells)
    V = mesh.verts[mesh.cells[cells]]
    lam = np.concatenate([1.0 - ref_pts.sum(axis=1, keepdims=True), ref_pts], axis=1)
    x_np = np.einsum("qk,ckx->cqx", lam, V)
    geo = {
        "Jinv": mesh._tensor(Jinv),  # (ne, 2, 2): constant over a triangle
        "wdet": mesh._tensor(wq[None, :] * absdet[:, None]),
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
            vals = f(cd["x"].reshape(-1, 2))
            cd["c_" + k] = vals.reshape(cd["x"].shape[:2] + vals.shape[1:])
        return cd

    nq = len(wq)

    def local(uflat, vflat, cd):
        ctx = Ctx(h=cd["h"])
        Ji = cd["Jinv"]
        u_locs = _unpack(uflat, layout) if uflat is not None else None
        v_locs = _unpack(vflat, layout)
        contrib = 0.0
        for q in range(nq):
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
    nq, 2)``: the points mapped back into the side's cells by the affine
    inverse, tabulated on the host.  Returns ``(val (nf, nq, nloc), gref
    (nf, nq, nloc, 2), href (nf, nq, nloc, 2, 2))`` tensors, ``Jinv (nf, 2,
    2)`` and host ``h (nf,)``."""
    nf, nq = x_np.shape[:2]
    p0, Jinv, _, h = _cell_geometry(mesh, cells)
    ref = np.einsum("frx,fqx->fqr", Jinv, x_np - p0[:, None, :])
    flat = ref.reshape(-1, 2)
    val = mesh._tensor(element.tabulate(flat).reshape(nf, nq, -1))
    gref = mesh._tensor(element.tabulate_grad(flat).reshape(nf, nq, -1, 2))
    href = mesh._tensor(element.tabulate_hess(flat).reshape(nf, nq, -1, 2, 2))
    return val, gref, href, mesh._tensor(Jinv), h


def _u_facet_local_fn(system: System, term, mesh: UMesh, data: Dict, facets: np.ndarray,
                      sides: Sequence[np.ndarray], normals: np.ndarray):
    """Facet counterpart of :func:`_u_cell_local_fn`: ``sides`` is
    ``(c0,)`` for a one-sided ``ds`` term and ``(c0, c1)`` for an interior
    ``dS`` term; ``normals`` already carry the term's orientation (outward,
    or side 0 -> side 1).  Gauss-Legendre points on the edge, weights scaled
    by its length."""
    nsides = len(sides)
    layout = _layout(system)
    ntot1 = sum(l[-1] for l in layout)
    ntot = nsides * ntot1

    ends = mesh.facet_endpoints[facets]  # (nf, 2, 2)
    t1d, w1d = segment_rule(term.npts)
    x_np = ends[:, None, 0, :] * (1 - t1d)[None, :, None] + ends[:, None, 1, :] * t1d[None, :, None]
    wscale = mesh.facet_lengths[facets]

    fn_data, call_data = _split(data)
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
            _, Jinv_np, _, h = _cell_geometry(mesh, cells)
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
            vals = f(cd["x"].reshape(-1, 2))
            cd["c_" + k] = vals.reshape(cd["x"].shape[:2] + vals.shape[1:])
        return cd

    nq = len(w1d)

    def local(uflat, vflat, cd):
        ctx = Ctx(h=cd["h"])
        u_sides = None
        if uflat is not None:
            u_sides = [_unpack(uflat[s_i * ntot1 : (s_i + 1) * ntot1], layout) for s_i in range(nsides)]
        v_sides = [_unpack(vflat[s_i * ntot1 : (s_i + 1) * ntot1], layout) for s_i in range(nsides)]

        def side_evals(locs, s_i, q):
            Ji = cd[f"Jinv{s_i}"]
            return {
                n: _phys_evals(locs[n], cd[f"t{s_i}_{n}_v"][q], cd[f"t{s_i}_{n}_g"][q], cd[f"t{s_i}_{n}_h"][q], Ji)
                for n in system.names
            }

        def side_data(s_i, q):
            Ji = cd[f"Jinv{s_i}"]
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
    _triangles_only(mesh)
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
    _triangles_only(mesh)
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
    _triangles_only(mesh)
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
