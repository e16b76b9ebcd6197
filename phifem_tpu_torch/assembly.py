"""Variational-form assembly as batched autodiff element kernels.

Counterpart of :mod:`phifem_tpu.assembly`.

* A term's integrand is plain torch code evaluated at one quadrature point:
  ``integrand(u, v, data, x, ctx) -> scalar`` where ``u``/``v`` map field
  names to :class:`FieldEval` (value / physical gradient / physical
  Hessian).  Every form is bilinear in (trial, test), so the exact element
  matrix is the Hessian of the local energy,
  ``torch.func.jacfwd(torch.func.grad(local, argnums=1), argnums=0)``,
  under ``torch.func.vmap`` over the batch's cells or facets.
* Terms act on tag regions: cell terms on cell tags (``dx(2)``), interior
  facet terms on facet tags (``dS((2, 3))``), boundary terms on a one-sided
  facet list (``ds(100)``).  Entity lists are chosen on the host from the
  tags; element matrices are computed on ``grid.device``.
* ``uniform=True`` terms (stiffness, mass) have one element matrix per cell
  orientation; on a scalar P1 field they become a
  :class:`~phifem_tpu_torch.ops.stencil.StencilCellBatch` (shifted adds on
  the vertex lattice, the hand-written kernel on the card) without ever
  building per-cell tables.
* Data-dependent batches keep the function that rebuilt them:
  :meth:`Operator.reassemble` recomputes their matrices from the current
  data (a new level set, new coefficients) in one call.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import grad, jacfwd, vmap

from .grid import Grid
from .measures import FacetSideList
from .ops.scatter import scatter_plan
from .quadrature import cell_rule, segment_rule
from .spaces import Function, Space

__all__ = [
    "FieldEval",
    "Ctx",
    "System",
    "CellTerm",
    "FacetTerm",
    "BoundaryTerm",
    "Batch",
    "Operator",
    "assemble_operator",
    "assemble_vector",
    "assemble_scalar",
    "uniform_element_matrices",
    "assemble_cellwise",
]

#: entities per vmapped element-kernel call; larger batches are chunked
ENTITY_CHUNK = 1 << 15


class FieldEval(NamedTuple):
    """Point evaluation of a field: value, physical gradient, physical
    Hessian (shapes ``vs``, ``vs+(2,)``, ``vs+(2,2)``).  A NamedTuple, so
    ``torch.func`` traverses it as a pytree."""

    val: torch.Tensor
    grad: Optional[torch.Tensor]
    hess: Optional[torch.Tensor]

    @property
    def lap(self) -> torch.Tensor:
        """Laplacian (trace of the Hessian)."""
        return torch.diagonal(self.hess, dim1=-2, dim2=-1).sum(-1)


@dataclasses.dataclass(frozen=True)
class Ctx:
    """Per-term context passed to integrands."""

    h: float  # cell diameter (uniform on this grid; ufl.CellDiameter)


class System:
    """Ordered collection of named fields.  Solution vectors are dicts
    ``{name: tensor of shape space.dof_shape}``."""

    def __init__(self, fields: Dict[str, Space]):
        self.fields: Dict[str, Space] = dict(fields)
        self.names: Tuple[str, ...] = tuple(self.fields.keys())

    def zeros(self) -> Dict[str, torch.Tensor]:
        return {
            n: torch.zeros(s.dof_shape, dtype=s.grid.dtype, device=s.grid.device)
            for n, s in self.fields.items()
        }

    @property
    def num_dofs(self) -> int:
        return sum(s.num_dofs for s in self.fields.values())

    def offsets(self) -> Dict[str, int]:
        off, cur = {}, 0
        for n, s in self.fields.items():
            off[n] = cur
            cur += s.num_dofs
        return off


# ------------------------------------------------------------------- terms
@dataclasses.dataclass(frozen=True)
class CellTerm:
    """``integrand(u, v, data, x, ctx) * dx(region)``; for vectors and
    functionals the integrand drops ``u`` (and ``v``)."""

    integrand: Callable
    region: Optional[Tuple[int, ...]] = None  # cell tags; None = all cells
    degree: int = 4
    uniform: bool = False  # True: no data/x dependence -> per-orientation matrix


@dataclasses.dataclass(frozen=True)
class FacetTerm:
    """Interior-facet term ``integrand(u0, u1, v0, v1, data0, data1, x, n,
    ctx) * dS(region)``; ``n`` points from side 0 to side 1."""

    integrand: Callable
    region: Tuple[int, ...] = (2, 3)
    npts: int = 3


@dataclasses.dataclass(frozen=True)
class BoundaryTerm:
    """One-sided facet term ``integrand(u, v, data, x, n, ctx) * ds`` over
    a :class:`FacetSideList`; ``n`` is outward for the chosen cell."""

    integrand: Callable
    facets: FacetSideList
    npts: int = 3


# ----------------------------------------------------------- tabulations
def _phys_tabs(e, grid: Grid, flat_pts: np.ndarray, lead: Tuple[int, ...]):
    """Basis values and physical gradients/Hessians at reference points,
    per orientation: VAL ``lead + (nloc,)``, GRAD ``(no,) + lead + (nloc,
    2)``, HESS ``(no,) + lead + (nloc, 2, 2)`` (``lead`` the point shape)."""
    val = e.tabulate(flat_pts)
    gref = e.tabulate_grad(flat_pts)
    href = e.tabulate_hess(flat_pts)
    J, _ = grid.cell_jacobians()
    Jinv = np.linalg.inv(J.cpu().numpy().astype(np.float64))  # d ref/d phys
    gphys = np.einsum("qlr,orx->oqlx", gref, Jinv)
    hphys = np.einsum("ory,qlrs,osx->oqlyx", Jinv, href, Jinv)
    no = Jinv.shape[0]
    return (
        grid._tensor(val.reshape(lead + (e.nloc,))),
        grid._tensor(gphys.reshape((no,) + lead + (e.nloc, 2))),
        grid._tensor(hphys.reshape((no,) + lead + (e.nloc, 2, 2))),
    )


def _cell_tabs(space: Space, ref_pts: np.ndarray, grid: Grid):
    """VAL (nq, nloc), GRAD (norient, nq, nloc, 2) physical, HESS
    (norient, nq, nloc, 2, 2)."""
    return _phys_tabs(space.element, grid, np.asarray(ref_pts), (len(ref_pts),))


def _facet_ref_points(grid: Grid, t: np.ndarray) -> np.ndarray:
    """(norient, nfpc, nq, 2) reference coordinates of facet points, indexed
    by the *global* facet parameter t (the one flip where a local edge runs
    against the global direction: upper triangle, local facet 1)."""
    out = []
    for o in range(grid.num_orientations):
        rows = []
        for k in range(grid.num_facets_per_cell):
            tt = 1.0 - t if (grid.is_simplex and o == 1 and k == 1) else t
            z, on = np.zeros_like(tt), np.ones_like(tt)
            if grid.is_simplex:
                table = [np.stack([tt, z], -1), np.stack([1.0 - tt, tt], -1), np.stack([z, tt], -1)]
            else:
                table = [
                    np.stack([z, tt], -1),
                    np.stack([on, tt], -1),
                    np.stack([tt, z], -1),
                    np.stack([tt, on], -1),
                ]
            rows.append(table[k])
        out.append(np.stack(rows))
    return np.stack(out)


def _facet_tabs(space: Space, grid: Grid, t: np.ndarray):
    """VAL, GRAD, HESS at the facet points, each flattened to
    ``(norient * nfpc, nq, nloc, ...)`` (row ``o * nfpc + k``)."""
    refs = _facet_ref_points(grid, t)  # (no, nfpc, nq, 2)
    no, nfpc, nq, _ = refs.shape
    e = space.element
    flat = refs.reshape(-1, 2)
    val, g, h = _phys_tabs(e, grid, flat, (no, nfpc, nq))
    # the values do not depend on the orientation; the derivatives take the
    # Jacobian of the point's own orientation
    sel = torch.arange(no, device=g.device)
    g = g[sel, sel]
    h = h[sel, sel]
    return val.flatten(0, 1), g.flatten(0, 1), h.flatten(0, 1)


# ------------------------------------------------------------- local layout
def _layout(system: System) -> List[Tuple[str, int, Tuple[int, ...], int]]:
    """[(field, nloc_scalar, value_shape, flat_len)] in system order."""
    return [
        (n, s.nloc, tuple(s.value_shape), s.nloc * s.value_size)
        for n, s in system.fields.items()
    ]


def _unpack(flat: torch.Tensor, layout) -> Dict[str, torch.Tensor]:
    out, cur = {}, 0
    for name, nloc, vs, ln in layout:
        out[name] = flat[cur : cur + ln].reshape((nloc,) + vs)
        cur += ln
    return out


def _eval_field(u_loc, valq, gradq, hessq) -> FieldEval:
    return FieldEval(
        val=torch.einsum("l,l...->...", valq, u_loc),
        grad=torch.einsum("lx,l...->...x", gradq, u_loc),
        hess=torch.einsum("lxy,l...->...xy", hessq, u_loc),
    )


def _normalize_data(data: Optional[Dict]) -> Dict:
    return dict(data) if data else {}


def _split_data(data: Dict):
    fn_data = {k: v for k, v in data.items() if isinstance(v, Function)}
    call_data = {k: v for k, v in data.items() if not isinstance(v, Function)}
    return fn_data, call_data


def _entity_map(fn: Callable) -> Callable:
    """``vmap(fn)`` over the leading (entity) axis of a dict of tensors,
    in chunks of :data:`ENTITY_CHUNK` entities."""
    vf = vmap(fn)

    def run(cd: Dict) -> torch.Tensor:
        ne = next(iter(cd.values())).shape[0]
        if ne <= ENTITY_CHUNK:
            return vf(cd)
        parts = [
            vf({k: v[s : s + ENTITY_CHUNK] for k, v in cd.items()})
            for s in range(0, ne, ENTITY_CHUNK)
        ]
        return torch.cat(parts)

    return run


# --------------------------------------------------------------- cell batch
def _cell_local_fn(system: System, term: CellTerm, grid: Grid, data: Dict):
    """Builds ``(local_fn, cell_data_fn, ntot, layout, fn_data)``.
    ``local_fn(uflat, vflat, cd)`` is the per-cell energy; ``cd`` carries
    the orientation, the physical quadrature points and gathered data.

    ``cell_data_fn(cells, arrays=None, static=None)``: ``static`` is the
    data-independent part ``cell_data_fn.static(cells)`` (orientation,
    points, DoF ids, callable-data values), kept by a rebuildable batch;
    ``arrays`` overrides the Functions' coefficient tensors by name."""
    ref_pts, wq = cell_rule(grid.cell_type.value, term.degree)
    _, detJ = grid.cell_jacobians()
    layout = _layout(system)
    ntot = sum(l[-1] for l in layout)
    tabs = {n: _cell_tabs(s, ref_pts, grid) for n, s in system.fields.items()}
    fn_data, call_data = _split_data(data)
    dtabs = {k: _cell_tabs(v.space, ref_pts, grid) for k, v in fn_data.items()}
    ctx = Ctx(h=grid.cell_diameter)
    wq_t = grid._tensor(wq)

    def cell_static(cells: torch.Tensor) -> Dict:
        st = {
            "orient": grid.orientation_of(cells).to(torch.int64),
            "x": grid.map_to_physical(cells, ref_pts),
        }
        for k, f in fn_data.items():
            st["dofs_" + k] = f.space.cell_dofs_of(cells)
        for k, f in call_data.items():
            vals = f(st["x"].reshape(-1, 2))
            st["c_" + k] = vals.reshape(st["x"].shape[:2] + vals.shape[1:])
        return st

    def cell_data(cells=None, arrays: Optional[Dict] = None, static: Optional[Dict] = None) -> Dict:
        st = cell_static(cells) if static is None else static
        cd = {k: v for k, v in st.items() if not k.startswith("dofs_")}
        for k, f in fn_data.items():
            dat = arrays[k] if arrays is not None else f.data
            cd["d_" + k] = dat[st["dofs_" + k]].to(grid.device)
        return cd

    cell_data.static = cell_static

    def local(uflat, vflat, cd):
        o = cd["orient"]
        u_locs = _unpack(uflat, layout) if uflat is not None else None
        v_locs = _unpack(vflat, layout)

        def at_point(q_tabs, q_dtabs, q_call, xpt, w):
            v_ev = {n: _eval_field(v_locs[n], *q_tabs[n]) for n in system.names}
            d_ev = {k: _eval_field(cd["d_" + k], *q_dtabs[k]) for k in fn_data}
            for k in call_data:
                d_ev[k] = FieldEval(q_call[k], None, None)
            if u_locs is None:
                return w * term.integrand(v_ev, d_ev, xpt, ctx)
            u_ev = {n: _eval_field(u_locs[n], *q_tabs[n]) for n in system.names}
            return w * term.integrand(u_ev, v_ev, d_ev, xpt, ctx)

        def at(t):  # t[o]; a 0-d index would be read as a Python int under vmap
            return t.index_select(0, o.reshape(1))[0]

        q_tabs = {n: (t[0], at(t[1]), at(t[2])) for n, t in tabs.items()}
        q_dtabs = {k: (t[0], at(t[1]), at(t[2])) for k, t in dtabs.items()}
        q_call = {k: cd["c_" + k] for k in call_data}
        contrib = vmap(at_point)(q_tabs, q_dtabs, q_call, cd["x"], wq_t * at(detJ))
        return contrib.sum()

    return local, cell_data, ntot, layout, fn_data


def _region_cells(grid: Grid, cell_tags, region) -> np.ndarray:
    """Host ids of the cells whose tag is in ``region`` (all when None)."""
    if region is None:
        return np.arange(grid.num_cells, dtype=np.int64)
    return np.where(np.isin(np.asarray(cell_tags), np.asarray(region)))[0]


# -------------------------------------------------------------- facet batch
def _facet_local_fn(system: System, term, grid: Grid, data: Dict, one_sided: bool):
    """Facet counterpart of :func:`_cell_local_fn`.  The per-point basis
    tables of each side's cell are gathered by (orientation, local facet)
    into the static data, outside the vmapped energy."""
    tq, wq = segment_rule(term.npts)
    layout = _layout(system)
    n_one = sum(l[-1] for l in layout)
    nsides = 1 if one_sided else 2
    ntot = nsides * n_one
    tabs = {n: _facet_tabs(s, grid, tq) for n, s in system.fields.items()}
    fn_data, call_data = _split_data(data)
    dtabs = {k: _facet_tabs(v.space, grid, tq) for k, v in fn_data.items()}
    ctx = Ctx(h=grid.cell_diameter)
    wq_t, tq_t = grid._tensor(wq), grid._tensor(tq)
    nfpc = grid.num_facets_per_cell
    tab_keys = (
        [f"{c}{s}_{n}" for s in range(nsides) for n in system.names for c in "vgh"]
        + [f"d{c}{s}_{k}" for s in range(nsides) for k in fn_data for c in "vgh"]
        + ["c_" + k for k in call_data]
    )

    def facet_static(facets, cells_sides, locals_sides, normals) -> Dict:
        ends = grid.facet_endpoints_of(facets)  # (ne, 2, 2)
        x = ends[:, None, 0, :] * (1 - tq_t)[None, :, None] + ends[:, None, 1, :] * tq_t[None, :, None]
        st = {"x": x, "n": normals, "len": grid.facet_lengths_of(facets)}
        for s, (cells, locs) in enumerate(zip(cells_sides, locals_sides)):
            row = grid.orientation_of(cells).to(torch.int64) * nfpc + locs.to(torch.int64)
            for n, t in tabs.items():
                for c, tab in zip("vgh", t):
                    st[f"{c}{s}_{n}"] = tab[row]
            for k, t in dtabs.items():
                for c, tab in zip("vgh", t):
                    st[f"d{c}{s}_{k}"] = tab[row]
                st[f"dofs{s}_{k}"] = fn_data[k].space.cell_dofs_of(cells)
        for k, f in call_data.items():
            vals = f(x.reshape(-1, 2))
            st["c_" + k] = vals.reshape(x.shape[:2] + vals.shape[1:])
        return st

    def facet_data(facets=None, cells_sides=None, locals_sides=None, normals=None,
                   arrays: Optional[Dict] = None, static: Optional[Dict] = None) -> Dict:
        st = facet_static(facets, cells_sides, locals_sides, normals) if static is None else static
        cd = {k: v for k, v in st.items() if not k.startswith("dofs")}
        for s in range(nsides):
            for k, f in fn_data.items():
                dat = arrays[k] if arrays is not None else f.data
                cd[f"d{s}_{k}"] = dat[st[f"dofs{s}_{k}"]].to(grid.device)
        return cd

    facet_data.static = facet_static

    def local(uflat, vflat, cd):
        has_u = uflat is not None
        sides = [slice(s * n_one, (s + 1) * n_one) for s in range(nsides)]
        u_sides = [_unpack(uflat[sl], layout) for sl in sides] if has_u else None
        v_sides = [_unpack(vflat[sl], layout) for sl in sides]

        def at_point(q, xpt, w):
            evs_u, evs_v, evs_d = [], [], []
            for s in range(nsides):
                tq_tabs = {n: (q[f"v{s}_{n}"], q[f"g{s}_{n}"], q[f"h{s}_{n}"]) for n in system.names}
                if has_u:
                    evs_u.append({n: _eval_field(u_sides[s][n], *tq_tabs[n]) for n in system.names})
                evs_v.append({n: _eval_field(v_sides[s][n], *tq_tabs[n]) for n in system.names})
                dd = {
                    k: _eval_field(cd[f"d{s}_{k}"], q[f"dv{s}_{k}"], q[f"dg{s}_{k}"], q[f"dh{s}_{k}"])
                    for k in fn_data
                }
                for k in call_data:
                    dd[k] = FieldEval(q["c_" + k], None, None)
                evs_d.append(dd)
            n_vec = cd["n"]
            if one_sided:
                if has_u:
                    return w * term.integrand(evs_u[0], evs_v[0], evs_d[0], xpt, n_vec, ctx)
                return w * term.integrand(evs_v[0], evs_d[0], xpt, n_vec, ctx)
            if has_u:
                return w * term.integrand(
                    evs_u[0], evs_u[1], evs_v[0], evs_v[1], evs_d[0], evs_d[1], xpt, n_vec, ctx
                )
            return w * term.integrand(evs_v[0], evs_v[1], evs_d[0], evs_d[1], xpt, n_vec, ctx)

        q = {k: cd[k] for k in tab_keys}
        contrib = vmap(at_point)(q, cd["x"], wq_t * cd["len"])
        return contrib.sum()

    return local, facet_data, ntot, layout, fn_data


# ---------------------------------------------------------------- operator
@dataclasses.dataclass
class Batch:
    """One assembled entity batch of an operator: per-entity local DoFs of
    each field and dense element matrices, applied as gather -> batched
    matmul -> scatter-add.  ``orient`` set: one matrix per orientation (a
    geometry-uniform term).  ``rebuild_core(arrays)`` recomputes the
    matrices of a data-dependent batch from the coefficient tensors of its
    ``rebuild_data`` Functions."""

    segments: List[Tuple[str, torch.Tensor, Tuple[int, ...]]]  # (field, dofs (ne, nloc), vshape)
    matrices: Optional[torch.Tensor]  # (ne, n, n) or (norient, n, n) if uniform
    orient: Optional[torch.Tensor] = None  # (ne,) for uniform batches
    rebuild_core: Optional[Callable] = None
    rebuild_data: Optional[Dict[str, Function]] = None
    cells: Optional[np.ndarray] = None  # covered cell ids (uniform cell batches)
    # per segment (unique DoFs, (nuniq, kmax) positions): see scatter_add
    _plans: Optional[list] = dataclasses.field(default=None, init=False, repr=False, compare=False)

    @property
    def dynamic(self) -> bool:
        """Data-dependent (rebuildable) batch."""
        return self.rebuild_core is not None

    def rebuild(self) -> torch.Tensor:
        return self.rebuild_core({k: f.data for k, f in self.rebuild_data.items()})

    @property
    def num_entities(self) -> int:
        return int(self.segments[0][1].shape[0])

    def astype(self, dtype: torch.dtype) -> "Batch":
        """Copy (not rebuildable) with the matrices cast to ``dtype``."""
        return Batch(self.segments, self.matrices.to(dtype), orient=self.orient)

    def gather(self, x: Dict[str, torch.Tensor]) -> torch.Tensor:
        ne = self.num_entities
        return torch.cat([x[name][dofs].reshape(ne, -1) for name, dofs, vs in self.segments], dim=1)

    def scatter_add(self, y: Dict[str, torch.Tensor], y_loc: torch.Tensor):
        """``y[field][dofs] += y_loc`` per segment, in place (duplicates
        accumulate); returns ``y``.  Deterministic: each DoF's
        contributions are gathered and summed in entity order, then added
        once (CUDA's ``index_add_`` on repeated indices sums in an order
        that changes from run to run)."""
        if self._plans is None:
            self._plans = [scatter_plan(dofs) for _, dofs, _ in self.segments]
        cur = 0
        ne = y_loc.shape[0]
        for (name, dofs, vs), (uniq, pos) in zip(self.segments, self._plans):
            nloc = dofs.shape[1]
            vsz = int(np.prod(vs)) if vs else 1
            seg = y_loc[:, cur : cur + nloc * vsz].reshape((ne * nloc,) + tuple(vs))
            seg = torch.cat([seg, seg.new_zeros((1,) + tuple(vs))])  # row ne*nloc: padding
            y[name].index_add_(0, uniq, seg[pos].sum(dim=1))
            cur += nloc * vsz
        return y

    def matvec_into(self, x, y, mats: Optional[torch.Tensor] = None):
        if mats is None:
            mats = self.matrices
        x_loc = self.gather(x)
        if self.orient is None:
            y_loc = torch.einsum("eij,ej->ei", mats, x_loc)
        else:
            # one matrix per orientation: apply each and select
            y_loc = x_loc @ mats[0].T
            for o in range(1, mats.shape[0]):
                y_loc = torch.where((self.orient == o)[:, None], x_loc @ mats[o].T, y_loc)
        return self.scatter_add(y, y_loc)

    def diagonal_into(self, d, mats: Optional[torch.Tensor] = None):
        if mats is None:
            mats = self.matrices
        dloc = torch.diagonal(mats, dim1=-2, dim2=-1)
        if self.orient is not None:
            dloc = dloc[self.orient]
        return self.scatter_add(d, dloc.expand(self.num_entities, dloc.shape[-1]))

    def _host_matrices(self, keep: Optional[np.ndarray] = None) -> np.ndarray:
        mats = self.matrices.cpu().numpy()
        if self.orient is not None:
            orient = self.orient.cpu().numpy()
            return mats[orient if keep is None else orient[keep]]
        return mats if keep is None else mats[keep]

    def entity_global_dofs(self, offsets: Dict[str, int]) -> np.ndarray:
        """(ne, L) global flat DoF ids per entity (system-offset layout)."""
        ne = self.num_entities
        gidx = []
        for name, dofs, vs in self.segments:
            vsz = int(np.prod(vs)) if vs else 1
            base = offsets[name] + dofs.cpu().numpy()[..., None] * vsz
            gidx.append((base + np.arange(vsz)[None, None, :]).reshape(ne, -1))
        return np.concatenate(gidx, axis=1)

    def restricted_entities(self, offsets, idx_of: np.ndarray):
        """Compact local ids (``idx_of``: global flat id -> compact index,
        -1 = unselected) and host element matrices of the entities with a
        selected DoF."""
        l = idx_of[self.entity_global_dofs(offsets)]
        keep = (l >= 0).any(axis=1)
        return l[keep], self._host_matrices(keep)

    def add_dense(self, A: np.ndarray, offsets: Dict[str, int]) -> None:
        gidx = self.entity_global_dofs(offsets)
        mats = self._host_matrices()
        # np.add.at accumulates duplicate indices (a facet batch's two cells
        # share DoFs)
        np.add.at(
            A,
            (gidx[:, :, None], gidx[:, None, :]),
            np.broadcast_to(mats, (gidx.shape[0],) + mats.shape[-2:]),
        )


def _is_dynamic(b) -> bool:
    return getattr(b, "dynamic", False)


@dataclasses.dataclass
class Operator:
    """Matrix-free assembled operator: sum of entity batches."""

    system: System
    batches: List

    def matvec(self, x: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        y = self.system.zeros()
        for b in self.batches:
            y = b.matvec_into(x, y)
        return y

    def __call__(self, x):
        return self.matvec(x)

    def diagonal(self) -> Dict[str, torch.Tensor]:
        """Jacobi diagonal."""
        d = self.system.zeros()
        for b in self.batches:
            d = b.diagonal_into(d)
        return d

    def dynamic_batch_ids(self) -> Tuple[int, ...]:
        """Indices of the data-dependent (rebuildable) batches."""
        return tuple(i for i, b in enumerate(self.batches) if _is_dynamic(b))

    def lattice_form(self):
        """Tap-form lattice representation (:mod:`phifem_tpu_torch.ops.taps`)
        of this operator, or None when unsupported (degree >= 2 fields) or
        pointless (pure uniform-stencil operators).  Built once (the
        structure does not depend on the data) and refreshed when
        :attr:`data_version` moves."""
        top = getattr(self, "_tap_form", None)
        if top is None:
            if getattr(self, "_tap_unsupported", False):
                return None
            from .ops.taps import build_tap_operator

            top = build_tap_operator(self)
            if top is None:
                self._tap_unsupported = True
                return None
            self._tap_form = top
        if top.data_version != self.data_version:
            top.refresh(self)
        return top

    @property
    def data_version(self) -> int:
        """Counter bumped by every :meth:`reassemble`: caches of anything
        built from element-matrix values key on it."""
        return getattr(self, "_data_version", 0)

    def _bump_version(self) -> None:
        self._data_version = self.data_version + 1

    def reassemble(self) -> None:
        """Recompute every data-dependent batch's element matrices from its
        current data, in place.  Geometry-uniform batches are constants."""
        ids = self.dynamic_batch_ids()
        if not ids:
            return
        for i in ids:
            self.batches[i].matrices = self.batches[i].rebuild()
        self._bump_version()

    def _selection_ids(self, sel: Dict[str, np.ndarray]):
        off = self.system.offsets()
        n = self.system.num_dofs
        gsel = np.zeros(n, bool)
        for name, s in self.system.fields.items():
            gsel[off[name] : off[name] + s.num_dofs] = np.broadcast_to(
                np.asarray(sel[name]), s.dof_shape
            ).reshape(-1)
        ids = np.where(gsel)[0]
        idx_of = -np.ones(n, np.int64)
        idx_of[ids] = np.arange(len(ids))
        return off, ids, idx_of

    def restricted_dense(self, sel: Dict[str, np.ndarray]):
        """Dense submatrix of the operator over the selected DoFs (boolean
        host masks per field) and the selected global flat ids."""
        off, ids, idx_of = self._selection_ids(sel)
        m = len(ids)
        A = np.zeros((m + 1, m + 1))
        for b in self.batches:
            l, mats = b.restricted_entities(off, idx_of)
            l = np.where(l >= 0, l, m)  # unselected local DoFs -> padded slot m
            np.add.at(A, (l[:, :, None], l[:, None, :]), mats)
        return A[:m, :m], ids

    def restricted_csr(self, sel: Dict[str, np.ndarray]):
        """Sparse (CSR) submatrix over the selected DoFs, O(nnz) memory."""
        import scipy.sparse as sp

        off, ids, idx_of = self._selection_ids(sel)
        m = len(ids)
        triplets = ([], [], [])
        for b in self.batches:
            l, mats = b.restricted_entities(off, idx_of)
            rows = np.broadcast_to(l[:, :, None], mats.shape)
            cols = np.broadcast_to(l[:, None, :], mats.shape)
            valid = (rows >= 0) & (cols >= 0)  # both endpoints selected
            triplets[0].append(rows[valid])
            triplets[1].append(cols[valid])
            triplets[2].append(mats[valid])
        if triplets[0]:
            rows, cols, vals = (np.concatenate(t) for t in triplets)
        else:
            rows = cols = np.zeros(0, np.int64)
            vals = np.zeros(0)
        return sp.coo_matrix((vals, (rows, cols)), shape=(m, m)).tocsr(), ids

    def to_dense(self) -> np.ndarray:
        """Dense global matrix (small problems / tests only)."""
        off = self.system.offsets()
        A = np.zeros((self.system.num_dofs, self.system.num_dofs))
        for b in self.batches:
            b.add_dense(A, off)
        return A


# ------------------------------------------------------------ entry points
def _orientation_matrices(system: System, grid: Grid, term: CellTerm, data: Dict):
    """(norient, ntot, ntot) element matrices at one representative cell
    per orientation (cells ``0..norient-1``), computed on the host: they
    are a few dozen numbers, and autodiff on the card would only add
    launches and one-off library start-up."""
    host = dataclasses.replace(grid, device=torch.device("cpu"))
    local, cell_data, ntot, layout, _ = _cell_local_fn(system, term, host, data)
    zeros = torch.zeros(ntot, dtype=grid.dtype)
    mat_fn = jacfwd(grad(local, argnums=1), argnums=0)
    rep = torch.arange(grid.num_orientations)
    return vmap(lambda c: mat_fn(zeros, zeros, c))(cell_data(rep)), layout


def uniform_element_matrices(
    system: System, grid: Grid, integrand, degree: int
) -> torch.Tensor:
    """(norient, nloc, nloc) element matrices of a geometry-uniform
    bilinear cell term: a CPU tensor in ``grid.dtype``."""
    term = CellTerm(integrand, None, degree=degree, uniform=True)
    return _orientation_matrices(system, grid, term, {})[0]


def _segments_for_cells(system: System, cells: torch.Tensor):
    return [(n, s.cell_dofs_of(cells), tuple(s.value_shape)) for n, s in system.fields.items()]


def _prune_batch(segments, mats: torch.Tensor):
    """Drop local-vector segments whose rows AND columns are identically
    zero (a term on a mixed space only touches its own fields).  Returns
    ``(segments, mats, kept_index_or_None)``."""
    nz = mats.abs().sum(dim=0).cpu().numpy()  # (n, n) aggregated over entities
    used = (nz.sum(axis=1) > 0.0) | (nz.sum(axis=0) > 0.0)
    keep_segments, keep_idx, cur = [], [], 0
    for name, dofs, vs in segments:
        vsz = int(np.prod(vs)) if vs else 1
        ln = dofs.shape[1] * vsz
        if used[cur : cur + ln].any():
            keep_segments.append((name, dofs, vs))
            keep_idx.extend(range(cur, cur + ln))
        cur += ln
    if len(keep_idx) == mats.shape[-1]:
        return segments, mats, None
    idx = torch.as_tensor(keep_idx, dtype=torch.int64, device=mats.device)
    return keep_segments, mats[:, idx][:, :, idx], idx


def _dynamic_batch(segments, mat_map, data_fn, static, fn_data) -> Optional[Batch]:
    """Batch of a data-dependent term: matrices from ``mat_map`` over the
    entity data, pruned, with the rebuild core that recomputes them."""
    segs, mats, keep = _prune_batch(segments, mat_map(data_fn(static=static)))
    if not segs:
        return None

    def core(arrays):
        m = mat_map(data_fn(arrays=arrays, static=static))
        return m if keep is None else m[:, keep][:, :, keep]

    return Batch(segs, mats, rebuild_core=core, rebuild_data=fn_data)


def _interior_facets(grid: Grid, facet_tags, region):
    """Host ``(facets, cells0, cells1)`` of the interior facets (two
    adjacent cells: dS semantics) whose tag is in ``region``."""
    facets = np.where(np.isin(np.asarray(facet_tags), np.asarray(region)))[0]
    f2c = grid.f2c_of_np(facets)
    inner = np.all(f2c >= 0, axis=1)
    return facets[inner], f2c[inner, 0], f2c[inner, 1]


def _facet_side_args(grid: Grid, facets, c0, c1):
    """Device ``(facets, (c0, c1), (k0, k1), normals)`` for facet data."""
    dev = grid.device
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int64, device=dev)
    k0 = grid.local_facet_index_np(c0, facets)
    k1 = grid.local_facet_index_np(c1, facets)
    facets_t = t(facets)
    return facets_t, (t(c0), t(c1)), (t(k0), t(k1)), grid.facet_base_normals_of(facets_t)


def assemble_operator(
    system: System,
    grid: Grid,
    cell_terms: Sequence[Tuple[CellTerm, Dict]] = (),
    facet_terms: Sequence[Tuple[FacetTerm, Dict]] = (),
    boundary_terms: Sequence[Tuple[BoundaryTerm, Dict]] = (),
    cell_tags=None,
    facet_tags=None,
) -> Operator:
    """Assemble a bilinear operator.  Each term comes with its own ``data``
    dict (Functions / callables available to the integrand); ``cell_tags``
    and ``facet_tags`` are host arrays."""
    from .ops.stencil import StencilCellBatch

    batches: List = []
    dev = grid.device
    for term, data in cell_terms:
        data = _normalize_data(data)
        if term.uniform:
            mats, layout = _orientation_matrices(system, grid, term, data)
            # decide the stencil path from the layout alone, before any
            # per-cell table exists (at 10M DoFs one is hundreds of MB):
            # each segment carries a single dummy row of local DoFs
            dummy = [(n, np.zeros((1, nloc), np.int32), vs) for n, nloc, vs, _ in layout]
            kept, mats_p, _ = _prune_batch(dummy, mats)
            if not kept:
                continue  # identically zero term (e.g. P1 Laplacian stabilization)
            name, _, vs = kept[0]
            sp = system.fields[name]
            if len(kept) == 1 and not vs and sp.element.family == "Lagrange" and sp.degree == 1:
                batches.append(StencilCellBatch.build(grid, name, mats_p, cell_tags, term.region))
                continue
            cells = _region_cells(grid, cell_tags, term.region)
            cells_t = torch.as_tensor(cells, device=dev)
            segs, mats_u, _ = _prune_batch(_segments_for_cells(system, cells_t), mats)
            batches.append(
                Batch(segs, mats_u.to(dev), orient=grid.orientation_of(cells_t).to(torch.int64), cells=cells)
            )
            continue
        local, cell_data, ntot, layout, fn_data = _cell_local_fn(system, term, grid, data)
        cells_t = torch.as_tensor(_region_cells(grid, cell_tags, term.region), device=dev)
        zeros = torch.zeros(ntot, dtype=grid.dtype, device=dev)
        mat_fn = jacfwd(grad(local, argnums=1), argnums=0)
        b = _dynamic_batch(
            _segments_for_cells(system, cells_t),
            _entity_map(lambda c, _m=mat_fn, _z=zeros: _m(_z, _z, c)),
            cell_data,
            cell_data.static(cells_t),
            fn_data,
        )
        if b is not None:
            batches.append(b)

    for term, data in facet_terms:
        facets, c0, c1 = _interior_facets(grid, facet_tags, term.region)
        local, facet_data, ntot, layout, fn_data = _facet_local_fn(
            system, term, grid, _normalize_data(data), one_sided=False
        )
        facets_t, cells_t, locals_t, normals = _facet_side_args(grid, facets, c0, c1)
        zeros = torch.zeros(ntot, dtype=grid.dtype, device=dev)
        mat_fn = jacfwd(grad(local, argnums=1), argnums=0)
        b = _dynamic_batch(
            _segments_for_cells(system, cells_t[0]) + _segments_for_cells(system, cells_t[1]),
            _entity_map(lambda c, _m=mat_fn, _z=zeros: _m(_z, _z, c)),
            facet_data,
            facet_data.static(facets_t, cells_t, locals_t, normals),
            fn_data,
        )
        if b is not None:
            batches.append(b)

    for term, data in boundary_terms:
        fl = term.facets
        local, facet_data, ntot, layout, fn_data = _facet_local_fn(
            system, term, grid, _normalize_data(data), one_sided=True
        )
        zeros = torch.zeros(ntot, dtype=grid.dtype, device=dev)
        mat_fn = jacfwd(grad(local, argnums=1), argnums=0)
        b = _dynamic_batch(
            _segments_for_cells(system, fl.cells),
            _entity_map(lambda c, _m=mat_fn, _z=zeros: _m(_z, _z, c)),
            facet_data,
            facet_data.static(fl.facets, (fl.cells,), (fl.local_facets,), fl.normals),
            fn_data,
        )
        if b is not None:
            batches.append(b)

    return Operator(system, batches)


def _try_stencil_rhs(system, grid, term, data, cell_tags, b):
    """Vertex-stencil path for a LINEAR cell term that is geometry-uniform
    and linear in a single P1 data field: the assembled vector is then
    ``b += B_o @ f_loc`` summed over the region's cells, i.e. a masked
    stencil batch applied to the data field's nodal lattice, with no
    per-cell tables.  Linearity is verified on the representative cells;
    any mismatch returns None (the generic path runs instead).

    Returns the updated vector dict, or None when ineligible."""
    from .ops.stencil import StencilCellBatch

    fn_data, call_data = _split_data(data)
    if len(fn_data) != 1 or call_data:
        return None
    ((dk, f),) = fn_data.items()
    fs = f.space
    if fs.value_shape or fs.degree != 1 or fs.element.family != "Lagrange":
        return None
    host = dataclasses.replace(grid, device=torch.device("cpu"))
    local, cell_data, ntot, layout, _ = _cell_local_fn(system, term, host, data)
    cd = cell_data(torch.arange(grid.num_orientations))
    zeros_v = torch.zeros(ntot, dtype=grid.dtype)

    def one(cd_o):
        def wrt_f(dvals):
            c2 = dict(cd_o)
            c2["d_" + dk] = dvals
            return grad(lambda v: local(None, v, c2))(zeros_v)

        return jacfwd(wrt_f)(torch.zeros(fs.nloc, dtype=grid.dtype))  # (ntot, nloc_f)

    M = vmap(one)(cd)
    # verify exact linearity in the data field on the representative cells
    # (their cd carries the real nodal data)
    exact = vmap(lambda c: grad(lambda v: local(None, v, c))(zeros_v))(cd)
    lin = torch.einsum("oif,of->oi", M, cd["d_" + dk])
    scale = float(exact.abs().max() + lin.abs().max()) + 1e-300
    if float((exact - lin).abs().max()) > 1e-12 * scale:
        return None

    nz = M.abs().sum(dim=(0, 2)).numpy()  # per-row usage
    fields_used, cur = [], 0
    for name, nloc, vs, ln in layout:
        if nz[cur : cur + ln].any():
            fields_used.append((name, vs, cur, ln))
        cur += ln
    if not fields_used:
        return b  # the term contributes nothing (e.g. a P1 test-Laplacian term)
    if len(fields_used) != 1:
        return None
    name, vs, cur, ln = fields_used[0]
    sp = system.fields[name]
    if vs or sp.degree != 1 or sp.element.family != "Lagrange":
        return None
    sb = StencilCellBatch.build(grid, name, M[:, cur : cur + ln, :], cell_tags, term.region)
    return sb.matvec_into({name: f.data.contiguous()}, b)


def assemble_vector(
    system: System,
    grid: Grid,
    cell_terms: Sequence[Tuple[CellTerm, Dict]] = (),
    facet_terms: Sequence[Tuple[FacetTerm, Dict]] = (),
    boundary_terms: Sequence[Tuple[BoundaryTerm, Dict]] = (),
    cell_tags=None,
    facet_tags=None,
) -> Dict[str, torch.Tensor]:
    """Assemble a linear form into a DoF vector.  Integrands drop the
    trial dict: cell ``integrand(v, data, x, ctx)``, interior facet
    ``integrand(v0, v1, data0, data1, x, n, ctx)``, boundary
    ``integrand(v, data, x, n, ctx)``."""
    b = system.zeros()
    dev = grid.device

    def vec_map(local, ntot):
        zeros = torch.zeros(ntot, dtype=grid.dtype, device=dev)
        vec_fn = grad(lambda v, c: local(None, v, c), argnums=0)
        return _entity_map(lambda c: vec_fn(zeros, c))

    for term, data in cell_terms:
        data = _normalize_data(data)
        if term.uniform:
            nb = _try_stencil_rhs(system, grid, term, data, cell_tags, b)
            if nb is not None:
                b = nb
                continue
        local, cell_data, ntot, layout, fn_data = _cell_local_fn(system, term, grid, data)
        cells_t = torch.as_tensor(_region_cells(grid, cell_tags, term.region), device=dev)
        vecs = vec_map(local, ntot)(cell_data(cells_t))
        b = Batch(_segments_for_cells(system, cells_t), None).scatter_add(b, vecs)

    for term, data in facet_terms:
        facets, c0, c1 = _interior_facets(grid, facet_tags, term.region)
        local, facet_data, ntot, layout, fn_data = _facet_local_fn(
            system, term, grid, _normalize_data(data), one_sided=False
        )
        facets_t, cells_t, locals_t, normals = _facet_side_args(grid, facets, c0, c1)
        vecs = vec_map(local, ntot)(facet_data(facets_t, cells_t, locals_t, normals))
        segs = _segments_for_cells(system, cells_t[0]) + _segments_for_cells(system, cells_t[1])
        b = Batch(segs, None).scatter_add(b, vecs)

    for term, data in boundary_terms:
        fl = term.facets
        local, facet_data, ntot, layout, fn_data = _facet_local_fn(
            system, term, grid, _normalize_data(data), one_sided=True
        )
        vecs = vec_map(local, ntot)(
            facet_data(fl.facets, (fl.cells,), (fl.local_facets,), fl.normals)
        )
        b = Batch(_segments_for_cells(system, fl.cells), None).scatter_add(b, vecs)

    return b


def assemble_scalar(
    grid: Grid,
    cell_terms: Sequence[Tuple[CellTerm, Dict]] = (),
    boundary_terms: Sequence[Tuple[BoundaryTerm, Dict]] = (),
    cell_tags=None,
) -> torch.Tensor:
    """Assemble a functional: a 0-d tensor.  Integrands: cell
    ``integrand(data, x, ctx)``, boundary ``integrand(data, x, n, ctx)``."""
    sys0 = System({})
    dev = grid.device
    total = torch.zeros((), dtype=grid.dtype, device=dev)
    zeros = torch.zeros(0, dtype=grid.dtype, device=dev)

    for term, data in cell_terms:
        wrapped = CellTerm(
            integrand=lambda v_ev, d_ev, x, ctx, _t=term: _t.integrand(d_ev, x, ctx),
            region=term.region,
            degree=term.degree,
        )
        local, cell_data, _, _, _ = _cell_local_fn(sys0, wrapped, grid, _normalize_data(data))
        cells_t = torch.as_tensor(_region_cells(grid, cell_tags, term.region), device=dev)
        vals = _entity_map(lambda c, _l=local: _l(None, zeros, c))(cell_data(cells_t))
        total = total + vals.sum()

    for term, data in boundary_terms:
        fl = term.facets
        wrapped = BoundaryTerm(
            integrand=lambda v_ev, d_ev, x, n, ctx, _t=term: _t.integrand(d_ev, x, n, ctx),
            facets=fl,
            npts=term.npts,
        )
        local, facet_data, _, _, _ = _facet_local_fn(
            sys0, wrapped, grid, _normalize_data(data), one_sided=True
        )
        cd = facet_data(fl.facets, (fl.cells,), (fl.local_facets,), fl.normals)
        vals = _entity_map(lambda c, _l=local: _l(None, zeros, c))(cd)
        total = total + vals.sum()

    return total


def assemble_cellwise(grid: Grid, term: CellTerm, data: Dict, cell_tags=None) -> torch.Tensor:
    """Per-cell values of a functional (``integrand(data, x, ctx)``) in a
    DG0-layout vector of ``grid.num_cells`` entries, zero off the term's
    region: the reference's DG0 localization of error fields.  Each cell's
    value is its own quadrature sum, written once (no scatter-add)."""
    wrapped = CellTerm(
        integrand=lambda v_ev, d_ev, x, ctx, _t=term: _t.integrand(d_ev, x, ctx),
        region=term.region,
        degree=term.degree,
    )
    local, cell_data, _, _, _ = _cell_local_fn(System({}), wrapped, grid, _normalize_data(data))
    cells_t = torch.as_tensor(_region_cells(grid, cell_tags, term.region), device=grid.device)
    zeros = torch.zeros(0, dtype=grid.dtype, device=grid.device)
    vals = _entity_map(lambda c: local(None, zeros, c))(cell_data(cells_t))
    out = torch.zeros(grid.num_cells, dtype=grid.dtype, device=grid.device)
    out[cells_t] = vals
    return out
