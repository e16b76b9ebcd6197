"""Row-slab domain decomposition with explicit halo exchange.

Counterpart of :mod:`phifem_tpu.parallel.halo`.  The background lattice is
partitioned into P row slabs over a 1D shard mesh; the operator matvec runs
on each shard's slab:

1. pull H halo rows of x from the next shard (one :func:`ppermute`);
2. apply every entity batch locally: a uniform scalar-P1 term (a
   :class:`~phifem_tpu_torch.ops.stencil.StencilCellBatch`) as the masked
   cell stencil on the slab's ``(nx, m)`` sub-lattice, through
   :func:`~phifem_tpu_torch.ops.cuda_stencil.stencil_matvec` (the
   hand-written kernel on the card), and the cut-cell / ghost / boundary
   batches as gather -> batched matmul -> ordered scatter over the
   host-partitioned per-shard entity lists
   (:class:`~phifem_tpu_torch.assembly.Batch`);
3. push the H rows of locally computed contributions that belong to the
   next shard back (one reverse :func:`ppermute`) and add.

Rows are padded to a multiple of the shard count and padded DoFs are
inactive identity rows, exactly like exterior DoFs.  Supported field
layouts: P1 vertex lattices (scalar / vector / tensor) and DG0 cell fields.
Higher-degree fields raise :class:`UnsupportedFieldError`, and so does a
halo wider than a slab.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..assembly import Batch, Operator
from ..grid import Grid
from ..ops.cuda_stencil import pack_matrices, stencil_matvec
from ..ops.stencil import StencilCellBatch
from ..solvers import lift_rhs
from . import sharding
from .sharding import ShardMesh, _flat, _krylov, _nested, _shard_key, pdot, ppermute

__all__ = ["HaloOperator", "UnsupportedFieldError", "halo_solve"]


class UnsupportedFieldError(ValueError):
    """System contains a field the halo decomposition cannot slab-partition."""


def _field_rows_width(space, grid: Grid) -> Tuple[int, int]:
    """(row count, scalar DoFs per row) of a field's row-major DoF layout."""
    if space.element.family == "DG" and space.degree == 0:
        return grid.ny, grid.nx * grid.cells_per_block
    if space.element.family == "Lagrange" and space.degree == 1:
        return grid.ny + 1, grid.nx + 1
    raise UnsupportedFieldError(
        f"halo decomposition supports P1/DG0 fields, got {space.element.family} degree {space.degree}"
    )


class _SlabStencil:
    """One shard's share of a uniform scalar-P1 term: the kernel's
    arguments for the slab's ``(nx, m)`` sub-lattice."""

    def __init__(self, field: str, grid: Grid, mats: torch.Tensor, masks: torch.Tensor):
        self.field, self.grid, self.mats, self.masks = field, grid, mats, masks
        self.packed = pack_matrices(grid, mats)
        self.nv = grid.num_vertices  # (m + 1) * (nx + 1)


class HaloOperator:
    """Slab-decomposed masked operator over a 1D shard mesh.

    The matvec acts as the reduced operator A_red (identity on inactive /
    BC / padded DoFs) on *padded* sharded DoF vectors ``{field: [slab of
    shard p]}`` (see :meth:`pad`)."""

    def __init__(self, op: Operator, grid: Grid, mesh: ShardMesh, bcs=()):
        self.op, self.grid, self.mesh, self.bcs = op, grid, mesh, tuple(bcs)
        nP = mesh.size
        self.nP = nP
        devs = mesh.devices

        # field row-major layouts: name -> (rows, width, value_shape)
        self.layout: Dict[str, Tuple[int, int, Tuple[int, ...]]] = {}
        rmax = 0
        for name, s in op.system.fields.items():
            rows, width = _field_rows_width(s, grid)
            self.layout[name] = (rows, width, tuple(s.value_shape))
            rmax = max(rmax, rows)
        self.m = m = -(-rmax // nP)  # rows per shard

        # ---- classify batches, compute the halo width from the entity tables
        stencil_raw, generic_raw = [], []
        H = 1
        for b in op.batches:
            if isinstance(b, StencilCellBatch):
                stencil_raw.append(b)
                continue
            rows_segs = [dofs.cpu().numpy() // self.layout[name][1] for name, dofs, vs in b.segments]
            r0 = np.min([r.min(axis=1) for r in rows_segs], axis=0)
            span = max(int((r.max(axis=1) - r0).max()) for r in rows_segs)
            H = max(H, span)
            generic_raw.append((b, r0))
        if H > m:
            raise UnsupportedFieldError(f"halo width {H} exceeds slab height {m} (grid too small for {nP} shards)")
        self.H = H

        # ---- stencil terms: each shard's rows of the padded orientation masks
        # and a slab grid of m cell rows (the kernel reads its nx, ny, type)
        self._stencils: List[List[_SlabStencil]] = [[] for _ in range(nP)]
        for b in stencil_raw:
            bmasks = b.masks_or_ones()
            no, ny, nx = bmasks.shape
            mpad = np.zeros((no, nP * m, nx), bmasks.dtype)
            mpad[:, :ny] = bmasks
            for p in range(nP):
                g = Grid(nx, m, grid.bbox, grid.cell_type, device=devs[p], dtype=grid.dtype)
                masks = torch.as_tensor(np.ascontiguousarray(mpad[:, p * m : (p + 1) * m]), dtype=grid.dtype,
                                        device=devs[p])
                self._stencils[p].append(_SlabStencil(b.field, g, b.matrices, masks))

        # ---- generic batches: host-partitioned per-shard entity tables, DoFs
        # local to the shard's extended slab (m + H rows)
        self._batches: List[List[Batch]] = [[] for _ in range(nP)]
        for b, r0 in generic_raw:
            dev = np.clip(r0 // m, 0, nP - 1)
            for p in range(nP):
                idx = np.where(dev == p)[0]
                if len(idx) == 0:
                    continue
                segs = []
                for name, dofs, vs in b.segments:
                    width = self.layout[name][1]
                    d = dofs.cpu().numpy()[idx].astype(np.int64) - p * m * width
                    assert d.min() >= 0 and d.max() < (m + H) * width, "entity DoF outside its owner's slab+halo"
                    segs.append((name, torch.as_tensor(d, device=devs[p]), vs))
                ti = torch.as_tensor(idx, device=b.matrices.device)
                if b.orient is not None:
                    self._batches[p].append(Batch(segs, b.matrices.to(devs[p]), orient=b.orient[ti].to(devs[p])))
                else:
                    self._batches[p].append(Batch(segs, b.matrices[ti].to(devs[p])))

        # ---- masked-operator data: diagonal / active (padded + sharded)
        diag = op.diagonal()
        active = {k: d != 0.0 for k, d in diag.items()}
        for bc in bcs:
            active[bc.field] = active[bc.field] & ~torch.broadcast_to(bc.mask, active[bc.field].shape)
        self.active_global = active
        self.active = {k: self.pad_field(k, v, fill=False) for k, v in active.items()}
        diag_p = {k: self.pad_field(k, v) for k, v in diag.items()}
        self.diag = {k: [torch.where(a, d, torch.ones_like(d)) for d, a in zip(diag_p[k], self.active[k])]
                     for k in diag_p}
        self.matvecs = 0  # halo matvecs applied

    # ------------------------------------------------------------ pad/unpad
    def pad_field(self, name: str, v: torch.Tensor, fill=0) -> List[torch.Tensor]:
        """``(rows * width, *vs)`` -> the shards' slabs ``(m * width, *vs)``
        (rows past the field's end filled with ``fill``)."""
        rows, width, _ = self.layout[name]
        m = self.m
        x = v.reshape((rows, width) + tuple(v.shape[1:]))
        x = torch.cat([x, torch.full((self.nP * m - rows, width) + tuple(v.shape[1:]), fill, dtype=v.dtype,
                                     device=v.device)])
        return [x[p * m : (p + 1) * m].reshape((m * width,) + tuple(v.shape[1:])).to(d, copy=True)
                for p, d in enumerate(self.mesh.devices)]

    def pad(self, x: Dict[str, torch.Tensor]) -> Dict[str, List[torch.Tensor]]:
        return {k: self.pad_field(k, v) for k, v in x.items()}

    def unpad(self, x: Dict[str, List[torch.Tensor]], device=None) -> Dict[str, torch.Tensor]:
        """The shards' slabs as whole fields on ``device`` (default: the
        first shard's)."""
        device = self.mesh.devices[0] if device is None else device
        out = {}
        for k, parts in x.items():
            rows, width, _ = self.layout[k]
            v = torch.cat([t.to(device) for t in parts])
            out[k] = v.reshape((self.nP * self.m, width) + tuple(v.shape[1:]))[:rows].reshape(
                (rows * width,) + tuple(v.shape[1:]))
        return out

    # ------------------------------------------------------------- matvec
    def _local(self, p: int, ext: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Shard p's contributions on its extended slab ``(m + H, width,
        *vs)``."""
        y = {f: torch.zeros_like(v) for f, v in ext.items()}
        flat_x = {f: v.reshape((-1,) + tuple(v.shape[2:])) for f, v in ext.items()}
        flat_y = {f: v.reshape((-1,) + tuple(v.shape[2:])) for f, v in y.items()}
        for st in self._stencils[p]:
            # the first m + 1 rows of the extended slab: its (nx, m) sub-lattice
            stencil_matvec(st.grid, flat_x[st.field][: st.nv], st.masks, st.mats, y=flat_y[st.field][: st.nv],
                           packed=st.packed)
        for b in self._batches[p]:
            b.matvec_into(flat_x, flat_y)
        return y

    def _halo_matvec(self, x: Dict[str, List[torch.Tensor]]) -> Dict[str, List[torch.Tensor]]:
        m, H, nP = self.m, self.H, self.nP
        pull = [(i, i - 1) for i in range(1, nP)]  # receive from the next shard
        push = [(i, i + 1) for i in range(nP - 1)]  # hand halo rows on
        ext: List[Dict[str, torch.Tensor]] = [{} for _ in range(nP)]
        for f, parts in x.items():
            _, width, vs = self.layout[f]
            xl = [t.reshape((m, width) + vs) for t in parts]
            halo = ppermute([t[:H] for t in xl], pull)
            for p in range(nP):
                ext[p][f] = torch.cat([xl[p], halo[p]])  # (m + H, width, *vs)
        ys = [self._local(p, ext[p]) for p in range(nP)]
        out = {}
        for f in x:
            _, width, vs = self.layout[f]
            recv = ppermute([y[f][m : m + H] for y in ys], push)
            parts = []
            for p in range(nP):
                yl = ys[p][f][:m]
                yl[:H] += recv[p]
                parts.append(yl.reshape((m * width,) + vs))
            out[f] = parts
        return out

    def matvec(self, x: Dict[str, List[torch.Tensor]]) -> Dict[str, List[torch.Tensor]]:
        """Masked matvec on padded sharded DoF vectors (identity on
        inactive / BC / padded DoFs)."""
        act = self.active
        xa = {f: [torch.where(a, t, 0.0) for t, a in zip(parts, act[f])] for f, parts in x.items()}
        y = self._halo_matvec(xa)
        self.matvecs += 1
        return {f: [torch.where(a, yt, xt) for yt, xt, a in zip(y[f], x[f], act[f])] for f in x}


def halo_solve(
    op: Operator,
    grid: Grid,
    b: Dict[str, torch.Tensor],
    mesh: ShardMesh,
    bcs=(),
    method: str = "bicgstab",
    tol: float = 1e-10,
    atol: float = 0.0,
    maxiter: Optional[int] = None,
    stats: Optional[dict] = None,
):
    """Distributed Krylov solve via the halo-exchange matvec on the
    symmetrically diagonally equilibrated system (the port's ``_pcg`` /
    ``_pbicgstab``, no preconditioner, the dots summed over the shards by
    :func:`~phifem_tpu_torch.parallel.sharding.psum`'s ordered reduction).

    Returns ``(x, relres)`` with ``x`` in the standard (unpadded) layout on
    the first shard's device.  ``stats``: a dict that receives
    ``iterations``, ``matvecs``, ``path`` and ``bytes_moved`` (between
    shards, over the whole solve)."""
    moved0 = sharding.bytes_moved
    Hop = HaloOperator(op, grid, mesh, bcs)
    b = lift_rhs(op, b, bcs, Hop.active_global)
    bp = Hop.pad(b)  # padded rows carry b = 0 and active = False -> stay 0
    names, nP = list(bp), Hop.nP

    dsqrt = {k: [torch.sqrt(torch.where(torch.abs(d) > 1e-30, torch.abs(d), 1.0)) for d in parts]
             for k, parts in Hop.diag.items()}
    dinv = _flat({k: [1.0 / d for d in parts] for k, parts in dsqrt.items()})

    def matvec_eq(y):
        z = _flat(Hop.matvec(_nested({k: v * dinv[k] for k, v in y.items()}, names, nP)))
        return {k: v * dinv[k] for k, v in z.items()}

    def dot(u, v):
        return pdot(u, v, _shard_key)

    beq = {k: v * dinv[k] for k, v in _flat(bp).items()}
    if maxiter is None:
        maxiter = 25 * int(math.isqrt(op.system.num_dofs)) + 1000
    y, rel, it = _krylov(matvec_eq, beq, None, None, None, dot, method, tol, atol, maxiter)
    x = {k: v * dinv[k] for k, v in y.items()}
    if stats is not None:
        stats.update(iterations=it, matvecs=Hop.matvecs, path="halo", halo_rows=Hop.H, slab_rows=Hop.m,
                     bytes_moved=sharding.bytes_moved - moved0)
    return Hop.unpad(_nested(x, names, nP)), rel
