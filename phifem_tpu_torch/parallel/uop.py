"""Element- and DoF-distributed execution for unstructured (imported)
meshes.

Counterpart of :mod:`phifem_tpu.parallel.uop`.  Two decompositions over a
shard mesh for the unstructured backend (:mod:`phifem_tpu_torch.
uassembly`):

* :class:`ElementShardedOperator`: every entity batch's ELEMENT axis is cut
  into the shards' contiguous blocks; DoF vectors are whole (one copy per
  shard's device).  Each shard scatters its elements' contributions into a
  shard-local accumulator and one :func:`~phifem_tpu_torch.parallel.
  sharding.psum` (shard order) reduces them: the MPI ghost-update analogue.
  The Krylov recurrence runs once on the first shard's device (JAX runs it
  replicated on every device; the replicas are identical).
* :class:`PartitionedUOperator`: each shard owns a contiguous block of every
  field's scalar DoFs; elements belong to the owner of their first DoF;
  ghost values cross shards through ONE :func:`~phifem_tpu_torch.parallel.
  sharding.all_to_all` per matvec and their contributions go back through
  one reverse exchange.  Per-shard vector memory is ~1/n_shards, and the
  Krylov recurrence runs on the owner blocks with the dots summed over the
  shards.

The local element work is the port's entity batch (gather -> batched
matmul -> ordered scatter, :class:`~phifem_tpu_torch.assembly.Batch`); the
ghost return's scatter-add is ordered too.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..assembly import Batch, Operator
from ..ops.scatter import scatter_plan
from ..solvers import lift_rhs, tree_dot
from . import sharding
from .sharding import ShardMesh, _flat, _krylov, _nested, _shard_key, all_to_all, pdot

__all__ = [
    "ElementShardedOperator",
    "element_sharded_solve",
    "PartitionedUOperator",
    "partitioned_solve",
]


def _active_diag(op: Operator, bcs):
    diag = op.diagonal()
    active = {k: d != 0.0 for k, d in diag.items()}
    for bc in bcs:
        active[bc.field] = active[bc.field] & ~torch.broadcast_to(bc.mask, active[bc.field].shape)
    return diag, active


def _shard_batch(b: Batch, idx: np.ndarray, dofs_of, device, mats_of) -> Batch:
    """The entities ``idx`` of batch ``b`` as a Batch on ``device``, DoFs
    mapped by ``dofs_of(field, global dofs)``."""
    segs = [(f, torch.as_tensor(dofs_of(f, d.cpu().numpy()[idx]), device=device), vs) for f, d, vs in b.segments]
    if b.orient is not None:
        ti = torch.as_tensor(idx, device=b.orient.device)
        return Batch(segs, b.matrices.to(device), orient=b.orient[ti].to(device))
    return Batch(segs, mats_of(b, idx, device))


def _entity_mats(b: Batch, idx: np.ndarray, device) -> torch.Tensor:
    return b.matrices[torch.as_tensor(idx, device=b.matrices.device)].to(device)


def _refresh(op: Operator, ent, batches, devices) -> None:
    """The rebuilt per-entity matrices of ``op``'s batches into the shards'
    batches (entity ids ``ent[batch][shard]``); uniform batches are
    constants."""
    for i, b in enumerate(op.batches):
        if b.orient is not None:
            continue
        for p, dev in enumerate(devices):
            if batches[p][i] is not None:
                batches[p][i].matrices = _entity_mats(b, ent[i][p], dev)


class ElementShardedOperator:
    """Entity batches split over the shards; whole DoF vectors.

    The matvec acts as the reduced operator (identity on inactive / BC
    DoFs) like :func:`phifem_tpu_torch.solvers.masked_operator`.  After
    ``op.reassemble()`` call :meth:`refresh` to re-split the rebuilt
    data-dependent element matrices (geometry-uniform batches are
    constants and never change)."""

    def __init__(self, op: Operator, mesh: ShardMesh, bcs=()):
        self.op, self.mesh, self.bcs = op, mesh, tuple(bcs)
        nP = self.nP = mesh.size
        # per batch: each shard's contiguous block of entities (ceil(ne / nP))
        self._ent: List[List[np.ndarray]] = []
        self._batches: List[List[Optional[Batch]]] = [[] for _ in range(nP)]
        for b in op.batches:
            ne = b.num_entities
            ne_p = max(1, -(-ne // nP))
            blocks = [np.arange(p * ne_p, min((p + 1) * ne_p, ne)) for p in range(nP)]
            self._ent.append(blocks)
            for p in range(nP):
                self._batches[p].append(
                    _shard_batch(b, blocks[p], lambda f, d: d, mesh.devices[p], _entity_mats)
                    if len(blocks[p]) else None)
        diag, active = _active_diag(op, bcs)
        self.active = active
        self.diag = {k: torch.where(active[k], d, torch.ones_like(d)) for k, d in diag.items()}
        self.matvecs = 0

    def refresh(self) -> None:
        """Re-split element matrices after ``op.reassemble()``: rebuilt
        per-element matrices go to their shards; DoF tables and
        orientations are topology and never move."""
        _refresh(self.op, self._ent, self._batches, self.mesh.devices)

    def matvec(self, x: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Masked distributed matvec on whole DoF vectors; the result lies
        on ``x``'s device."""
        xa = {k: torch.where(self.active[k], v, 0.0) for k, v in x.items()}
        parts = []
        for p, dev in enumerate(self.mesh.devices):
            xp = {k: v.to(dev) for k, v in xa.items()}
            if p:
                for v in xa.values():
                    sharding._count(v, 0, p)
            yp = {k: torch.zeros_like(v) for k, v in xp.items()}
            for b in self._batches[p]:
                if b is not None:
                    b.matvec_into(xp, yp)
            parts.append(yp)
        y = {k: sharding._reduce([yp[k] for yp in parts]) for k in x}  # psum's ordered reduction
        self.matvecs += 1
        return {k: torch.where(self.active[k], y[k], x[k]) for k in y}


def element_sharded_solve(
    op: Operator,
    b: Dict[str, torch.Tensor],
    mesh: ShardMesh,
    bcs=(),
    method: str = "bicgstab",
    tol: float = 1e-10,
    atol: float = 0.0,
    maxiter: Optional[int] = None,
    deflate: Optional[Tuple[Dict[str, torch.Tensor], ...]] = None,
    stats: Optional[dict] = None,
):
    """Distributed Krylov solve on an imported (unstructured) mesh: the
    element work distributes over the shards, the Krylov recurrence runs on
    the whole vectors, and the matvec's psum is the only cross-shard
    reduction per product.  ``deflate`` carries known null-space modes
    (e.g. S5's rigid modes) exactly like :func:`phifem_tpu_torch.solvers.
    solve`.  Returns ``(x, relres, iterations)``; ``stats`` receives
    ``iterations``, ``matvecs`` and ``bytes_moved``."""
    moved0 = sharding.bytes_moved
    E = ElementShardedOperator(op, mesh, bcs)
    b = lift_rhs(op, b, bcs, E.active)
    dsqrt = {k: torch.sqrt(torch.where(torch.abs(d) > 1e-30, torch.abs(d), 1.0)) for k, d in E.diag.items()}
    dinv = {k: 1.0 / d for k, d in dsqrt.items()}

    def mv_eq(y):
        z = E.matvec({k: v * dinv[k] for k, v in y.items()})
        return {k: v * dinv[k] for k, v in z.items()}

    if maxiter is None:
        maxiter = 25 * int(math.isqrt(op.system.num_dofs)) + 1000
    beq = {k: v * dinv[k] for k, v in b.items()}
    y, rel, it = _krylov(mv_eq, beq, deflate, E.active, dsqrt, tree_dot, method, tol, atol, maxiter)
    if stats is not None:
        stats.update(iterations=it, matvecs=E.matvecs, bytes_moved=sharding.bytes_moved - moved0)
    return {k: v * dinv[k] for k, v in y.items()}, rel, it


class PartitionedUOperator:
    """Element- AND DoF-partitioned unstructured operator.

    Host preprocessing (once): per-field block ownership, per-shard element
    lists, global -> shard-local DoF maps, and the pairwise send / receive
    index maps of the ghost exchange.  The matvec: gather ghosts
    (:func:`all_to_all`), per-element gather -> batched matmul -> ordered
    scatter into the local accumulator, ghost contributions back to their
    owners (reverse :func:`all_to_all`) and added in a fixed order.

    Local index space per field on each shard: ``[0, chunk)`` owned (global
    ``g - p*chunk``), then the shard's ghosts, then ONE dummy slot absorbing
    the padded exchange slots."""

    def __init__(self, op: Operator, mesh: ShardMesh, bcs=()):
        self.op, self.mesh, self.bcs = op, mesh, tuple(bcs)
        nP = self.nP = mesh.size
        devs = mesh.devices
        names = self.names = list(op.system.fields)

        # ---- ownership
        self.chunk: Dict[str, int] = {}
        self.vshape: Dict[str, Tuple[int, ...]] = {}
        for f in names:
            sp = op.system.fields[f]
            self.chunk[f] = -(-sp.num_scalar_dofs // nP)
            self.vshape[f] = tuple(sp.dof_shape[1:])

        def owner_of(f, g):
            return np.minimum(g // self.chunk[f], nP - 1)

        # ---- element partition (owner of the first DoF of the first segment)
        host = [[(f, d.cpu().numpy(), vs) for f, d, vs in b.segments] for b in op.batches]
        ent_dev = [owner_of(segs[0][0], segs[0][1].reshape(segs[0][1].shape[0], -1)[:, 0]) for segs in host]

        # ---- per-shard ghost discovery
        ghosts = {f: [set() for _ in range(nP)] for f in names}
        for segs, dev in zip(host, ent_dev):
            for f, dn, _ in segs:
                dn = dn.reshape(dn.shape[0], -1)
                own = owner_of(f, dn)
                for p in range(nP):
                    rows = dev == p
                    if rows.any():
                        ghosts[f][p].update(dn[rows][own[rows] != p].tolist())
        ghost_list = {f: [np.array(sorted(s), np.int64) for s in ghosts[f]] for f in names}
        self.nghost = {f: max(1, max(len(g) for g in ghost_list[f])) for f in names}

        def local_of(f, p, g):
            """Local slot of global DoFs ``g`` on shard p (own / ghost / dummy)."""
            ch = self.chunk[f]
            gl = ghost_list[f][p]
            res = np.full(g.shape, self._dummy(f), np.int64)
            own = owner_of(f, g) == p
            res[own] = g[own] - p * ch
            if len(gl):
                pos = np.clip(np.searchsorted(gl, g), 0, len(gl) - 1)
                hit = (~own) & (gl[pos] == g)
                res[hit] = ch + pos[hit]
            return res

        # ---- exchange maps, for the shard pair (p owner <- q requester):
        # recv_slot[q][p] = local slots on q of the DoFs owned by p,
        # send_idx[p][q] = own indices on p of those same DoFs
        S = {f: 1 for f in names}
        per_pair = {f: [[None] * nP for _ in range(nP)] for f in names}
        for f in names:
            for q in range(nP):
                gl = ghost_list[f][q]
                own = owner_of(f, gl) if len(gl) else np.zeros(0, np.int64)
                for p in range(nP):
                    sel = gl[own == p] if len(gl) else np.zeros(0, np.int64)
                    per_pair[f][q][p] = sel
                    S[f] = max(S[f], len(sel))
        self.S = S
        self.send_idx, self.recv_slot = {}, {}
        self._return_plan = {}  # per field and owner shard: the ordered scatter of the ghost return
        for f in names:
            ch = self.chunk[f]
            si = np.zeros((nP, nP, S[f]), np.int64)
            rs = np.full((nP, nP, S[f]), self._dummy(f), np.int64)
            va = np.zeros((nP, nP, S[f]), bool)
            for q in range(nP):
                gl = ghost_list[f][q]
                for p in range(nP):
                    sel = per_pair[f][q][p]
                    k = len(sel)
                    if k:
                        si[p, q, :k] = sel - p * ch
                        rs[q, p, :k] = ch + np.searchsorted(gl, sel)
                        va[p, q, :k] = True  # send-side layout (shard p, peer q)
            self.send_idx[f] = [torch.as_tensor(si[p], device=devs[p]) for p in range(nP)]
            self.recv_slot[f] = [torch.as_tensor(rs[q], device=devs[q]) for q in range(nP)]
            plans = []
            for p in range(nP):
                sel = np.where(va[p].reshape(-1))[0]  # the valid slots of p's returns, in (peer, slot) order
                targets = torch.as_tensor(si[p].reshape(-1)[sel], device=devs[p])
                plans.append((torch.as_tensor(sel, device=devs[p]),) + scatter_plan(targets))
            self._return_plan[f] = plans

        # ---- per-shard element tables, remapped to local DoF slots
        self._ent: List[List[np.ndarray]] = []  # per batch: each shard's entity ids
        self._batches: List[List[Optional[Batch]]] = [[] for _ in range(nP)]
        for b, dev in zip(op.batches, ent_dev):
            order = np.argsort(dev, kind="stable")
            per = [order[dev[order] == p] for p in range(nP)]
            self._ent.append(per)
            for p in range(nP):
                self._batches[p].append(
                    _shard_batch(b, per[p], lambda f, g, p=p: local_of(f, p, g), devs[p], _entity_mats)
                    if len(per[p]) else None)

        # ---- masked-operator data, partitioned
        diag, active = _active_diag(op, bcs)
        self.active_rep = active
        self.diag_rep = {k: torch.where(active[k], d, torch.ones_like(d)) for k, d in diag.items()}
        self.active = {f: self.partition_field(f, active[f]) for f in names}
        self.diag = {f: self.partition_field(f, self.diag_rep[f]) for f in names}
        self.matvecs = 0

    def _dummy(self, f: str) -> int:
        return self.chunk[f] + self.nghost[f]

    # ------------------------------------------------------- partition I/O
    def partition_field(self, f: str, v: torch.Tensor) -> List[torch.Tensor]:
        """``(N, *vs)`` -> the shards' owner blocks ``(chunk, *vs)`` (zero
        padded)."""
        ch, nP = self.chunk[f], self.nP
        pad = torch.zeros((nP * ch,) + tuple(v.shape[1:]), dtype=v.dtype, device=v.device)
        pad[: v.shape[0]] = v
        return [pad[p * ch : (p + 1) * ch].to(d, copy=True) for p, d in enumerate(self.mesh.devices)]

    def partition(self, x: Dict[str, torch.Tensor]) -> Dict[str, List[torch.Tensor]]:
        return {f: self.partition_field(f, x[f]) for f in self.names}

    def unpartition(self, x: Dict[str, List[torch.Tensor]], device=None) -> Dict[str, torch.Tensor]:
        """The owner blocks as whole fields on ``device`` (default: the first
        shard's)."""
        device = self.mesh.devices[0] if device is None else device
        return {f: torch.cat([t.to(device) for t in x[f]])[: self.op.system.fields[f].num_scalar_dofs]
                for f in self.names}

    def refresh(self) -> None:
        """Re-split data-dependent element matrices after
        ``op.reassemble()`` (topology and maps never move)."""
        _refresh(self.op, self._ent, self._batches, self.mesh.devices)

    # ------------------------------------------------------------- matvec
    def _exchange_ghosts(self, f: str, x_own: List[torch.Tensor]) -> List[torch.Tensor]:
        """Owner blocks ``(chunk, *vs)`` -> local vectors ``(chunk + G + 1,
        *vs)`` with the ghosts filled in."""
        bufs = [x[si] for x, si in zip(x_own, self.send_idx[f])]  # (nP, S, *vs): what p sends to each q
        recv = all_to_all(bufs)
        L = self._dummy(f) + 1
        out = []
        for q, x in enumerate(x_own):
            loc = x.new_zeros((L,) + tuple(x.shape[1:]))
            loc[: self.chunk[f]] = x
            # the padded slots all land on the dummy slot, which no element reads
            loc[self.recv_slot[f][q].reshape(-1)] = recv[q].reshape((-1,) + tuple(x.shape[1:]))
            out.append(loc)
        return out

    def _return_ghosts(self, f: str, y_loc: List[torch.Tensor], y_own: List[torch.Tensor]) -> None:
        """Ghost-slot accumulations back to their owners, added in place in a
        fixed order."""
        contrib = [y[rs] for y, rs in zip(y_loc, self.recv_slot[f])]  # (nP, S, *vs) on each q
        back = all_to_all(contrib)  # back[p][q] = what q accumulated for p
        for p, yo in enumerate(y_own):
            sel, uniq, pos = self._return_plan[f][p]
            vals = back[p].reshape((-1,) + tuple(yo.shape[1:]))[sel]
            vals = torch.cat([vals, vals.new_zeros((1,) + tuple(vals.shape[1:]))])  # row len(sel): padding
            yo.index_add_(0, uniq, vals[pos].sum(dim=1))

    def matvec(self, x: Dict[str, List[torch.Tensor]]) -> Dict[str, List[torch.Tensor]]:
        """Masked distributed matvec on PARTITIONED vectors (``{field:
        [owner block of shard p]}``)."""
        names, nP = self.names, self.nP
        x_own = {f: [torch.where(a, t, 0.0) for t, a in zip(x[f], self.active[f])] for f in names}
        x_loc = {f: self._exchange_ghosts(f, x_own[f]) for f in names}
        y_loc = {f: [torch.zeros_like(t) for t in x_loc[f]] for f in names}
        for p in range(nP):
            xp = {f: x_loc[f][p] for f in names}
            yp = {f: y_loc[f][p] for f in names}
            for b in self._batches[p]:
                if b is not None:
                    b.matvec_into(xp, yp)
        out = {}
        for f in names:
            y_own = [t[: self.chunk[f]].clone() for t in y_loc[f]]
            self._return_ghosts(f, y_loc[f], y_own)
            out[f] = [torch.where(a, yo, xt) for yo, xt, a in zip(y_own, x[f], self.active[f])]
        self.matvecs += 1
        return out


def partitioned_solve(
    op: Operator,
    b: Dict[str, torch.Tensor],
    mesh: ShardMesh,
    bcs=(),
    method: str = "bicgstab",
    tol: float = 1e-10,
    atol: float = 0.0,
    maxiter: Optional[int] = None,
    deflate: Optional[Tuple[Dict[str, torch.Tensor], ...]] = None,
    stats: Optional[dict] = None,
):
    """Distributed Krylov solve with PARTITIONED DoF vectors: every Krylov
    vector is a list of owner blocks, the matvec's ghost traffic is two
    :func:`all_to_all` exchanges, and the dots are summed over the shards in
    shard order (float64 where JAX rounds them to float32).  Returns ``(x,
    relres, iterations)`` with ``x`` whole on the first shard's device;
    ``stats`` receives ``iterations``, ``matvecs`` and ``bytes_moved``."""
    moved0 = sharding.bytes_moved
    E = PartitionedUOperator(op, mesh, bcs)
    names, nP = E.names, E.nP
    b = lift_rhs(op, b, bcs, E.active_rep)
    b_p = _flat(E.partition(b))
    defl = tuple(_flat(E.partition(v)) for v in (deflate or ()))
    if maxiter is None:
        maxiter = 25 * int(math.isqrt(op.system.num_dofs)) + 1000

    def dot(u, v):
        return pdot(u, v, _shard_key)

    active = _flat(E.active)
    dsqrt = {k: torch.sqrt(torch.where(torch.abs(d) > 1e-30, torch.abs(d), 1.0)) for k, d in _flat(E.diag).items()}
    dinv = {k: 1.0 / d for k, d in dsqrt.items()}

    def mv_eq(y):
        z = _flat(E.matvec(_nested({k: v * dinv[k] for k, v in y.items()}, names, nP)))
        return {k: v * dinv[k] for k, v in z.items()}

    beq = {k: v * dinv[k] for k, v in b_p.items()}
    y, rel, it = _krylov(mv_eq, beq, defl, active, dsqrt, dot, method, tol, atol, maxiter)
    if stats is not None:
        stats.update(iterations=it, matvecs=E.matvecs, bytes_moved=sharding.bytes_moved - moved0)
    return E.unpartition(_nested({k: v * dinv[k] for k, v in y.items()}, names, nP)), rel, it
