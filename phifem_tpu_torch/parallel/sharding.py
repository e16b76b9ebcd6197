"""Domain-decomposed execution of assembly/solve over a shard mesh.

Counterpart of :mod:`phifem_tpu.parallel.sharding`.  The JAX package runs
one program over a ``jax.sharding.Mesh`` (``shard_map``, XLA collectives).
The port runs one Python process over a :class:`ShardMesh`: an ordered list
of torch devices in which a device may appear several times.  Shard ``p``'s
slab of every sharded vector is a tensor on ``mesh.devices[p]``; the
collectives are plain functions on the list of per-shard tensors:

* :func:`ppermute`: copies between shards by ``(source, target)`` pairs; a
  shard that receives nothing gets zeros, as ``lax.ppermute``;
* :func:`psum`: the shards' values summed in shard order on the first
  shard's device, the sum copied to every shard: the same bits on every
  run, whatever the devices;
* :func:`all_gather` and :func:`all_to_all`.

A copy between two different devices is a peer copy; between two shards of
one device it is a copy on that device.  ``bytes_moved`` counts the bytes
the collectives move between shards (the halo traffic, the ghost exchange,
the dots' partial sums).

:func:`sharded_solve` prefers the row-slab halo decomposition
(:func:`~phifem_tpu_torch.parallel.halo.halo_solve`).  For systems it does
not cover (degree >= 2 fields) JAX lets GSPMD partition the masked
operator; the port applies the masked operator to the whole vector on the
first shard's device and splits the result into the mesh's row blocks, and
the Jacobi-preconditioned CG / BiCGStab recurrence runs on those blocks.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..assembly import Operator
from ..solvers import _pbicgstab, _pcg, lift_rhs, masked_operator, tree_axpy

AXIS = "shard"

__all__ = [
    "AXIS",
    "ShardMesh",
    "make_mesh",
    "ppermute",
    "psum",
    "all_gather",
    "all_to_all",
    "shard_vector",
    "sharded_matvec_fn",
    "sharded_solve",
]

#: bytes the collectives moved between shards (copies from a shard to itself
#: are not counted)
bytes_moved = 0


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """A 1D mesh of shards over the axis :data:`AXIS`: shard ``p`` lives on
    ``devices[p]``.  A device may hold several shards."""

    devices: Tuple[torch.device, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return {AXIS: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> ShardMesh:
    """1D shard mesh.  ``devices`` (names or ``torch.device``; one device
    may repeat, e.g. ``["cuda:0"] * 4`` or ``["cpu"] * 3``) gives one shard
    per entry.  Without it the mesh is one shard per CUDA card, the first
    ``n_devices`` cards when given; asking for more cards than the host has
    raises: the mesh never shrinks below what was asked for."""
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = have if n_devices is None else int(n_devices)
        if n < 1 or n > have:
            raise RuntimeError(f"make_mesh: asked for {n_devices if n_devices is not None else 'every'} CUDA "
                               f"card(s), the host has {have}; pass devices=[...] to place several shards "
                               "on one device")
        devices = [f"cuda:{i}" for i in range(n)]
    elif n_devices is not None and int(n_devices) != len(devices):
        raise ValueError(f"make_mesh: n_devices={n_devices} but {len(devices)} devices given")
    devs = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda":
            if d.index is None:
                d = torch.device("cuda", 0)
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if d.index >= have:
                raise RuntimeError(f"make_mesh: {d} asked for, the host has {have} CUDA card(s)")
        devs.append(d)
    if not devs:
        raise ValueError("make_mesh: no devices")
    return ShardMesh(tuple(devs))


def _count(src: torch.Tensor, src_shard: int, dst_shard: int) -> None:
    global bytes_moved
    if src_shard != dst_shard:
        bytes_moved += src.numel() * src.element_size()


def _copy_to(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` on ``like``'s device (a peer copy across devices)."""
    return torch.empty_like(t, device=like.device).copy_(t)


def ppermute(parts: List[torch.Tensor], perm: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """``out[j] = parts[i]`` for each ``(i, j)`` in ``perm`` (copied to
    shard j's device); a shard that receives nothing gets zeros shaped like
    its own part."""
    out = [torch.zeros_like(p) for p in parts]
    for i, j in perm:
        out[j] = _copy_to(parts[i], parts[j])
        _count(parts[i], i, j)
    return out


def _reduce(parts: List[torch.Tensor]) -> torch.Tensor:
    """The shards' parts summed in shard order on shard 0's device."""
    acc = parts[0]
    for i in range(1, len(parts)):
        _count(parts[i], i, 0)
        acc = acc + parts[i].to(acc.device)
    return acc


def psum(parts: List[torch.Tensor]) -> List[torch.Tensor]:
    """The sum of the shards' parts, accumulated in shard order on shard 0's
    device, then copied to every shard."""
    acc = _reduce(parts)
    out = [acc]
    for j in range(1, len(parts)):
        out.append(_copy_to(acc, parts[j]))
        _count(acc, 0, j)
    return out


def all_gather(parts: List[torch.Tensor]) -> List[torch.Tensor]:
    """Every shard's part stacked along a new leading axis, on every shard."""
    out = []
    for j in range(len(parts)):
        for i, p in enumerate(parts):
            _count(p, i, j)
        out.append(torch.stack([p.to(parts[j].device) for p in parts]))
    return out


def all_to_all(parts: List[torch.Tensor]) -> List[torch.Tensor]:
    """``parts[p]`` of shape ``(nP, ...)``: block ``q`` goes to shard q.
    Returns ``out[q]`` with ``out[q][p] = parts[p][q]`` (``lax.all_to_all``
    with split and concat axis 0)."""
    n = len(parts)
    out = []
    for q in range(n):
        for p in range(n):
            _count(parts[p][q], p, q)
        out.append(torch.stack([parts[p][q].to(parts[q].device) for p in range(n)]))
    return out


def pdot(a: Dict, b: Dict, shard_of) -> torch.Tensor:
    """Dot product of two sharded vectors ``{key: part}``: each shard's
    partial sum, then the reduction of :func:`psum` in shard order.  The
    Krylov recurrences keep their scalars in one place, so the sum is not
    copied back to the shards: it lies on shard 0's device when every shard
    shares it, and on the host otherwise (a CPU scalar combines with tensors
    on any card).  ``shard_of`` maps a key to its shard."""
    n = max(shard_of(k) for k in a) + 1
    partial: List[Optional[torch.Tensor]] = [None] * n
    for k in a:
        d = torch.dot(a[k].reshape(-1), b[k].reshape(-1))
        p = shard_of(k)
        partial[p] = d if partial[p] is None else partial[p] + d
    s = _reduce(partial)
    if any(p.device != s.device for p in partial):
        s = s.cpu()
    return s


def _deflation(defl, active, dsqrt, dot):
    """``(proj, ortho)``: the masked, equilibrated, Gram-Schmidt
    orthonormalized deflation basis and its projector ``v - sum (o.v) o``."""
    ortho = []
    for v in defl:
        q = {k: torch.where(active[k], v[k].to(dsqrt[k]), 0.0) * dsqrt[k] for k in v}
        for o in ortho:
            q = tree_axpy(-dot(o, q), o, q)
        nrm = torch.clamp(torch.sqrt(dot(q, q)), min=1e-300)
        ortho.append({k: t / nrm.to(t.device) for k, t in q.items()})

    def proj(v):
        for o in ortho:
            v = tree_axpy(-dot(o, v), o, v)
        return v

    return proj, ortho


def _krylov(mv_eq, beq, defl, active, dsqrt, dot, method, tol, atol, maxiter):
    """The Krylov solve of an equilibrated system ``mv_eq y = beq`` (the
    port's ``_pcg`` / ``_pbicgstab`` with ``dot``), deflated by the null
    vectors ``defl`` (masked by ``active``, scaled by ``dsqrt``) when given,
    as :func:`phifem_tpu.parallel.uop.element_sharded_solve`'s ``run``.
    Returns ``(y, relres, iterations)``, relres that of the (deflated)
    equilibrated system."""
    M = lambda r: r
    mv = mv_eq
    proj = None
    if defl:
        proj, ortho = _deflation(defl, active, dsqrt, dot)

        def mv(y):
            z = proj(mv_eq(proj(y)))
            for o in ortho:
                z = tree_axpy(dot(o, y), o, z)
            return z

        M = proj
        beq = proj(beq)
    runner = {"cg": _pcg, "bicgstab": _pbicgstab}[method]
    x0 = {k: torch.zeros_like(v) for k, v in beq.items()}
    x, it, _ = runner(mv, beq, x0, tol=tol, atol=atol, maxiter=maxiter, M=M, dot=dot)
    Ax = mv(x)
    r = {k: beq[k] - Ax[k] for k in beq}
    rel = float(torch.sqrt(dot(r, r))) / max(float(torch.sqrt(dot(beq, beq))), 1e-300)
    if proj is not None:
        x = proj(x)
    return x, rel, it


def _pad_to(v: torch.Tensor, n: int) -> torch.Tensor:
    """Zero-pad the leading axis to a multiple of n (so the DoF axis always
    genuinely shards)."""
    r = (-v.shape[0]) % n
    if r == 0:
        return v
    return torch.cat([v, v.new_zeros((r,) + tuple(v.shape[1:]))])


def shard_vector(x: Dict[str, torch.Tensor], mesh: ShardMesh) -> Dict[str, List[torch.Tensor]]:
    """Split each field's leading (scalar-DoF) axis, zero-padded to a
    multiple of the shard count, into the mesh's row blocks: ``{field:
    [block on shard p]}``."""
    n = mesh.size
    out = {}
    for k, v in x.items():
        vp = _pad_to(v, n)
        m = vp.shape[0] // n
        out[k] = [vp[p * m : (p + 1) * m].to(mesh.devices[p], copy=True) for p in range(n)]
    return out


def _gather_vector(x: Dict[str, List[torch.Tensor]], shapes: Dict[str, torch.Size], device) -> Dict[str, torch.Tensor]:
    """The blocks of :func:`shard_vector` back as whole fields on ``device``."""
    return {k: torch.cat([b.to(device) for b in x[k]])[: shapes[k][0]] for k in x}


def sharded_matvec_fn(op: Operator, mesh: ShardMesh, bcs=()):
    """The masked operator on sharded vectors (``{field: [row block]}``):
    the blocks are gathered on the first shard's device, the masked operator
    is applied there, and the result is split into the mesh's row blocks.
    Returns ``(matvec, diag, active)`` (``diag`` and ``active`` whole, on
    the operator's device)."""
    matvec, diag, active = masked_operator(op, bcs)
    shapes = {k: v.shape for k, v in diag.items()}
    dev0 = mesh.devices[0]

    def mv(x: Dict[str, List[torch.Tensor]]) -> Dict[str, List[torch.Tensor]]:
        for k in x:
            for p, blk in enumerate(x[k]):
                _count(blk, p, 0)
        y = matvec(_gather_vector(x, shapes, dev0))
        out = shard_vector(y, mesh)
        for k in out:
            for p, blk in enumerate(out[k]):
                _count(blk, 0, p)
        return out

    return mv, diag, active


def _flat(x: Dict[str, List[torch.Tensor]]) -> Dict[Tuple[str, int], torch.Tensor]:
    """``{field: [part of shard p]}`` -> ``{(field, p): part}``: the layout
    the Krylov recurrences of :mod:`phifem_tpu_torch.solvers` take."""
    return {(k, p): t for k, parts in x.items() for p, t in enumerate(parts)}


def _nested(x: Dict[Tuple[str, int], torch.Tensor], names, n: int) -> Dict[str, List[torch.Tensor]]:
    """The inverse of :func:`_flat` for the fields ``names`` on n shards."""
    return {k: [x[k, p] for p in range(n)] for k in names}


def _shard_key(k) -> int:
    return k[1]


def sharded_solve(
    op: Operator,
    b: Dict[str, torch.Tensor],
    mesh: ShardMesh,
    bcs=(),
    method: str = "bicgstab",
    tol: float = 1e-10,
    maxiter: int = 1000,
    grid=None,
    stats: Optional[dict] = None,
):
    """Sharded Krylov solve over the mesh; returns ``(x, relres)``.

    Prefers the row-slab halo-exchange decomposition (:mod:`.halo`).  For a
    system it does not cover (degree >= 2 fields) the masked operator is
    applied on the first shard's device and split into row blocks, and
    Jacobi-preconditioned CG / BiCGStab runs on the blocks with the dots
    summed by :func:`psum` (the relative residual is that of the lifted,
    unscaled system, as in JAX).  ``stats``: a dict that receives
    ``iterations``, ``path`` and ``bytes_moved``."""
    from .halo import UnsupportedFieldError, halo_solve

    if grid is None:
        grid = next(iter(op.system.fields.values())).grid
    try:
        return halo_solve(op, grid, b, mesh, bcs=bcs, method=method, tol=tol, maxiter=maxiter, stats=stats)
    except UnsupportedFieldError:
        pass

    global bytes_moved
    moved0 = bytes_moved
    mv, diag, active = sharded_matvec_fn(op, mesh, bcs)
    b = lift_rhs(op, b, bcs, active)
    shapes = {k: v.shape for k, v in b.items()}
    names = list(b)
    inv_diag = _flat(shard_vector({k: 1.0 / d for k, d in diag.items()}, mesh))
    runner = {"cg": _pcg, "bicgstab": _pbicgstab}[method]

    def A(x):
        return _flat(mv(_nested(x, names, mesh.size)))

    def M(x):
        return {k: v * inv_diag[k] for k, v in x.items()}

    def dot(u, v):
        return pdot(u, v, _shard_key)

    bf = _flat(shard_vector(b, mesh))
    x0 = {k: torch.zeros_like(v) for k, v in bf.items()}
    x, it, _ = runner(A, bf, x0, tol=tol, atol=0.0, maxiter=maxiter, M=M, dot=dot)
    Ax = A(x)
    r = {k: bf[k] - Ax[k] for k in bf}
    rel = float(torch.sqrt(dot(r, r))) / max(float(torch.sqrt(dot(bf, bf))), 1e-300)
    if stats is not None:
        stats.update(iterations=it, path="whole-vector", bytes_moved=bytes_moved - moved0)
    return _gather_vector(_nested(x, names, mesh.size), shapes, mesh.devices[0]), rel
