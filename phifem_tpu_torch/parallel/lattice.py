"""Distributed lattice multigrid: the box-Poisson MG-CG over row slabs of a
shard mesh.

Counterpart of :mod:`phifem_tpu.parallel.lattice`.  Row-slab decomposition
of the 2D vertex lattice (:mod:`phifem_tpu_torch.ops.lattice`): shard ``p``
owns ``m`` logical rows; every stencil / transfer application exchanges ONE
halo row per neighbour (:func:`~phifem_tpu_torch.parallel.sharding.
ppermute`), and the CG dots are summed over the shards in shard order.
Levels coarsen locally: slab boundaries sit at even logical rows, so coarse
row ``i`` (fine row ``2i``) stays on its shard and restriction /
prolongation never need more than the same 1-row halo.  When a level's slab
height would drop below ``replicate_rows``, the rest of the hierarchy is
agglomerated: the slabs are gathered on the first shard, the port's
:class:`~phifem_tpu_torch.ops.lattice.LatticeMG` (or the dense coarse
inverse) runs there once, and each shard receives its rows back.  (JAX
gathers on every device and runs the tail redundantly; the result is the
same.)

The slab arithmetic is plain PyTorch, as the port's single-device 2D
lattice cycle; the CG dots are float64 where JAX rounds them to float32.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops.lattice import LatticeMG, _dense_coarse_inv, _terms, build_lattice_mg
from ..solvers import _pcg
from . import sharding
from .sharding import ShardMesh, all_gather, pdot, ppermute

__all__ = ["ShardedLatticeMG", "build_sharded_lattice_mg", "sharded_lattice_solve"]


def _exchange_rows(xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """(m, ...) local blocks -> (m+2, ...) with the neighbours' ghost rows
    (or planes; zeros at the global ends)."""
    n = len(xs)
    top = ppermute([x[-1:] for x in xs], [(i, i + 1) for i in range(n - 1)])
    bot = ppermute([x[:1] for x in xs], [(i + 1, i) for i in range(n - 1)])
    return [torch.cat([t, x, b]) for t, x, b in zip(top, xs, bot)]


@dataclasses.dataclass(frozen=True)
class _SLevel:
    R: int  # global logical rows (ny + 1)
    C: int  # global logical cols (nx + 1)
    m: int  # logical rows per shard (R <= nP * m, m even unless tail)


@dataclasses.dataclass
class ShardedLatticeMG:
    """Distributed V-cycle + CG over row slabs.  Local block layout per
    level: (m, C+2), logical col ``c`` at index ``c+1``; shard ``p`` owns
    logical rows ``[p*m, (p+1)*m)`` (rows >= R are dead)."""

    levels: List[_SLevel]
    terms: List[Tuple[int, int, float]]
    tail: Optional[LatticeMG]  # agglomerated coarse hierarchy (or None)
    coarse_inv: Optional[torch.Tensor]  # dense inverse when the tail IS the bottom
    mesh: ShardMesh
    dtype: torch.dtype = torch.float32
    omega: float = 0.8
    pre_smooth: int = 2
    post_smooth: int = 2

    def __post_init__(self):
        self.nP = self.mesh.size
        self._dinv = 1.0 / next(wt for a, b, wt in self.terms if a == 1 and b == 1)
        # per level and shard: (m, 1) interior-row masks
        self._valid = []
        for lvl in self.levels:
            per = []
            for p, dev in enumerate(self.mesh.devices):
                gr = p * lvl.m + torch.arange(lvl.m, device=dev).reshape(-1, 1)
                per.append((gr >= 1) & (gr <= lvl.R - 2))
            self._valid.append(per)

    # ---- every function below maps the list of the shards' local blocks
    def _conv(self, xs, k: int):
        """Reduced operator on the local blocks: (m, C+2) -> (m, C+2)."""
        lvl = self.levels[k]
        C = lvl.C
        out = []
        for p, e in enumerate(_exchange_rows(xs)):
            acc = None
            for a, b, wt in self.terms:
                part = wt * e[a : a + lvl.m, b : b + C]
                acc = part if acc is None else acc + part
            o = torch.zeros_like(xs[p])
            o[:, 2:C] = acc[:, 1 : C - 1]
            out.append(torch.where(self._valid[k][p], o, 0.0))
        return out

    def _smooth(self, xs, bbs, k: int, sweeps: int):
        od = self.omega * self._dinv
        for _ in range(sweeps):
            ax = self._conv(xs, k)
            xs = [x + od * (bb - a) for x, bb, a in zip(xs, bbs, ax)]
        return xs

    def _restrict(self, rs, k: int):
        lvl, nxt = self.levels[k], self.levels[k + 1]
        Cc = nxt.C
        out = []
        for p, e in enumerate(_exchange_rows(rs)):
            acc = None
            for s, ws in ((-1, 0.5), (0, 1.0), (1, 0.5)):
                rows = e[1 + s :: 2][: nxt.m]
                for t, wt in ((-1, 0.5), (0, 1.0), (1, 0.5)):
                    part = (ws * wt) * rows[:, 1 + t :: 2][:, :Cc]
                    acc = part if acc is None else acc + part
            bc = torch.zeros((nxt.m, Cc + 2), dtype=e.dtype, device=e.device)
            bc[:, 1 : 1 + Cc] = acc
            # zero logical borders / dead rows on the coarse level
            bc[:, 1] = 0.0
            bc[:, Cc] = 0.0
            out.append(torch.where(self._valid[k + 1][p], bc, 0.0))
        return out

    def _prolong(self, ecs, k: int):
        """Coarse local (m_c, Cc+2) -> fine local correction (m_f, C+2)."""
        lvl, nxt = self.levels[k], self.levels[k + 1]
        Cc, C = nxt.C, lvl.C
        out = []
        for p, e in enumerate(_exchange_rows(ecs)):
            E = e[:, 1 : 1 + Cc]  # (m_c+2, Cc) logical cols
            Hc = 0.5 * (E[:, :-1] + E[:, 1:])
            body = torch.stack([E[:, : Cc - 1], Hc], dim=2).reshape(E.shape[0], -1)
            W = torch.cat([body, E[:, Cc - 1 :]], dim=1)  # (m_c+2, C)
            A = W[1 : 1 + nxt.m]  # own coarse rows
            B = 0.5 * (A + W[2 : 2 + nxt.m])  # average with the next row (ghost-aware)
            F = torch.stack([A, B], dim=1).reshape(lvl.m, C)
            o = torch.zeros((lvl.m, C + 2), dtype=e.dtype, device=e.device)
            o[:, 1 : 1 + C] = F
            o[:, 1] = 0.0
            o[:, C] = 0.0
            out.append(torch.where(self._valid[k][p], o, 0.0))
        return out

    def _tail_solve(self, bbs, k: int):
        """Agglomerated coarse solve: gather the slabs on the first shard,
        run the tail hierarchy (or the dense inverse) there once, hand each
        shard its rows."""
        lvl = self.levels[k]
        allb = all_gather(bbs)[0]  # (nP, m, C+2) on shard 0
        full = allb.reshape(self.nP * lvl.m, lvl.C + 2)
        bp = torch.zeros((lvl.R + 2, lvl.C + 2), dtype=full.dtype, device=full.device)
        bp[1 : 1 + lvl.R] = full[: lvl.R]
        if self.tail is not None:
            xp = self.tail._cycle(0, bp)
        else:
            v = self.coarse_inv.to(bp.dtype) @ bp[2 : lvl.R, 2 : lvl.C].reshape(-1)
            xp = torch.zeros_like(bp)
            xp[2 : lvl.R, 2 : lvl.C] = v.reshape(lvl.R - 2, lvl.C - 2)
        xfull = torch.zeros((self.nP * lvl.m, lvl.C + 2), dtype=bp.dtype, device=bp.device)
        xfull[: lvl.R] = xp[1 : 1 + lvl.R]
        blocks = list(xfull.reshape(self.nP, lvl.m, lvl.C + 2))
        return _scatter_rows(blocks, bbs)

    def _cycle(self, k: int, bbs):
        if k == len(self.levels) - 1:
            return self._tail_solve(bbs, k)
        xs = self._smooth([torch.zeros_like(b) for b in bbs], bbs, k, self.pre_smooth)
        ax = self._conv(xs, k)
        rs = [bb - a for bb, a in zip(bbs, ax)]
        bcs = self._restrict(rs, k)
        ecs = self._cycle(k + 1, bcs)
        xs = [x + c for x, c in zip(xs, self._prolong(ecs, k))]
        return self._smooth(xs, bbs, k, self.post_smooth)

    def precond(self, rs):
        """One V-cycle in ``dtype`` on the shards' blocks, cast back."""
        return [z.to(r.dtype) for z, r in zip(self._cycle(0, [r.to(self.dtype) for r in rs]), rs)]

    def cg(self, bbs, tol: float = 1e-10, maxiter: int = 40):
        """The distributed MG-CG on the shards' local blocks; see
        :func:`_mg_cg`."""
        return _mg_cg(self, bbs, tol, maxiter)


def _mg_cg(mg, bbs, tol: float, maxiter: int):
    """MG-preconditioned CG over the shards' local blocks ``bbs`` (the
    port's ``_pcg`` on the ||b||-normalized system, the float64 dots summed
    over the shards, ``mg._conv`` the operator and ``mg.precond`` the
    V-cycle).  Returns ``(xs, relres, iters)`` with ``xs`` the local
    solution blocks."""
    dot = lambda a, b: pdot(a, b, lambda p: p)
    keyed = lambda xs: dict(enumerate(xs))
    listed = lambda d: [d[p] for p in range(mg.nP)]
    bb = keyed(bbs)
    bscale = torch.clamp(torch.sqrt(dot(bb, bb)), min=torch.finfo(bbs[0].dtype).tiny)
    bn = {p: v / bscale.to(v.device) for p, v in bb.items()}
    x0 = {p: torch.zeros_like(v) for p, v in bn.items()}
    x, it, rel = _pcg(lambda v: keyed(mg._conv(listed(v), 0)), bn, x0, tol=tol, atol=0.0, maxiter=maxiter,
                      M=lambda v: keyed(mg.precond(listed(v))), dot=dot)
    return [x[p] * bscale.to(x[p].device) for p in range(mg.nP)], rel, it


def _scatter_rows(blocks: List[torch.Tensor], like: List[torch.Tensor]) -> List[torch.Tensor]:
    """Shard 0's row blocks sent to their shards (one copy each)."""
    out = [blocks[0]]
    for p in range(1, len(blocks)):
        sharding._count(blocks[p], 0, p)
        out.append(blocks[p].to(like[p].device, copy=True))
    return out


def build_sharded_lattice_mg(
    nx: int,
    ny: int,
    w: np.ndarray,
    mesh: ShardMesh,
    min_n: int = 16,
    replicate_rows: int = 32,
    dtype: torch.dtype = torch.float32,
    **kw,
) -> ShardedLatticeMG:
    """Plan the distributed hierarchy for an ``nx x ny`` lattice over
    ``mesh``.  Distributed levels keep even slab heights; the rest becomes
    the agglomerated tail (on the first shard's device)."""
    nP = mesh.size
    R0 = ny + 1
    grids = [(nx, ny)]
    gx, gy = nx, ny
    while gx % 2 == 0 and gy % 2 == 0 and gx // 2 >= min_n and gy // 2 >= min_n:
        gx //= 2
        gy //= 2
        grids.append((gx, gy))
    n_dist = 1
    for k in range(1, len(grids)):
        m_would = -(-(grids[k][1] + 1) // nP)
        if m_would < replicate_rows:
            break
        n_dist = k + 1
    # slab heights: m_0 a multiple of 2^(n_dist-1) so every distributed
    # level's m is even
    align = 2 ** (n_dist - 1)
    m0 = -(-R0 // nP)
    m0 = -(-m0 // align) * align
    levels = [_SLevel(grids[k][1] + 1, grids[k][0] + 1, m0 // (2**k)) for k in range(n_dist)]
    terms = _terms(np.asarray(w))
    tail = coarse_inv = None
    dev0 = mesh.devices[0]
    if n_dist < len(grids):
        gx, gy = grids[n_dist - 1]
        # the tail's finest level == the last distributed level; its own
        # _cycle smooths, recurses and solves the dense bottom
        tail = build_lattice_mg(gx, gy, w, min_n=min_n, dtype=dtype, device=dev0)
    else:
        inv = _dense_coarse_inv(terms, grids[-1][1] + 1, grids[-1][0] + 1)
        coarse_inv = torch.as_tensor(inv, dtype=dtype, device=dev0)
    return ShardedLatticeMG(levels, terms, tail, coarse_inv, mesh, dtype=dtype, **kw)


def sharded_lattice_solve(
    mg: ShardedLatticeMG,
    mesh: ShardMesh,
    b2d: torch.Tensor,
    tol: float = 1e-10,
    maxiter: int = 40,
    stats: Optional[dict] = None,
):
    """Distributed solve of the reduced lattice system.

    ``b2d``: global (R, C) logical RHS (reduced: borders zero).  Returns
    ``(u2d (R, C), relres, iters)`` with ``u2d`` on ``b2d``'s device.  The
    RHS is padded to ``nP * m`` rows and split into the shards' slabs.
    ``stats``: a dict that receives ``bytes_moved``."""
    moved0 = sharding.bytes_moved
    lvl = mg.levels[0]
    R, C = lvl.R, lvl.C
    total = mg.nP * lvl.m
    # the reduced system carries identity rows on the logical border; a
    # nonzero border RHS entry would leave an irreducible residual
    b2d = b2d.clone()
    b2d[0, :] = 0.0
    b2d[-1, :] = 0.0
    b2d[:, 0] = 0.0
    b2d[:, -1] = 0.0
    bp = torch.zeros((total, C + 2), dtype=b2d.dtype, device=b2d.device)
    bp[:R, 1 : 1 + C] = b2d
    bbs = [bp[p * lvl.m : (p + 1) * lvl.m].to(d, copy=True) for p, d in enumerate(mesh.devices)]
    xs, rel, it = mg.cg(bbs, tol=tol, maxiter=maxiter)
    x = torch.cat([v.to(b2d.device) for v in xs])
    if stats is not None:
        stats.update(bytes_moved=sharding.bytes_moved - moved0)
    return x[:R, 1 : 1 + C], rel, it
