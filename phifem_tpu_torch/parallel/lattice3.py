"""Distributed 3D lattice multigrid: z-plane slabs over a shard mesh.

Counterpart of :mod:`phifem_tpu.parallel.lattice3` for
:mod:`phifem_tpu_torch.ops.lattice3`: shard ``p`` owns ``m`` logical
z-planes of the ``(D, R, C)`` vertex lattice; every 27-point stencil /
transfer application exchanges ONE halo plane per neighbour
(:func:`~phifem_tpu_torch.parallel.sharding.ppermute`), and the CG dots are
summed over the shards in shard order (float64 where JAX rounds them to
float32).  Coarsening keeps slab edges at even logical planes; when a
level's slab height would drop below ``replicate_planes`` the rest of the
hierarchy is agglomerated on the first shard (the port's
:class:`~phifem_tpu_torch.ops.lattice3.Lattice3MG`, run once; JAX runs it
redundantly on every device).  Levels carry their own stencils.

Each slab's 27-point stencil is the 3D lattice sweep kernel
(:func:`~phifem_tpu_torch.ops.cuda_lattice3.lattice3_sweep`, ``MATVEC``
mode; its plain version on the CPU).  The kernel writes only
``out[2:D', 2:R, 2:C]`` of a ``(D'+2, R+2, C+2)`` array, so the slab goes to
it as ``(m+4, R+2, C+2)``: one zero plane, the ghost plane below, the ``m``
own planes, the ghost plane above, one zero plane.  Then ``D' = m + 2`` and
the kernel computes exactly the ``m`` own planes.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from ..ops.cuda_lattice3 import MATVEC, lattice3_sweep, pack_terms
from ..ops.lattice3 import Lattice3MG, _dense_coarse_inv3, _terms3, build_lattice3_mg, hex_element_matrix, \
    vertex_stencil_weights3
from . import sharding
from .lattice import _exchange_rows, _mg_cg, _scatter_rows
from .sharding import ShardMesh, all_gather, ppermute

__all__ = ["ShardedLattice3MG", "build_sharded_lattice3_mg", "sharded_lattice3_solve"]


@dataclasses.dataclass(frozen=True)
class _SLevel3:
    D: int  # global logical z-planes (nz + 1)
    R: int
    C: int
    m: int  # planes per shard
    terms: Tuple[Tuple[int, int, int, float], ...]


@dataclasses.dataclass
class ShardedLattice3MG:
    """Distributed V-cycle + CG over z-plane slabs.  Local layout per
    level: (m, R+2, C+2); logical (r, c) at (+1, +1); shard ``p`` owns
    logical planes ``[p*m, (p+1)*m)`` (planes >= D are dead)."""

    levels: List[_SLevel3]
    tail: Optional[Lattice3MG]
    coarse_inv: Optional[torch.Tensor]
    mesh: ShardMesh
    dtype: torch.dtype = torch.float32
    omega: float = 0.8
    pre_smooth: int = 2
    post_smooth: int = 2

    def __post_init__(self):
        self.nP = self.mesh.size
        self._packed = [pack_terms(lvl.terms) for lvl in self.levels]  # the kernel's form, per level
        self._valid = []  # per level and shard: (m, 1, 1) interior-plane masks
        for lvl in self.levels:
            per = []
            for p, dev in enumerate(self.mesh.devices):
                gz = p * lvl.m + torch.arange(lvl.m, device=dev).reshape(-1, 1, 1)
                per.append((gz >= 1) & (gz <= lvl.D - 2))
            self._valid.append(per)

    def _dinv(self, k: int) -> float:
        return 1.0 / next(wt for a, b, c, wt in self.levels[k].terms if (a, b, c) == (1, 1, 1))

    def _conv(self, xs, k: int):
        """The 27-point stencil on each slab, by the sweep kernel on the slab
        framed as ``(m+4, R+2, C+2)``."""
        lvl = self.levels[k]
        n, m = len(xs), lvl.m
        top = ppermute([x[-1:] for x in xs], [(i, i + 1) for i in range(n - 1)])
        bot = ppermute([x[:1] for x in xs], [(i + 1, i) for i in range(n - 1)])
        out = []
        for p, x in enumerate(xs):
            slab = torch.zeros((m + 4,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
            slab[1:2] = top[p]
            slab[2 : m + 2] = x
            slab[m + 2 : m + 3] = bot[p]
            y = lattice3_sweep(MATVEC, slab, self._packed[k])[2 : m + 2]
            out.append(torch.where(self._valid[k][p], y, 0.0))
        return out

    def _smooth(self, xs, bbs, k: int, sweeps: int):
        od = self.omega * self._dinv(k)
        for _ in range(sweeps):
            ax = self._conv(xs, k)
            xs = [x + od * (bb - a) for x, bb, a in zip(xs, bbs, ax)]
        return xs

    def _restrict(self, rs, k: int):
        nxt = self.levels[k + 1]
        Rc, Cc = nxt.R, nxt.C
        wts = ((-1, 0.5), (0, 1.0), (1, 0.5))
        out = []
        for p, e in enumerate(_exchange_rows(rs)):
            acc = None
            for s, ws in wts:
                planes = e[1 + s :: 2][: nxt.m]
                for t, wt in wts:
                    rows = planes[:, 1 + t :: 2][:, :Rc]
                    for u, wu in wts:
                        part = (ws * wt * wu) * rows[:, :, 1 + u :: 2][:, :, :Cc]
                        acc = part if acc is None else acc + part
            bc = torch.zeros((nxt.m, Rc + 2, Cc + 2), dtype=e.dtype, device=e.device)
            bc[:, 1 : 1 + Rc, 1 : 1 + Cc] = acc
            bc[:, 1] = 0.0
            bc[:, Rc] = 0.0
            bc[:, :, 1] = 0.0
            bc[:, :, Cc] = 0.0
            out.append(torch.where(self._valid[k + 1][p], bc, 0.0))
        return out

    def _prolong(self, ecs, k: int):
        lvl, nxt = self.levels[k], self.levels[k + 1]
        Rc, Cc = nxt.R, nxt.C
        R, C = lvl.R, lvl.C
        out = []
        for p, e in enumerate(_exchange_rows(ecs)):
            E = e[:, 1 : 1 + Rc, 1 : 1 + Cc]  # (m_c+2, Rc, Cc), with the z ghosts
            # x then y interpolation (local), then z through the ghost planes
            Hx = 0.5 * (E[:, :, :-1] + E[:, :, 1:])
            body = torch.stack([E[:, :, : Cc - 1], Hx], dim=3).reshape(E.shape[0], Rc, -1)
            W = torch.cat([body, E[:, :, Cc - 1 :]], dim=2)  # (.., Rc, C)
            Hy = 0.5 * (W[:, :-1] + W[:, 1:])
            body = torch.stack([W[:, : Rc - 1], Hy], dim=2).reshape(E.shape[0], -1, C)
            V = torch.cat([body, W[:, Rc - 1 :]], dim=1)  # (.., R, C)
            A = V[1 : 1 + nxt.m]
            B = 0.5 * (A + V[2 : 2 + nxt.m])
            F = torch.stack([A, B], dim=1).reshape(lvl.m, R, C)
            o = torch.zeros((lvl.m, R + 2, C + 2), dtype=e.dtype, device=e.device)
            o[:, 1 : 1 + R, 1 : 1 + C] = F
            o[:, 1] = 0.0
            o[:, R] = 0.0
            o[:, :, 1] = 0.0
            o[:, :, C] = 0.0
            out.append(torch.where(self._valid[k][p], o, 0.0))
        return out

    def _tail_solve(self, bbs, k: int):
        lvl = self.levels[k]
        allb = all_gather(bbs)[0]  # (nP, m, R+2, C+2) on shard 0
        full = allb.reshape(self.nP * lvl.m, lvl.R + 2, lvl.C + 2)
        bp = torch.zeros((lvl.D + 2, lvl.R + 2, lvl.C + 2), dtype=full.dtype, device=full.device)
        bp[1 : 1 + lvl.D] = full[: lvl.D]
        if self.tail is not None:
            xp = self.tail._cycle(0, bp)
        else:
            v = self.coarse_inv.to(bp.dtype) @ bp[2 : lvl.D, 2 : lvl.R, 2 : lvl.C].reshape(-1)
            xp = torch.zeros_like(bp)
            xp[2 : lvl.D, 2 : lvl.R, 2 : lvl.C] = v.reshape(lvl.D - 2, lvl.R - 2, lvl.C - 2)
        xfull = torch.zeros((self.nP * lvl.m, lvl.R + 2, lvl.C + 2), dtype=bp.dtype, device=bp.device)
        xfull[: lvl.D] = xp[1 : 1 + lvl.D]
        return _scatter_rows(list(xfull.reshape(self.nP, lvl.m, lvl.R + 2, lvl.C + 2)), bbs)

    def _cycle(self, k: int, bbs):
        if k == len(self.levels) - 1:
            return self._tail_solve(bbs, k)
        xs = self._smooth([torch.zeros_like(b) for b in bbs], bbs, k, self.pre_smooth)
        ax = self._conv(xs, k)
        rs = [bb - a for bb, a in zip(bbs, ax)]
        ecs = self._cycle(k + 1, self._restrict(rs, k))
        xs = [x + c for x, c in zip(xs, self._prolong(ecs, k))]
        return self._smooth(xs, bbs, k, self.post_smooth)

    def precond(self, rs):
        """One V-cycle in ``dtype`` on the shards' blocks, cast back."""
        return [z.to(r.dtype) for z, r in zip(self._cycle(0, [r.to(self.dtype) for r in rs]), rs)]

    def cg(self, bbs, tol: float = 1e-10, maxiter: int = 40):
        """The distributed MG-CG on the shards' local blocks; see
        :func:`~phifem_tpu_torch.parallel.lattice._mg_cg`."""
        return _mg_cg(self, bbs, tol, maxiter)


def build_sharded_lattice3_mg(
    nx: int,
    ny: int,
    nz: int,
    spacing: Tuple[float, float, float],
    mesh: ShardMesh,
    stiffness: float = 1.0,
    mass: float = 0.0,
    min_n: int = 8,
    replicate_planes: int = 8,
    dtype: torch.dtype = torch.float32,
    **kw,
) -> ShardedLattice3MG:
    """Plan the distributed 3D hierarchy over ``mesh``: z-plane slabs with
    even slab heights on distributed levels, the agglomerated tail below
    ``replicate_planes`` (on the first shard's device)."""
    nP = mesh.size
    hx, hy, hz = spacing
    grids = [(nx, ny, nz)]
    gx, gy, gz = nx, ny, nz
    while gx % 2 == 0 and gy % 2 == 0 and gz % 2 == 0 and min(gx, gy, gz) // 2 >= min_n:
        gx, gy, gz = gx // 2, gy // 2, gz // 2
        grids.append((gx, gy, gz))
    n_dist = 1
    for k in range(1, len(grids)):
        m_would = -(-(grids[k][2] + 1) // nP)
        if m_would < replicate_planes:
            break
        n_dist = k + 1
    align = 2 ** (n_dist - 1)
    m0 = -(-(nz + 1) // nP)
    m0 = -(-m0 // align) * align

    def terms_at(k):
        A8 = hex_element_matrix(hx * 2**k, hy * 2**k, hz * 2**k, stiffness=stiffness, mass=mass)
        return tuple(_terms3(vertex_stencil_weights3(A8)))

    levels = [
        _SLevel3(grids[k][2] + 1, grids[k][1] + 1, grids[k][0] + 1, m0 // (2**k), terms_at(k))
        for k in range(n_dist)
    ]
    tail = coarse_inv = None
    dev0 = mesh.devices[0]
    if n_dist < len(grids):
        gx, gy, gz = grids[n_dist - 1]
        sc = 2 ** (n_dist - 1)
        tail = build_lattice3_mg(gx, gy, gz, (hx * sc, hy * sc, hz * sc), stiffness=stiffness, mass=mass,
                                 min_n=min_n, dtype=dtype, device=dev0)
    else:
        lvl = levels[-1]
        coarse_inv = torch.as_tensor(_dense_coarse_inv3(lvl.terms, lvl.D, lvl.R, lvl.C), dtype=dtype, device=dev0)
    return ShardedLattice3MG(levels, tail, coarse_inv, mesh, dtype=dtype, **kw)


def sharded_lattice3_solve(
    mg: ShardedLattice3MG,
    mesh: ShardMesh,
    b3d: torch.Tensor,
    tol: float = 1e-10,
    maxiter: int = 40,
    stats: Optional[dict] = None,
):
    """Distributed solve of the reduced 3D lattice system.  ``b3d``: global
    (D, R, C) logical RHS.  Returns ``(u3d, relres, iters)`` with ``u3d`` on
    ``b3d``'s device; ``stats`` receives ``bytes_moved``."""
    moved0 = sharding.bytes_moved
    lvl = mg.levels[0]
    D, R, C = lvl.D, lvl.R, lvl.C
    total = mg.nP * lvl.m
    b3d = b3d.clone()
    b3d[0] = 0.0
    b3d[-1] = 0.0
    b3d[:, 0] = 0.0
    b3d[:, -1] = 0.0
    b3d[:, :, 0] = 0.0
    b3d[:, :, -1] = 0.0
    bp = torch.zeros((total, R + 2, C + 2), dtype=b3d.dtype, device=b3d.device)
    bp[:D, 1 : 1 + R, 1 : 1 + C] = b3d
    bbs = [bp[p * lvl.m : (p + 1) * lvl.m].to(d, copy=True) for p, d in enumerate(mesh.devices)]
    xs, rel, it = mg.cg(bbs, tol=tol, maxiter=maxiter)
    x = torch.cat([v.to(b3d.device) for v in xs])
    if stats is not None:
        stats.update(bytes_moved=sharding.bytes_moved - moved0)
    return x[:D, 1 : 1 + R, 1 : 1 + C], rel, it
