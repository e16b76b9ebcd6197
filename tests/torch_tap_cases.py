"""Synthetic tap operators for the tap-matvec tests: every block pair of a
(u: P1, y: vector P1, p: DG0) system at every offset in [-2, 2]^2, with
random weights, and a direct numpy evaluation of the tap sum.  No JAX."""

import numpy as np
import torch

import phifem_tpu_torch as pt
from phifem_tpu_torch.assembly import System
from phifem_tpu_torch.ops.taps import TapOperator, _field_specs


def random_tap_operator(nx, ny, cell_type, dtype, device, seed=0, fields="uyp"):
    """A :class:`TapOperator` over the chosen fields of the mixed system,
    with a tap for every (target, source, dr, dc), random W, and a random
    x: ``(top, x)``."""
    g = pt.Grid(nx, ny, ((-1.0, -1.0), (1.0, 1.0)), cell_type, device=device, dtype=dtype)
    spaces = {"u": pt.Space.lagrange(g, 1), "y": pt.Space.lagrange(g, 1, (2,)), "p": pt.Space.dg0(g)}
    system = System({f: spaces[f] for f in fields})
    specs = _field_specs(system, g)
    shapes, ch = [], []
    for sp in specs:
        shapes += [sp.shape] * sp.nblocks
        ch += [sp.vsz] * sp.nblocks
    nb = len(shapes)
    taps = [(bi, bj, dr, dc) for bi in range(nb) for bj in range(nb) for dr in range(-2, 3) for dc in range(-2, 3)]
    sizes = [shapes[bi][0] * shapes[bi][1] * ch[bi] * ch[bj] for bi, bj, _, _ in taps]
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    rng = np.random.default_rng(seed)
    W = torch.as_tensor(rng.standard_normal(int(offsets[-1])), dtype=dtype, device=device)
    top = TapOperator(g, specs, taps, offsets, shapes, ch, 2, W, None, [], [])
    x = {n: torch.as_tensor(rng.standard_normal(s.dof_shape), dtype=dtype, device=device)
         for n, s in system.fields.items()}
    return top, x


def direct_tap_sum(top, x):
    """``y[bi][r, c, ki] = sum_t sum_kj W_t[r, c, ki, kj] x[bj][r+dr, c+dc, kj]``
    by explicit index arithmetic in numpy (zero outside the source)."""
    blocks = [b.cpu().double().numpy() for b in top._decompose(x)]
    W = top.W.cpu().double().numpy()
    ys = [np.zeros(top.blk_shapes[i] + (top.blk_ch[i],)) for i in range(len(blocks))]
    for t, (bi, bj, dr, dc) in enumerate(top.taps):
        Ri, Ci = top.blk_shapes[bi]
        Rj, Cj = top.blk_shapes[bj]
        w = W[top.tap_offsets[t] : top.tap_offsets[t + 1]].reshape(Ri, Ci, top.blk_ch[bi], top.blk_ch[bj])
        r = np.arange(Ri)[:, None] + dr
        c = np.arange(Ci)[None, :] + dc
        ok = (r >= 0) & (r < Rj) & (c >= 0) & (c < Cj)
        src = blocks[bj][np.clip(r, 0, Rj - 1), np.clip(c, 0, Cj - 1)] * ok[..., None]
        ys[bi] += np.einsum("rcij,rcj->rci", w, src)
    return {k: v.cpu().numpy() for k, v in top._recompose([torch.as_tensor(y) for y in ys]).items()}
