"""Synthetic tap operators for the tap-matvec tests: every block pair of a
(u: P1, y: vector P1, p: DG0, t: tensor P1 of 4 channels) system at every
offset in [-2, 2]^2, with random weights, and a direct numpy evaluation of
the tap sum.  No JAX."""

import numpy as np
import torch

import phifem_tpu_torch as pt
from phifem_tpu_torch.assembly import System
from phifem_tpu_torch.ops.taps import TapOperator, _field_specs


def random_tap_operator(nx, ny, cell_type, dtype, device, seed=0, fields="uyp", chans=None):
    """A :class:`TapOperator` over the chosen fields of the mixed system,
    with a tap for every (target, source, dr, dc) (only the pairs of
    (target, source) channel counts in ``chans`` where given), random W,
    and a random x: ``(top, x)``."""
    g = pt.Grid(nx, ny, ((-1.0, -1.0), (1.0, 1.0)), cell_type, device=device, dtype=dtype)
    spaces = {"u": pt.Space.lagrange(g, 1), "y": pt.Space.lagrange(g, 1, (2,)), "p": pt.Space.dg0(g),
              "t": pt.Space.lagrange(g, 1, (2, 2))}
    system = System({f: spaces[f] for f in fields})
    specs = _field_specs(system, g)
    shapes, ch = [], []
    for sp in specs:
        shapes += [sp.shape] * sp.nblocks
        ch += [sp.vsz] * sp.nblocks
    nb = len(shapes)
    taps = [(bi, bj, dr, dc) for bi in range(nb) for bj in range(nb) for dr in range(-2, 3) for dc in range(-2, 3)
            if chans is None or (ch[bi], ch[bj]) in chans]
    sizes = [shapes[bi][0] * shapes[bi][1] * ch[bi] * ch[bj] for bi, bj, _, _ in taps]
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    rng = np.random.default_rng(seed)
    W = torch.as_tensor(rng.standard_normal(int(offsets[-1])), dtype=dtype, device=device)
    top = TapOperator(g, specs, taps, offsets, shapes, ch, 2, W, None, [], [])
    x = {n: torch.as_tensor(rng.standard_normal(s.dof_shape), dtype=dtype, device=device)
         for n, s in system.fields.items()}
    return top, x


#: block pairs at 4 channels: (case id, fields, (target, source) channels)
FOUR_CHANNEL_PAIRS = [("4x4", "t", {(4, 4)}), ("4x2", "ty", {(4, 2)}), ("2x4", "ty", {(2, 4)}),
                      ("mixed", "uytp", None)]


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


def sparse_tap_operator(nx, ny, cell_type, dtype, device, seed=0):
    """Like :func:`random_tap_operator`, but the last block lattice is the
    target of no tap, and each tap plane's weights may be nonzero only on a
    thin diagonal band in the upper half of its rows (``top.support``), so
    the tile table has empty tiles and whole empty rows of tiles; a fifth of
    the supported weights are zero too.  ``(top, x)``."""
    top, x = random_tap_operator(nx, ny, cell_type, dtype, device, seed)
    shapes, ch = top.blk_shapes, top.blk_ch
    taps = [t for t in top.taps if t[0] != len(shapes) - 1]
    sizes = [shapes[bi][0] * shapes[bi][1] * ch[bi] * ch[bj] for bi, bj, _, _ in taps]
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    rng = np.random.default_rng(seed + 1)
    ids = []
    for t, (bi, bj, _, _) in enumerate(taps):
        R, C = shapes[bi]
        per = ch[bi] * ch[bj]
        r, c = np.mgrid[0:R, 0:C]
        band = (np.abs(2 * r - c - 4) <= 2) & (r < R // 2) & (rng.random((R, C)) < 0.7)
        pts = np.flatnonzero(band)
        ids.append(offsets[t] + (pts[:, None] * per + np.arange(per)).reshape(-1))
    support = np.unique(np.concatenate(ids))
    W = np.zeros(int(offsets[-1]))
    W[support] = rng.standard_normal(len(support)) * (rng.random(len(support)) >= 0.2)
    W = torch.as_tensor(W, dtype=dtype, device=device)
    return TapOperator(top.grid, top.specs, taps, offsets, shapes, ch, 2, W, None, [], [], support=support), x
