"""Share of the tap kernel's work per tile shape, on the CPU.

    python3 scripts/profile_torch_tiles.py [--s1 200 400 800] [--s4 200 400]

Builds the tap forms of S1 (the flower, as ``chip_smoke.py`` runs it) and
S4 (the Robin demo) at small n on the CPU and prints, per candidate tile
shape of the tap kernel's tile table (``ops/cuda_taps.TILE`` is the one
the kernel is built for): the share of ``(tap, tile)`` pairs
with a supported weight (the pairs the kernel walks), the share of tiles
with one, and the share of W those pairs hold (what the kernel reads of W),
also as a multiple of the supported weights.  The shares roughly halve
with each doubling of n, which is how the shares at the card's sizes
(S1 n=3200, S4 n=1600) are predicted; ``chip_smoke.py`` prints them there.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

SHAPES = [(1, 32), (2, 32), (4, 32), (8, 32), (4, 16), (8, 16), (16, 16)]


def _pairs(top, TR: int, TC: int):
    """(active (tap, tile) pairs, all pairs, active tiles, all tiles, weights
    in the active pairs' whole tiles) of ``top`` cut into TR x TC tiles: the
    count ``ops/cuda_taps.tile_table`` makes for the kernel's one shape."""
    shapes = np.asarray(top.blk_shapes, np.int64).reshape(-1, 2)
    ch = np.asarray(top.blk_ch, np.int64)
    taps = np.asarray(top.taps, np.int64).reshape(-1, 4)
    ntc = -(-shapes[:, 1] // TC)
    ntiles = -(-shapes[:, 0] // TR) * ntc
    base = np.concatenate([[0], np.cumsum(ntiles)])
    ids = np.asarray(top.support, np.int64)
    t = np.searchsorted(top.tap_offsets, ids, side="right") - 1
    bi, per = taps[t, 0], ch[taps[t, 0]] * ch[taps[t, 1]]
    rc = (ids - np.asarray(top.tap_offsets, np.int64)[t]) // per
    tile = base[bi] + (rc // shapes[bi, 1]) // TR * ntc[bi] + (rc % shapes[bi, 1]) // TC
    keys = np.unique(t * int(base[-1]) + tile)
    tap_of = keys // int(base[-1])
    read = int((ch[taps[tap_of, 0]] * ch[taps[tap_of, 1]]).sum()) * TR * TC  # ragged edges counted full
    return len(keys), int(ntiles[taps[:, 0]].sum()), len(np.unique(keys % int(base[-1]))), int(base[-1]), read


def survey(label: str, top) -> None:
    nsup = len(top.support)
    print(f"{label}: {top.num_taps} taps, {top.num_weights} weights, {nsup} supported "
          f"({nsup / top.num_weights:.4%})", flush=True)
    for TR, TC in SHAPES:
        active, pairs, tiles, ntiles, read = _pairs(top, TR, TC)
        print(f"  tile {TR:2d}x{TC:2d}: active pairs {active / pairs:.4%}, active tiles "
              f"{tiles / ntiles:.4%}, W read {read / top.num_weights:.4%} ({read / nsup:.1f}x the "
              f"supported weights)", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--s1", type=int, nargs="*", default=[200, 400, 800])
    ap.add_argument("--s4", type=int, nargs="*", default=[200, 400])
    args = ap.parse_args()
    import chip_smoke
    import phifem_tpu_torch as pt

    for n in args.s1:
        s = chip_smoke._flower_s1(pt, n, "cpu").assemble()
        survey(f"S1 n={n}", s.op.lattice_form())
    for n in args.s4:
        s, _ = chip_smoke._square(pt, "s4", n, "cpu")
        s.assemble(rhs=False)
        survey(f"S4 n={n}", s.op.lattice_form())
    return 0


if __name__ == "__main__":
    sys.exit(main())
