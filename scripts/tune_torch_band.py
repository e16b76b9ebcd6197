"""Times the interface band solve's kernels on the card, on the four bands
``chip_smoke.py`` holds them on.

    python3 scripts/tune_torch_band.py [--bands s1,q1,s53d,u] [--builds CHUNK=16,THREADS=64 ...]
        [--windows 1 256 4096]

Each band is built as ``chip_smoke.py`` builds it: ``s1`` the S1 flower at
n=3200 (``lattice_preconditioner(min_n=13)``, m=48,642, K=6), ``q1`` the
weak-Dirichlet sphere at Q1 n=128 (m=170,654, K=16), ``s53d`` S5-3D at n=24
(per-vertex blocks, K=27), ``u`` S1-U on the perturbed triangle mesh at
n=800 with ``amg_preconditioner()`` (m=7,712).  Then ``chip_smoke._hold_band``
with ``timed=True``: every kernel and one whole inner solve against their
plain versions by ``torch.equal``, the launches per inner sweep (10), the
ELL table's slices and padding, and for the RAS apply, the ELL product, the
dots (t.s, t.t) and the XR update: ms per call by CUDA events, device ms per
launch (profiler), host ms per call, the plain version, the byte bound and
the PyTorch call for the same function; the ELL product's former route
(the AMG kernel on the padded slot-major table) beside it; one inner
solve's device and host time.  With ``--builds``, the ELL kernel built
again with each set of ``PHIFEM_BAND_ELL_<NAME>`` defines (``CHUNK`` /
``WIDE_CHUNK``: slots a thread loads a step on tables up to / past 32
wide; ``THREADS``: the CTA size) and timed on each
band; with ``--windows``, the band's table built again with rows sorted by
length within each such window (1: unsorted) and the kernel timed on it.
Each variant is held to the plain version first, then timed by the
profiler, by CUDA events around calls back to back, and in a CUDA graph
of 20 launches (``chip_smoke._graph_ms``: no host time between launches).
``chip_smoke.py`` times only the S1 band.  Needs a CUDA device (about 4
minutes).
"""

from __future__ import annotations

import argparse
import functools
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as c  # noqa: E402
import phifem_tpu_torch as pt  # noqa: E402
from phifem_tpu_torch.ops import cuda_amg, cuda_band, cuda_hex3, cuda_lattice3, cuda_stencil, cuda_taps  # noqa: E402

DEVICE = "cuda"


def _band(name: str):
    """(label, the band's tables, its inner sweeps)."""
    if name == "s1":
        s = c._flower_s1(pt, c.N, DEVICE).assemble()
        vc = s.lattice_preconditioner(min_n=13)
        return f"S1 n={c.N}", vc.band_tables, vc.schwarz_sweeps
    if name == "q1":
        s = c._weak3(pt, c.N3_Q1, 1, DEVICE).assemble()
        s.lattice_preconditioner()
        return f"weak3 Q1 n={c.N3_Q1}", s._band.band_tables, s._band.schwarz_sweeps
    if name == "s53d":
        s, _ = c._s53d(pt, c.N_S53D_LARGE, DEVICE)
        s.assemble()
        M = s.lattice_preconditioner()
        return f"s53d n={c.N_S53D_LARGE}", M.iface.band.band_tables, M.iface.band.schwarz_sweeps
    s, _, _ = c._u_scheme(pt, "s1", c._u_mesh(pt, c.N_AMG_LARGE, DEVICE), 0.49)
    s.assemble()
    vc = s.amg_preconditioner()
    return f"u-amg s1 n={c.N_AMG_LARGE}", vc.band_tables, vc.schwarz_sweeps


def _variant_times(label: str, tab, builds, windows) -> None:
    """The ELL kernel of each build, and on the table sorted within each
    window, on ``tab``: slots padded, device ms a launch, ms a call and ms
    a launch in a graph, after a check against the plain version."""
    build, library = cuda_band.build, cuda_band._library
    x = torch.as_tensor(np.random.default_rng(7).standard_normal(tab.m), device=DEVICE)
    y = torch.empty_like(x)
    want = cuda_band.band_ell_ref(tab, x)
    n0, t0 = cuda_band.ell_launches, cuda_band.tables_built

    def timed(name: str, t) -> None:
        call = lambda: cuda_band.band_ell(t, x, y)
        if not torch.equal(call(), want):
            raise AssertionError(f"{label}: the ELL kernel ({name}) differs from its plain version")
        pad = 1 - int(t.row_len.sum()) / max(1, t.sell_cols.numel())
        print(f"[{label} band] band_ell, {name}: {pad:.1%} of {t.sell_cols.numel()} slots padding; device "
              f"{c._device_ms(call, c.BAND_REPS, 'band_ell_kernel'):.4f} ms a launch, "
              f"{c._event_ms(call, c.BAND_REPS):.4f} ms a call (events), {c._graph_ms(call):.4f} ms a launch in a "
              "graph", flush=True)

    if windows:
        rows = tab.ell_rows()
        for window in windows:
            saved, cuda_band.WINDOW = cuda_band.WINDOW, window
            try:
                t = cuda_band.band_tables(tab.ids.cpu(), tab.inv.cpu(), tab.owner.cpu(), *rows, DEVICE)
            finally:
                cuda_band.WINDOW = saved
            timed(f"window {window}", t)
            del t
            torch.cuda.empty_cache()
    try:
        for spec in builds:
            defines = tuple(f"-DPHIFEM_BAND_ELL_{kv}" for kv in spec.split(","))
            cuda_band.build = lambda d=defines: cuda_band.nvcc_build.build(cuda_band.SOURCE, d)
            cuda_band._library = functools.lru_cache(maxsize=None)(library.__wrapped__)
            cuda_band._LAUNCH.clear()
            timed(f"build {spec}", tab)
    finally:
        cuda_band.build, cuda_band._library = build, library
        cuda_band._LAUNCH.clear()
        cuda_band.ell_launches, cuda_band.tables_built = n0, t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bands", default="s1,q1,s53d,u")
    ap.add_argument("--builds", nargs="*", default=[], help="ELL builds to time, e.g. CHUNK=16 THREADS=64,CHUNK=4")
    ap.add_argument("--windows", nargs="*", type=int, default=[], help="row-sort windows to time, e.g. 1 256 4096")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tune_torch_band: no CUDA device", file=sys.stderr)
        return 2
    c.phase_device()
    c.phase_build(cuda_stencil, cuda_taps, cuda_hex3, cuda_lattice3, cuda_amg, cuda_band)
    for name in args.bands.split(","):
        t0 = time.perf_counter()
        label, tab, sweeps = _band(name)
        t1 = time.perf_counter()
        c._hold_band(label, tab, sweeps, timed=True)
        if args.builds or args.windows:
            _variant_times(label, tab, args.builds, args.windows)
        print(f"[time] {label}: set-up {t1 - t0:.1f} s, band kernels {time.perf_counter() - t1:.1f} s", flush=True)
        del tab
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
