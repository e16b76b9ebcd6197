"""Times the interface band solve's kernels on the card, on the four bands
``chip_smoke.py`` holds them on.

    python3 scripts/tune_torch_band.py [--bands s1,q1,s53d,u]

Each band is built as ``chip_smoke.py`` builds it: ``s1`` the S1 flower at
n=3200 (``lattice_preconditioner(min_n=13)``, m=48,642, K=6), ``q1`` the
weak-Dirichlet sphere at Q1 n=128 (m=170,654, K=16), ``s53d`` S5-3D at n=24
(per-vertex blocks, K=27), ``u`` S1-U on the perturbed triangle mesh at
n=800 with ``amg_preconditioner()`` (m=7,712).  Then ``chip_smoke._hold_band``
with ``timed=True``: every kernel and one whole inner solve against their
plain versions by ``torch.equal``, the launches per inner sweep, and for the
RAS apply, the ELL product, the dots (t.s, t.t) and the XR update: ms per
call by CUDA events, device ms per launch (profiler), host ms per call, the
plain version, the byte bound and the PyTorch call for the same function;
one inner solve's device and host time.  ``chip_smoke.py`` times only the
S1 band.  Needs a CUDA device (about 3 minutes).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bands", default="s1,q1,s53d,u")
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
        print(f"[time] {label}: set-up {t1 - t0:.1f} s, band kernels {time.perf_counter() - t1:.1f} s", flush=True)
        del tab
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
