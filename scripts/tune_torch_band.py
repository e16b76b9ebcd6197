"""Times the interface band solve's kernels on the card, on the four bands
``chip_smoke.py`` holds them on.

    python3 scripts/tune_torch_band.py --save-before DIR [--commit REV]
        (no card: writes REV's cuda_band.py and band_solve.cu into DIR, a
        directory that .gitignore lists, such as _checkout/before)
    python3 scripts/tune_torch_band.py [--bands s1,q1,s53d,u] [--before DIR]
        [--builds ELL_CHUNK=16,RAS_THREADS=256 ...] [--windows 1 256 4096]

Each band is built as ``chip_smoke.py`` builds it: ``s1`` the S1 flower at
n=3200 (``lattice_preconditioner(min_n=13)``, m=48,642, K=6), ``q1`` the
weak-Dirichlet sphere at Q1 n=128 (m=170,654, K=16), ``s53d`` S5-3D at n=24
(per-vertex blocks, K=27), ``u`` S1-U on the perturbed triangle mesh at
n=800 with ``amg_preconditioner()`` (m=7,712).  Then ``chip_smoke._hold_band``
with ``timed=True``: every kernel, fused step and one whole inner solve
against their plain versions by ``torch.equal``, the launches per inner
sweep (8), the ELL table's slices and padding, and for the RAS apply, the
fused RAS+P and RAS+S launches, the ELL product, the dots (t.s, t.t) and
the XR update: ms per call by CUDA events, device ms per launch
(profiler), host ms per call, the plain version, the byte bound and the
PyTorch call for the same function; the ELL product's former route (the
AMG kernel on the padded slot-major table) beside it; one inner solve's
device and host time.  With ``--before``, the older module and kernel
source in DIR (``--save-before``; by default revision d2c7372: the RAS
kernel a thread a DoF through its owner slot, the P and S updates in
launches of their own, 10 launches a sweep) are loaded beside the
package's, their tables built from the same host arrays, their RAS apply
and inner solve held bit for bit against the new ones, and timed in turns
(new, older, older, new): the RAS apply and the P and S updates device ms
a launch (the unfused pair each fused launch replaces), the XR update, and
one inner solve by CUDA events and on the host clock.  With ``--builds``,
the kernels built again with each set of ``PHIFEM_BAND_<NAME>`` defines
(``ELL_CHUNK`` / ``ELL_WIDE_CHUNK``: slots a thread of the ELL kernel
loads a step on tables up to / past 32 wide, ``ELL_THREADS`` its CTA size;
``RAS_CHUNK`` / ``RAS_THREADS`` the same for the RAS kernel, whatever K)
and the ELL product, the RAS apply, RAS+P,
RAS+S and one inner solve timed on each band; with ``--windows``, the
band's table built again with rows sorted by length within each such
window (1: unsorted) and the ELL kernel timed on it.  Each variant is held
to the plain versions first, then timed by the profiler, by CUDA events
around calls back to back, and (the ELL product) in a CUDA graph of 20
launches (``chip_smoke._graph_ms``: no host time between launches).
``chip_smoke.py`` times only the S1 band.  Needs a CUDA device (about 4
minutes).
"""

from __future__ import annotations

import argparse
import functools
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as c  # noqa: E402
import phifem_tpu_torch as pt  # noqa: E402
from phifem_tpu_torch.ops import cuda_amg, cuda_band, cuda_hex3, cuda_lattice3, cuda_stencil, cuda_taps  # noqa: E402

DEVICE = "cuda"
HERE = Path(__file__).resolve().parents[1]
BEFORE_FILES = ("phifem_tpu_torch/ops/cuda_band.py", "phifem_tpu_torch/csrc/band_solve.cu")


def _save_before(out: Path, commit: str) -> None:
    out.mkdir(parents=True, exist_ok=True)
    for f in BEFORE_FILES:
        src = subprocess.run(["git", "show", f"{commit}:{f}"], cwd=HERE, check=True, capture_output=True).stdout
        (out / Path(f).name).write_bytes(src)
    print(f"wrote {commit}'s {', '.join(BEFORE_FILES)} to {out}")


def _load_before(d: Path):
    """The older ``cuda_band`` module of ``d`` as a module of its own,
    building its kernel source from ``d``."""
    src = (d / "cuda_band.py").read_text()
    src = src.replace("from . import nvcc_build", "from phifem_tpu_torch.ops import nvcc_build")
    src = src.replace('SOURCE = nvcc_build.PKG / "csrc" / "band_solve.cu"', f"SOURCE = Path({str(d / 'band_solve.cu')!r})")
    mod = types.ModuleType("cuda_band_before")
    sys.modules[mod.__name__] = mod
    exec(compile("from pathlib import Path\n" + src.replace("from __future__ import annotations\n", ""),
                 str(d / "cuda_band.py"), "exec"), mod.__dict__)
    return mod


def _former_times(label: str, tab, sweeps: int, old) -> None:
    """The older module's RAS apply, P / S / XR updates and inner solve
    beside the package's, on the same band, in turns (new, older, older,
    new), after a check that both give the same bits."""
    cb = cuda_band
    cols, vals = tab.ell_rows()
    before = old.band_tables(tab.ids.cpu(), tab.inv.cpu(), tab.owner.cpu(), cols, vals, DEVICE)
    m = tab.m
    rng = np.random.default_rng(11)
    x, rb = (torch.as_tensor(rng.standard_normal(m), device=DEVICE) for _ in range(2))
    y = torch.empty_like(x)
    if not torch.equal(old.band_ras(before, x), cb.band_ras(tab, x)):
        raise AssertionError(f"{label}: the older RAS kernel and the new one differ")
    if not torch.equal(old.band_bicgstab(before, rb, sweeps), cb.band_bicgstab(tab, rb, sweeps)):
        raise AssertionError(f"{label}: the older inner solve and the new one differ")
    st = c._band_update_state(m, rng)
    p_vecs = {k: st[k] for k in ("r", "p", "v", "x", "xb")}
    s_vecs = {k: st[k] for k in ("r", "v", "s")}
    xr = {k: st[k] for k in cb.MODE_VECS[cb.XR]}
    new = {"RAS": (lambda: cb.band_ras(tab, x, y), "band_ras_kernel"),
           "RAS+P": (lambda: cb.band_ras_p(tab, 1, *(st[k] for k in c.RAS_P_ARGS)), "band_ras_kernel"),
           "RAS+S": (lambda: cb.band_ras_s(tab, *(st[k] for k in c.RAS_S_ARGS)), "band_ras_kernel"),
           "XR": (lambda: cb.band_update(cb.XR, 1, st["sc"], **xr), "band_update_kernel")}
    older = {"RAS": (lambda: old.band_ras(before, x, y), "band_ras_kernel"),
             "P": (lambda: old.band_update(old.P, 1, st["sc"], **p_vecs), "band_update_kernel"),
             "S": (lambda: old.band_update(old.S, 1, st["sc"], **s_vecs), "band_update_kernel"),
             "XR": (lambda: old.band_update(old.XR, 1, st["sc"], **xr), "band_update_kernel")}
    got = {}
    for turn, (side, calls) in enumerate((("new", new), ("older", older), ("older", older), ("new", new))):
        for name, (fn, kernel) in calls.items():
            got.setdefault((side, name), []).append(c._device_ms(fn, c.BAND_REPS, kernel))
        for who, solve in (("new", lambda: cb.band_bicgstab(tab, rb, sweeps)),
                           ("older", lambda: old.band_bicgstab(before, rb, sweeps))):
            if who == side:
                got.setdefault((side, "solve"), []).append(c._event_ms(solve, 3))
                got.setdefault((side, "solve host"), []).append(c._host_ms(solve, 3))
    fmt = lambda k: "/".join(f"{v:.4f}" for v in got[k])
    print(f"[{label} band] older beside new, in turns (new, older, older, new), device ms a launch: RAS {fmt(('new', 'RAS'))} "
          f"against {fmt(('older', 'RAS'))}; RAS+P {fmt(('new', 'RAS+P'))} against RAS + P {fmt(('older', 'RAS'))} + "
          f"{fmt(('older', 'P'))}; RAS+S {fmt(('new', 'RAS+S'))} against RAS + S {fmt(('older', 'RAS'))} + "
          f"{fmt(('older', 'S'))}; XR {fmt(('new', 'XR'))} against {fmt(('older', 'XR'))}", flush=True)
    print(f"[{label} band] one inner solve ({sweeps} sweeps; 8 launches a sweep against 10), ms by events "
          f"{fmt(('new', 'solve'))} against {fmt(('older', 'solve'))}; host ms to issue it {fmt(('new', 'solve host'))} "
          f"against {fmt(('older', 'solve host'))}", flush=True)
    del before


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


def _variant_times(label: str, tab, sweeps: int, builds, windows) -> None:
    """The kernels of each build, and the ELL kernel on the table sorted
    within each window, on ``tab``: after a check against the plain
    versions, device ms a launch of the ELL product, the RAS apply, RAS+P
    and RAS+S, ms a call and a launch in a graph of the ELL product, and
    one inner solve by CUDA events."""
    build, library = cuda_band.build, cuda_band._library
    rng = np.random.default_rng(7)
    x = torch.as_tensor(rng.standard_normal(tab.m), device=DEVICE)
    y = torch.empty_like(x)
    st = c._band_update_state(tab.m, rng)
    want = cuda_band.band_ell_ref(tab, x)
    want_ras = cuda_band.band_ras_ref(tab, x)
    want_solve = cuda_band.band_bicgstab_ref(tab, x, sweeps)
    counts = (cuda_band.launches, cuda_band.ras_launches, cuda_band.ell_launches, cuda_band.dot_launches,
              cuda_band.update_launches, cuda_band.tables_built)

    def timed(name: str, t, kernels: bool) -> None:
        call = lambda: cuda_band.band_ell(t, x, y)
        if not torch.equal(call(), want):
            raise AssertionError(f"{label}: the ELL kernel ({name}) differs from its plain version")
        pad = 1 - int(t.row_len.sum()) / max(1, t.sell_cols.numel())
        line = (f"[{label} band] {name}: ELL {pad:.1%} of {t.sell_cols.numel()} slots padding; device "
                f"{c._device_ms(call, c.BAND_REPS, 'band_ell_kernel'):.4f} ms a launch, "
                f"{c._event_ms(call, c.BAND_REPS):.4f} ms a call (events), {c._graph_ms(call):.4f} ms a launch in a "
                "graph")
        if kernels:
            if not (torch.equal(cuda_band.band_ras(t, x), want_ras)
                    and torch.equal(cuda_band.band_bicgstab(t, x, sweeps), want_solve)):
                raise AssertionError(f"{label}: the RAS kernel or the inner solve ({name}) differs from its plain "
                                     "version")
            ras = {"RAS": lambda: cuda_band.band_ras(t, x, y),
                   "RAS+P": lambda: cuda_band.band_ras_p(t, 1, *(st[k] for k in c.RAS_P_ARGS)),
                   "RAS+S": lambda: cuda_band.band_ras_s(t, *(st[k] for k in c.RAS_S_ARGS))}
            line += "; " + ", ".join(f"{k} {c._device_ms(f, c.BAND_REPS, 'band_ras_kernel'):.4f}" for k, f in ras.items())
            line += (f" ms a launch; one inner solve "
                     f"{c._event_ms(lambda: cuda_band.band_bicgstab(t, x, sweeps), 3):.3f} ms (events)")
        print(line, flush=True)

    if windows:
        rows = tab.ell_rows()
        for window in windows:
            saved, cuda_band.WINDOW = cuda_band.WINDOW, window
            try:
                t = cuda_band.band_tables(tab.ids.cpu(), tab.inv.cpu(), tab.owner.cpu(), *rows, DEVICE)
            finally:
                cuda_band.WINDOW = saved
            timed(f"window {window}", t, False)
            del t
            torch.cuda.empty_cache()
    try:
        for spec in builds:
            defines = tuple(f"-DPHIFEM_BAND_{kv}" for kv in spec.split(","))
            cuda_band.build = lambda d=defines: cuda_band.nvcc_build.build(cuda_band.SOURCE, d)
            cuda_band._library = functools.lru_cache(maxsize=None)(library.__wrapped__)
            cuda_band._LAUNCH.clear()
            timed(f"build {spec}", tab, True)
    finally:
        cuda_band.build, cuda_band._library = build, library
        cuda_band._LAUNCH.clear()
        (cuda_band.launches, cuda_band.ras_launches, cuda_band.ell_launches, cuda_band.dot_launches,
         cuda_band.update_launches, cuda_band.tables_built) = counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bands", default="s1,q1,s53d,u")
    ap.add_argument("--save-before", help="write the older module and source into this directory and stop")
    ap.add_argument("--commit", default="d2c7372", help="the revision --save-before takes")
    ap.add_argument("--before", help="a directory --save-before wrote: time the older kernels beside the new")
    ap.add_argument("--builds", nargs="*", default=[],
                    help="builds to time, e.g. ELL_CHUNK=16 RAS_CHUNK=4,RAS_THREADS=256")
    ap.add_argument("--windows", nargs="*", type=int, default=[], help="row-sort windows to time, e.g. 1 256 4096")
    args = ap.parse_args()
    if args.save_before:
        _save_before(Path(args.save_before), args.commit)
        return 0
    if not torch.cuda.is_available():
        print("tune_torch_band: no CUDA device", file=sys.stderr)
        return 2
    c.phase_device()
    c.phase_build(cuda_stencil, cuda_taps, cuda_hex3, cuda_lattice3, cuda_amg, cuda_band)
    old = None
    if args.before:
        old = _load_before(Path(args.before))
        print(f"[build] older band_solve.cu: {old.build()['seconds']:.1f} s", flush=True)
    for name in args.bands.split(","):
        t0 = time.perf_counter()
        label, tab, sweeps = _band(name)
        t1 = time.perf_counter()
        c._hold_band(label, tab, sweeps, timed=True)
        if old is not None:
            _former_times(label, tab, sweeps, old)
        if args.builds or args.windows:
            _variant_times(label, tab, sweeps, args.builds, args.windows)
        print(f"[time] {label}: set-up {t1 - t0:.1f} s, band kernels {time.perf_counter() - t1:.1f} s", flush=True)
        del tab
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
