"""Time builds of the stencil-matvec kernel against each other on the card.

    python3 scripts/tune_torch_stencil.py [--variants "BX,BY,R32,R64 ..."]
        [--source OTHER.cu ...] [--reference FIRST_VERSION.cu] [--n 3200]

Builds ``phifem_tpu_torch/csrc/stencil_matvec.cu`` once per tile-shape variant
(``-DPHIFEM_STENCIL_BX=.. -DPHIFEM_STENCIL_BY=.. -DPHIFEM_STENCIL_ROWS_F32=..
-DPHIFEM_STENCIL_ROWS_F64=..``; the source's own constants when none is
given), and every ``--source`` (another design with the same C interface) as
it is, one nvcc each, all at once.  Every build is then

* held, bit for bit, against the ``--reference`` build (the first if none is
  given) on seeded inputs at 37 x 53, 129 x 65 and n x n, both cell types,
  masked and maskless, float32 and float64: the order of the sums must not
  depend on the tiling;
* timed at n x n on the same eight cases: calls of the C entry back to back,
  CUDA events, mean per call, in two passes (the second in reverse order).

Prints the card's name and power limit and one line per build and case.
Needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))

from phifem_tpu_torch.ops import cuda_stencil, nvcc_build  # noqa: E402

DEFAULT_VARIANTS = "128,2,8,2 64,4,4,2 32,8,4,2 128,2,4,2 64,4,1,1 64,4,2,1 64,4,8,4 128,2,8,4 32,8,8,4 64,2,4,2 128,4,4,2 32,8,2,2 64,4,4,4"
CASES = list(itertools.product((torch.float32, torch.float64), (True, False), (False, True)))  # dt, tri, masked


def _defines(v: str) -> tuple:
    bx, by, r32, r64 = (int(t) for t in v.split(","))
    return (f"-DPHIFEM_STENCIL_BX={bx}", f"-DPHIFEM_STENCIL_BY={by}",
            f"-DPHIFEM_STENCIL_ROWS_F32={r32}", f"-DPHIFEM_STENCIL_ROWS_F64={r64}")


def _load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.phifem_stencil_matvec.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, vp]
    lib.phifem_stencil_matvec.restype = ci
    return lib


def _inputs(nx: int, ny: int, dt, tri: bool, masked: bool, seed: int = 0):
    rng = np.random.default_rng(seed)
    no, nl = (2, 3) if tri else (1, 4)
    mats = np.ascontiguousarray(rng.standard_normal(no * nl * nl))
    nv = (nx + 1) * (ny + 1)
    x = torch.as_tensor(rng.standard_normal(nv), dtype=dt, device="cuda")
    y0 = torch.as_tensor(rng.standard_normal(nv), dtype=dt, device="cuda")
    masks = None
    if masked:
        masks = torch.as_tensor(rng.random((no, ny, nx)) < 0.6, dtype=dt, device="cuda")
    return mats, x, y0, masks


def _call(lib, mats, x, y, masks, nx, ny, tri, stream):
    err = lib.phifem_stencil_matvec(x.data_ptr(), y.data_ptr(), None if masks is None else masks.data_ptr(),
                                    mats.ctypes.data, nx, ny, int(tri), int(x.dtype == torch.float64), stream)
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")


def _event_ms(fn, reps: int = 50) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _label(dt, tri, masked) -> str:
    return f"{'f32' if dt == torch.float32 else 'f64'} {'tri' if tri else 'quad'} {'masked' if masked else 'maskless'}"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default=DEFAULT_VARIANTS)
    ap.add_argument("--source", action="append", default=[])
    ap.add_argument("--reference")
    ap.add_argument("--n", type=int, default=3200)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("tune_torch_stencil: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[device] {smi}")

    jobs = {}  # name -> (source, defines)
    if a.reference:
        jobs[f"reference {Path(a.reference).name}"] = (Path(a.reference), ())
    for v in a.variants.split():
        jobs[f"variant {v}"] = (cuda_stencil.SOURCE, _defines(v))
    for s in a.source:
        jobs[f"source {Path(s).name}"] = (Path(s), ())
    built = {}
    threads = [threading.Thread(target=lambda k=k, j=j: built.__setitem__(k, nvcc_build.build(*j)))
               for k, j in jobs.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    libs = {}
    for k in jobs:
        if k not in built:
            raise RuntimeError(f"{k}: did not build")
        regs = [l.split("Used ")[1].split(",")[0] for l in built[k]["log"].splitlines() if "Used " in l]
        print(f"[build] {k}: {built[k]['seconds']:.1f} s; registers {' '.join(regs)}")
        libs[k] = _load(built[k]["path"])
    ref_name = next(iter(libs))
    stream = torch.cuda.current_stream().cuda_stream

    # bits
    for (nx, ny) in ((37, 53), (129, 65), (a.n, a.n)):
        for dt, tri, masked in CASES:
            mats, x, y0, masks = _inputs(nx, ny, dt, tri, masked)
            want = y0.clone()
            _call(libs[ref_name], mats, x, want, masks, nx, ny, tri, stream)
            for k, lib in libs.items():
                got = y0.clone()
                _call(lib, mats, x, got, masks, nx, ny, tri, stream)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    d = float((got - want).abs().max())
                    print(f"[bits] {k} differs from {ref_name} at {nx}x{ny} {_label(dt, tri, masked)}: max|d| {d:.3e}")
    print(f"[bits] every build compared with {ref_name} (differences, if any, are listed above)")

    # times
    n = a.n
    for dt, tri, masked in CASES:
        mats, x, y0, masks = _inputs(n, n, dt, tri, masked)
        y = torch.zeros_like(x)
        nbytes = (3 * x.numel() + (0 if masks is None else masks.numel())) * x.element_size()
        names = list(libs)
        ms = {k: [] for k in names}
        for order in (names, names[::-1]):
            for k in order:
                ms[k].append(_event_ms(lambda: _call(libs[k], mats, x, y, masks, n, n, tri, stream)))
        for k in names:
            best = min(ms[k])
            print(f"[time] {_label(dt, tri, masked):22s} {k:28s} {ms[k][0]:.4f} {ms[k][1]:.4f} ms "
                  f"({nbytes / best / 1e9:.2f} TB/s of the bound's bytes, {nbytes / 3.35e12 * 1e3 / best:.1%} of the bound)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
