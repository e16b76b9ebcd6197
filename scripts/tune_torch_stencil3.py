"""Time builds of the two 3D kernels against each other and against an older
version, on the card.

    python3 scripts/tune_torch_stencil3.py --save-before DIR [--commit REV]
        (no card: writes REV's csrc/lattice3_sweep.cu and hex_stencil3.cu
        into DIR with ``git show``; DIR should be one that .gitignore lists,
        such as _checkout/before)
    python3 scripts/tune_torch_stencil3.py [--before DIR]
        [--lattice "v,v,... ..."] [--hex "v,v,... ..."]
        [--reps 50]

Builds ``phifem_tpu_torch/csrc/lattice3_sweep.cu`` once per ``--lattice``
variant (values of ``cuda_lattice3.TILE``'s keys in order, its
``PHIFEM_L3_*`` macros) and ``hex_stencil3.cu`` once per ``--hex`` variant
(``cuda_hex3.TILE``, ``PHIFEM_HEX3_*``), the shipped tilings first
(``cuda_lattice3.TILE``, ``cuda_hex3.TILE``), and the two sources in
``--before`` as they are (the same C interfaces), one nvcc each, all at
once.  Every build is then

* held bit for bit (``torch.equal``) against the plain versions
  (``lattice3_sweep_ref``, ``hex_stencil3_ref``) on seeded inputs: lattice3
  at 5x7x9, 3x5x4, 37^3 and 129x65x33 in its four modes; hex3 at n = 3, 5,
  13, 37 with random masks and on the sphere masks of the timed shapes;
  float32 and float64;
* timed at the shapes of ``chip_smoke.py``'s kernel phases (lattice3 129^3
  and 257^3, four modes; hex3 d=1 n=128, d=2 n=64, d=3 n=40 on the sphere
  mask), float32 and float64, and hex3 d=1 and d=3 in float64 with every
  cell active ("full") and none ("empty"), to split a time into its
  arithmetic and its loads: calls of the C entry back to back by CUDA
  events (``ms``) and the kernel's device time per launch from the profiler
  (``dev``), in two passes (the second in reverse order), with each case's
  bound as ``chip_smoke.py`` counts it.

Prints the card's name and power limit and one line per build and case.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))

from phifem_tpu_torch.ops import cuda_hex3, cuda_lattice3 as cl, nvcc_build  # noqa: E402
from phifem_tpu_torch.ops.lattice3 import _terms3, hex_element_matrix, vertex_stencil_weights3  # noqa: E402

HBM = 3.35e12
FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
MODES = ((cl.MATVEC, "matvec", False), (cl.RESIDUAL, "residual", True), (cl.JACOBI, "jacobi masked", True),
         (cl.JACOBI, "jacobi", False))
L3_KEYS = tuple(cl.TILE)
HEX_KEYS = tuple(cuda_hex3.TILE)
DEFAULT_L3 = ("32,4,1,8,1,16,8,2,4,1 32,4,1,8,2,16,8,2,4,2 32,4,1,8,8,16,8,2,4,4 32,8,1,4,4,16,8,2,2,4 "
              "32,4,1,4,8,16,4,2,4,4")
DEFAULT_HEX = "16,8,4,2,1,4,4,128,512,4,2,1 16,8,4,2,2,4,4,128,512,4,2,1 16,8,4,2,8,4,4,128,512,4,2,1 32,4,8,4,4,4,4,128,512,4,2,1"
SPHERE = 0.7
BOX3 = ((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0))


def _bind_lattice(path: str):
    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.phifem_lattice3_sweep.argtypes = [vp, vp, vp, vp, ci, ci, ci, vp, vp, ci, ctypes.c_double, ci, ci, vp]
    lib.phifem_lattice3_sweep.restype = ci
    return lib.phifem_lattice3_sweep


def _bind_hex(path: str):
    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.phifem_hex_stencil3.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, vp]
    lib.phifem_hex_stencil3.restype = ci
    return lib.phifem_hex_stencil3


def _check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what}: launch failed, CUDA error {err}")


def _event_ms(fn, reps: int) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fn, reps: int, name: str) -> float:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = [(e.count, e.self_device_time_total) for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and name in e.key]
        n = sum(c for c, _ in ev)
        if n:
            return sum(t for _, t in ev) / n / 1e3
    return float("nan")


def _sphere_mask(pt, n: int, dt) -> torch.Tensor:
    from phifem_tpu_torch.tagging3 import compute_tags3

    phi = lambda x: x[..., 0] ** 2 + x[..., 1] ** 2 + x[..., 2] ** 2 - SPHERE**2
    tags = compute_tags3(pt.Grid3(n, n, n, BOX3, device="cuda"), phi)
    return torch.as_tensor(tags.region_mask((1, 2)), dtype=dt, device="cuda").contiguous()


def _lattice_inputs(shape, dt, seed):
    rng = np.random.default_rng(seed)
    D, R, C = shape
    x = torch.zeros((D + 2, R + 2, C + 2), dtype=dt, device="cuda")
    b = torch.zeros_like(x)
    x[2:D, 2:R, 2:C] = torch.as_tensor(rng.standard_normal((D - 2, R - 2, C - 2)), dtype=dt, device="cuda")
    b[2:D, 2:R, 2:C] = torch.as_tensor(rng.standard_normal((D - 2, R - 2, C - 2)), dtype=dt, device="cuda")
    x[0] = 1.5  # a shell that Jacobi must keep
    mask = torch.as_tensor(rng.random(shape) < 0.7, dtype=dt, device="cuda")
    return x, b, mask


def _terms(n: int):
    h = 1.0 / n
    w = vertex_stencil_weights3(hex_element_matrix(h, h, h))
    return cl.pack_terms(_terms3(w)), 0.8 / w[1, 1, 1]


def _lattice_call(fn, mode, x, b, m, out, terms, od, stream):
    D, R, C = (s - 2 for s in x.shape)
    return lambda: _check(fn(x.data_ptr(), b.data_ptr(), None if m is None else m.data_ptr(), out.data_ptr(), D, R,
                             C, terms.offs_ptr, terms.w_ptr, len(terms), od, mode, x.dtype == torch.float64,
                             stream), "lattice3")


def _hex_call(fn, x, y, mask, A, d, stream):
    nz, ny, nx = mask.shape
    return lambda: _check(fn(x.data_ptr(), y.data_ptr(), mask.data_ptr(), A.data_ptr(), nx, ny, nz, d,
                             x.dtype == torch.float64, stream), "hex3")


def _hex_inputs(mask: torch.Tensor, d: int, seed: int):
    rng = np.random.default_rng(seed)
    nz, ny, nx = mask.shape
    nloc = (d + 1) ** 3
    dt = mask.dtype
    x = torch.as_tensor(rng.standard_normal((d * nz + 1, d * ny + 1, d * nx + 1)), dtype=dt, device="cuda")
    A = torch.as_tensor(rng.standard_normal((nloc, nloc)), dtype=dt, device="cuda")
    return x, A


def _time(label: str, calls: dict, kernel: str, bound: float, reps: int) -> None:
    names = list(calls)
    ms = {k: [] for k in names}
    dev = {k: [] for k in names}
    for order in (names, names[::-1]):
        for k in order:
            ms[k].append(_event_ms(calls[k], reps))
            dev[k].append(_device_ms(calls[k], reps // 2, kernel))
    for k in names:
        best = min(dev[k])
        print(f"[time] {label:28s} {k:34s} ms {ms[k][0]:.4f} {ms[k][1]:.4f} dev {dev[k][0]:.4f} {dev[k][1]:.4f} "
              f"(bound {bound:.4f}; {bound / best:.1%} by dev, {bound / min(ms[k]):.1%} by ms)")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--save-before")
    ap.add_argument("--commit", default="ce6822e")
    ap.add_argument("--before")
    ap.add_argument("--lattice", default=DEFAULT_L3)
    ap.add_argument("--hex", default=DEFAULT_HEX)
    ap.add_argument("--reps", type=int, default=50)
    a = ap.parse_args()
    if a.save_before:
        out = Path(a.save_before)
        out.mkdir(parents=True, exist_ok=True)
        for f in ("lattice3_sweep.cu", "hex_stencil3.cu"):
            src = subprocess.run(["git", "show", f"{a.commit}:phifem_tpu_torch/csrc/{f}"], cwd=HERE,
                                 capture_output=True, text=True, check=True).stdout
            (out / f).write_text(src)
        print(f"wrote {a.commit}'s kernels to {out}")
        return 0
    if not torch.cuda.is_available():
        print("tune_torch_stencil3: no CUDA device", file=sys.stderr)
        return 2
    import phifem_tpu_torch as pt

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[device] {smi}")
    jobs = {}  # name -> (kind, source, defines)
    for v in [",".join(str(cl.TILE[k]) for k in L3_KEYS)] + a.lattice.split():
        jobs.setdefault(f"lattice3 {v}", ("l", cl.SOURCE, cl.defines(dict(zip(L3_KEYS, map(int, v.split(",")))))))
    for v in [",".join(str(cuda_hex3.TILE[k]) for k in HEX_KEYS)] + a.hex.split():
        jobs.setdefault(f"hex3 {v}", ("h", cuda_hex3.SOURCE,
                                      cuda_hex3.defines(dict(zip(HEX_KEYS, map(int, v.split(",")))))))
    if a.before:
        jobs["lattice3 before"] = ("l", Path(a.before) / "lattice3_sweep.cu", ())
        jobs["hex3 before"] = ("h", Path(a.before) / "hex_stencil3.cu", ())
    built = {}
    threads = [threading.Thread(target=lambda k=k, j=j: built.__setitem__(k, nvcc_build.build(j[1], j[2])))
               for k, j in jobs.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    lat, hexes = {}, {}
    for k, (kind, _, _) in jobs.items():
        if k not in built:
            raise RuntimeError(f"{k}: did not build")
        regs = [l.split("Used ")[1].split(",")[0] for l in built[k]["log"].splitlines() if "Used " in l]
        spill = [l.split(", ")[1] for l in built[k]["log"].splitlines() if "spill stores" in l]
        print(f"[build] {k}: {built[k]['seconds']:.1f} s; registers {' '.join(regs)}; "
              f"spill stores {' / '.join(sorted(set(spill)))}")
        (lat if kind == "l" else hexes)[k] = (_bind_lattice if kind == "l" else _bind_hex)(built[k]["path"])
    stream = torch.cuda.current_stream().cuda_stream

    # bits
    nbad = 0
    for dt in (torch.float32, torch.float64):
        for shape in ((5, 7, 9), (3, 5, 4), (37, 37, 37), (129, 65, 33)):
            x, b, mask = _lattice_inputs(shape, dt, sum(shape))
            terms, od = _terms(shape[0] - 1)
            for mode, name, masked in MODES:
                m = mask if masked else None
                want = cl.lattice3_sweep_ref(mode, x, terms, b, m, od)
                for k, fn in lat.items():
                    out = torch.full_like(x, float("nan"))
                    _lattice_call(fn, mode, x, b, m, out, terms, od, stream)()
                    torch.cuda.synchronize()
                    if not torch.equal(out, want):
                        nbad += 1
                        print(f"[bits] {k} {name} {shape} {dt}: max|d| {float((out - want).abs().max()):.3e}")
        rng = np.random.default_rng(3)
        hex_cases = [(d, torch.as_tensor(rng.random((n, n + 1, n + 2)) < 0.5, dtype=dt, device="cuda"))
                     for d in (1, 2, 3) for n in (3, 5, 13, 37)]
        hex_cases += [(d, _sphere_mask(pt, n, dt)) for d, n in ((1, 128), (2, 64), (3, 40))]
        for d, mask in hex_cases:
            x, A = _hex_inputs(mask, d, d)
            want = cuda_hex3.hex_stencil3_ref(x, mask, A, d)
            for k, fn in hexes.items():
                y = torch.full_like(x, float("nan"))
                _hex_call(fn, x, y, mask, A, d, stream)()
                torch.cuda.synchronize()
                if not torch.equal(y, want):
                    nbad += 1
                    print(f"[bits] {k} d={d} {tuple(mask.shape)} {dt}: max|d| {float((y - want).abs().max()):.3e}")
    print(f"[bits] every build against the plain versions: {nbad} differences")

    # times
    for n in (128, 256):
        terms, od = _terms(n)
        for dt in (torch.float32, torch.float64):
            x, b, mask = _lattice_inputs((n + 1,) * 3, dt, n)
            out = torch.empty_like(x)
            for mode, name, masked in MODES:
                m = mask if masked else None
                nb = ((2 + (mode != cl.MATVEC)) * x.numel() + (m.numel() if masked else 0)) * x.element_size()
                bound = 1e3 * max(nb / HBM, 2 * len(terms) * (n - 1) ** 3 / FLOPS[dt])
                calls = {k: _lattice_call(fn, mode, x, b, m, out, terms, od, stream) for k, fn in lat.items()}
                _time(f"lattice3 {name} {n + 1}^3 {str(dt)[6:]}", calls, "lattice3_sweep_kernel", bound, a.reps)
            del x, b, mask, out
    for d, n, kind in ((1, 128, "sphere"), (2, 64, "sphere"), (3, 40, "sphere"), (1, 128, "full"),
                       (3, 40, "full"), (1, 128, "empty"), (3, 40, "empty")):
        for dt in (torch.float64, torch.float32) if kind == "sphere" else (torch.float64,):
            mask = _sphere_mask(pt, n, dt)
            if kind != "sphere":  # where the time goes: every cell active, or none
                mask = torch.full_like(mask, 1.0 if kind == "full" else 0.0)
            x, A = _hex_inputs(mask, d, d)
            y = torch.empty_like(x)
            ncell = int((mask != 0).sum())
            nloc = (d + 1) ** 3
            nb = (2 * x.numel() + mask.numel()) * x.element_size()
            bound = 1e3 * max(nb / HBM, 2 * nloc * nloc * ncell / FLOPS[dt])
            calls = {k: _hex_call(fn, x, y, mask, A, d, stream) for k, fn in hexes.items()}
            _time(f"hex3 d={d} n={n} {kind} {str(dt)[6:]}", calls, "stencil3_kernel", bound, a.reps)
    return 1 if nbad else 0


if __name__ == "__main__":
    sys.exit(main())
