"""Time builds of the 3D kernels and their 3-channel block forms against
each other and against an older version, on the card.

    python3 scripts/tune_torch_stencil3.py --save-before DIR [--commit REV]
        (no card: writes REV's csrc/lattice3_sweep.cu and hex_stencil3.cu
        into DIR with ``git show``; DIR should be one that .gitignore lists,
        such as _checkout/before)
    python3 scripts/tune_torch_stencil3.py [--before DIR]
        [--kernels lattice,hex,latblock,hexblock]
        [--lattice "v,v,... ..."] [--hex "v,v,... ..."]
        [--latblock "v,v,... ..."] [--hexblock "v,v,... ..."] [--reps 50]

Builds ``phifem_tpu_torch/csrc/lattice3_sweep.cu`` once per ``--lattice``
variant (values of ``cuda_lattice3.TILE``'s keys in order, its
``PHIFEM_L3_*`` macros) and per ``--latblock`` variant
(``cuda_lattice3.BLOCK_TILE``, ``PHIFEM_L3B_*``), ``hex_stencil3.cu`` once
per ``--hex`` variant (``cuda_hex3.TILE``, ``PHIFEM_HEX3_*``) and per
``--hexblock`` variant (``cuda_hex3.BLOCK_TILE``, ``PHIFEM_HEX3B_*``), the
shipped tilings first, and the two sources in ``--before`` as they are (the
same C interfaces), one nvcc each, all at once; ``--kernels`` picks which of
the four kernels are built and run.  Every build is then

* held bit for bit (``torch.equal``) against the plain versions
  (``lattice3_sweep_ref``, ``hex_stencil3_ref``,
  ``lattice3_block_sweep_ref``, ``hex_block_stencil3_ref``) on seeded
  inputs: lattice3 at 5x7x9, 3x5x4, 37^3 and 129x65x33 in its four modes;
  hex3 at n = 3, 5, 13, 37 with random masks and on the sphere masks of the
  timed shapes; the block sweep at 5x7x9, 3x5x4, 3^3, 14x6x62, 37^3 and
  65x33x129 in its five modes (residual masked and not), with all 27 block
  terms and, at 5x7x9, 14x6x62 and 37^3, with some dropped (``PARTIAL``:
  the kernel's branch per absent term); the block hex
  stencil at odd, ragged and tile-sized grids with random, full and empty
  masks and on S5-3D's two sides at n = 32 and 64; float32 and float64;
* timed at the shapes of ``chip_smoke.py``'s kernel phases (lattice3 129^3
  and 257^3, four modes; hex3 d=1 n=128, d=2 n=64, d=3 n=40 on the sphere
  mask; the block sweep at 3 x 129^3 and 3 x 65^3, four modes; the block
  hex stencil on S5-3D's in / out sides at n=64), float32 and float64, and
  hex3 d=1 and d=3 and the block hex stencil in float64 with every cell
  active ("full") and none ("empty"), to split a time into its arithmetic
  and its loads: calls of the C entry back to back by CUDA events (``ms``)
  and the kernel's device time per launch from the profiler (``dev``), in
  two passes (the second in reverse order; the block hex stencil's device
  time counts its copy of K into the constant bank), with each case's bound as
  ``chip_smoke.py`` counts it and, for the block kernels, its no-FMA floor
  (the operations at half the data sheet's rate: every product and sum is
  an instruction of its own) and the SM clock, power and temperature that
  ``nvidia-smi`` reads while the first build runs back to back.

Prints the card's name and power limit and one line per build and case.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import threading
import time
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
DEFAULT_L3 = "32,4,1,4,16,8,2,4 32,8,1,8,16,4,2,2"
DEFAULT_HEX = "16,8,4,2,2,4,4,128,512,4,2,1,4 32,4,8,4,4,4,4,128,512,4,2,1,4"
LB_KEYS = tuple(cl.BLOCK_TILE)
HB_KEYS = tuple(cuda_hex3.BLOCK_TILE)
DEFAULT_LB = "32,8,6,1,4,3,0 32,4,8,0,8,2,1"
DEFAULT_HB = "32,4,4,0,1 16,8,4,1,0"
KERNELS = ("lattice", "hex", "latblock", "hexblock")
SPHERE = 0.7
BOX3 = ((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0))
S53D_BOX = ((-1.5, -1.5, -1.5), (1.5, 1.5, 1.5))
BLOCK_MODES = MODES + ((cl.RESIDUAL, "residual unmasked", False),)
#: block term sets with positions (oz, oy, ox) dropped, the centre kept
PARTIAL = {"no corners": lambda a, b, c: not {a, b, c} <= {0, 2},
           "star": lambda a, b, c: sorted((a, b, c)) in ([1, 1, 1], [0, 1, 1], [1, 1, 2]),
           "no top plane": lambda a, b, c: a != 2}


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


def _bind_latblock(path: str):
    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.phifem_lattice3_block_sweep.argtypes = [vp, vp, vp, vp, ci, ci, ci, vp, vp, ci, vp, ctypes.c_double, ci, ci,
                                                vp]
    lib.phifem_lattice3_block_sweep.restype = ci
    return lib.phifem_lattice3_block_sweep


def _bind_hexblock(path: str):
    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.phifem_hex_block_stencil3.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, vp]
    lib.phifem_hex_block_stencil3.restype = ci
    return lib.phifem_hex_block_stencil3


BIND = {"lattice": _bind_lattice, "hex": _bind_hex, "latblock": _bind_latblock, "hexblock": _bind_hexblock}


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


def _device_ms(fn, reps: int, name: str, also: str = None) -> float:
    """Device ms per launch of the kernels named ``name``, with the device
    operations named ``also`` (a launch's own copies) counted in."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = [(e.count, e.self_device_time_total, name in e.key) for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and (name in e.key or also is not None and also in e.key)]
        n = sum(c for c, _, mine in ev if mine)
        if n:
            return sum(t for _, t, _ in ev) / n / 1e3
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


def _block_terms(n: int):
    """S5-3D's bulk block stencil on the n-cell grid of [-1.5, 1.5]^3 (E 1,
    nu 0.3), packed with its centre block's inverse."""
    from phifem_tpu_torch.models.interface_elasticity import lame
    from phifem_tpu_torch.models.interface_elasticity3 import _elastic_element_matrix
    from phifem_tpu_torch.ops.lattice3 import _block_terms3, block_vertex_stencil_weights3

    h = 3.0 / n
    terms = _block_terms3(block_vertex_stencil_weights3(_elastic_element_matrix(h, h, h, *lame(1.0, 0.3)), 3))
    dinv = np.linalg.inv(next(W for a, b, c, W in terms if (a, b, c) == (1, 1, 1)))
    return cl.pack_block_terms(terms, dinv)


def _block_inputs(shape, dt, seed):
    rng = np.random.default_rng(seed)
    D, R, C = shape
    x = torch.zeros((3, D + 2, R + 2, C + 2), dtype=dt, device="cuda")
    b = torch.zeros_like(x)
    if min(shape) > 2:
        x[:, 2:D, 2:R, 2:C] = torch.as_tensor(rng.standard_normal((3, D - 2, R - 2, C - 2)), dtype=dt, device="cuda")
        b[:, 2:D, 2:R, 2:C] = torch.as_tensor(rng.standard_normal((3, D - 2, R - 2, C - 2)), dtype=dt, device="cuda")
    x[:, 0], x[:, :, -1] = 1.5, -2.5  # a shell that the Jacobi sweep keeps
    mask = torch.as_tensor(rng.random(shape) < 0.7, dtype=dt, device="cuda")
    return x, b, mask


def _latblock_call(fn, mode, x, b, m, out, pk, stream):
    D, R, C = (s - 2 for s in x.shape[1:])
    return lambda: _check(fn(x.data_ptr(), b.data_ptr(), None if m is None else m.data_ptr(), out.data_ptr(), D, R,
                             C, pk.offs_ptr, pk.w_ptr, len(pk), pk.dinv_ptr, 0.6, mode,
                             x.dtype == torch.float64, stream), "lattice3 block")


def _hexblock_call(fn, x, y, mask, K, stream):
    nz, ny, nx = mask.shape
    return lambda: _check(fn(x.data_ptr(), y.data_ptr(), mask.data_ptr(), K.data_ptr(), nx, ny, nz,
                             x.dtype == torch.float64, stream), "hex3 block")


def _s53d_side(pt, n: int, side: str, dt):
    """S5-3D's cell mask of one side at n (the sphere r = 1 in [-1.5,
    1.5]^3) and that side's elasticity cell matrix."""
    from phifem_tpu_torch.models.interface_elasticity import lame
    from phifem_tpu_torch.models.interface_elasticity3 import _elastic_element_matrix
    from phifem_tpu_torch.tagging3 import compute_tags3

    g = pt.Grid3(n, n, n, S53D_BOX, device="cuda")
    tags = compute_tags3(g, lambda x: 1.0 - (x[..., 0] ** 2 + x[..., 1] ** 2 + x[..., 2] ** 2))
    region, E = ((1, 2), 1.0) if side == "in" else ((2, 3), 0.001)
    mask = torch.as_tensor(tags.region_mask(region), dtype=dt, device="cuda").contiguous()
    K = torch.as_tensor(_elastic_element_matrix(*g.spacing, *lame(E, 0.3)), dtype=dt, device="cuda").contiguous()
    return mask, K


def _clocks_under(fn, seconds: float = 1.5) -> str:
    """nvidia-smi's SM clock, its maximum, the power draw and the
    temperature, read halfway through ``seconds`` of ``fn`` back to back."""
    got = {}

    def query():
        time.sleep(seconds / 2)
        got["smi"] = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu",
                                     "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()

    t = threading.Thread(target=query)
    t0 = time.perf_counter()
    t.start()
    while time.perf_counter() - t0 < seconds:
        fn()
    torch.cuda.synchronize()
    t.join()
    return got.get("smi", "?")


def _time(label: str, calls: dict, kernel: str, bound: float, reps: int, floor: float = None,
          clocks: bool = False, also: str = None) -> None:
    names = list(calls)
    ms = {k: [] for k in names}
    dev = {k: [] for k in names}
    for order in (names, names[::-1]):
        for k in order:
            ms[k].append(_event_ms(calls[k], reps))
            dev[k].append(_device_ms(calls[k], reps // 2, kernel, also))
    for k in names:
        best = min(dev[k])
        fl = "" if floor is None else f"; no-FMA floor {floor:.4f}, {floor / best:.1%} of it by dev"
        if clocks and k == names[0]:
            fl += f"; under load clocks.sm, clocks.max.sm, power.draw, temperature: {_clocks_under(calls[k])}"
        print(f"[time] {label:28s} {k:34s} ms {' '.join(f'{v:.4f}' for v in ms[k])} dev "
              f"{' '.join(f'{v:.4f}' for v in dev[k])} "
              f"(bound {bound:.4f}; {bound / best:.1%} by dev, {bound / min(ms[k]):.1%} by ms{fl})")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--save-before")
    ap.add_argument("--commit", default="8441e93")
    ap.add_argument("--before")
    ap.add_argument("--lattice", default=DEFAULT_L3)
    ap.add_argument("--hex", default=DEFAULT_HEX)
    ap.add_argument("--latblock", default=DEFAULT_LB)
    ap.add_argument("--hexblock", default=DEFAULT_HB)
    ap.add_argument("--kernels", default=",".join(KERNELS))
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
    kinds = a.kernels.split(",")
    if not set(kinds) <= set(KERNELS):
        raise SystemExit(f"--kernels: choose from {KERNELS}")
    jobs = {}  # name -> (kind, source, defines)
    variants = {  # kind -> (source, keys, shipped values, variants, defines of a variant)
        "lattice": (cl.SOURCE, L3_KEYS, cl.TILE, a.lattice, lambda t: cl.defines(tile=t)),
        "hex": (cuda_hex3.SOURCE, HEX_KEYS, cuda_hex3.TILE, a.hex, lambda t: cuda_hex3.defines(tile=t)),
        "latblock": (cl.SOURCE, LB_KEYS, cl.BLOCK_TILE, a.latblock, lambda t: cl.defines(block_tile=t)),
        "hexblock": (cuda_hex3.SOURCE, HB_KEYS, cuda_hex3.BLOCK_TILE, a.hexblock,
                     lambda t: cuda_hex3.defines(block_tile=t)),
    }
    for kind in kinds:
        src, keys, shipped, more, defs = variants[kind]
        for v in [",".join(str(shipped[k]) for k in keys)] + more.split():
            if len(v.split(",")) != len(keys):
                raise SystemExit(f"--{kind}: {v} gives {len(v.split(','))} values for {keys}")
            jobs.setdefault(f"{kind} {v}", (kind, src, defs(dict(zip(keys, map(int, v.split(",")))))))
        if a.before:
            jobs[f"{kind} before"] = (kind, Path(a.before) / src.name, ())
    built = {}
    threads = [threading.Thread(target=lambda k=k, j=j: built.__setitem__(k, nvcc_build.build(j[1], j[2])))
               for k, j in jobs.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    libs = {kind: {} for kind in kinds}
    for k, (kind, _, _) in jobs.items():
        if k not in built:
            raise RuntimeError(f"{k}: did not build")
        regs = [l.split("Used ")[1].split(",")[0] for l in built[k]["log"].splitlines() if "Used " in l]
        spill = [l.split(", ")[1] for l in built[k]["log"].splitlines() if "spill stores" in l]
        print(f"[build] {k}: {built[k]['seconds']:.1f} s; registers {' '.join(regs)}; "
              f"spill stores {' / '.join(sorted(set(spill)))}")
        libs[kind][k] = BIND[kind](built[k]["path"])
    lat, hexes = libs.get("lattice", {}), libs.get("hex", {})
    latb, hexb = libs.get("latblock", {}), libs.get("hexblock", {})
    stream = torch.cuda.current_stream().cuda_stream

    # bits
    nbad = 0
    for dt in (torch.float32, torch.float64):
        for shape in ((5, 7, 9), (3, 5, 4), (37, 37, 37), (129, 65, 33)) if lat else ():
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
        for d, mask in hex_cases if hexes else ():
            x, A = _hex_inputs(mask, d, d)
            want = cuda_hex3.hex_stencil3_ref(x, mask, A, d)
            for k, fn in hexes.items():
                y = torch.full_like(x, float("nan"))
                _hex_call(fn, x, y, mask, A, d, stream)()
                torch.cuda.synchronize()
                if not torch.equal(y, want):
                    nbad += 1
                    print(f"[bits] {k} d={d} {tuple(mask.shape)} {dt}: max|d| {float((y - want).abs().max()):.3e}")
        for shape in ((5, 7, 9), (3, 5, 4), (3, 3, 3), (14, 6, 62), (37, 37, 37), (65, 33, 129)) if latb else ():
            x, b, mask = _block_inputs(shape, dt, sum(shape))
            full = _block_terms(shape[0] - 1)
            sets = {"27 terms": full}
            if shape in ((5, 7, 9), (14, 6, 62), (37, 37, 37)):
                sets.update({tn: cl.pack_block_terms([t for t in full if keep(*t[:3])], full.dinv)
                             for tn, keep in PARTIAL.items()})
            for tn, pk in sets.items():
                for mode, name, masked in BLOCK_MODES:
                    m = mask if masked else None
                    want = cl.lattice3_block_sweep_ref(mode, x, pk, b, m, 0.6)
                    for k, fn in latb.items():
                        out = torch.full_like(x, float("nan"))
                        _latblock_call(fn, mode, x, b, m, out, pk, stream)()
                        torch.cuda.synchronize()
                        if not torch.equal(out, want):
                            nbad += 1
                            print(f"[bits] {k} {name} {tn} {shape} {dt}: max|d| "
                                  f"{float((out - want).abs().nan_to_num(float('inf')).max()):.3e}")
        rng = np.random.default_rng(4)
        hb_cases = [(torch.as_tensor(rng.random(sh) < 0.5, dtype=dt, device="cuda"),
                     torch.as_tensor(rng.standard_normal((24, 24)), dtype=dt, device="cuda"))
                    for sh in ((3, 4, 5), (1, 1, 1), (7, 5, 6), (13, 7, 9), (16, 8, 16), (17, 9, 33), (37, 37, 37))]
        hb_cases += [(torch.full((16, 8, 31), v, dtype=dt, device="cuda"), hb_cases[-1][1]) for v in (0.0, 1.0)]
        hb_cases += [_s53d_side(pt, n, side, dt) for n in (32, 64) for side in ("in", "out")] if hexb else []
        for mask, K in hb_cases if hexb else ():
            nz, ny, nx = mask.shape
            x = torch.as_tensor(rng.standard_normal((3, nz + 1, ny + 1, nx + 1)), dtype=dt, device="cuda")
            want = cuda_hex3.hex_block_stencil3_ref(x, mask, K)
            for k, fn in hexb.items():
                y = torch.full_like(x, float("nan"))
                _hexblock_call(fn, x, y, mask, K, stream)()
                torch.cuda.synchronize()
                if not torch.equal(y, want):
                    nbad += 1
                    print(f"[bits] {k} {tuple(mask.shape)} {dt}: max|d| "
                          f"{float((y - want).abs().nan_to_num(float('inf')).max()):.3e}")
    print(f"[bits] every build against the plain versions: {nbad} differences")

    # times
    for n in (128, 256) if lat else ():
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
                       (3, 40, "full"), (1, 128, "empty"), (3, 40, "empty")) if hexes else ():
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
    for n in (128, 64) if latb else ():
        pk = _block_terms(n)
        for dt in (torch.float32, torch.float64):
            x, b, mask = _block_inputs((n + 1,) * 3, dt, n)
            out = torch.empty_like(x)
            ops = 2 * 9 * len(pk) * (n - 1) ** 3
            for mode, name, masked in MODES:
                m = mask if masked else None
                nb = ((2 + (mode != cl.MATVEC)) * x.numel() + (m.numel() if masked else 0)) * x.element_size()
                bound = 1e3 * max(nb / HBM, ops / FLOPS[dt])
                calls = {k: _latblock_call(fn, mode, x, b, m, out, pk, stream) for k, fn in latb.items()}
                _time(f"lat3 block {name} 3x{n + 1}^3 {str(dt)[6:]}", calls, "lattice3_block_kernel", bound, a.reps,
                      1e3 * ops / (FLOPS[dt] / 2), clocks=n == 128)
            del x, b, mask, out
    for side, kind in (("in", "s53d"), ("out", "s53d"), ("in", "full"), ("in", "empty")) if hexb else ():
        for dt in (torch.float64, torch.float32) if kind == "s53d" else (torch.float64,):
            mask, K = _s53d_side(pt, 64, side, dt)
            if kind != "s53d":
                mask = torch.full_like(mask, 1.0 if kind == "full" else 0.0)
            x = torch.as_tensor(np.random.default_rng(5).standard_normal((3,) + (65,) * 3), dtype=dt, device="cuda")
            y = torch.empty_like(x)
            ops = 2 * 24 * 24 * int((mask != 0).sum())
            bound = 1e3 * max((2 * x.numel() + mask.numel()) * x.element_size() / HBM, ops / FLOPS[dt])
            calls = {k: _hexblock_call(fn, x, y, mask, K, stream) for k, fn in hexb.items()}
            _time(f"hex3 block n=64 {side if kind == 's53d' else kind} {str(dt)[6:]}", calls,
                  "hexblock_stencil3_kernel", bound, a.reps, 1e3 * ops / (FLOPS[dt] / 2), clocks=side == "in",
                  also="Memcpy")
    return 1 if nbad else 0


if __name__ == "__main__":
    sys.exit(main())
