"""Smoke run of the PyTorch + CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py

Builds the hand-written CUDA stencil kernel from the checkout, holds it
against its plain PyTorch version on the card (both bodies; the masked one
also timed on the S1 flower's masks at 3200 x 3200), then drives the port's
main paths:

* box Poisson on a 3200 x 3200 triangle grid (10,246,401 vertex DoFs),
  solved by the generic MG-preconditioned CG (float64 CG, float32 V-cycle,
  every stencil matvec through the kernel) and by the lattice-resident
  MG-CG, both to a relative residual of 1e-10;
* the S1 weak-Dirichlet flower (tag, assemble, lattice + cut-band
  preconditioned BiCGStab to 1e-8, and one warm re-tag + reassemble +
  solve iteration) at n=200 (80,802 DoFs, dense interface branch) and at
  n=3200 (20,492,802 DoFs, Schwarz/ELL interface branch), each held
  against the same problem on the CPU.

Every check raises; the script exits non-zero without a result when there
is no card or no checkout.  The line before the last is a JSON record of
the kernels; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEP = "-" * 72
N = 3200  # grid blocks per side: bench.py's poisson_mg problem
SEED = 0  # of the kernel-check inputs
TOL = 1e-10
# The generic solve's TRUE residual b - A x, evaluated in float64, cannot go
# below a floor that grows like n^2: 3.142e-10 at n=3200 on the H100, and
# 1.3e-12, 5.2e-12, 2.05e-11 at n=200, 400, 800 on the CPU (PERF.md).  The
# Krylov loop itself must reach TOL; the true residual is held to the floor.
F64_TRUE_RESIDUAL_FLOOR = 4e-10
N_S1 = 200  # the S1 headline size of bench.py (80,802 DoFs)
S1_TOL = 1e-8
S1_MAX_IT_SMALL = 30  # the JAX package takes 15 at n=200
FLOWER_BOX = ((-4.5, -4.5), (4.5, 4.5))
KNIFE_EDGE = 1e-12  # |phi| at a detection point below which a tag may flip
DEVICE = "cuda"


def _sync_time(fn, *args, **kw):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _warm_runs(fn, reps: int = 5, **kw):
    """Result of the last of ``reps`` synchronized calls, the median wall
    time, and every time."""
    times = []
    for _ in range(reps):
        out, t = _sync_time(fn, **kw)
        times.append(t)
    return out, float(np.median(times)), times


def _fmt(times) -> str:
    return "[" + ", ".join(f"{t:.4f}" for t in times) + "]"


def _event_ms(fn, reps: int) -> float:
    """Mean milliseconds per call, by CUDA events, after one warm-up call."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device() -> str:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[device] torch.cuda: {name} x{torch.cuda.device_count()}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"[device] nvidia-smi name, power.limit: {smi}")
    return name


def phase_build(cs) -> None:
    info = cs.build()
    regs = [l.strip() for l in info["log"].splitlines() if "registers" in l]
    print(f"[build] {info['path']} in {info['seconds']:.2f} s "
          f"({len(regs)} ptxas register reports{': ' + regs[0] if regs else ''})")


def phase_kernel(pt, cs) -> dict:
    """Kernel vs plain on the card: 8 variants at an odd, non-square size,
    and the main path's shapes at N x N; then times at N x N."""
    rng = np.random.default_rng(SEED)
    tol = {torch.float32: 1e-5, torch.float64: 1e-13}
    worst = 0.0
    cases = [(37, 53, ct, masked, dt)
             for ct in ("triangle", "quadrilateral")
             for masked in (True, False)
             for dt in (torch.float32, torch.float64)]
    cases += [(N, N, "triangle", False, dt) for dt in (torch.float32, torch.float64)]
    for nx, ny, ct, masked, dt in cases:
        g = pt.Grid(nx, ny, cell_type=ct, device="cuda", dtype=dt)
        no, nl = g.num_orientations, g.num_vertices_per_cell
        mats = torch.as_tensor(rng.standard_normal((no, nl, nl)), dtype=dt)
        masks = None
        if masked:
            masks = torch.as_tensor(rng.random((no, ny, nx)) < 0.6, dtype=dt, device="cuda")
        x = torch.as_tensor(rng.standard_normal(g.num_vertices), dtype=dt, device="cuda")
        y0 = torch.as_tensor(rng.standard_normal(g.num_vertices), dtype=dt, device="cuda")
        yk = cs.stencil_matvec(g, x, masks, mats, y=y0.clone())
        yr = cs.stencil_matvec_ref(g, x, masks, mats, y=y0.clone())
        torch.cuda.synchronize()
        err = float((yk - yr).abs().max())
        rel = err / float(yr.abs().max())
        worst = max(worst, err)
        ok = rel <= tol[dt]
        print(f"[kernel] {ct:13s} {'masked' if masked else 'maskless':8s} "
              f"{str(dt)[6:]:7s} {nx}x{ny}: max|dy|/max|y| = {rel:.3e} "
              f"(tol {tol[dt]:.0e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"kernel disagrees with plain version: {rel} > {tol[dt]}")

    times = {}
    for dt in (torch.float32, torch.float64):
        g = pt.Grid(N, N, device="cuda", dtype=dt)
        mats = torch.as_tensor(rng.standard_normal((2, 3, 3)), dtype=dt)
        x = torch.as_tensor(rng.standard_normal(g.num_vertices), dtype=dt, device="cuda")
        y = torch.zeros_like(x)
        k_ms = _event_ms(lambda: cs.stencil_matvec(g, x, None, mats, y=y), 50)
        p_ms = _event_ms(lambda: cs.stencil_matvec_ref(g, x, None, mats, y=y), 10)
        gbs = 3 * x.element_size() * g.num_vertices / (k_ms * 1e-3) / 1e9
        times[dt] = (k_ms, p_ms)
        print(f"[kernel] time {str(dt)[6:]} maskless triangle {N}x{N}: kernel "
              f"{k_ms:.4f} ms ({gbs:.0f} GB/s of x+y traffic), plain {p_ms:.4f} ms")

    # the masked body on the S1 bulk-region masks (cells tagged 1|2) of the
    # flower at n=N: the masks the S1 operator and load vector run with
    from phifem_tpu_torch.models import flower
    from phifem_tpu_torch.tagging import tag_cells

    tags = tag_cells(pt.Grid(N, N, FLOWER_BOX, device="cuda"), flower.detection_levelset, 1, True)
    tags = tags.cpu().numpy()
    masked = {}
    for dt in (torch.float32, torch.float64):
        g = pt.Grid(N, N, FLOWER_BOX, device="cuda", dtype=dt)
        b = pt.StencilCellBatch.build(
            g, "u", torch.as_tensor(rng.standard_normal((2, 3, 3)), dtype=dt), tags, (1, 2))
        x = torch.as_tensor(rng.standard_normal(g.num_vertices), dtype=dt, device="cuda")
        yk = cs.stencil_matvec(g, x, b.masks, b.matrices, packed=b.packed)
        yr = cs.stencil_matvec_ref(g, x, b.masks, b.matrices)
        torch.cuda.synchronize()
        err = float((yk - yr).abs().max())
        rel = err / float(yr.abs().max())
        worst = max(worst, err)
        print(f"[kernel] triangle masked {str(dt)[6:]:7s} {N}x{N} flower masks "
              f"({float(b.masks.mean()):.3f} of cells set): max|dy|/max|y| = {rel:.3e} "
              f"(tol {tol[dt]:.0e}) {'ok' if rel <= tol[dt] else 'FAIL'}")
        if rel > tol[dt]:
            raise AssertionError(f"masked kernel disagrees with plain version: {rel} > {tol[dt]}")
        y = torch.zeros_like(x)
        k_ms = _event_ms(lambda: cs.stencil_matvec(g, x, b.masks, b.matrices, y=y, packed=b.packed), 50)
        p_ms = _event_ms(lambda: cs.stencil_matvec_ref(g, x, b.masks, b.matrices, y=y), 10)
        masked[dt] = (k_ms, p_ms)
        print(f"[kernel] time {str(dt)[6:]} masked triangle {N}x{N}: kernel {k_ms:.4f} ms, "
              f"plain {p_ms:.4f} ms")
    return {
        "name": "stencil_matvec",
        "route": "cuda",
        "source": "phifem_tpu_torch/csrc/stencil_matvec.cu",
        "replaces": "phifem_tpu/ops/pallas_stencil.py:124",
        "max_abs_err": worst,
        "ms": times[torch.float32][0],
        "plain_ms": times[torch.float32][1],
        "ms_f64": times[torch.float64][0],
        "plain_ms_f64": times[torch.float64][1],
        "shape": f"{N}x{N} triangle maskless",
        "masked_ms": masked[torch.float32][0],
        "masked_plain_ms": masked[torch.float32][1],
        "masked_ms_f64": masked[torch.float64][0],
        "masked_plain_ms_f64": masked[torch.float64][1],
        "masked_shape": f"{N}x{N} triangle, S1 flower masks",
    }


def _problem(pt):
    g = pt.Grid(N, N, ((0.0, 0.0), (1.0, 1.0)), pt.CellType.triangle, device="cuda")
    uex = lambda x: torch.sin(math.pi * x[..., 0]) * torch.sin(math.pi * x[..., 1])
    f = lambda x: 2.0 * math.pi**2 * uex(x)
    return g, uex, f


def phase_generic(pt):
    g, uex, f = _problem(pt)
    s = pt.BoxPoisson(g)
    _, t_setup = _sync_time(s.setup, f)
    _, t_asm = _sync_time(s.assemble)
    vc, t_mg = _sync_time(s.mg_preconditioner, dtype=torch.float32)
    kw = dict(method="cg", tol=TOL, maxiter=60, precond=vc)
    _, t_cold = _sync_time(s.solve, **kw)
    r, t_warm, runs = _warm_runs(s.solve, **kw)
    ndofs = s.system.num_dofs
    err = float((r.x["u"] - pt.interpolate(uex, s.V).data).abs().max())
    h = 1.0 / N
    print(f"[generic] n={N} ndofs={ndofs} levels={len(vc.levels)}: setup {t_setup:.3f} s, "
          f"assemble {t_asm:.3f} s, mg setup {t_mg:.3f} s, solve cold {t_cold:.3f} s / warm "
          f"median {t_warm:.4f} s of {_fmt(runs)}, {r.iterations} it, recurrence relres "
          f"{r.recurrence:.3e}, true relres {r.residual:.3e} (floor bound "
          f"{F64_TRUE_RESIDUAL_FLOOR:.0e}), {ndofs / t_warm / 1e6:.2f} MDoF/s, max nodal err "
          f"{err:.3e} (5h^2 {5 * h * h:.3e})")
    if not (r.recurrence <= TOL and r.residual <= F64_TRUE_RESIDUAL_FLOOR):
        raise AssertionError(
            f"generic solve: recurrence relres {r.recurrence}, true relres {r.residual}")
    if err > 5 * h * h:
        raise AssertionError(f"generic solve error {err} > 5h^2")
    return s, r


def phase_lattice(pt, s, r_gen):
    _, uex, _ = _problem(pt)
    mg, t_mg = _sync_time(s.lattice_solver, min_n=16, dtype=torch.float32)
    _, t_cold = _sync_time(s.solve_lattice, tol=TOL, maxiter=40, mg=mg)
    r, t_warm, runs = _warm_runs(s.solve_lattice, tol=TOL, maxiter=40, mg=mg)
    ndofs = s.system.num_dofs
    err = float((r.x["u"] - pt.interpolate(uex, s.V).data).abs().max())
    diff = float((r.x["u"] - r_gen.x["u"]).abs().max() / r_gen.x["u"].abs().max())
    h = 1.0 / N
    print(f"[lattice] n={N} levels={len(mg.levels)}: mg setup {t_mg:.3f} s, solve cold "
          f"{t_cold:.3f} s / warm median {t_warm:.4f} s of {_fmt(runs)}, {r.iterations} it, relres "
          f"{r.residual:.3e}, {ndofs / t_warm / 1e6:.2f} MDoF/s, max nodal err "
          f"{err:.3e}, max|u_lat - u_gen|/max|u_gen| {diff:.3e}")
    if not (r.converged and r.residual <= TOL and r.iterations <= 12):
        raise AssertionError(f"lattice solve: converged={r.converged} it={r.iterations}")
    if err > 5 * h * h:
        raise AssertionError(f"lattice solve error {err} > 5h^2")
    if diff > 1e-8:
        raise AssertionError(f"lattice and generic solutions differ: {diff}")


def _flower_s1(pt, n: int, device: str):
    """bench.py's S1 flower scheme at n x n, set up (tagged) on ``device``."""
    from phifem_tpu_torch.models import flower

    g = pt.Grid(n, n, FLOWER_BOX, pt.CellType.triangle, device=device)
    s = pt.WeakDirichletPoisson(g, mode="bg", detection_degree=1, single_layer_cut=True)
    return s.setup(flower.levelset, flower.source_term, detection_levelset=flower.detection_levelset)


def _band(vc) -> str:
    if vc.interface_inv is not None:
        return f"dense interface branch, m={vc.interface_ids.numel()}"
    return (f"Schwarz/ELL interface branch, m={vc.band_ids.numel()}, "
            f"{vc.schwarz_ids.shape[0]} blocks of <= {vc.schwarz_ids.shape[1]}, "
            f"schwarz_sweeps={vc.schwarz_sweeps}")


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.cpu() - b.cpu()).abs().max() / b.abs().max().cpu())


def _check_tags(s, h) -> None:
    """Card tags equal the CPU lane's, except at knife-edge cells (|phi| <=
    KNIFE_EDGE at a detection point, where rounding decides the sign) and
    at the facets next to them."""
    from phifem_tpu_torch import levelset as lsm
    from phifem_tpu_torch.models import flower

    bad = np.where(s.cell_tags != h.cell_tags)[0]
    g = h.grid
    if bad.size:
        vals = lsm.evaluate_on_cells(g, flower.detection_levelset, lsm.detection_points(g.cell_type, 1),
                                     torch.as_tensor(bad))
        if float(vals.abs().min(dim=1).values.max()) > KNIFE_EDGE:
            raise AssertionError(f"cell tags differ off the knife edge at {bad[:10]}")
    fbad = np.where(s.facet_tags != h.facet_tags)[0]
    if fbad.size and not np.isin(g.f2c_of_np(fbad), bad).any(axis=1).all():
        raise AssertionError(f"facet tags differ away from knife-edge cells at {fbad[:10]}")
    print(f"[s1 n={g.nx}] tags: {bad.size} cell and {fbad.size} facet tags differ from the CPU lane "
          f"(allowed only at knife-edge cells, |phi| <= {KNIFE_EDGE:.0e})")


def _against_cpu(s, h) -> dict:
    """Largest relative differences of the card's load vector and of its
    operator applied to a seeded random x from the CPU lane's."""
    rng = np.random.default_rng(SEED)
    x = {k: torch.as_tensor(rng.standard_normal(v.shape)) for k, v in h.b.items()}
    yc = s.op.matvec({k: v.to(DEVICE) for k, v in x.items()})
    yh = h.op.matvec(x)
    return {
        "b": max(_rel(s.b[k], h.b[k]) for k in h.b),
        "matvec": max(_rel(yc[k], yh[k]) for k in yh),
    }


def phase_s1_small(pt, cs) -> int:
    """Phase 6: S1 at n=200 on the card, held against the CPU lane."""
    kw = dict(method="bicgstab", tol=S1_TOL, maxiter=60)
    s, t_tag = _sync_time(_flower_s1, pt, N_S1, DEVICE)
    _, t_asm = _sync_time(s.assemble)
    vc, t_mg = _sync_time(s.lattice_preconditioner, min_n=13)
    _, t_cold = _sync_time(s.solve, precond=vc, **kw)
    r, t_warm, runs = _warm_runs(s.solve, reps=3, precond=vc, **kw)

    def pipeline():
        # bench.py's warm convergence-loop iteration: re-tag (the host tags
        # are how a caller sees a topology change), reassemble, solve
        from phifem_tpu_torch.models import flower

        res = pt.compute_tags_measures(s.grid, flower.detection_levelset, 1, box_mode=True,
                                       single_layer_cut=True)
        res.cells_tags.as_numpy()
        s.op.reassemble()
        return s.solve(precond=vc, **kw)

    pipeline()
    r_pipe, t_pipe = _sync_time(pipeline)
    launches, masked = cs.launches, cs.masked_launches
    ndofs = s.system.num_dofs
    print(f"[s1 n={N_S1}] ndofs={ndofs}: tag {t_tag:.3f} s, assemble {t_asm:.3f} s, "
          f"lattice_preconditioner(min_n=13) {t_mg:.3f} s ({_band(vc)}), solve cold {t_cold:.3f} s "
          f"/ warm median {t_warm:.4f} s of {_fmt(runs)}, {r.iterations} it, recurrence relres "
          f"{r.recurrence:.3e}, true relres {r.residual:.3e}; warm pipeline (re-tag + "
          f"reassemble + solve) {t_pipe:.4f} s, {r_pipe.iterations} it; stencil launches "
          f"{launches}, of them masked {masked}")

    # the same problem on the CPU (plain versions), as a check
    t0 = time.perf_counter()
    h = _flower_s1(pt, N_S1, "cpu").assemble()
    rh = h.solve(precond=h.lattice_preconditioner(min_n=13), **kw)
    _check_tags(s, h)
    errs = _against_cpu(s, h)
    errs["u"] = _rel(r.x["u"], rh.x["u"])
    m = s.boundary_measure()
    L = m.lengths
    closure = float((m.normals * L[:, None]).sum(0).abs().max() / L.sum())
    print(f"[s1 n={N_S1}] against the CPU lane ({time.perf_counter() - t0:.1f} s; CPU solve "
          f"{rh.iterations} it): max rel diff b {errs['b']:.3e} (tol 1e-12), operator matvec "
          f"{errs['matvec']:.3e} (tol 1e-12), u {errs['u']:.3e} (tol 1e-6); Gamma_h closure "
          f"|sum n dL| / sum dL = {closure:.3e} (tol 1e-12)")
    if errs["b"] > 1e-12 or errs["matvec"] > 1e-12 or errs["u"] > 1e-6:
        raise AssertionError(f"S1 on the card disagrees with the CPU lane: {errs}")
    if closure > 1e-12:
        raise AssertionError(f"Gamma_h measure does not close: {closure}")
    if vc.interface_inv is None:
        raise AssertionError(f"S1 n={N_S1} should take the dense interface branch")
    for res in (r, r_pipe):
        if not (res.recurrence <= S1_TOL and res.iterations <= S1_MAX_IT_SMALL):
            raise AssertionError(
                f"S1 n={N_S1} solve: recurrence {res.recurrence}, {res.iterations} iterations")
    if masked <= 0:
        raise AssertionError(f"S1 n={N_S1} never launched the masked stencil kernel")
    return launches


def phase_s1_large(pt, cs) -> int:
    """Phase 7: S1 at n=N (bench.py's reassemble_large problem) on the card:
    the Schwarz/ELL interface branch."""
    torch.cuda.reset_peak_memory_stats()
    s, t_tag = _sync_time(_flower_s1, pt, N, DEVICE)
    _, t_asm = _sync_time(s.assemble)
    s.op.reassemble()
    _, t_reasm, reasm_runs = _warm_runs(s.op.reassemble, reps=3)
    vc, t_mg = _sync_time(s.lattice_preconditioner, min_n=13)
    kw = dict(method="bicgstab", tol=S1_TOL, maxiter=200, precond=vc)
    r0, t_cold = _sync_time(s.solve, **kw)
    r, t_warm, runs = _warm_runs(s.solve, reps=3, **kw)
    launches, masked = cs.launches, cs.masked_launches
    ndofs = s.system.num_dofs
    print(f"[s1 n={N}] ndofs={ndofs}: tag {t_tag:.3f} s, assemble {t_asm:.3f} s, warm "
          f"reassemble median {t_reasm:.4f} s of {_fmt(reasm_runs)}, "
          f"lattice_preconditioner(min_n=13) {t_mg:.3f} s ({_band(vc)})")
    print(f"[s1 n={N}] bicgstab tol {S1_TOL:.0e}: cold {t_cold:.3f} s ({r0.iterations} it), warm "
          f"median {t_warm:.4f} s of {_fmt(runs)}, {r.iterations} it, recurrence relres "
          f"{r.recurrence:.3e}, true relres {r.residual:.3e}, {ndofs / t_warm / 1e6:.2f} MDoF/s; "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; stencil "
          f"launches {launches}, of them masked {masked}")

    # the same operator and load vector on the CPU (plain stencil, cut
    # entities assembled by the host), as a check of the tables at this size
    t0 = time.perf_counter()
    h = _flower_s1(pt, N, "cpu").assemble()
    _check_tags(s, h)
    errs = _against_cpu(s, h)
    print(f"[s1 n={N}] against the CPU lane ({time.perf_counter() - t0:.1f} s): max rel diff b "
          f"{errs['b']:.3e} (tol 1e-12), operator matvec {errs['matvec']:.3e} (tol 1e-12)")
    if errs["b"] > 1e-12 or errs["matvec"] > 1e-12:
        raise AssertionError(f"S1 n={N} on the card disagrees with the CPU lane: {errs}")
    if vc.schwarz_inv is None:
        raise AssertionError(f"S1 n={N} should take the Schwarz/ELL interface branch")
    for res in (r0, r):
        if not (res.recurrence <= S1_TOL and res.residual <= 2 * S1_TOL):
            raise AssertionError(
                f"S1 n={N} solve: recurrence {res.recurrence}, true relres {res.residual} after "
                f"{res.iterations} iterations")
    if masked <= 0:
        raise AssertionError(f"S1 n={N} never launched the masked stencil kernel")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2

    here = Path(__file__).resolve().parent
    sys.path.insert(0, str(here))
    import phifem_tpu_torch as pt
    from phifem_tpu_torch.ops import cuda_stencil as cs

    if Path(pt.__file__).resolve().parent.parent != here:
        raise RuntimeError(f"phifem_tpu_torch imported from {pt.__file__}, not this checkout")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print(SEP)
    name = phase_device()
    phase_build(cs)
    kernel = phase_kernel(pt, cs)

    # each main path counts its own launches, from 0 just before it
    cs.launches = cs.masked_launches = 0
    s, r_gen = phase_generic(pt)
    phase_lattice(pt, s, r_gen)
    poisson = cs.launches
    del s, r_gen
    cs.launches = cs.masked_launches = 0
    s1_small = phase_s1_small(pt, cs)
    cs.launches = cs.masked_launches = 0
    s1_large = phase_s1_large(pt, cs)
    kernel["launches"] = poisson + s1_small + s1_large
    kernel["s1_launches"] = s1_small + s1_large
    print(f"[main path] stencil_matvec kernel launches: box Poisson {poisson}, S1 n={N_S1} "
          f"{s1_small}, S1 n={N} {s1_large}")
    if min(poisson, s1_small, s1_large) <= 0:
        raise AssertionError("a main path never launched the stencil kernel")

    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
