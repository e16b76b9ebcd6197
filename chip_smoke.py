"""Smoke run of the PyTorch + CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py

Builds the two hand-written CUDA kernels from the checkout (one nvcc per
source, in parallel), holds the stencil kernel against its plain PyTorch
version on the card (both bodies, both cell types; the masked one also
timed on the S1 flower's masks at 3200 x 3200), then drives the port's
main paths, each through the schemes' setup -> assemble -> solve:

* box Poisson on a 3200 x 3200 triangle grid (10,246,401 vertex DoFs),
  solved by the generic MG-preconditioned CG (float64 CG, float32 V-cycle,
  every stencil matvec through the kernel) and by the lattice-resident
  MG-CG, both to a relative residual of 1e-10;
* the S1 weak-Dirichlet flower (tag, assemble, lattice + cut-band
  preconditioned BiCGStab to 1e-8, and one warm re-tag + reassemble +
  solve iteration) at n=200 (80,802 DoFs, dense interface branch) and at
  n=3200 (20,492,802 DoFs, Schwarz/ELL interface branch), each held
  against the same problem on the CPU; every operator matvec runs the
  tap kernel;
* the tap kernel against its plain version, float64 and float32, on the
  tap forms of S1 at n=3200 and of S4 at n=1600 (12.8M DoFs, tag and
  assemble only), timed;
* S2 (strong Dirichlet, the flower, n=200, bg and sub mode): default
  BiCGStab and BiCGStab with ``mg_preconditioner()``; S3 (Neumann, tilted
  square, quadrilaterals): tag, assemble and tap form at n=200, BiCGStab
  with ``lattice_preconditioner()`` at n=100; S4 (Robin, tilted square,
  triangles, n=200): BiCGStab with ``lattice_preconditioner()`` and with
  ``mg_preconditioner()``; each held against the same problem on the CPU
  and against the JAX package's iteration counts and H1 errors.

Every check raises; the script exits non-zero without a result when there
is no card or no checkout.  The line before the last is a JSON record of
the kernels; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import threading
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
SQUARE_BOX = ((-1.0, -1.0), (1.0, 1.0))
N_S4_TAPS = 1600  # the S4 tap form the tap kernel is timed on (12.8M DoFs)
SCHEME_TOL = 1e-10  # the demos' BiCGStab tolerance
# the JAX package on the CPU, the demos' configurations (bg mode, detection
# degree 1, tol 1e-10): S2 n=200 default BiCGStab 505 it; S3 quads n=100
# lattice 38 it, H1 0.05465; S4 n=200 lattice 158 it, H1 0.02715, mg 11 it
JAX_S2_IT, JAX_S3_IT, JAX_S4_IT = 505, 38, 158
JAX_S3_H1, JAX_S4_H1 = 0.05465, 0.02715
S2_MG_MAX_IT, S4_MG_MAX_IT = 10, 20


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


def phase_build(*mods) -> None:
    """Build every kernel library at once: one nvcc process per source."""
    out = {}
    threads = [threading.Thread(target=lambda m=m: out.__setitem__(m, m.build())) for m in mods]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for m in mods:
        if m not in out:
            raise RuntimeError(f"{m.__name__}: the kernel did not build")
        info = out[m]
        regs = [l.strip() for l in info["log"].splitlines() if "registers" in l]
        print(f"[build] {info['path']} in {info['seconds']:.2f} s "
              f"({len(regs)} ptxas register reports{': ' + regs[0] if regs else ''})")
    print(f"[build] all kernels in {time.perf_counter() - t0:.2f} s")


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

    # both bodies on quadrilaterals (S3's bulk), at N x N, random masks
    quad = {}
    for dt in (torch.float32, torch.float64):
        g = pt.Grid(N, N, device="cuda", dtype=dt, cell_type="quadrilateral")
        mats = torch.as_tensor(rng.standard_normal((1, 4, 4)), dtype=dt)
        x = torch.as_tensor(rng.standard_normal(g.num_vertices), dtype=dt, device="cuda")
        y = torch.zeros_like(x)
        for body, masks in (("masked", torch.as_tensor(rng.random((1, N, N)) < 0.5, dtype=dt,
                                                      device="cuda")), ("maskless", None)):
            k_ms = _event_ms(lambda: cs.stencil_matvec(g, x, masks, mats, y=y), 50)
            p_ms = _event_ms(lambda: cs.stencil_matvec_ref(g, x, masks, mats, y=y), 10)
            quad[body, dt] = (k_ms, p_ms)
            print(f"[kernel] time {str(dt)[6:]} {body} quadrilateral {N}x{N}: kernel {k_ms:.4f} ms, "
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
        **{f"{body}_quad_{what}{sfx}": quad[body, dt][i]
           for body in ("masked", "maskless")
           for dt, sfx in ((torch.float32, ""), (torch.float64, "_f64"))
           for i, what in enumerate(("ms", "plain_ms"))},
    }


def _tap_kernel_check(ct, top, label: str) -> dict:
    """The tap kernel against its plain version on ``top`` (its own W, a
    seeded random x), float64 and float32, then both timed by CUDA events.
    Returns ``{dtype: (max rel diff, max abs diff, kernel ms, plain ms)}``."""
    rng = np.random.default_rng(SEED)
    tol = {torch.float32: 1e-5, torch.float64: 1e-13}
    out = {}
    for dt in (torch.float64, torch.float32):
        W = top.W.to(dt)
        x = {sp.name: torch.as_tensor(
                rng.standard_normal((sp.shape[0] * sp.shape[1] * sp.nblocks,) + sp.vshape),
                dtype=dt, device=top.W.device) for sp in top.specs}
        yk = ct.tap_matvec(top, W, x)
        yr = ct.tap_matvec_ref(top, W, x)
        torch.cuda.synchronize()
        err = max(float((yk[k] - yr[k]).abs().max()) for k in yr)
        rel = err / max(float(yr[k].abs().max()) for k in yr)
        k_ms = _event_ms(lambda: ct.tap_matvec(top, W, x), 20)
        p_ms = _event_ms(lambda: ct.tap_matvec_ref(top, W, x), 3)
        nbytes = (W.numel() + 2 * sum(v.numel() for v in x.values())) * W.element_size()
        out[dt] = (rel, err, k_ms, p_ms)
        print(f"[taps {label}] {str(dt)[6:]}: {top.num_taps} taps, {top.num_weights} weights; "
              f"max|dy|/max|y| = {rel:.3e} (tol {tol[dt]:.0e}) {'ok' if rel <= tol[dt] else 'FAIL'}; "
              f"kernel {k_ms:.4f} ms ({nbytes / (k_ms * 1e-3) / 1e9:.0f} GB/s of W+x+y traffic), "
              f"plain {p_ms:.4f} ms")
        if rel > tol[dt]:
            raise AssertionError(f"tap kernel disagrees with plain version on {label}: {rel} > {tol[dt]}")
        del W, x, yk, yr
    return out


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


def _check_tags(s, h, detection_levelset=None, label="s1") -> None:
    """Card tags equal the CPU lane's, except at knife-edge cells (|phi| <=
    KNIFE_EDGE at a detection point, where rounding decides the sign) and
    at the facets next to them."""
    from phifem_tpu_torch import levelset as lsm
    from phifem_tpu_torch.models import flower

    if detection_levelset is None:
        detection_levelset = flower.detection_levelset
    bad = np.where(s.cell_tags != h.cell_tags)[0]
    g = h.grid
    if bad.size:
        vals = lsm.evaluate_on_cells(g, detection_levelset, lsm.detection_points(g.cell_type, 1),
                                     torch.as_tensor(bad))
        if float(vals.abs().min(dim=1).values.max()) > KNIFE_EDGE:
            raise AssertionError(f"cell tags differ off the knife edge at {bad[:10]}")
    fbad = np.where(s.facet_tags != h.facet_tags)[0]
    if fbad.size and not np.isin(g.f2c_of_np(fbad), bad).any(axis=1).all():
        raise AssertionError(f"facet tags differ away from knife-edge cells at {fbad[:10]}")
    print(f"[{label} n={g.nx}] tags: {bad.size} cell and {fbad.size} facet tags differ from the CPU lane "
          f"(allowed only at knife-edge cells, |phi| <= {KNIFE_EDGE:.0e})")


def _against_cpu(s, h) -> dict:
    """Largest relative differences of the card's load vector, of its
    operator (entity batches) and of its tap form (the tap kernel) applied
    to a seeded random x, from the CPU lane's operator."""
    rng = np.random.default_rng(SEED)
    x = {k: torch.as_tensor(rng.standard_normal(v.shape)) for k, v in h.b.items()}
    xc = {k: v.to(DEVICE) for k, v in x.items()}
    yc = s.op.matvec(xc)
    yt = s.op.lattice_form().make_matvec(s.op)(xc)
    yh = h.op.matvec(x)
    return {
        "b": max(_rel(s.b[k], h.b[k]) for k in h.b),
        "matvec": max(_rel(yc[k], yh[k]) for k in yh),
        "tap_matvec": max(_rel(yt[k], yh[k]) for k in yh),
    }


def _hold(label: str, errs: dict, tol_u: float = 1e-6) -> None:
    """Raise unless b and the matvecs agree with the CPU lane to 1e-12 and
    the solution (where compared) to ``tol_u``."""
    print(f"[{label}] against the CPU lane: max rel diff "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (tol 1e-12; solution {tol_u:.0e})")
    for k, v in errs.items():
        if v > (tol_u if k in ("u", "w") else 1e-12):
            raise AssertionError(f"{label} on the card disagrees with the CPU lane: {errs}")


def phase_s1_small(pt, cs) -> dict:
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
    counts = _counts(cs)  # the path's own launches, before the CPU-lane check
    ndofs = s.system.num_dofs
    print(f"[s1 n={N_S1}] ndofs={ndofs}: tag {t_tag:.3f} s, assemble {t_asm:.3f} s, "
          f"lattice_preconditioner(min_n=13) {t_mg:.3f} s ({_band(vc)}), solve cold {t_cold:.3f} s "
          f"/ warm median {t_warm:.4f} s of {_fmt(runs)}, {r.iterations} it, recurrence relres "
          f"{r.recurrence:.3e}, true relres {r.residual:.3e}; warm pipeline (re-tag + "
          f"reassemble + solve) {t_pipe:.4f} s, {r_pipe.iterations} it; launches {counts}")

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
    print(f"[s1 n={N_S1}] CPU lane {time.perf_counter() - t0:.1f} s, CPU solve {rh.iterations} it; "
          f"Gamma_h closure |sum n dL| / sum dL = {closure:.3e} (tol 1e-12)")
    _hold(f"s1 n={N_S1}", errs)
    if closure > 1e-12:
        raise AssertionError(f"Gamma_h measure does not close: {closure}")
    if vc.interface_inv is None:
        raise AssertionError(f"S1 n={N_S1} should take the dense interface branch")
    for res in (r, r_pipe):
        if not (res.recurrence <= S1_TOL and res.iterations <= S1_MAX_IT_SMALL):
            raise AssertionError(
                f"S1 n={N_S1} solve: recurrence {res.recurrence}, {res.iterations} iterations")
    if counts["masked"] <= 0:
        raise AssertionError(f"S1 n={N_S1} never launched the masked stencil kernel")
    return counts


def phase_s1_large(pt, cs):
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
    counts = _counts(cs)  # the path's own launches, before the CPU-lane check
    ndofs = s.system.num_dofs
    top = s.op.lattice_form()
    print(f"[s1 n={N}] ndofs={ndofs}: tag {t_tag:.3f} s, assemble {t_asm:.3f} s, warm "
          f"reassemble median {t_reasm:.4f} s of {_fmt(reasm_runs)}, "
          f"lattice_preconditioner(min_n=13) {t_mg:.3f} s ({_band(vc)})")
    print(f"[s1 n={N}] bicgstab tol {S1_TOL:.0e}: cold {t_cold:.3f} s ({r0.iterations} it), warm "
          f"median {t_warm:.4f} s of {_fmt(runs)}, {r.iterations} it, recurrence relres "
          f"{r.recurrence:.3e}, true relres {r.residual:.3e}, {ndofs / t_warm / 1e6:.2f} MDoF/s; "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
          f"{counts}; tap form {top.num_taps} taps, {top.num_weights} weights")

    # the same operator and load vector on the CPU (plain stencil, cut
    # entities assembled by the host), as a check of the tables at this size
    t0 = time.perf_counter()
    h = _flower_s1(pt, N, "cpu").assemble()
    _check_tags(s, h)
    errs = _against_cpu(s, h)
    print(f"[s1 n={N}] CPU lane {time.perf_counter() - t0:.1f} s")
    _hold(f"s1 n={N}", errs)
    del h
    if vc.schwarz_inv is None:
        raise AssertionError(f"S1 n={N} should take the Schwarz/ELL interface branch")
    for res in (r0, r):
        if not (res.recurrence <= S1_TOL and res.residual <= 2 * S1_TOL):
            raise AssertionError(
                f"S1 n={N} solve: recurrence {res.recurrence}, true relres {res.residual} after "
                f"{res.iterations} iterations")
    if counts["masked"] <= 0:
        raise AssertionError(f"S1 n={N} never launched the masked stencil kernel")
    return counts, s


def _taps():
    from phifem_tpu_torch.ops import cuda_taps

    return cuda_taps


def _reset(cs) -> None:
    """Every kernel count to 0, just before a main path."""
    cs.launches = cs.masked_launches = 0
    _taps().launches = 0


def _counts(cs) -> dict:
    return {"stencil": cs.launches, "masked": cs.masked_launches, "taps": _taps().launches}


def _within(it: int, ref: int) -> bool:
    """At most max(3, 25%) more iterations than the JAX package's count."""
    return it <= ref + max(3, 0.25 * ref)


def _flower_s2(pt, n: int, device: str, mode: str):
    """The strong-Dirichlet demo's flower (detection degree 1) at n x n."""
    from phifem_tpu_torch.models import flower

    g = pt.Grid(n, n, FLOWER_BOX, pt.CellType.triangle, device=device)
    s = pt.StrongDirichletPoisson(g, mode=mode, detection_degree=1)
    return s.setup(flower.levelset, flower.source_term, detection_levelset=flower.detection_levelset)


def _square(pt, scheme: str, n: int, device: str):
    """The Neumann demo (S3, quadrilaterals) or the Robin demo (S4,
    triangles) on the tilted square at n x n, P2 level set."""
    from phifem_tpu_torch.models import neumann_square as nsq
    from phifem_tpu_torch.models import robin_square as rsq

    if scheme == "s3":
        g = pt.Grid(n, n, SQUARE_BOX, pt.CellType.quadrilateral, device=device)
        s = pt.NeumannPoisson(g, mode="bg", detection_degree=1, levelset_degree=2)
        return s.setup(nsq.levelset, nsq.source_term, nsq.neumann_data,
                       detection_levelset=nsq.detection_levelset), nsq
    g = pt.Grid(n, n, SQUARE_BOX, pt.CellType.triangle, device=device)
    s = pt.RobinPoisson(g, mode="bg", detection_degree=1, levelset_degree=2, robin_coef=rsq.robin_coef)
    return s.setup(rsq.levelset, rsq.source_term, rsq.robin_data,
                   detection_levelset=rsq.detection_levelset), rsq


def phase_s2(pt, cs, mode: str) -> dict:
    """S2 at n=200 (the demo's flower), default BiCGStab and BiCGStab with
    mg_preconditioner(), held against the CPU lane."""
    from phifem_tpu_torch.models import flower

    label = f"s2 {mode}"
    s, t_tag = _sync_time(_flower_s2, pt, N_S1, DEVICE, mode)
    _, t_asm = _sync_time(s.assemble)
    top, t_taps = _sync_time(s.op.lattice_form)
    r, t_solve = _sync_time(s.solve, tol=SCHEME_TOL)
    r_warm, t_warm = _sync_time(s.solve, tol=SCHEME_TOL)
    vc, t_mg = _sync_time(s.mg_preconditioner)
    r_mg, t_mg_solve = _sync_time(s.solve, tol=SCHEME_TOL, precond=vc)
    r_mg2, t_mg_warm = _sync_time(s.solve, tol=SCHEME_TOL, precond=vc)
    counts = _counts(cs)
    print(f"[{label} n={N_S1}] ndofs={s.system.num_dofs}: tag {t_tag:.3f} s, assemble {t_asm:.3f} s, "
          f"tap form {t_taps:.3f} s ({top.num_taps} taps, {top.num_weights} weights); default "
          f"bicgstab {r.iterations} it (JAX {JAX_S2_IT}), relres {r.residual:.3e}, cold {t_solve:.3f} s, "
          f"warm {t_warm:.4f} s; mg_preconditioner() {t_mg:.3f} s ({len(vc.levels)} levels, "
          f"{_band(vc)}): {r_mg.iterations} it (JAX 5), relres {r_mg.residual:.3e}, cold "
          f"{t_mg_solve:.3f} s, warm {t_mg_warm:.4f} s; launches {counts}")
    t0 = time.perf_counter()
    h = _flower_s2(pt, N_S1, "cpu", mode).assemble()
    rh = h.solve(tol=SCHEME_TOL)
    _check_tags(s, h, flower.detection_levelset, label)
    errs = _against_cpu(s, h)
    errs["w"] = _rel(r.x["w"], rh.x["w"])
    errs["u"] = _rel(s.phi_h.data * r.x["w"], h.phi_h.data * rh.x["w"])  # u_h = phi_h w_h (P1)
    print(f"[{label}] CPU lane {time.perf_counter() - t0:.1f} s, CPU solve {rh.iterations} it")
    _hold(label, errs)
    for res in (r, r_warm):
        if not (res.converged and res.recurrence <= SCHEME_TOL and _within(res.iterations, JAX_S2_IT)):
            raise AssertionError(f"{label} default solve: {res.iterations} it, recurrence {res.recurrence}")
    for res in (r_mg, r_mg2):
        if not (res.converged and res.iterations <= S2_MG_MAX_IT):
            raise AssertionError(f"{label} mg solve: {res.iterations} it, relres {res.residual}")
    return counts


def phase_s3(pt, cs) -> dict:
    """S3 on quadrilaterals: tag, assemble and tap form at n=200 against the
    CPU lane; lattice-preconditioned BiCGStab at n=100, whose launches are
    the ones returned."""
    from phifem_tpu_torch.models import neumann_square as nsq

    (s, _), t_tag = _sync_time(_square, pt, "s3", N_S1, DEVICE)
    _, t_asm = _sync_time(s.assemble)
    top, t_taps = _sync_time(s.op.lattice_form)
    print(f"[s3 n={N_S1}] ndofs={s.system.num_dofs}: tag {t_tag:.3f} s, assemble {t_asm:.3f} s, "
          f"tap form {t_taps:.3f} s ({top.num_taps} taps, {top.num_weights} weights)")
    t0 = time.perf_counter()
    h, _ = _square(pt, "s3", N_S1, "cpu")
    h.assemble()
    _check_tags(s, h, nsq.detection_levelset, "s3")
    errs = _against_cpu(s, h)
    print(f"[s3 n={N_S1}] CPU lane {time.perf_counter() - t0:.1f} s")
    _hold(f"s3 n={N_S1}", errs)
    del s, h

    # the path's own launches: from 0 after the n=200 check's matvecs
    _reset(cs)
    n = N_S1 // 2
    (s, _), t_tag = _sync_time(_square, pt, "s3", n, DEVICE)
    _, t_asm = _sync_time(s.assemble)
    vc, t_pre = _sync_time(s.lattice_preconditioner)
    r, t_cold = _sync_time(s.solve, tol=SCHEME_TOL, precond=vc)
    r2, t_warm = _sync_time(s.solve, tol=SCHEME_TOL, precond=vc)
    err = s.l2_h1_errors(s.u_h, nsq.exact_solution)
    counts = _counts(cs)
    print(f"[s3 n={n}] ndofs={s.system.num_dofs}: tag {t_tag:.3f} s, assemble {t_asm:.3f} s, "
          f"lattice_preconditioner() {t_pre:.3f} s ({_band(vc)}); bicgstab {r.iterations} it (JAX "
          f"{JAX_S3_IT}), relres {r.residual:.3e}, cold {t_cold:.3f} s, warm {t_warm:.4f} s; relative "
          f"H1 error {err['h1']:.5f} (JAX {JAX_S3_H1}), L2 {err['l2']:.3e}; launches {counts}")
    for res in (r, r2):
        if not (res.converged and res.recurrence <= SCHEME_TOL and _within(res.iterations, JAX_S3_IT)):
            raise AssertionError(f"s3 n={n} solve: {res.iterations} it, recurrence {res.recurrence}")
    if err["h1"] > 1.01 * JAX_S3_H1:
        raise AssertionError(f"s3 n={n}: H1 error {err['h1']} > 1.01 x {JAX_S3_H1}")
    return counts


def phase_s4(pt, cs) -> dict:
    """S4 at n=200 on triangles: lattice- and mg-preconditioned BiCGStab,
    held against the CPU lane."""
    from phifem_tpu_torch.models import robin_square as rsq

    (s, _), t_tag = _sync_time(_square, pt, "s4", N_S1, DEVICE)
    _, t_asm = _sync_time(s.assemble)
    top, t_taps = _sync_time(s.op.lattice_form)
    vc, t_pre = _sync_time(s.lattice_preconditioner)
    r, t_cold = _sync_time(s.solve, tol=SCHEME_TOL, precond=vc)
    r2, t_warm = _sync_time(s.solve, tol=SCHEME_TOL, precond=vc)
    err = s.l2_h1_errors(s.u_h, rsq.exact_solution)
    mg, t_mg = _sync_time(s.mg_preconditioner)
    r_mg, t_mg_solve = _sync_time(s.solve, tol=SCHEME_TOL, precond=mg)
    r_mg2, t_mg_warm = _sync_time(s.solve, tol=SCHEME_TOL, precond=mg)
    counts = _counts(cs)
    print(f"[s4 n={N_S1}] ndofs={s.system.num_dofs}: tag {t_tag:.3f} s, assemble {t_asm:.3f} s, "
          f"tap form {t_taps:.3f} s ({top.num_taps} taps, {top.num_weights} weights), "
          f"lattice_preconditioner() {t_pre:.3f} s ({_band(vc)}); bicgstab {r.iterations} it (JAX "
          f"{JAX_S4_IT}), relres {r.residual:.3e}, cold {t_cold:.3f} s, warm {t_warm:.4f} s; relative "
          f"H1 error {err['h1']:.5f} (JAX {JAX_S4_H1}), L2 {err['l2']:.3e}; mg_preconditioner() "
          f"{t_mg:.3f} s ({len(mg.levels)} levels, {_band(mg)}): {r_mg.iterations} it (JAX 11), "
          f"relres {r_mg.residual:.3e}, cold {t_mg_solve:.3f} s, warm {t_mg_warm:.4f} s; launches {counts}")
    t0 = time.perf_counter()
    h, _ = _square(pt, "s4", N_S1, "cpu")
    h.assemble()
    rh = h.solve(tol=SCHEME_TOL, precond=h.lattice_preconditioner())
    _check_tags(s, h, rsq.detection_levelset, "s4")
    errs = _against_cpu(s, h)
    errs["u"] = _rel(r.x["u"], rh.x["u"])
    print(f"[s4 n={N_S1}] CPU lane {time.perf_counter() - t0:.1f} s, CPU solve {rh.iterations} it")
    _hold(f"s4 n={N_S1}", errs)
    for res in (r, r2):
        if not (res.converged and res.recurrence <= SCHEME_TOL and _within(res.iterations, JAX_S4_IT)):
            raise AssertionError(f"s4 solve: {res.iterations} it, recurrence {res.recurrence}")
    if err["h1"] > 1.01 * JAX_S4_H1:
        raise AssertionError(f"s4: H1 error {err['h1']} > 1.01 x {JAX_S4_H1}")
    for res in (r_mg, r_mg2):
        if not (res.converged and res.iterations <= S4_MG_MAX_IT):
            raise AssertionError(f"s4 mg solve: {res.iterations} it, relres {res.residual}")
    return counts


def phase_s4_taps(pt, ct) -> dict:
    """The tap kernel on S4's tap form at n=N_S4_TAPS (tag and assemble
    only): P1, vector P1 and two triangle DG0 block lattices."""
    torch.cuda.reset_peak_memory_stats()
    (s, _), t_tag = _sync_time(_square, pt, "s4", N_S4_TAPS, DEVICE)
    _, t_asm = _sync_time(s.assemble, rhs=False)
    top, t_taps = _sync_time(s.op.lattice_form)
    print(f"[s4 n={N_S4_TAPS}] ndofs={s.system.num_dofs}: tag {t_tag:.3f} s, assemble {t_asm:.3f} s, "
          f"tap form {t_taps:.3f} s; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return _tap_kernel_check(ct, top, f"s4 n={N_S4_TAPS}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2

    here = Path(__file__).resolve().parent
    sys.path.insert(0, str(here))
    import phifem_tpu_torch as pt
    from phifem_tpu_torch.ops import cuda_stencil as cs
    from phifem_tpu_torch.ops import cuda_taps as ct

    if Path(pt.__file__).resolve().parent.parent != here:
        raise RuntimeError(f"phifem_tpu_torch imported from {pt.__file__}, not this checkout")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    print(SEP)
    name = phase_device()
    phase_build(cs, ct)
    kernel = phase_kernel(pt, cs)

    # each main path counts its own launches, from 0 just before it
    paths = {}
    _reset(cs)
    s, r_gen = phase_generic(pt)
    phase_lattice(pt, s, r_gen)
    paths["box Poisson"] = _counts(cs)
    del s, r_gen
    _reset(cs)
    paths[f"S1 n={N_S1}"] = phase_s1_small(pt, cs)
    _reset(cs)
    paths[f"S1 n={N}"], s1 = phase_s1_large(pt, cs)
    taps_s1 = _tap_kernel_check(ct, s1.op.lattice_form(), f"s1 n={N}")
    del s1
    torch.cuda.empty_cache()
    for mode in ("bg", "sub"):
        _reset(cs)
        paths[f"S2 {mode}"] = phase_s2(pt, cs, mode)
    _reset(cs)
    paths["S3 quad"] = phase_s3(pt, cs)
    _reset(cs)
    paths["S4"] = phase_s4(pt, cs)
    taps_s4 = phase_s4_taps(pt, ct)

    print(f"[main path] kernel launches per path: {paths}")
    if paths["box Poisson"]["stencil"] <= 0:
        raise AssertionError("the box-Poisson path never launched the stencil kernel")
    for p, c in paths.items():
        if p != "box Poisson" and c["taps"] <= 0:
            raise AssertionError(f"{p} never launched the tap kernel")
        if p.startswith(("S1", "S3", "S4")) and c["masked"] <= 0:
            raise AssertionError(f"{p} never launched the masked stencil kernel")
    kernel["launches"] = sum(c["stencil"] for c in paths.values())
    kernel["launches_by_path"] = {p: c["stencil"] for p, c in paths.items()}
    f64, f32 = torch.float64, torch.float32
    taps = {
        "name": "tap_matvec",
        "route": "cuda",
        "source": "phifem_tpu_torch/csrc/tap_matvec.cu",
        "replaces": "phifem_tpu/ops/taps.py:305 (per-tap loop, XLA-fused; not a Pallas kernel)",
        "launches": sum(c["taps"] for c in paths.values()),
        "launches_by_path": {p: c["taps"] for p, c in paths.items()},
        "max_abs_err": max(v[1] for d in (taps_s1, taps_s4) for v in d.values()),
        "ms": taps_s1[f64][2],
        "plain_ms": taps_s1[f64][3],
        "shape": f"S1 flower n={N} tap form, float64",
        "ms_f32": taps_s1[f32][2],
        "plain_ms_f32": taps_s1[f32][3],
        "s4_ms": taps_s4[f64][2],
        "s4_plain_ms": taps_s4[f64][3],
        "s4_ms_f32": taps_s4[f32][2],
        "s4_plain_ms_f32": taps_s4[f32][3],
        "s4_shape": f"S4 Robin square n={N_S4_TAPS} tap form",
    }
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [kernel, taps]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
