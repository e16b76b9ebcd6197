"""Smoke run of the PyTorch + CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from the checkout's six sources (one nvcc per
source, in parallel), holds the stencil kernel against its plain PyTorch
version on the card (both bodies, both cell types, at lattices that are no
multiple of its tile and at the main path's; the masked one also timed on
the S1 flower's masks at 3200 x 3200; every variant beside its bound, both
bodies on triangles also beside ``torch.mv`` of their CSR matrix, with the
kernel's device time per launch and the wrapper's host time per call), then
drives the port's main paths, each through the schemes' setup ->
assemble -> solve:

* box Poisson on a 3200 x 3200 triangle grid (10,246,401 vertex DoFs),
  solved by the generic MG-preconditioned CG (float64 CG, float32 V-cycle,
  every stencil matvec through the kernel) and by the lattice-resident
  MG-CG, both to a relative residual of 1e-10 in exactly 10 and 8
  iterations, the stencil launches counted per lattice size;
* the S1 weak-Dirichlet flower (tag, assemble, lattice + cut-band
  preconditioned BiCGStab to 1e-8, and one warm re-tag + reassemble +
  solve iteration) at n=200 (80,802 DoFs, dense interface branch) and at
  n=3200 (20,492,802 DoFs, Schwarz/ELL interface branch), each held
  against the same problem on the CPU; every operator matvec runs the
  tap kernel;
* the tap kernel against its plain version, float64 and float32, on the
  tap forms of S1 at n=3200 and of S4 at n=1600 (12.8M DoFs, tag and
  assemble only), timed beside its bound (the supported weights, x and y
  over the memory rate) and beside ``torch.mv`` of the same operator as a
  CSR matrix (cuSPARSE), with the share of (tap, tile) pairs it walks;
* S2 (strong Dirichlet, the flower, n=200, bg and sub mode): default
  BiCGStab and BiCGStab with ``mg_preconditioner()``; S3 (Neumann, tilted
  square, quadrilaterals): tag, assemble and tap form at n=200, BiCGStab
  with ``lattice_preconditioner()`` at n=100; S4 (Robin, tilted square,
  triangles, n=200): BiCGStab with ``lattice_preconditioner()`` and with
  ``mg_preconditioner()``; each held against the same problem on the CPU,
  against the port's own iteration counts exactly, and against the JAX
  package's H1 errors;
* S5 (two-material interface elasticity, the demo's disk, param1.yaml's
  level 3: n=120, h = 0.025 on [-1.5, 1.5]^2): tag, assemble and the
  sparse direct solve (factor, then the cached re-solve), held against the
  CPU lane and against the reference's recorded L2 / H10 errors; deflated
  BiCGStab with the flat ``lattice_preconditioner(coupled=False)`` at
  n=120 and with the default coupled hierarchy at n=64; and the tap kernel
  at 4 channels on S5's tap form at n=512 (tag and assemble only), timed
  as the S1 and S4 tap forms are;
* slice E: box Poisson's ``solve_ir`` at n=1024 (float32 MG-CG corrections
  in a float64 loop, counted in the box-Poisson path); left-preconditioned
  GMRES on S1 n=200, held to the BiCGStab solution; S1 on the flower at
  degree 2 and 3 (P2 / P3 level set) with ``p_multigrid_preconditioner()``
  and flexible GMRES to 1e-8: P2 and P3 at n=200 (321,602 / 722,402 DoFs)
  against the CPU lane, P2 at n=800 (5,126,402 DoFs) with the parts of
  its set-up timed and, after its launches are read, two iterations
  traced; Q3 on quadrilaterals (the
  circle of ``tests/test_schemes.py``) at n=32 and 64, its L2 error falling
  by more than 10; every count exact.  The degree >= 2 operator runs its
  entity batches; both kernels run in its P1 twin's cycle;
* slice F1 (3D, the sphere R0 = 0.7 of demo/poisson3d in [-1, 1]^3): the
  masked hex-cell stencil (d = 1, 2, 3) and the 27-point lattice sweep (its
  three modes, 129^3 and 257^3) against their plain versions, timed beside
  their bounds, torch.mv of the hex operator's CSR and conv3d; box Poisson
  3D (bench.py's poisson3d) at n=128 and 256; the weak-Dirichlet scheme at
  Q1 (n=32 against the CPU lane's whole solve, n=64, n=128 with 4,293,378
  DoFs against the CPU lane's tags, b and matvec, and a device trace of two
  iterations), at Q2 n=16 and 32 (low-order-refined cycle) and at Q3 n=8
  (sparse direct, a cubic reproduced); the strong-Dirichlet scheme at n=64;
  every count exact.  The 3D paths launch the two 3D kernels and neither
  2D one;
* slice F2 (3D): the 3-channel block forms of both 3D kernels (the block
  hex-cell stencil on S5-3D's sphere masks at n=32 and 64, the block
  lattice sweep in its modes at 3 x 129^3 and 3 x 65^3) against their plain
  versions, timed beside their bounds and no-FMA floors, torch.mv of the
  block operator's CSR and conv3d with 3 in / 3 out channels; S3-3D (Neumann) on the sphere
  at n=16 (BiCGStab with lattice_preconditioner(); against the CPU lane),
  n=32 (Jacobi BiCGStab, the demo's path), n=64 (1.4M DoFs, traced) by
  flexible GMRES with lattice_preconditioner(); S4-3D (Robin) at
  n=32 and 64; S5-3D (two-material elasticity, contrast 1000) by flexible
  GMRES with rigid-mode deflation and lattice_preconditioner() at n=8, 12
  and 16 (against the JAX package's recorded counts and errors) and n=24
  (421,875 DoFs, traced).  S5-3D launches both block kernels;
* slice G1a (imported triangle meshes): the AMG cycle's ELL kernel against
  its plain version by ``torch.equal`` on synthetic tables (widths 1 to
  130: every lane group and chunk remainder, empty and all-pad rows, a
  rectangular R, row counts off the CTA and the groups) and on every table
  of the scale run's hierarchy, in its four modes and at every group size,
  float32 and float64; timed on the scale run's level-0 operator and R with
  the L2 flushed beside its byte bound and torch.mv of the same CSR matrix
  (cuSPARSE), and at every launch of the V-cycle through CUDA graphs beside
  its bound and launch floor; demo/unstructured/main.py's four schemes
  S1-S4 on its fallback mesh (n=24, Jacobi BiCGStab), each against the CPU
  lane (tags, solution) and the JAX package's counts and errors; S1-U with
  ``amg_preconditioner()`` on the perturbed mesh at n=40, 80 and 160
  (against JAX's counts) and at n=800 (641,601 vertices, 1,280,000
  triangles: set-up broken down, and a trace of two iterations); every
  count exact.  The AMG paths launch the AMG kernel, 4 times per level and
  V-cycle;
* slice G1b (imported quadrilaterals, the bilinear geometry; S5 on an
  imported triangle mesh): S1-U and S3-U on the perturbed quad mesh of
  tests/test_usolve.py (n=24, Jacobi BiCGStab) against the CPU lane; S1-U
  with ``amg_preconditioner()`` at n=40, 80, 160 (against JAX's counts) and
  n=800 (640,000 quads), the AMG kernel held on every level of its
  hierarchy and its level 0 timed; ``InterfaceElasticityU`` at n=10 (JAX's
  test path, against the CPU lane and JAX's count), at n=32 with Jacobi and
  with ``amg_preconditioner()`` (Jacobi plus the band solve), and at n=120
  (204,974 DoF) with Jacobi;
* slice G2 (imported tetrahedra, ``UMesh3.box``): demo/unstructured/main.py's
  main3 S1-S4 at n=12 against the CPU lane and JAX's counts and errors;
  S1-U with ``amg_preconditioner()`` at n=8, 12, 16 and, by flexible GMRES,
  at n=64 (1,572,864 tets), the AMG kernel held on every level of its
  hierarchy and its level 0 timed;
* slice I (the demo CLIs of ``phifem_tpu_torch.demo``, each through its
  ``main()`` with ``--device cuda``): the four 2D demos at n=200 in bg and
  sub mode, the S5 demo on ``param_quick`` (Jacobi: the default coupled
  preconditioner's dense coarse solve of the whole n=24 system takes ~100 s
  of host pseudo-inverse; ``scripts/run_torch_demos.py`` runs it), poisson3d's
  four Poisson schemes at n=32 and its elasticity case at n=16, the
  unstructured demo's S1 on triangles and tets; each count exact, each
  written field read back equal to the scheme's, each path's launches of
  all seven kernels counted; ``Timer`` around tap-kernel calls that only
  queue work (after the S1 n=3200 phase, which builds the largest tap form)
  and ``device_trace`` around one solve;
  S5 n=64 with ``lattice_preconditioner(ritz_modes=12)``; P2 S1-U with
  ``p_multigrid_preconditioner()`` by fgmres at n=40 (against JAX's count)
  and 160;
* slice H (``phifem_tpu_torch.parallel``), four shards on the one card
  (``make_mesh(devices=["cuda:0"] * 4)``), each run held to the port's
  single-device solve of the same system: box Poisson n=3200 by
  ``sharded_lattice_solve`` (row slabs, the tail agglomerated); the S1
  flower n=200 by ``sharded_solve`` -> ``halo_solve`` (one halo matvec
  against the masked operator to 1e-13, the stencil kernel on every slab
  and once against its plain version at a slab's shape); box Poisson 3D
  n=128 by ``sharded_lattice3_solve`` (the lattice sweep kernel on every
  slab, bit-equal to its plain version at a slab frame's shape); S1-U n=160
  by ``partitioned_solve`` and ``element_sharded_solve``; S1 at degree 2
  (n=9) through ``sharded_solve``'s whole-vector branch; S5-U n=10 by
  ``partitioned_solve`` with rigid-mode deflation; every count pinned, the
  bytes moved between shards per iteration printed;
* the interface band solve (``ops.cuda_band``, every Schwarz band of every
  path above): on the bands the S1 n=3200, Q1 n=128, S5-3D n=24 and S1-U
  n=800 paths build, the RAS kernel (three modes), the band's ELL product
  on the AMG kernel (apply and residual), the dot kernel (one to three
  pairs), every update mode and one whole inner solve ``torch.equal`` to
  their plain versions, the launches per inner sweep (at most 16), each
  kernel timed beside its bound, its plain version and the PyTorch call
  for the same function; every path that builds a Schwarz band launches
  all four, every other path none.

Every check raises; the script exits non-zero without a result when there
is no card or no checkout.  The line before the last is a JSON record of
the kernels; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import re
import shutil
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
S1_IT_SMALL = 15  # the port on the H100 at n=200, as the JAX package
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
# the port's iteration counts on the H100 (PERF.md): deterministic, since
# every sum on the solve path runs in a fixed order; any other count means
# that an order of summation moved (the tap kernel's, for one).  The counts
# of paths with a Schwarz band follow the band kernels' sums (their fixed
# inner sweeps make the preconditioner nonlinear): S1 n=3200 took 63 before
# them, 77 with them
S1_IT = 77  # S1 n=3200, cold and warm
POISSON_IT, POISSON_LATTICE_IT = 10, 8  # box Poisson n=3200: generic CG, lattice CG
# what the kernels line gives of each tap-kernel timing (ms: per call back to
# back by CUDA events, as every kernel's ms; device_ms: per launch, profiler;
# host_ms: the wrapper's host time per call)
TAP_TIMES = ("ms", "device_ms", "host_ms", "plain_ms", "bound_ms", "library_ms")
S2_IT, S2_MG_IT = 397, 5  # bg and sub
S3_IT, S4_IT, S4_MG_IT = 37, 86, 10
# S5: the demo's disk on [-1.5, 1.5]^2 (demo/interface-elasticity)
S5_BOX = ((-1.5, -1.5), (1.5, 1.5))
N_S5 = 120  # param1.yaml level 3: h = 0.2 / 8, 29,282 displacement DoFs
N_S5_COUPLED = 64  # bench.py's s5_iter size
N_S5_TAPS = 512  # the S5 tap form the tap kernel is timed on (3.7M DoFs)
S5_TOL = 1e-8
# the reference's record at level 3 (docs/s5_param1_results.csv; JAX's
# deflated BiCGStab, another null gauge than the direct solve's, hence 5%)
S5_REF_L2, S5_REF_H10 = 6.694107748208591e-3, 0.24532890594543272
# the port's iteration counts on the H100: flat preconditioner at n=120
# (JAX 25 at n=128, docs/s5_preconditioner.md), coupled hierarchy at n=64
S5_FLAT_IT, S5_COUPLED_IT = 26, 15  # 27 / 13 before the band kernels
# slice E: S1 on the demo's flower at degree 2 and 3 (P2 / P3 level set),
# p-multigrid + flexible GMRES to S1_TOL, in whole restart cycles of 20; the
# counts are the port's own on the H100 and its CPU lane's (JAX converges in
# one cycle, 20, at the sizes it ran: n <= 80)
N_PMG, N_PMG_LARGE = 200, 800
S1_P2_IT, S1_P3_IT, S1_P2_LARGE_IT = 40, 80, 40
# Q3 on the circle of tests/test_schemes.py, fgmres to SCHEME_TOL, n=32 / 64
N_Q3, Q3_IT = (32, 64), (20, 80)
N_IR = 1024  # solve_ir's box Poisson (1,050,625 DoFs), to TOL in <= 6 rounds
# the card's published peaks (NVIDIA H100 SXM data sheet, dense, outside
# the tensor cores): the least time of a kernel is the larger of its bytes
# over the memory rate and its flops over the rate of its value type
HBM_BYTES_PER_S = 3.35e12
FLOP_PER_S = {torch.float32: 67e12, torch.float64: 34e12}


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


def _host_ms(fn, reps: int) -> float:
    """Mean host milliseconds per call of ``fn`` issued back to back, the
    card left to run behind (synchronized once at each end)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * t / reps


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


def _bound(nbytes: float, flops: float, dt):
    """(bound ms, "bytes" or "operations") of a kernel that must move
    ``nbytes`` and do ``flops`` in ``dt``."""
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / FLOP_PER_S[dt]
    return 1e3 * max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


def _floor(flops: float, dt) -> float:
    """The no-FMA floor (ms) of a kernel that does ``flops`` in ``dt`` with
    every product and sum an instruction of its own (the 3D kernels round
    each one for the bits of their plain versions): half the data sheet's
    rate, which counts a fused multiply-add as two operations."""
    return 1e3 * flops / (FLOP_PER_S[dt] / 2)


def _stencil_csr(g, mats: torch.Tensor, masks=None) -> torch.Tensor:
    """The float64 CSR matrix on the card of the stencil operator with
    per-orientation matrices ``mats`` on grid ``g``, over every cell or
    over the cells whose (0 / 1) ``masks`` entry is set: the library
    call's input (a yardstick; the port never builds it)."""
    from phifem_tpu_torch.ops.stencil import orientation_offsets

    C = g.nx + 1
    every = (torch.arange(g.ny, device=DEVICE)[:, None] * C + torch.arange(g.nx, device=DEVICE)[None, :]).reshape(-1)
    A = mats.to(torch.float64).tolist()
    rows, cols, vals = [], [], []
    for o, offs in enumerate(orientation_offsets(g)):
        blk = every if masks is None else every[masks[o].reshape(-1) > 0]
        for i, (dxi, dyi) in enumerate(offs):
            for j, (dxj, dyj) in enumerate(offs):
                rows.append(blk + (dyi * C + dxi))
                cols.append(blk + (dyj * C + dxj))
                vals.append(torch.full(blk.shape, A[o][i][j], dtype=torch.float64, device=DEVICE))
    n = g.num_vertices
    coo = torch.sparse_coo_tensor(torch.stack([torch.cat(rows), torch.cat(cols)]), torch.cat(vals), (n, n))
    del rows, cols, vals
    return coo.coalesce().to_sparse_csr()


def _csr_as(A: torch.Tensor, dt) -> torch.Tensor:
    """``A`` in ``dt`` with int32 row pointers and column indices (what
    cuSPARSE's SpMV reads fastest; every matrix here has < 2^31 nonzeros)."""
    return torch.sparse_csr_tensor(A.crow_indices().int(), A.col_indices().int(), A.values().to(dt),
                                   A.shape)


def _device_kernels(fn, reps: int) -> dict:
    """{kernel name: (launches, device ms in all)} of ``reps`` calls of
    ``fn`` in the profiler's CUDA trace, after one warm-up call.  The trace
    may drop a few launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def _flush_op(flush: torch.Tensor, clean: bool):
    """What evicts the L2 before a launch: a write of ``flush`` (a buffer
    larger than the L2), which leaves it full of dirty lines that the
    launch's own reads must write back, or with ``clean`` a read of it."""
    return flush.sum if clean else flush.zero_


def _bracket_ms(fn, reps: int, flush: torch.Tensor = None, clean: bool = False) -> float:
    """Mean device milliseconds of one call of ``fn`` (one kernel launch),
    each call between two CUDA events queued behind a sleeping kernel, so
    that the host's launch time falls outside them; ``flush`` (a buffer
    larger than the L2), when given, is written (with ``clean``: read)
    before each call, outside the events."""
    fn()
    total = 0.0
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if flush is not None:
            _flush_op(flush, clean)()
        torch.cuda._sleep(1_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / reps


class _EventsMs(float):
    """A time from :func:`_device_ms` that came from CUDA events around
    single calls (the events' own time in it), not from the profiler's
    trace: the kernels line marks it with a ``*_source`` key."""


def _device_ms(fn, reps: int, kernel: str, also: str = None, flush: torch.Tensor = None,
               clean: bool = False) -> float:
    """Mean device milliseconds per launch of the kernels named ``kernel``
    over ``reps`` calls of ``fn``: the kernel's own time, whatever the host
    takes between launches, plus that of the device operations named
    ``also`` that ``fn`` issues with it (K3's copy of its cell matrix).  A
    trace that lost launches (it happens, most often to the first trace
    after other work in a long process: none, some, or their times) is
    taken again: it must hold a whole number of launches per call and a
    mean of at least 0.6 of one call's time between CUDA events
    (:func:`_bracket_ms`) net of the events' own few microseconds (the
    same bracket around no call), which would otherwise reject a true
    trace of a launch under ~0.006 ms.  After 8 such traces the bracketed
    time, events included, is returned instead, as an :class:`_EventsMs`.  With ``flush`` (a buffer
    larger than the L2) written (with ``clean``: read) before each call,
    the kernel finds none of its inputs in the L2."""
    bracket = _bracket_ms(fn, 3, flush, clean) - _bracket_ms(lambda: None, 3, flush, clean)
    traced = fn if flush is None else (lambda: (_flush_op(flush, clean)(), fn()))
    for attempt in range(8):
        trace = _device_kernels(traced, reps)
        evs = [v for k, v in trace.items() if kernel in k]
        count = sum(c for c, _ in evs)
        if count and count % reps == 0:
            extra = sum(t for k, (_, t) in trace.items() if also is not None and also in k)
            ms = (sum(t for _, t in evs) + extra) / count
            if ms >= 0.6 * bracket:
                return ms
            print(f"[profiler] the trace of {kernel} gave {ms:.4f} ms per launch against {bracket:.4f} between "
                  f"CUDA events, net of their own time (attempt {attempt + 1} of 8)")
            continue
        print(f"[profiler] the trace held {count} launches of {kernel} for {reps} calls (attempt {attempt + 1} of 8)")
    ms = _EventsMs(_bracket_ms(fn, reps, flush, clean))
    print(f"[profiler] {kernel}: device time by CUDA events around single calls instead, {ms:.4f} ms")
    return ms


def _mark_sources(entry: dict) -> dict:
    """``entry`` (a kernel's record in the kernels line) with a
    ``<key>_source: "events"`` beside every time that :func:`_device_ms`
    took from CUDA events instead of the profiler's trace."""
    for k, v in list(entry.items()):
        if isinstance(v, _EventsMs):
            entry[f"{k}_source"] = "events"
    return entry


def _library_kernels(fn, reps: int = 10) -> str:
    """The device kernels one call of ``fn`` (a library call) runs, with
    their device ms per call, as the profiler sees them."""
    evs = sorted(_device_kernels(fn, reps).items(), key=lambda kv: -kv[1][1])
    return "; ".join(f"{k[:60]} x{c / reps:g} {t / reps:.4f} ms" for k, (c, t) in evs)


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


def _template_args(mangled: str) -> str:
    """``f10`` for ``...kernelIfLb1ELb0EE...``, ``d42`` for
    ``...kernelIdLi4ELi2EE...``: a kernel's scalar type and its boolean or
    integer template arguments, from the name ptxas reports."""
    m = re.search(r"I([fd])((?:L[bi]\d+E)+)E", mangled)
    return m.group(1) + "".join(re.findall(r"L[bi](\d+)E", m.group(2))) if m else mangled[-16:]


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
        regs = re.findall(r"Compiling entry function '(\w+)'.*?(\d+) bytes spill stores.*?Used (\d+) registers",
                          info["log"], re.S)
        print(f"[build] {info['path']} in {info['seconds']:.2f} s; ptxas registers per thread (bytes of "
              "spill stores): " + (", ".join(f"{_template_args(k)} {n} ({sp})" for k, sp, n in regs)
                                   or "(already built)"))
    print(f"[build] all kernels in {time.perf_counter() - t0:.2f} s")


def _stencil_times(cs, g, x, masks, mats, A) -> dict:
    """Times of one stencil variant at the main path's size, as the tap
    kernel is timed: the wrapper's calls back to back (``ms``) and the plain
    version by CUDA events, the kernel's own device time per launch from the
    profiler, the wrapper's host time per call and, where ``A`` is the
    operator's CSR matrix, ``torch.mv``."""
    y = torch.zeros_like(x)
    packed = cs.pack_matrices(g, mats)  # as a batch keeps it

    def call():
        return cs.stencil_matvec(g, x, masks, mats, y=y, packed=packed)

    return {
        "device_ms": _device_ms(call, 20, "stencil_matvec_kernel"),
        "ms": _event_ms(call, 50),
        "host_ms": _host_ms(call, 50),
        "plain_ms": _event_ms(lambda: cs.stencil_matvec_ref(g, x, masks, mats, y=y), 10),
        "library_ms": None if A is None else _event_ms(lambda: torch.mv(A, x), 20),
    }


def _stencil_report(label: str, t: dict, nbytes: int, bound) -> None:
    lib = "" if t["library_ms"] is None else f", CSR torch.mv {t['library_ms']:.4f} ms (int32 indices, cuSPARSE)"
    print(f"[kernel] time {label}: kernel {t['ms']:.4f} ms per call back to back (CUDA events), "
          f"{t['device_ms']:.4f} ms of device time per launch (profiler), {t['host_ms']:.4f} ms of host time "
          f"per call; {nbytes / (t['ms'] * 1e-3) / 1e9:.0f} GB/s of the bound's bytes; bound {bound[0]:.4f} ms "
          f"by {bound[1]}, {bound[0] / t['ms']:.1%} of it per call, {bound[0] / t['device_ms']:.1%} of the "
          f"device time; plain {t['plain_ms']:.4f} ms{lib}")


def phase_kernel(pt, cs) -> dict:
    """Kernel vs plain on the card: 8 variants at two sizes that are no
    multiple of the kernel's tile (one below it, one above), and the main
    path's shapes at N x N; then times at N x N."""
    rng = np.random.default_rng(SEED)
    tol = {torch.float32: 1e-5, torch.float64: 1e-13}
    worst = 0.0
    cases = [(nx, ny, ct, masked, dt)
             for nx, ny in ((37, 53), (269, 131))
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

    # the bound of y += A x: read x, read and write y (masks, where there
    # are, in the value type); 9 FMAs per cell (16 on quads)
    times, bounds = {}, {}
    mats = torch.as_tensor(rng.standard_normal((2, 3, 3)))
    A64 = _stencil_csr(pt.Grid(N, N, device="cuda"), mats)
    for dt in (torch.float32, torch.float64):
        g = pt.Grid(N, N, device="cuda", dtype=dt)
        x = torch.as_tensor(rng.standard_normal(g.num_vertices), dtype=dt, device="cuda")
        A, md = _csr_as(A64, dt), mats.to(dt)
        yk = cs.stencil_matvec(g, x, None, md)
        yl = torch.mv(A, x)
        torch.cuda.synchronize()
        rel = float((yk - yl).abs().max()) / float(yl.abs().max())
        if rel > tol[dt]:
            raise AssertionError(f"the stencil CSR is not the kernel's operator: {rel}")
        nbytes = 3 * x.element_size() * g.num_vertices
        bounds["maskless", dt] = _bound(nbytes, 2 * 9 * 2 * N * N, dt)
        times["maskless", dt] = _stencil_times(cs, g, x, None, md, A)
        _stencil_report(f"{str(dt)[6:]} maskless triangle {N}x{N}", times["maskless", dt], nbytes,
                        bounds["maskless", dt])
        print(f"[kernel] CSR of the maskless operator: {A._nnz()} nonzeros, agrees with the kernel to {rel:.1e}; "
              f"CSR kernels: {_library_kernels(lambda: torch.mv(A, x))}")
        del A, yk, yl
    del A64
    torch.cuda.empty_cache()

    # the masked body on the S1 bulk-region masks (cells tagged 1|2) of the
    # flower at n=N: the masks the S1 operator and load vector run with
    from phifem_tpu_torch.models import flower
    from phifem_tpu_torch.tagging import tag_cells

    tags = tag_cells(pt.Grid(N, N, FLOWER_BOX, device="cuda"), flower.detection_levelset, 1, True)
    tags = tags.cpu().numpy()
    mats = torch.as_tensor(rng.standard_normal((2, 3, 3)))
    A64 = None
    for dt in (torch.float32, torch.float64):
        g = pt.Grid(N, N, FLOWER_BOX, device="cuda", dtype=dt)
        b = pt.StencilCellBatch.build(g, "u", mats.to(dt), tags, (1, 2))
        if A64 is None:
            A64 = _stencil_csr(g, mats, b.masks)
        A = _csr_as(A64, dt)
        x = torch.as_tensor(rng.standard_normal(g.num_vertices), dtype=dt, device="cuda")
        yk = cs.stencil_matvec(g, x, b.masks, b.matrices, packed=b.packed)
        yr = cs.stencil_matvec_ref(g, x, b.masks, b.matrices)
        yl = torch.mv(A, x)
        torch.cuda.synchronize()
        err = float((yk - yr).abs().max())
        rel = err / float(yr.abs().max())
        rel_l = float((yk - yl).abs().max()) / float(yr.abs().max())
        worst = max(worst, err)
        print(f"[kernel] triangle masked {str(dt)[6:]:7s} {N}x{N} flower masks "
              f"({float(b.masks.mean()):.3f} of cells set): max|dy|/max|y| = {rel:.3e} "
              f"(tol {tol[dt]:.0e}) {'ok' if rel <= tol[dt] else 'FAIL'}; CSR of the masked operator "
              f"{A._nnz()} nonzeros, agrees to {rel_l:.1e}")
        if rel > tol[dt]:
            raise AssertionError(f"masked kernel disagrees with plain version: {rel} > {tol[dt]}")
        if rel_l > tol[dt]:
            raise AssertionError(f"the masked stencil CSR is not the kernel's operator: {rel_l}")
        nbytes = (3 * g.num_vertices + b.masks.numel()) * x.element_size()
        bounds["masked", dt] = _bound(nbytes, 36 * N * N, dt)
        times["masked", dt] = _stencil_times(cs, g, x, b.masks, b.matrices, A)
        _stencil_report(f"{str(dt)[6:]} masked triangle {N}x{N}", times["masked", dt], nbytes, bounds["masked", dt])
        del A, yk, yr, yl
    del A64
    torch.cuda.empty_cache()

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
            nmask = 0 if masks is None else masks.numel()
            bounds[body, "quad", dt] = _bound((3 * g.num_vertices + nmask) * x.element_size(), 32 * N * N, dt)
            print(f"[kernel] time {str(dt)[6:]} {body} quadrilateral {N}x{N}: kernel {k_ms:.4f} ms "
                  f"(bound {bounds[body, 'quad', dt][0]:.4f} ms, {bounds[body, 'quad', dt][0] / k_ms:.1%} "
                  f"of it), plain {p_ms:.4f} ms")
    f32, f64 = torch.float32, torch.float64
    keys = ("ms", "device_ms", "host_ms", "plain_ms", "library_ms")
    return {
        "name": "stencil_matvec",
        "route": "cuda",
        "source": "phifem_tpu_torch/csrc/stencil_matvec.cu",
        "replaces": "phifem_tpu/ops/pallas_stencil.py:124",
        "max_abs_err": worst,
        **{k: times["maskless", f32][k] for k in keys},
        "bound_ms": bounds["maskless", f32][0],
        "bound_by": bounds["maskless", f32][1],
        "library": "torch.mv of the operator as a CUDA CSR matrix (cuSPARSE SpMV)",
        **{f"{k}_f64": times["maskless", f64][k] for k in keys},
        "bound_ms_f64": bounds["maskless", f64][0],
        "shape": f"{N}x{N} triangle maskless",
        "tile": {"block": list(cs.BLOCK), "rows_f32": cs.ROWS[f32], "rows_f64": cs.ROWS[f64]},
        **{f"masked_{k}": times["masked", f32][k] for k in keys},
        "masked_bound_ms": bounds["masked", f32][0],
        **{f"masked_{k}_f64": times["masked", f64][k] for k in keys},
        "masked_bound_ms_f64": bounds["masked", f64][0],
        "masked_shape": f"{N}x{N} triangle, S1 flower masks",
        **{f"{body}_quad_bound_ms{sfx}": bounds[body, "quad", dt][0]
           for body in ("masked", "maskless")
           for dt, sfx in ((f32, ""), (f64, "_f64"))},
        **{f"{body}_quad_{what}{sfx}": quad[body, dt][i]
           for body in ("masked", "maskless")
           for dt, sfx in ((f32, ""), (f64, "_f64"))
           for i, what in enumerate(("ms", "plain_ms"))},
    }


def _tap_csr(top) -> torch.Tensor:
    """The float64 CSR matrix on the card of ``top``'s tap operator over
    the fields concatenated in spec order, from ``top.support`` and
    ``top.W``: the library call's input (a yardstick; the port never
    builds it)."""
    ids = np.asarray(top.support, np.int64)
    t = np.searchsorted(top.tap_offsets, ids, side="right") - 1
    taps = np.asarray(top.taps, np.int64).reshape(-1, 4)
    bi, bj, dr, dc = (taps[t, k] for k in range(4))
    shapes = np.asarray(top.blk_shapes, np.int64)
    ch = np.asarray(top.blk_ch, np.int64)
    start, stride, sub, off = [], [], [], 0
    for sp in top.specs:
        for o in range(sp.nblocks):
            start.append(off)
            stride.append(sp.nblocks * sp.vsz)
            sub.append(o * sp.vsz)
        off += sp.shape[0] * sp.shape[1] * sp.nblocks * sp.vsz
    start, stride, sub = (np.asarray(a, np.int64) for a in (start, stride, sub))
    vi, vj = ch[bi], ch[bj]
    q, kj = np.divmod(ids - top.tap_offsets[t], vj)
    pt_, ki = np.divmod(q, vi)
    r, c = np.divmod(pt_, shapes[bi, 1])
    rr, cc = r + dr, c + dc
    ok = (rr >= 0) & (rr < shapes[bj, 0]) & (cc >= 0) & (cc < shapes[bj, 1])
    rows = start[bi] + (r * shapes[bi, 1] + c) * stride[bi] + sub[bi] + ki
    cols = start[bj] + (rr * shapes[bj, 1] + cc) * stride[bj] + sub[bj] + kj
    vals = top.W[torch.as_tensor(ids[ok], device=top.W.device)].to(torch.float64)
    idx = torch.as_tensor(np.stack([rows[ok], cols[ok]]), device=top.W.device)
    return torch.sparse_coo_tensor(idx, vals, (off, off)).coalesce().to_sparse_csr()


def _tap_kernel_check(ct, top, label: str) -> dict:
    """The tap kernel against its plain version on ``top`` (its own W, a
    seeded random x), float64 and float32, then timed: its wrapper's calls
    back to back (``ms``), the plain version and the CSR library call by
    CUDA events, as the stencil kernel is timed; and the kernel's own device time
    per launch from the profiler (``device_ms``).  Returns ``{dtype: {...}}``
    with the max rel and abs differences, those times and the bound."""
    rng = np.random.default_rng(SEED)
    tol = {torch.float32: 1e-5, torch.float64: 1e-13}
    frac = ct.active_tile_fraction(top)
    nsup = len(top.support)
    A64 = _tap_csr(top)
    base, ptr, _ = ct.tile_table(top)
    runs, work = ct.zero_runs(top, base, ptr)
    print(f"[taps {label}] {top.num_taps} taps, {top.num_weights} weights, {nsup} supported "
          f"({nsup / top.num_weights:.4%}); tiles of {ct.TILE[0]}x{ct.TILE[1]} points: "
          f"{frac:.4%} of (tap, tile) pairs active, {int((np.diff(ptr) > 0).sum())} of {base[-1]} tiles; "
          f"{len(runs)} zero runs in {len(work) - 1} work items; CSR {A64._nnz()} nonzeros")
    out = {}
    for dt in (torch.float64, torch.float32):
        W = top.W.to(dt)
        x = {sp.name: torch.as_tensor(
                rng.standard_normal((sp.shape[0] * sp.shape[1] * sp.nblocks,) + sp.vshape),
                dtype=dt, device=top.W.device) for sp in top.specs}
        yk = ct.tap_matvec(top, W, x)
        yr = ct.tap_matvec_ref(top, W, x)
        A = _csr_as(A64, dt)
        xv = torch.cat([x[sp.name].reshape(-1) for sp in top.specs])
        yl = torch.mv(A, xv)
        torch.cuda.synchronize()
        err = max(float((yk[k] - yr[k]).abs().max()) for k in yr)
        ymax = max(float(yr[k].abs().max()) for k in yr)
        rel = err / ymax
        rel_l = float((torch.cat([yk[sp.name].reshape(-1) for sp in top.specs]) - yl).abs().max()) / ymax
        d_ms = _device_ms(lambda: ct.tap_matvec(top, W, x), 20, "tap_matvec_kernel")
        k_ms = _event_ms(lambda: ct.tap_matvec(top, W, x), 50)
        h_ms = _host_ms(lambda: ct.tap_matvec(top, W, x), 50)
        p_ms = _event_ms(lambda: ct.tap_matvec_ref(top, W, x), 3)
        l_ms = _event_ms(lambda: torch.mv(A, xv), 20)
        nbytes = (nsup + 2 * xv.numel()) * W.element_size()  # supported weights, x, y
        b_ms, b_by = _bound(nbytes, 2 * nsup, dt)
        out[dt] = dict(rel=rel, err=err, ms=k_ms, device_ms=d_ms, host_ms=h_ms, plain_ms=p_ms,
                       library_ms=l_ms, bound_ms=b_ms, bound_by=b_by, active_tile_fraction=frac)
        print(f"[taps {label}] {str(dt)[6:]}: max|dy|/max|y| = {rel:.3e} (tol {tol[dt]:.0e}) "
              f"{'ok' if rel <= tol[dt] else 'FAIL'}; kernel {k_ms:.4f} ms per call back to back "
              f"(CUDA events), {d_ms:.4f} ms of device time per launch (profiler), {h_ms:.4f} ms of host "
              f"time per call; {nbytes / (k_ms * 1e-3) / 1e9:.0f} GB/s of the bound's bytes "
              f"(supported W + x + y, {nbytes / 1e6:.1f} MB); bound {b_ms:.4f} ms by {b_by}, "
              f"{b_ms / k_ms:.1%} of it per call, {b_ms / d_ms:.1%} of the device time; plain "
              f"{p_ms:.4f} ms, CSR torch.mv {l_ms:.4f} ms (int32 indices; agrees to {rel_l:.1e}; "
              f"kernel / CSR {k_ms / l_ms:.3f}); CSR kernels: {_library_kernels(lambda: torch.mv(A, xv))}")
        if rel > tol[dt]:
            raise AssertionError(f"tap kernel disagrees with plain version on {label}: {rel} > {tol[dt]}")
        if rel_l > 10 * tol[dt]:
            raise AssertionError(f"the tap CSR is not the kernel's operator on {label}: {rel_l}")
        del W, x, yk, yr, A, xv, yl
    del A64
    torch.cuda.empty_cache()
    return out


def _problem(pt, n: int = N):
    g = pt.Grid(n, n, ((0.0, 0.0), (1.0, 1.0)), pt.CellType.triangle, device="cuda")
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
    if r.iterations != POISSON_IT:
        raise AssertionError(f"generic solve took {r.iterations} iterations, not {POISSON_IT}: the order of "
                             "summation moved")
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
    if not (r.converged and r.residual <= TOL and r.iterations == POISSON_LATTICE_IT):
        raise AssertionError(f"lattice solve: converged={r.converged}, {r.iterations} iterations (not "
                             f"{POISSON_LATTICE_IT}), relres {r.residual}")
    if err > 5 * h * h:
        raise AssertionError(f"lattice solve error {err} > 5h^2")
    if diff > 1e-8:
        raise AssertionError(f"lattice and generic solutions differ: {diff}")


def _flower_s1(pt, n: int, device: str, degree: int = 1):
    """bench.py's S1 flower scheme at n x n, set up (tagged) on ``device``;
    at ``degree`` >= 2 with the level set of the same degree."""
    from phifem_tpu_torch.models import flower

    g = pt.Grid(n, n, FLOWER_BOX, pt.CellType.triangle, device=device)
    s = pt.WeakDirichletPoisson(g, mode="bg", detection_degree=1, single_layer_cut=True,
                                primal_degree=degree, levelset_degree=degree)
    return s.setup(flower.levelset, flower.source_term, detection_levelset=flower.detection_levelset)


def _band(vc) -> str:
    if vc.interface_inv is not None:
        return f"dense interface branch, m={vc.interface_ids.numel()}"
    return (f"Schwarz/ELL interface branch, m={vc.band_ids.numel()}, "
            f"{vc.band_tables.nb} blocks of <= {vc.band_tables.K}, "
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


def _against_cpu(s, h, taps: bool = True) -> dict:
    """Largest relative differences of the card's load vector, of its
    operator (entity batches) and, with ``taps`` (degree 1), of its tap
    form (the tap kernel) applied to a seeded random x, from the CPU lane's
    operator."""
    rng = np.random.default_rng(SEED)
    x = {k: torch.as_tensor(rng.standard_normal(v.shape)) for k, v in h.b.items()}
    xc = {k: v.to(DEVICE) for k, v in x.items()}
    yc = s.op.matvec(xc)
    yh = h.op.matvec(x)
    errs = {
        "b": max(_rel(s.b[k], h.b[k]) for k in h.b),
        "matvec": max(_rel(yc[k], yh[k]) for k in yh),
    }
    if taps:
        top = s.op.lattice_form()
        if top is None:
            raise AssertionError("the degree-1 operator has no tap form")
        yt = top.make_matvec(s.op)(xc)
        errs["tap_matvec"] = max(_rel(yt[k], yh[k]) for k in yh)
    return errs


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
        if not (res.recurrence <= S1_TOL and res.iterations == S1_IT_SMALL):
            raise AssertionError(
                f"S1 n={N_S1} solve: recurrence {res.recurrence}, {res.iterations} iterations")
    if counts["masked"] <= 0:
        raise AssertionError(f"S1 n={N_S1} never launched the masked stencil kernel")
    return counts, s, vc, r


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
    if vc.band_tables is None:
        raise AssertionError(f"S1 n={N} should take the Schwarz/ELL interface branch")
    for res in (r0, r):
        _pin(f"S1 n={N}", res.iterations, S1_IT)  # any other count: an order of summation moved
        if not (res.recurrence <= S1_TOL and res.residual <= 2 * S1_TOL):
            raise AssertionError(
                f"S1 n={N} solve: recurrence {res.recurrence}, true relres {res.residual} after "
                f"{res.iterations} iterations")
    if counts["masked"] <= 0:
        raise AssertionError(f"S1 n={N} never launched the masked stencil kernel")
    t0 = time.perf_counter()
    _hold_band(f"S1 n={N}", vc.band_tables, vc.schwarz_sweeps, timed=True)
    print(f"[time] S1 n={N} band kernels {time.perf_counter() - t0:.1f} s")
    return counts, s


def _taps():
    from phifem_tpu_torch.ops import cuda_taps

    return cuda_taps


def _reset(cs) -> None:
    """Every kernel count to 0, just before a main path."""
    cs.launches = cs.masked_launches = 0
    cs.shape_launches.clear()
    _taps().launches = 0
    _band_reset()


def _counts(cs) -> dict:
    return {"stencil": cs.launches, "masked": cs.masked_launches, "taps": _taps().launches, **_band_read()}


def _band_mod():
    from phifem_tpu_torch.ops import cuda_band

    return cuda_band


# the band solve's kernels count on every path: the 2D and 3D counters
# above and below carry them, the imported-mesh paths (whose own count is
# the AMG kernel's) keep them in BAND_U by path; "band_tables" counts the
# Schwarz bands the path built (cuda_band.tables_built)
BAND_U = {}
# the band solve's kernels in the kernels line: (name and count key,
# profiler name, source, the JAX loop it replaces)
BAND_KERNELS = (
    ("band_ras", "band_ras_kernel", "phifem_tpu_torch/csrc/band_solve.cu",
     "phifem_tpu/mg.py:389-398 (band_ras in VCycle._band_correct_flat; XLA-fused, not a Pallas kernel)"),
    ("band_dots", "band_dots_kernel", "phifem_tpu_torch/csrc/band_solve.cu",
     "phifem_tpu/mg.py:85-139 (the dots of _band_bicgstab; XLA-fused, not a Pallas kernel)"),
    ("band_update", "band_update_kernel", "phifem_tpu_torch/csrc/band_solve.cu",
     "phifem_tpu/mg.py:85-139 (the vector updates of _band_bicgstab; XLA-fused, not a Pallas kernel)"),
    ("band_ell", "amg_ell_kernel", "phifem_tpu_torch/csrc/amg_ell.cu",
     "phifem_tpu/mg.py:383-387 (band_mv; XLA-fused, not a Pallas kernel): the AMG ELL kernel, reused"),
)
# what the band phase measures of each kernel, by band (the label of the
# path that built it)
BAND_TIMES = {}
BAND_REPS = 20


def _band_reset() -> None:
    cb = _band_mod()
    cb.launches = cb.ras_launches = cb.ell_launches = cb.dot_launches = cb.update_launches = 0
    cb.tables_built = 0


def _band_read() -> dict:
    cb = _band_mod()
    return {"band": cb.launches, "band_ras": cb.ras_launches, "band_ell": cb.ell_launches,
            "band_dots": cb.dot_launches, "band_update": cb.update_launches, "band_tables": cb.tables_built}


def _band_update_state(m: int, rng) -> dict:
    """Vectors and scalar slots for one call of each update mode: rr below
    the best residual of slot 0 and above that of slot 1, so that the
    select takes x at sweep 0 and keeps xb at sweep 1."""
    cb = _band_mod()
    st = {k: torch.as_tensor(rng.standard_normal(m), device=DEVICE)
          for k in ("r", "p", "v", "s", "t", "x", "ph", "sh", "xb", "rout")}
    sc = torch.as_tensor(0.5 + rng.random(cb.SLOTS), device=DEVICE)
    sc[cb.RR], sc[cb.RRB0], sc[cb.RRB1] = 0.5, 1.0, 0.25
    return {"sc": sc, **st}


def _hold_band(label: str, tab, sweeps: int, timed: bool = False) -> None:
    """The band solve's kernels on a band the path built (after the path's
    counts are read): the RAS apply in its three modes, the ELL product
    (apply and residual), the dots of one to three pairs, every update mode
    and one whole inner solve (and 4 Richardson sweeps), each ``torch.equal``
    to its plain version; launches per inner sweep.  With ``timed``, each
    kernel timed per call by CUDA events, its device ms per launch, the
    wrapper's host ms per call, the plain version, the bound (each input
    once, each output once over the memory rate) and the one PyTorch call
    where there is one, and one inner solve, kept in BAND_TIMES[label]
    (the main path's band here; ``scripts/tune_torch_band.py`` times every
    band)."""
    cb = _band_mod()
    f64 = torch.float64
    m, nb, K = tab.m, tab.nb, tab.K
    rng = np.random.default_rng(SEED + m)
    vec = lambda: torch.as_tensor(rng.standard_normal(m), device=DEVICE)
    x, c = vec(), vec()
    own = tab.owner < nb * K
    n_own = int(own.sum())
    n_blk = int(torch.unique(torch.div(tab.owner[own].long(), K, rounding_mode="floor")).numel())
    w = tab.ell_cols.shape[0]
    nnz = int((tab.ell_cols < m).sum())
    ras_bytes = n_own * K * 8 + n_blk * K * 4 + m * (4 + 8 + 8)
    print(f"[{label} band] m={m}, nb={nb} blocks of K={K} ({n_own} owned DoFs in {n_blk} blocks), ELL width {w} "
          f"({nnz} nonzeros, {tab.lanes} lanes a row), {sweeps} inner sweeps; the RAS apply reads "
          f"{ras_bytes / 1e6:.3f} MB (one row of K a DoF; x, owner, y), the whole block table "
          f"{nb * K * K * 8 / 1e6:.3f} MB")

    # agreement, every kernel and mode
    t0 = time.perf_counter()
    for mode in (cb.RAS_APPLY, cb.RAS_SCALE, cb.RAS_ADD):
        if not torch.equal(cb.band_ras(tab, x, mode=mode, om=0.7, c=c), cb.band_ras_ref(tab, x, mode=mode, om=0.7, c=c)):
            raise AssertionError(f"{label}: the RAS kernel (mode {mode}) differs from its plain version")
    for b in (None, c):
        if not torch.equal(cb.band_ell(tab, x, b=b), cb.band_ell_ref(tab, x, b=b)):
            raise AssertionError(f"{label}: the band's ELL product (b {b is not None}) differs from its plain version")
    for q in (1, 2, 3):
        pairs = [(x, c), (c, c), (x, x)][:q]
        if not torch.equal(cb.band_dots(pairs), cb.band_dots_ref(pairs)):
            raise AssertionError(f"{label}: the dot kernel ({q} pairs) differs from its plain version")
    for mode, sweep in ((cb.P, 0), (cb.P, 1), (cb.P, 2), (cb.S, 1), (cb.XR, 1), (cb.SEL, 3)):
        st = _band_update_state(m, rng)
        ref = {k: v.clone() for k, v in st.items()}
        vecs = {k: st[k] for k in cb.MODE_VECS[mode]}
        cb.band_update(mode, sweep, st["sc"], **vecs)
        cb.band_update_ref(mode, sweep, ref["sc"], **{k: ref[k] for k in cb.MODE_VECS[mode]})
        bad = [k for k in st if not torch.equal(st[k], ref[k])]
        if bad:
            raise AssertionError(f"{label}: the update kernel (mode {mode}, sweep {sweep}) differs from its plain "
                                 f"version in {bad}")
    rb = vec()
    n0 = cb.launches
    e = cb.band_bicgstab(tab, rb, sweeps)
    torch.cuda.synchronize()
    launches = cb.launches - n0
    per_sweep = (launches - cb.dot_stages(m) - 1) / sweeps
    if not torch.equal(e, cb.band_bicgstab_ref(tab, rb, sweeps)):
        raise AssertionError(f"{label}: the inner solve on the kernels differs from its plain version")
    if not torch.equal(cb.band_richardson(tab, rb, 4, 0.8), cb.band_richardson_ref(tab, rb, 4, 0.8)):
        raise AssertionError(f"{label}: the Richardson inner solve on the kernels differs from its plain version")
    print(f"[{label} band] every kernel, mode and the whole inner solve ({sweeps} sweeps, |e| max "
          f"{float(e.abs().max()):.3e}) torch.equal to their plain versions ({time.perf_counter() - t0:.1f} s); "
          f"{launches} launches a solve, {per_sweep:g} an inner sweep (at most 16)")
    if not per_sweep <= 16:
        raise AssertionError(f"{label}: {per_sweep} launches an inner sweep")
    # how far the fixed sweeps take the inner solve: the true relative
    # residual of its best iterate, at the default sweeps and twice and
    # four times as many (reported: a solve stopped far from convergence
    # makes the preconditioner nonlinear, and the outer count follows its
    # rounding)
    nrb = float(torch.linalg.norm(rb))
    relres = {k * sweeps: float(torch.linalg.norm(cb.band_ell(tab, cb.band_bicgstab(tab, rb, k * sweeps), b=rb))) / nrb
              for k in (1, 2, 4)}
    print(f"[{label} band] inner solve on a random right-hand side, true relative residual of the best iterate: "
          + ", ".join(f"{v:.3e} after {k} sweeps" for k, v in relres.items()))
    if not timed:
        return

    # times
    zero = x.new_zeros(1)
    ids64, owner64 = tab.ids.long(), tab.owner.long()
    A = _ell_csr(tab.ell_cols, tab.ell_vals, m)
    t, s_ = vec(), vec()
    sc = _band_update_state(m, rng)
    xr = {k: sc[k] for k in cb.MODE_VECS[cb.XR]}
    work = torch.empty(max(1, cb.dot_work(m, 2)), dtype=f64, device=DEVICE)
    out = torch.empty(2, dtype=f64, device=DEVICE)
    y = torch.empty(m, dtype=f64, device=DEVICE)
    cases = {
        "band_ras": (lambda: cb.band_ras(tab, x, y), lambda: cb.band_ras_ref(tab, x, y),
                     lambda: torch.cat([torch.einsum("bkl,bl->bk", tab.inv, torch.cat([x, zero])[ids64]).reshape(-1),
                                        zero])[owner64],
                     _bound(ras_bytes, 2 * K * n_own, f64), "einsum over every block entry + the owner gather"),
        "band_ell": (lambda: cb.band_ell(tab, x, y), lambda: cb.band_ell_ref(tab, x, y), lambda: torch.mv(A, x),
                     _ell_bound(_amg().APPLY, nnz, m, m, f64)[:2], "torch.mv of the band matrix as CUDA CSR"),
        "band_dots": (lambda: cb.band_dots([(t, s_), (t, t)], out, work), lambda: cb.band_dots_ref([(t, s_), (t, t)]),
                      lambda: (torch.dot(t, s_), torch.dot(t, t)), _bound(2 * m * 8 + 16, 4 * m, f64),
                      "two torch.dot (t.s, t.t)"),
        "band_update": (lambda: cb.band_update(cb.XR, 1, sc["sc"], **xr),
                        lambda: cb.band_update_ref(cb.XR, 1, sc["sc"], **xr), None,
                        _bound(7 * m * 8, 6 * m, f64), None),
    }
    times = {}
    for name, (fn, plain, lib, (bound, by), lib_name) in cases.items():
        kname = next(k for n, k, _, _ in BAND_KERNELS if n == name)
        tt = {"ms": _event_ms(fn, BAND_REPS), "device_ms": _device_ms(fn, BAND_REPS, kname),
              "host_ms": _host_ms(fn, BAND_REPS), "plain_ms": _event_ms(plain, BAND_REPS), "bound_ms": bound,
              "bound_by": by, "library_ms": None if lib is None else _event_ms(lib, BAND_REPS)}
        times[name] = tt
        print(f"[{label} band] {name}: {tt['ms']:.4f} ms a call (events), device {tt['device_ms']:.4f} ms a launch"
              + (f" ({cb.dot_stages(m)} launches a call)" if name == "band_dots" else "")
              + f", host {tt['host_ms']:.4f} ms a call; plain {tt['plain_ms']:.4f} ms; bound {bound:.4f} ms by {by} "
              f"({bound / tt['device_ms']:.1%} of it by device time)"
              + ("" if lib is None else f"; {lib_name} {tt['library_ms']:.4f} ms"))
    solve = lambda: cb.band_bicgstab(tab, rb, sweeps)
    times["solve"] = {"ms": _event_ms(solve, 3), "host_ms": _host_ms(solve, 3),
                      "plain_ms": _event_ms(lambda: cb.band_bicgstab_ref(tab, rb, sweeps), 1), "launches": launches,
                      "launches_per_sweep": per_sweep, "sweeps": sweeps}
    ts = times["solve"]
    print(f"[{label} band] one inner solve ({sweeps} sweeps): {ts['ms']:.3f} ms (events), host {ts['host_ms']:.3f} ms "
          f"to issue its {launches} launches; plain {ts['plain_ms']:.3f} ms")
    times["shape"] = f"m={m}, nb={nb}, K={K}, ELL width {w}, {nnz} nonzeros"
    BAND_TIMES[label] = times


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
        if not (res.converged and res.recurrence <= SCHEME_TOL):
            raise AssertionError(f"{label} default solve: {res.iterations} it, recurrence {res.recurrence}")
        _pin(f"{label} default solve", res.iterations, S2_IT)
    for res in (r_mg, r_mg2):
        if not res.converged:
            raise AssertionError(f"{label} mg solve: {res.iterations} it, relres {res.residual}")
        _pin(f"{label} mg solve", res.iterations, S2_MG_IT)
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
        if not (res.converged and res.recurrence <= SCHEME_TOL):
            raise AssertionError(f"s3 n={n} solve: {res.iterations} it, recurrence {res.recurrence}")
        _pin(f"s3 n={n}", res.iterations, S3_IT)
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
        if not (res.converged and res.recurrence <= SCHEME_TOL):
            raise AssertionError(f"s4 solve: {res.iterations} it, recurrence {res.recurrence}")
        _pin("s4", res.iterations, S4_IT)
    if err["h1"] > 1.01 * JAX_S4_H1:
        raise AssertionError(f"s4: H1 error {err['h1']} > 1.01 x {JAX_S4_H1}")
    for res in (r_mg, r_mg2):
        if not res.converged:
            raise AssertionError(f"s4 mg solve: {res.iterations} it, relres {res.residual}")
        _pin("s4 mg", res.iterations, S4_MG_IT)
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


def _s5(pt, n: int, device: str):
    """The S5 demo's disk problem at n x n, set up (tagged) on ``device``."""
    from phifem_tpu_torch.models import elasticity_disk as disk

    g = pt.Grid(n, n, S5_BOX, pt.CellType.triangle, device=device)
    s = pt.InterfaceElasticity(g, mode="bg", E_in=disk.E_in, nu_in=disk.nu_in, E_out=disk.E_out,
                               nu_out=disk.nu_out)
    return s.setup(disk.levelset, disk.source_term, disk.exact_solution)


def _s5_errors(s) -> dict:
    from phifem_tpu_torch.models import elasticity_disk as disk

    return s.l2_h1_errors(s.u_h, disk.exact_solution, region=None)


def _within(e: dict, ref: dict, frac: float = 0.05) -> bool:
    return all(abs(e[k] - ref[k]) / ref[k] < frac for k in ("l2", "h10"))


def phase_s5_direct(pt, cs):
    """S5 at n=N_S5: tag, assemble, sparse LU (factor, then the cached
    re-solve), held against the CPU lane and the reference's errors.
    Returns ``(launches, scheme, errors)``."""
    from phifem_tpu_torch.models import elasticity_disk as disk

    label = f"s5 n={N_S5}"
    s, t_tag = _sync_time(_s5, pt, N_S5, DEVICE)
    _, t_asm = _sync_time(s.assemble)
    r1, t_fac = _sync_time(s.solve, method="sparse")
    r2, t_re = _sync_time(s.solve, method="sparse")
    counts = _counts(cs)  # the path's own launches, before the CPU-lane check
    e = _s5_errors(s)
    top = s.op.lattice_form()
    print(f"[{label}] ndofs={s.system.num_dofs} ({s.U.num_dofs} displacement DoFs): tag {t_tag:.3f} s, "
          f"assemble {t_asm:.3f} s; tap form {top.num_taps} taps, pad {top.pad}, channels {top.blk_ch}; "
          f"sparse LU factor + solve {t_fac:.3f} s (relres {r1.residual:.3e}), cached re-solve "
          f"{t_re:.3f} s (relres {r2.residual:.3e}); relative L2 {e['l2']:.4e} (reference {S5_REF_L2:.4e}), "
          f"H10 {e['h10']:.4f} (reference {S5_REF_H10:.4f}); launches {counts}")
    t0 = time.perf_counter()
    h = _s5(pt, N_S5, "cpu").assemble()
    _check_tags(s, h, disk.levelset, "s5")
    errs = _against_cpu(s, h)
    print(f"[{label}] CPU lane {time.perf_counter() - t0:.1f} s")
    _hold(label, errs)
    del h
    for r in (r1, r2):
        if not r.residual < 1e-10:
            raise AssertionError(f"{label} sparse solve: relres {r.residual}")
    if not _within(e, {"l2": S5_REF_L2, "h10": S5_REF_H10}):
        raise AssertionError(f"{label} errors {e} not within 5% of the reference's")
    return counts, s, e


def phase_s5_flat(pt, cs, s, e_direct) -> dict:
    """Deflated BiCGStab with the flat lattice preconditioner on the direct
    phase's scheme (n=N_S5)."""
    label = f"s5 n={N_S5} flat"
    vc, t_pre = _sync_time(s.lattice_preconditioner, coupled=False)
    r, t_cold = _sync_time(s.solve, tol=S5_TOL, precond=vc)
    r2, t_warm = _sync_time(s.solve, tol=S5_TOL, precond=vc)
    counts = _counts(cs)
    e = _s5_errors(s)
    print(f"[{label}] lattice_preconditioner(coupled=False) {t_pre:.3f} s ({_band(vc)}; bulk cycles "
          f"{ {f: type(m).__name__ for f, m in vc.mgs.items()} }, {vc.coarse_Z.shape[0]} coarse modes); "
          f"deflated bicgstab tol {S5_TOL:.0e}: {r.iterations} it (JAX 25 at n=128), relres "
          f"{r.residual:.3e}, cold {t_cold:.3f} s, warm {t_warm:.3f} s ({r2.iterations} it); relative L2 "
          f"{e['l2']:.4e}, H10 {e['h10']:.4f} (direct {e_direct['l2']:.4e}, {e_direct['h10']:.4f}); "
          f"launches {counts}")
    for res in (r, r2):
        if not res.converged:
            raise AssertionError(f"{label}: {res.iterations} it, relres {res.residual}")
        _pin(label, res.iterations, S5_FLAT_IT)
    if not _within(e, e_direct):
        raise AssertionError(f"{label} errors {e} not within 5% of the direct solve's {e_direct}")
    return counts


def phase_s5_coupled(pt, cs) -> dict:
    """S5 at n=N_S5_COUPLED with its default preconditioner, the coupled
    hierarchy, and deflated BiCGStab."""
    label = f"s5 n={N_S5_COUPLED} coupled"
    s, t_tag = _sync_time(_s5, pt, N_S5_COUPLED, DEVICE)
    _, t_asm = _sync_time(s.assemble)
    vc, t_pre = _sync_time(s.lattice_preconditioner)
    r, t_cold = _sync_time(s.solve, tol=S5_TOL, precond=vc)
    r2, t_warm = _sync_time(s.solve, tol=S5_TOL, precond=vc)
    counts = _counts(cs)
    e = _s5_errors(s)
    print(f"[{label}] ndofs={s.system.num_dofs}: tag {t_tag:.3f} s, assemble {t_asm:.3f} s, "
          f"lattice_preconditioner() {t_pre:.3f} s ({type(vc).__name__}: smoothing levels "
          f"{[lv['grid'].nx for lv in vc.levels]}, coarse n={vc.coarse_level.grid.nx} pinv of "
          f"{vc.coarse_level.coarse_inv.shape[0]}); deflated bicgstab tol {S5_TOL:.0e}: {r.iterations} it, "
          f"relres {r.residual:.3e}, cold {t_cold:.3f} s, warm {t_warm:.3f} s ({r2.iterations} it); "
          f"relative L2 {e['l2']:.4e}, H10 {e['h10']:.4f}; launches {counts}")
    for res in (r, r2):
        if not res.converged:
            raise AssertionError(f"{label}: {res.iterations} it, relres {res.residual}")
        _pin(label, res.iterations, S5_COUPLED_IT)
    return counts


def phase_s5_taps(pt, ct) -> dict:
    """The tap kernel at 4 channels on S5's tap form at n=N_S5_TAPS (tag and
    assemble only): five block lattices of 2 / 2 / 4 / 4 / 2 channels."""
    torch.cuda.reset_peak_memory_stats()
    s, t_tag = _sync_time(_s5, pt, N_S5_TAPS, DEVICE)
    _, t_asm = _sync_time(s.assemble, rhs=False)
    top, t_taps = _sync_time(s.op.lattice_form)
    nw = top.num_weights
    print(f"[s5 n={N_S5_TAPS}] ndofs={s.system.num_dofs}: tag {t_tag:.3f} s, assemble {t_asm:.3f} s, tap "
          f"form {t_taps:.3f} s; W {nw} weights ({nw / s.grid.num_vertices:.0f} per lattice point; "
          f"{nw * 8 / 1e9:.2f} GB in float64, {nw * 4 / 1e9:.2f} GB more in float32 for the check); "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return _tap_kernel_check(ct, top, f"s5 n={N_S5_TAPS}")


def phase_ir(pt) -> None:
    """Mixed-precision iterative refinement on box Poisson at n=N_IR:
    float32 MG-preconditioned CG corrections (every float32 matvec through
    the stencil kernel) in a float64 residual loop, to TOL in <= 6 rounds."""
    g, uex, f = _problem(pt, N_IR)
    s = pt.BoxPoisson(g).setup(f).assemble()
    vc, t_mg = _sync_time(s.mg_preconditioner, dtype=torch.float32)
    r0, t_cold = _sync_time(s.solve_ir, tol=TOL, precond=vc)
    r, t_warm = _sync_time(s.solve_ir, tol=TOL, precond=vc)
    err = float((r.x["u"] - pt.interpolate(uex, s.V).data).abs().max())
    h = 1.0 / N_IR
    print(f"[solve_ir] n={N_IR} ndofs={s.system.num_dofs}: mg_preconditioner(float32) {t_mg:.3f} s; "
          f"{r.iterations} rounds (cold {r0.iterations}), relres {r.residual:.3e}, cold {t_cold:.3f} s, "
          f"warm {t_warm:.4f} s; max nodal err {err:.3e} (5h^2 {5 * h * h:.3e})")
    for res in (r0, r):
        if not (res.converged and res.residual <= TOL and res.iterations <= 6):
            raise AssertionError(f"solve_ir n={N_IR}: {res.iterations} rounds, relres {res.residual}")
    if err > 5 * h * h:
        raise AssertionError(f"solve_ir error {err} > 5h^2")


def phase_gmres(pt, cs, s, vc, r_bicg) -> dict:
    """Left-preconditioned restarted GMRES (restart 50, JAX's contract) on
    the S1 n=N_S1 phase's scheme and lattice preconditioner, held to that
    phase's BiCGStab solution."""
    kw = dict(method="gmres", tol=S1_TOL, precond=vc)
    r0, t_cold = _sync_time(s.solve, **kw)
    r, t_warm = _sync_time(s.solve, **kw)
    counts = _counts(cs)
    diff = _rel(r.x["u"], r_bicg.x["u"])
    print(f"[s1 n={N_S1} gmres] tol {S1_TOL:.0e}: iterations {r.iterations} (not reported, as in JAX), "
          f"||M r|| / ||b|| {r.recurrence:.3e}, true relres {r.residual:.3e}, cold {t_cold:.3f} s, warm "
          f"{t_warm:.4f} s; max|u_gmres - u_bicgstab| / max|u_bicgstab| {diff:.3e} (tol 1e-6); launches "
          f"{counts}")
    for res in (r0, r):
        if not (res.iterations == -1 and res.converged and res.recurrence <= S1_TOL):
            raise AssertionError(f"S1 gmres: {res.iterations}, recurrence {res.recurrence}, relres {res.residual}")
    if diff > 1e-6:
        raise AssertionError(f"S1 gmres and BiCGStab solutions differ: {diff}")
    return counts


# the band solve's kernels in a trace; off the AMG paths every ELL launch is
# the band's product
KERNELS_BAND = {"band RAS": "band_ras_kernel", "band dots": "band_dots_kernel", "band updates": "band_update_kernel",
                "band ELL (amg_ell)": "amg_ell_kernel"}
KERNELS_2D = {"stencil": "stencil_matvec_kernel", "tap": "tap_matvec_kernel", **KERNELS_BAND}
# the device-to-device copies include hex3 block's copy of K, one per launch
KERNELS_3D = {"hex3": "hex1_stencil3", "hex3 block": "hexblock_stencil3", "lattice3": "lattice3_sweep_kernel",
              "lattice3 block": "lattice3_block_kernel", "device-to-device copies": "Memcpy DtoD", **KERNELS_BAND}


def _trace_report(label: str, kernels: dict, wall: float, iters: int, solver: str = "fgmres",
                  named: dict = KERNELS_2D, top: int = 12) -> None:
    """Print a device trace (``{kernel: (launches, device ms)}``, as
    :func:`_device_kernels` gives it) of ``iters`` ``solver`` iterations
    that took ``wall`` seconds unprofiled (the solve's set-up included):
    kernels per iteration, device busy share of the wall, the device time of
    the ``named`` kernels (``{label: part of the kernel's name}``), the top
    kernels."""
    busy = sum(t for _, t in kernels.values())
    count = sum(c for c, _ in kernels.values())
    hit = lambda key, k: any(x in k for x in ((key,) if isinstance(key, str) else key))
    parts = ", ".join(f"{name} {sum(t for k, (_, t) in kernels.items() if hit(key, k)):.2f} ms in "
                      f"{sum(c for k, (c, _) in kernels.items() if hit(key, k))}" for name, key in named.items())
    print(f"[{label} profile] {iters} {solver} iterations, wall {wall:.3f} s unprofiled: {count} kernels "
          f"({count / max(iters, 1):.0f} per {solver} iteration), device busy {busy:.1f} ms = "
          f"{busy / 1e3 / wall:.1%} of the wall; {parts}; top kernels by device time:")
    for k, (c, t) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:top]:
        print(f"    {k[:90]:90s} x{c:8d} {t:9.2f} ms")


def _profile_steps(s, vc, label: str, steps: int = 2) -> None:
    """A device-only ``torch.profiler`` trace of ``steps`` Arnoldi steps of
    the flexible GMRES that ``s.solve(method="fgmres")`` runs (its
    equilibrated operator and p-MG; one cycle of ``restart=steps``).  A
    whole solve launches over a million kernels, whose trace takes minutes
    to read back (``scripts/profile_torch_pmg.py`` traces one)."""
    from phifem_tpu_torch.solvers import _eq_context, _pfgmres, lift_rhs

    matvec, active, _, dinv_sqrt, mv_eq, M, _ = _eq_context(s.op, (), vc)
    b = lift_rhs(s.op, s.b, (), active, raw_matvec=matvec.raw)
    b_eq = {k: v * dinv_sqrt[k] for k, v in b.items()}
    x0 = {k: torch.zeros_like(v) for k, v in b_eq.items()}
    run = lambda: _pfgmres(mv_eq, b_eq, x0, tol=0.0, atol=0.0, maxiter=steps, M=M, restart=steps)
    _, wall = _sync_time(run)
    _trace_report(label, _device_kernels(run, 1), wall, steps)


def phase_pmg(pt, cs, degree: int, n: int, expect_it, cpu: str = "", trace: bool = False) -> dict:
    """S1 on the demo's flower at ``degree`` (P2 / P3 level set) and n x n:
    ``p_multigrid_preconditioner()`` + fgmres to S1_TOL in exactly
    ``expect_it`` iterations, a cold and a warm solve.  ``cpu="solve"``:
    held against the CPU lane (tags, b, one matvec, u); ``cpu="operator"``:
    tags, b and one matvec only.  ``trace``: two Arnoldi steps traced after
    the path's launches are read."""
    label = f"s1 P{degree} n={n}"
    torch.cuda.reset_peak_memory_stats()
    s, t_tag = _sync_time(_flower_s1, pt, n, DEVICE, degree)
    _, t_asm = _sync_time(s.assemble)
    vc, t_pre = _sync_time(s.p_multigrid_preconditioner)
    kw = dict(method="fgmres", tol=S1_TOL, maxiter=400, precond=vc)
    r0, t_cold = _sync_time(s.solve, **kw)
    r, t_warm = _sync_time(s.solve, **kw)
    counts = _counts(cs)  # the path's own launches, before the trace and the CPU-lane check
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[{label}] ndofs={s.system.num_dofs} (P1 twin {2 * s.grid.num_vertices}): tag {t_tag:.3f} s, "
          f"assemble {t_asm:.3f} s, p_multigrid_preconditioner() {t_pre:.3f} s ("
          + ", ".join(f"{k} {v:.3f} s" for k, v in vc.setup_seconds.items()) + f"; {_band(vc)}); fgmres tol "
          f"{S1_TOL:.0e}: cold {t_cold:.3f} s ({r0.iterations} it), warm {t_warm:.3f} s, {r.iterations} it, "
          f"recurrence relres {r.recurrence:.3e}, true relres {r.residual:.3e}, "
          f"{s.system.num_dofs / t_warm / 1e6:.3f} MDoF/s; peak device memory {peak:.2f} GiB; launches {counts}")
    if trace:
        _profile_steps(s, vc, label)
    if cpu:
        t0 = time.perf_counter()
        h = _flower_s1(pt, n, "cpu", degree).assemble()
        _check_tags(s, h, label=f"s1 P{degree}")
        errs = _against_cpu(s, h, taps=False)
        if cpu == "solve":
            rh = h.solve(**{**kw, "precond": h.p_multigrid_preconditioner()})
            errs["u"] = _rel(r.x["u"], rh.x["u"])
            print(f"[{label}] CPU solve {rh.iterations} it, relres {rh.residual:.3e}")
        print(f"[{label}] CPU lane {time.perf_counter() - t0:.1f} s")
        _hold(label, errs)
    for res in (r0, r):
        if not (res.converged and res.recurrence <= S1_TOL):
            raise AssertionError(f"{label}: {res.iterations} it, recurrence {res.recurrence}, relres {res.residual}")
        _pin(label, res.iterations, expect_it)
    return counts


def phase_q3(pt, cs) -> dict:
    """Q3 on quadrilaterals, the circle problem of tests/test_schemes.py
    (u = cos x e^{y/2}, P3 level set), p-MG + fgmres to 1e-10 at n=32 and
    64 in exactly Q3_IT iterations: L2(32) / L2(64) > 10 (O(h^4))."""
    phi = lambda x: x[..., 0] ** 2 + x[..., 1] ** 2 - 1.0
    uex = lambda x: torch.cos(x[..., 0]) * torch.exp(x[..., 1] / 2.0)
    errs = []
    torch.cuda.reset_peak_memory_stats()
    for n, it in zip(N_Q3, Q3_IT):
        g = pt.Grid(n, n, ((-1.5, -1.5), (1.5, 1.5)), pt.CellType.quadrilateral, device=DEVICE)
        s = pt.WeakDirichletPoisson(g, mode="bg", primal_degree=3, levelset_degree=3)
        _, t_build = _sync_time(lambda: s.setup(phi, lambda x: 0.75 * uex(x), u_D=uex).assemble())
        vc, t_pre = _sync_time(s.p_multigrid_preconditioner)
        kw = dict(method="fgmres", tol=SCHEME_TOL, maxiter=400, precond=vc)
        r0, t_cold = _sync_time(s.solve, **kw)
        r, t_warm = _sync_time(s.solve, **kw)
        e = s.l2_h1_errors(s.u_h, uex, region=(1, 2))
        errs.append(e["l2"])
        print(f"[s1 Q3 n={n}] ndofs={s.system.num_dofs}: setup + assemble {t_build:.3f} s, "
              f"p_multigrid_preconditioner() {t_pre:.3f} s ({_band(vc)}); fgmres tol {SCHEME_TOL:.0e}: cold "
              f"{t_cold:.3f} s ({r0.iterations} it), warm {t_warm:.3f} s, {r.iterations} it, recurrence relres "
              f"{r.recurrence:.3e}, true relres {r.residual:.3e}; relative L2 {e['l2']:.4e}, H10 {e['h10']:.4e}")
        for res in (r0, r):
            if not (res.converged and res.recurrence <= SCHEME_TOL):
                raise AssertionError(f"S1 Q3 n={n}: {res.iterations} it, recurrence {res.recurrence}")
            _pin(f"S1 Q3 n={n}", res.iterations, it)
    counts = _counts(cs)
    print(f"[s1 Q3] L2({N_Q3[0]}) / L2({N_Q3[1]}) = {errs[0] / errs[1]:.2f} (> 10: O(h^4) is 16); peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {counts}")
    if not errs[0] / errs[1] > 10.0:
        raise AssertionError(f"Q3 convergence rate: {errs}")
    return counts


# ---------------------------------------------------------------- slice F1
# 3D: box Poisson (bench.py's poisson3d), the weak-Dirichlet scheme on the
# sphere of demo/poisson3d (Q1-Q3) and the strong-Dirichlet scheme, with the
# two 3D kernels: the masked hex-cell stencil (hex3) and the 27-point lattice
# sweep (lattice3)
BOX3 = ((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0))  # demo/poisson3d's box
N3_BOX, N3_BOX_LARGE = 128, 256  # 2,146,689 / 16,974,593 DoFs
# Q3's host SuperLU took 760.358 s at n=16 (235,298 DoFs) and 94-109 s at
# n=12 on the card's host: the direct solve runs at n=8 (31,250 DoFs; 12.8 s
# on a CPU), which reproduces the cubic as well, to make room for slice I
N3_Q1, N3_Q1_CPU, N3_Q2, N3_Q3, N3_STRONG = 128, 32, 32, 8, 64
# the port's iteration counts on the H100 (PERF.md): box Poisson (JAX 6 at
# n=128, BENCH_r04.json), Q1 at n=32 / 64 / 128 (BiCGStab, tol 1e-10; n=32
# equals the CPU lane's), Q2 at n=16 / 32 (tol 1e-10, maxiter 2000; JAX on the
# CPU 76 at n=16: the inner band solve's rounding moves this count, ROADMAP),
# S2-3D at n=64; before the band kernels Q1 n=64 took 9, Q2 101 / 26.  Q2
# n=32 at the default inner sweeps (76) is reported, not pinned: three
# summation orders of the band solve gave 26, 29 and 39 on an H100
# (scripts/compare_band_counts.py); with four times the sweeps (304) the
# inner solve converges and the count is 18 in every order (Q2_CONVERGED)
BOX3_IT = {N3_BOX: 6, N3_BOX_LARGE: 6}
Q1_IT = {N3_Q1_CPU: 6, N3_Q1 // 2: 10, N3_Q1: 10}
Q2_IT = {N3_Q2 // 2: 90, N3_Q2: None}
Q2_CONVERGED = {N3_Q2: (304, 18)}  # n: (inner sweeps, count)
STRONG3_IT = 93
# the hex3 kernel checks: (degree, n) on the sphere's mask; the first three
# are timed; then every other shape the 3D weak paths run (Q1 n=32 / 64, Q2
# n=16 / 32, Q3 n=8) and the odd lattice n=37
HEX3_CASES = ((1, N3_Q1), (2, 64), (3, 40), (1, N3_Q1_CPU), (1, N3_Q1 // 2), (2, N3_Q2 // 2), (2, N3_Q2),
              (3, N3_Q3), (1, 37), (2, 37), (3, 37))


def _p3():
    """The port's poisson3d demo: its sphere ``phi`` (R0 = 0.7), the
    weak-scheme solution ``u_smooth`` (-Δu = u / 2), ``du_dn`` and the
    strong-scheme solution ``u_product``."""
    from phifem_tpu_torch.demo import poisson3d

    return poisson3d


def _strong3_data():
    """demo/poisson3d's strong-scheme solution u = phi w, w = cos(s),
    s = x + y/2 - z/4, and f = -Δu in closed form (|grad s|^2 = 21/16)."""
    p3 = _p3()
    s_ = lambda x: x[..., 0] + 0.5 * x[..., 1] - 0.25 * x[..., 2]
    f = lambda x: (-6.0 + 21.0 / 16.0 * p3.phi(x)) * torch.cos(s_(x)) + 4.0 * s_(x) * torch.sin(s_(x))
    return p3.u_product, f


def _k3():
    from phifem_tpu_torch.ops import cuda_hex3, cuda_lattice3

    return cuda_hex3, cuda_lattice3


def _reset3() -> None:
    ch, cl = _k3()
    ch.launches = cl.launches = ch.block_launches = cl.block_launches = 0
    _band_reset()


def _counts3() -> dict:
    ch, cl = _k3()
    return {"hex3": ch.launches, "lattice3": cl.launches, "hex3_block": ch.block_launches,
            "lattice3_block": cl.block_launches, **_band_read()}


def _hex3_csr(mask: torch.Tensor, A: torch.Tensor, degree: int) -> torch.Tensor:
    """The float64 CUDA CSR matrix of the masked hex-cell stencil (the
    library call's input; the port never builds it)."""
    from phifem_tpu_torch.ops.cuda_hex3 import hex_offsets

    nz, ny, nx = mask.shape
    d = degree
    Rn, Cn = d * ny + 1, d * nx + 1
    c = torch.nonzero(mask.reshape(nz, ny, nx) != 0)
    base = (d * c[:, 0] * Rn + d * c[:, 1]) * Cn + d * c[:, 2]
    off = torch.tensor([(oz * Rn + oy) * Cn + ox for ox, oy, oz in hex_offsets(d)], device=mask.device)
    nodes = base[:, None] + off[None, :]  # (ne, nloc)
    nl = off.numel()
    rows = nodes[:, :, None].expand(-1, nl, nl).reshape(-1)
    cols = nodes[:, None, :].expand(-1, nl, nl).reshape(-1)
    vals = (A.to(torch.float64)[None] * mask[c[:, 0], c[:, 1], c[:, 2]].to(torch.float64)[:, None, None])
    n = (d * nz + 1) * Rn * Cn
    coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals.reshape(-1), (n, n))
    del rows, cols, vals
    return coo.coalesce().to_sparse_csr()


def _sphere_mask(pt, n: int, dt) -> torch.Tensor:
    from phifem_tpu_torch.tagging3 import compute_tags3

    tags = compute_tags3(pt.Grid3(n, n, n, BOX3, device=DEVICE), _p3().phi)
    return torch.as_tensor(tags.region_mask((1, 2)), dtype=dt, device=DEVICE).contiguous()


def phase_kernel_hex3(pt) -> dict:
    """The masked hex-cell stencil against its plain version on the card:
    d=1 on the n=128 sphere mask (129^3 nodes), d=2 at n=64 (129^3), d=3 at
    n=40 (121^3), every other (degree, n) of the 3D weak paths, every degree
    on the odd lattice n=37, float32 and float64; then the first three
    shapes' times in float64 and float32 beside their bounds (the share by
    device time per launch and by ms per call), the plain version and, in
    float64, torch.mv of the CUDA CSR matrix."""
    ch, _ = _k3()
    rng = np.random.default_rng(SEED)
    tol = {torch.float32: 1e-5, torch.float64: 1e-13}
    worst, out = 0.0, {}
    for d, n in HEX3_CASES:
        nloc = (d + 1) ** 3
        A64 = torch.as_tensor(rng.standard_normal((nloc, nloc)))
        for dt in (torch.float32, torch.float64):
            mask = _sphere_mask(pt, n, dt)
            nodes = (d * n + 1,) * 3
            x = torch.as_tensor(rng.standard_normal(nodes), dtype=dt, device=DEVICE)
            A = A64.to(dt).to(DEVICE)
            yk = ch.hex_stencil3(x, mask, A, d)
            yr = ch.hex_stencil3_ref(x, mask, A, d)
            torch.cuda.synchronize()
            err = float((yk - yr).abs().max())
            rel = err / float(yr.abs().max())
            worst = max(worst, err)
            print(f"[kernel hex3] d={d} n={n} {str(dt)[6:]:7s} nodes {nodes[0]}^3, {int(mask.sum())} masked cells: "
                  f"max|dy|/max|y| = {rel:.3e} (tol {tol[dt]:.0e}) {'ok' if rel <= tol[dt] else 'FAIL'}")
            if rel > tol[dt]:
                raise AssertionError(f"hex3 kernel disagrees with its plain version: {rel} > {tol[dt]}")
            if (d, n) not in HEX3_CASES[:3]:
                continue
            # the main-path shape of this degree: time it (the library call in float64 only)
            ncell = int((mask != 0).sum())
            nbytes = (2 * x.numel() + mask.numel()) * x.element_size()
            bound = _bound(nbytes, 2 * nloc * nloc * ncell, dt)
            call = lambda: ch.hex_stencil3(x, mask, A, d)
            t = {
                "device_ms": _device_ms(call, 20, "stencil3_kernel"),
                "ms": _event_ms(call, 20),
                "host_ms": _host_ms(call, 20),
                "plain_ms": _event_ms(lambda: ch.hex_stencil3_ref(x, mask, A, d), 2),
                "library_ms": None,
                "bound_ms": bound[0],
                "bound_by": bound[1],
            }
            floor_ms = _floor(2 * nloc * nloc * ncell, dt)
            lib = ""
            if dt is torch.float64:
                Acsr = _hex3_csr(mask, A, d)
                yl = torch.mv(Acsr, x.reshape(-1))
                rel_l = float((yl - yr.reshape(-1)).abs().max()) / float(yr.abs().max())
                if rel_l > 1e-12:
                    raise AssertionError(f"the hex3 CSR is not the kernel's operator: {rel_l}")
                t["library_ms"] = _event_ms(lambda: torch.mv(Acsr, x.reshape(-1)), 10)
                t["csr_nnz"] = int(Acsr._nnz())
                lib = f"; CSR torch.mv {t['library_ms']:.4f} ms ({t['csr_nnz']} nonzeros, agrees to {rel_l:.1e})"
                del Acsr, yl
            out[d, dt] = t
            print(f"[kernel hex3] time d={d} n={n} {str(dt)[6:]}: kernel {t['ms']:.4f} ms per call back to back (CUDA "
                  f"events), {t['device_ms']:.4f} ms device per launch (profiler), {t['host_ms']:.4f} ms host per "
                  f"call; bound {bound[0]:.4f} ms by {bound[1]} ({nbytes / 1e6:.1f} MB, "
                  f"{2 * nloc * nloc * ncell / 1e9:.3f} GFLOP), {bound[0] / t['device_ms']:.1%} of it by device time, "
                  f"{bound[0] / t['ms']:.1%} by ms; no-FMA floor {floor_ms:.4f} ms; plain {t['plain_ms']:.3f} "
                  f"ms{lib}")
            torch.cuda.empty_cache()
    # the host floor of one launch: the C entry with all its arguments
    # converted by ctypes but degree 0 (it returns at once, nothing launched)
    fn = ch._LAUNCH["phifem_hex_stencil3"][0]
    xf = torch.zeros(8, dtype=torch.float64, device=DEVICE)
    stream = torch.cuda.current_stream().cuda_stream
    floor = _host_ms(lambda: fn(xf.data_ptr(), xf.data_ptr(), xf.data_ptr(), xf.data_ptr(), 1, 1, 1, 0, 1, stream),
                     200)
    print(f"[kernel hex3] host floor per call: the ctypes call alone {floor:.4f} ms")
    f64, f32 = torch.float64, torch.float32
    keys = ("ms", "device_ms", "host_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    main = out[1, f64]
    return {
        "name": "hex_stencil3",
        "route": "cuda",
        "source": "phifem_tpu_torch/csrc/hex_stencil3.cu",
        "replaces": "phifem_tpu/models/weak_dirichlet3.py:273 (_masked_stencil_apply, XLA-fused; not a Pallas kernel)",
        "max_abs_err": worst,
        **{k: main[k] for k in keys},
        "library": "torch.mv of the operator as a CUDA CSR matrix (cuSPARSE SpMV)",
        "shape": f"Q1 sphere mask n={N3_Q1} (129^3 nodes), float64",
        **{f"q{d}_{k}": out[d, f64][k] for d in (2, 3) for k in keys},
        **{f"q{d}_f32_{k}": out[d, f32][k] for d in (1, 2, 3) for k in keys if k != "library_ms"},
        "q2_shape": "Q2 sphere mask n=64 (129^3 nodes), float64",
        "q3_shape": "Q3 sphere mask n=40 (121^3 nodes), float64",
        "host_floor_ctypes_ms": floor,
    }


def phase_kernel_lattice3(pt) -> dict:
    """The 27-point lattice sweep against its plain version on the card at
    129^3 and 257^3 in its three modes, float32 and float64 (the residual
    and Jacobi modes with a random mask, Jacobi also without one), each
    timed beside its bound (the share by device time per launch and by ms
    per call), the wrapper's host time and the plain version, and the matvec
    beside torch.nn.functional.conv3d with the same 3x3x3 weights."""
    from phifem_tpu_torch.ops.lattice3 import _terms3, hex_element_matrix, vertex_stencil_weights3

    _, cl = _k3()
    rng = np.random.default_rng(SEED + 1)
    tol = {torch.float32: 1e-5, torch.float64: 1e-13}
    worst, times = 0.0, {}
    for n in (N3_BOX, N3_BOX_LARGE):
        D = n + 1
        h = 1.0 / n
        w = vertex_stencil_weights3(hex_element_matrix(h, h, h))
        terms = cl.pack_terms(_terms3(w))
        od = 0.8 / w[1, 1, 1]
        for dt in (torch.float32, torch.float64):
            x = torch.zeros((D + 2,) * 3, dtype=dt, device=DEVICE)
            x[2:D, 2:D, 2:D] = torch.as_tensor(rng.standard_normal((D - 2,) * 3), dtype=dt, device=DEVICE)
            b = torch.zeros_like(x)
            b[2:D, 2:D, 2:D] = torch.as_tensor(rng.standard_normal((D - 2,) * 3), dtype=dt, device=DEVICE)
            mask = torch.as_tensor(rng.random((D,) * 3) < 0.7, dtype=dt, device=DEVICE)
            for mode, name, m in ((cl.MATVEC, "matvec", None), (cl.RESIDUAL, "residual", mask),
                                  (cl.JACOBI, "jacobi masked", mask), (cl.JACOBI, "jacobi", None)):
                yk = cl.lattice3_sweep(mode, x, terms, b, m, od)
                yr = cl.lattice3_sweep_ref(mode, x, terms, b, m, od)
                torch.cuda.synchronize()
                err = float((yk - yr).abs().max())
                rel = err / float(yr.abs().max())
                worst = max(worst, err)
                if rel > tol[dt]:
                    raise AssertionError(f"lattice3 kernel ({name}) disagrees with its plain version: {rel}")
                # bytes: x read, out written, b (and the mask) read in modes 1-2
                nb = (2 + (mode != cl.MATVEC)) * x.numel() + (0 if m is None else m.numel())
                bound = _bound(nb * x.element_size(), 2 * len(terms) * (D - 2) ** 3, dt)
                call = lambda: cl.lattice3_sweep(mode, x, terms, b, m, od)
                t = {"ms": _event_ms(call, 20), "plain_ms": _event_ms(
                    lambda: cl.lattice3_sweep_ref(mode, x, terms, b, m, od), 3),
                     "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None,
                     "device_ms": _device_ms(call, 10, "lattice3_sweep_kernel"), "host_ms": _host_ms(call, 20)}
                if mode == cl.MATVEC:
                    W = torch.as_tensor(w, dtype=dt, device=DEVICE)[None, None]
                    conv = lambda: torch.nn.functional.conv3d(x[None, None], W)
                    yl = conv()[0, 0, 1:-1, 1:-1, 1:-1]
                    rel_l = float((yl - yk[2:D, 2:D, 2:D]).abs().max()) / float(yr.abs().max())
                    if rel_l > 10 * tol[dt]:
                        raise AssertionError(f"conv3d is not the kernel's matvec: {rel_l}")
                    t["library_ms"] = _event_ms(conv, 20)
                times[n, dt, name] = t
                extra = "".join(f", {k} {t[k]:.4f}" for k in ("device_ms", "host_ms", "library_ms")
                                if t.get(k) is not None)
                print(f"[kernel lattice3] {name:13s} {str(dt)[6:]:7s} {D}^3: max|dy|/max|y| = {rel:.3e} (tol "
                      f"{tol[dt]:.0e}) ok; ms {t['ms']:.4f} (bound {bound[0]:.4f} by {bound[1]}, "
                      f"{bound[0] / t['device_ms']:.1%} by device time, {bound[0] / t['ms']:.1%} by ms), plain "
                      f"{t['plain_ms']:.4f}{extra}")
            del x, b, mask, yk, yr
            torch.cuda.empty_cache()
    # the host floor of one launch: the C entry with all its arguments
    # converted by ctypes but a term count of 0 (it returns at once, nothing
    # launched), and the output's allocation
    fn = cl._LAUNCH["phifem_lattice3_sweep"][0]
    xf = torch.zeros((N3_BOX + 3,) * 3, device=DEVICE)
    stream = torch.cuda.current_stream().cuda_stream
    floor = {"ctypes_ms": _host_ms(lambda: fn(xf.data_ptr(), None, None, xf.data_ptr(), N3_BOX + 1, N3_BOX + 1,
                                              N3_BOX + 1, terms.offs_ptr, terms.w_ptr, 0, 0.0, 0, 0, stream), 200),
             "empty_like_ms": _host_ms(lambda: torch.empty_like(xf), 200)}
    print(f"[kernel lattice3] host floor per call: the ctypes call alone {floor['ctypes_ms']:.4f} ms, "
          f"torch.empty_like {floor['empty_like_ms']:.4f} ms")
    f32 = torch.float32
    main = times[N3_BOX, f32, "jacobi"]
    keys = ("ms", "device_ms", "host_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    line = {
        "name": "lattice3_sweep",
        "route": "cuda",
        "source": "phifem_tpu_torch/csrc/lattice3_sweep.cu",
        "replaces": "phifem_tpu/ops/lattice3.py:130 (_conv_interior3 in Lattice3MG._smooth :261, _cycle :271 and "
                    "lattice3_cg :580; XLA-fused, not a Pallas kernel)",
        "max_abs_err": worst,
        **{k: main.get(k) for k in keys},
        # the one PyTorch call that computes a mode of the kernel: the matvec's
        "library_ms": times[N3_BOX, f32, "matvec"]["library_ms"],
        "library": "torch.nn.functional.conv3d with the 3x3x3 weights (matvec mode; cuDNN, TF32 off)",
        "shape": f"{N3_BOX + 1}^3 Jacobi sweep, float32, unmasked (box Poisson's finest level)",
        "host_floor_ctypes_ms": floor["ctypes_ms"],
        "host_floor_empty_like_ms": floor["empty_like_ms"],
    }
    for (n, dt, name), t in times.items():
        tag = f"{name.replace(' ', '_')}_{n + 1}_{str(dt)[6:]}"
        for k in keys:
            if t.get(k) is not None:
                line[f"{tag}_{k}"] = t[k]
    return line


def _hold_lattice3_levels(mg, label: str, f64_matvec: bool = False) -> None:
    """The lattice sweep against its plain version on every smoothed level
    of a Lattice3MG hierarchy, with that level's own packed stencil, pooled
    mask and Jacobi factor, in the cycle's dtype: the masked Jacobi sweep
    and the residual the cycle runs (and, with ``f64_matvec``, the float64
    matvec of lattice3_cg on the finest level).  Random interior inputs;
    these launches are not counted."""
    _, cl = _k3()
    n0 = cl.launches
    rng = np.random.default_rng(SEED + 2)
    tol = {torch.float32: 1e-5, torch.float64: 1e-13}
    worst = {}
    for k, lvl in enumerate(mg.levels[:-1]):  # the coarsest level is a dense solve
        D, R, C = lvl.D, lvl.R, lvl.C
        m = None if mg.masks is None else mg.masks[k]
        od = mg.omega * mg._dinv(k)
        cases = [(cl.JACOBI, mg.dtype), (cl.RESIDUAL, mg.dtype)]
        if f64_matvec and k == 0:
            cases.append((cl.MATVEC, torch.float64))
        for mode, dt in cases:
            x = torch.zeros((D + 2, R + 2, C + 2), dtype=dt, device=DEVICE)
            b = torch.zeros_like(x)
            x[2:D, 2:R, 2:C] = torch.as_tensor(rng.standard_normal((D - 2, R - 2, C - 2)), dtype=dt, device=DEVICE)
            b[2:D, 2:R, 2:C] = torch.as_tensor(rng.standard_normal((D - 2, R - 2, C - 2)), dtype=dt, device=DEVICE)
            mm = None if m is None else m.to(dt)
            yk = cl.lattice3_sweep(mode, x, mg._packed[k], b, mm, od)
            yr = cl.lattice3_sweep_ref(mode, x, mg._packed[k], b, mm, od)
            rel = float((yk - yr).abs().max()) / max(float(yr.abs().max()), 1e-300)
            worst[f"{D}x{R}x{C} mode {mode} {str(dt)[6:]}"] = rel
            if rel > tol[dt]:
                raise AssertionError(f"{label}: lattice3 kernel disagrees with its plain version on level {k} "
                                     f"({D}x{R}x{C}, mode {mode}, {dt}): {rel}")
    cl.launches = n0
    print(f"[{label}] lattice3 kernel against its plain version on {len(mg.levels) - 1} smoothed levels "
          f"({'masked' if mg.masks is not None else 'unmasked'}): max|dy|/max|y| = {max(worst.values()):.3e} "
          f"over {len(worst)} cases")


def _box3(pt, n: int):
    g = pt.Grid3(n, n, n, ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)), device=DEVICE)
    uex = lambda x: torch.sin(math.pi * x[..., 0]) * torch.sin(math.pi * x[..., 1]) * torch.sin(math.pi * x[..., 2])
    return g, uex, (lambda x: 3.0 * math.pi**2 * uex(x))


def phase_box3(pt, n: int) -> None:
    """bench.py's poisson3d: lattice_solver(min_n=8, float32) and
    solve_lattice(tol=1e-10, maxiter=40), cold and warm, in exactly
    BOX3_IT[n] iterations, the nodal error <= 5h^2."""
    g, uex, f = _box3(pt, n)
    s = pt.BoxPoisson3(g)
    _, t_setup = _sync_time(lambda: s.setup(f).assemble())
    mg, t_mg = _sync_time(s.lattice_solver, min_n=8, dtype=torch.float32)
    r0, t_cold = _sync_time(s.solve_lattice, tol=TOL, maxiter=40, mg=mg)
    r, t_warm, runs = _warm_runs(s.solve_lattice, tol=TOL, maxiter=40, mg=mg)
    _hold_lattice3_levels(mg, f"box3 n={n}", f64_matvec=True)
    ndofs = g.num_vertices
    exact = uex(torch.stack(torch.broadcast_tensors(*g.vertex_coords_lattice()), -1))
    err = float((s.u_lat - exact).abs().max())
    h = 1.0 / n
    print(f"[box3 n={n}] ndofs={ndofs} levels={len(mg.levels)}: setup + assemble {t_setup:.3f} s, lattice_solver "
          f"{t_mg:.3f} s, solve cold {t_cold:.3f} s ({r0.iterations} it) / warm median {t_warm:.4f} s of "
          f"{_fmt(runs)}, {r.iterations} it, relres {r.residual:.3e}, {ndofs / t_warm / 1e6:.2f} MDoF/s, max nodal "
          f"err {err:.3e} (5h^2 {5 * h * h:.3e}); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for res in (r0, r):
        if not (res.converged and res.residual <= TOL):
            raise AssertionError(f"box3 n={n}: relres {res.residual}")
        if res.iterations != BOX3_IT[n]:
            raise AssertionError(f"box3 n={n}: {res.iterations} iterations, not {BOX3_IT[n]}")
    if err > 5 * h * h:
        raise AssertionError(f"box3 n={n}: nodal error {err} > 5h^2")


def _weak3(pt, n: int, degree: int, device: str, u=None, f=None):
    g = pt.Grid3(n, n, n, BOX3, device=device)
    p3 = _p3()
    u = p3.u_smooth if u is None else u
    f = (lambda x: 0.5 * p3.u_smooth(x)) if f is None else f
    return pt.WeakDirichletPoisson3(g, degree=degree).setup(p3.phi, f, u_D=u)


def _check_tags3(s, h, label: str) -> None:
    """Card tags equal the CPU lane's except at cells with a vertex where
    |phi| <= KNIFE_EDGE (rounding decides the sign there)."""
    bad = np.argwhere(s.tags.cell_tags != h.tags.cell_tags)
    if bad.size:
        phi, d = h.phi_lat, h.degree
        near = [float(phi[d * z : d * z + d + 1 : d, d * y : d * y + d + 1 : d, d * x : d * x + d + 1 : d].abs().min())
                for z, y, x in bad]
        if max(near) > KNIFE_EDGE:
            raise AssertionError(f"{label}: cell tags differ off the knife edge at {bad[:10]}")
    print(f"[{label}] tags: {len(bad)} cell tags differ from the CPU lane (allowed only at knife-edge cells)")


def _against_cpu3(s, h) -> dict:
    """b and one seeded matvec of the card's scheme against the CPU lane's
    (fields of any shape)."""
    rng = np.random.default_rng(SEED)
    x = {k: torch.as_tensor(rng.standard_normal(tuple(v.shape))) for k, v in h.b.items()}
    yc = s.matvec({k: v.to(DEVICE) for k, v in x.items()})
    yh = h.matvec(x)
    return {"b": max(_rel(s.b[k], h.b[k]) for k in h.b), "matvec": max(_rel(yc[k], yh[k]) for k in yh)}


def _solve_weak3(s, label: str, expect, tol=TOL, maxiter=200) -> tuple:
    """lattice_preconditioner() + BiCGStab, cold and warm; the count pinned
    (``expect`` None: cold and warm take the same count)."""
    M, t_pre = _sync_time(s.lattice_preconditioner)
    kw = dict(method="bicgstab", tol=tol, maxiter=maxiter, precond=M)
    r0, t_cold = _sync_time(s.solve, **kw)
    r, t_warm = _sync_time(s.solve, **kw)
    nd = 2 * s.b["u"].numel()
    print(f"[{label}] ndofs={nd} ({int(s.active['u'].sum()) + int(s.active['p'].sum())} active): "
          f"lattice_preconditioner() {t_pre:.3f} s ({_band(s._band)}); bicgstab tol {tol:.0e}: cold {t_cold:.3f} s "
          f"({r0.iterations} it), warm {t_warm:.3f} s, {r.iterations} it, relres {r.residual:.3e}; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for res in (r0, r):
        if not (res.converged and res.residual <= 10 * tol):
            raise AssertionError(f"{label}: not converged, relres {res.residual}, {res.iterations} it")
        _pin(label, res.iterations, r0.iterations if expect is None else expect)
    _hold_lattice3_levels(M.mg, label)
    return M, r


def phase_weak3_q1(pt) -> dict:
    """Q1 on the sphere: n=32 held against the CPU lane's whole solve (same
    count, u to 1e-6); n=64 and n=128 (4,293,378 DoFs, Schwarz branch)
    solved to 1e-10 in exactly Q1_IT[n] iterations, L2(64) / L2(128) > 3;
    at n=128 the tags, b and one seeded matvec against the CPU lane's."""
    errs, counts = {}, {}
    torch.cuda.reset_peak_memory_stats()
    for n in (N3_Q1_CPU, N3_Q1 // 2, N3_Q1):
        label = f"weak3 Q1 n={n}"
        _reset3()
        s, t_tag = _sync_time(_weak3, pt, n, 1, DEVICE)
        _, t_asm = _sync_time(s.assemble)
        print(f"[{label}] tag {t_tag:.3f} s ({s.tags.num_cut_cells} cut cells), assemble {t_asm:.3f} s")
        M, r = _solve_weak3(s, label, Q1_IT[n])
        counts[n] = _counts3()
        errs[n] = s.l2_h1_errors(_p3().u_smooth)
        print(f"[{label}] relative L2 {errs[n]['l2']:.4e}, H10 {errs[n]['h10']:.4e}; launches {counts[n]}")
        if n == N3_Q1_CPU:
            h = _weak3(pt, n, 1, "cpu").assemble()
            rh = h.solve(tol=TOL, maxiter=200, precond=h.lattice_preconditioner())
            e = _against_cpu3(s, h)
            e["u"] = _rel(r.x["u"], rh.x["u"])
            _check_tags3(s, h, label)
            _hold(label, e)
            print(f"[{label}] CPU lane: {rh.iterations} it (card {r.iterations})")
            if rh.iterations != r.iterations:
                raise AssertionError(f"{label}: {r.iterations} iterations on the card, {rh.iterations} on the CPU")
        if n == N3_Q1:
            t0 = time.perf_counter()
            h = _weak3(pt, n, 1, "cpu").assemble()
            _check_tags3(s, h, label)
            _hold(label, _against_cpu3(s, h))
            del h
            print(f"[{label}] CPU lane (tag, assemble, one matvec) {time.perf_counter() - t0:.1f} s")
            kern = _device_kernels(lambda: s.solve(tol=TOL, maxiter=2, precond=M), 1)
            _, wall = _sync_time(lambda: s.solve(tol=TOL, maxiter=2, precond=M))
            _trace_report(label, kern, wall, 2, "BiCGStab", KERNELS_3D, top=10)
            t0 = time.perf_counter()
            _hold_band(label, s._band.band_tables, s._band.schwarz_sweeps)
            print(f"[time] {label} band kernels {time.perf_counter() - t0:.1f} s")
        del s, M, r
        torch.cuda.empty_cache()
    ratio = errs[N3_Q1 // 2]["l2"] / errs[N3_Q1]["l2"]
    print(f"[weak3 Q1] L2(64) / L2(128) = {ratio:.2f} (> 3: O(h^2))")
    if not ratio > 3.0:
        raise AssertionError(f"weak3 Q1 convergence: {errs}")
    return counts


def phase_weak3_q2(pt) -> dict:
    """Q2 on the sphere with the low-order-refined lattice_preconditioner()
    and BiCGStab to 1e-10 (maxiter 2000) at n=16 and n=32 (549,250 DoFs),
    n=16's count pinned, n=32's with the inner band solve converged
    (Q2_CONVERGED), L2(16) / L2(32) > 6; at n=16 the tags, b and one
    seeded matvec against the CPU lane's; then Q3 at n=N3_Q3 by the sparse
    direct solve, which reproduces a cubic (L2 and H10 < 1e-9)."""
    counts, errs = {}, {}
    for n in (N3_Q2 // 2, N3_Q2):
        label = f"weak3 Q2 n={n}"
        _reset3()
        s, t_build = _sync_time(lambda: _weak3(pt, n, 2, DEVICE).assemble())
        print(f"[{label}] setup + assemble {t_build:.3f} s")
        _, r = _solve_weak3(s, label, Q2_IT[n], maxiter=2000)
        counts[n] = _counts3()
        e = errs[n] = s.l2_h1_errors(_p3().u_smooth)
        print(f"[{label}] relative L2 {e['l2']:.4e}, H10 {e['h10']:.4e}; launches {counts[n]}")
        if n in Q2_CONVERGED:
            sweeps, expect = Q2_CONVERGED[n]
            M = s.lattice_preconditioner(sweeps=sweeps)
            rc, t_c = _sync_time(s.solve, method="bicgstab", tol=TOL, maxiter=2000, precond=M)
            print(f"[{label}] lattice_preconditioner(sweeps={sweeps}) (the inner band solve converged): {t_c:.3f} s, "
                  f"{rc.iterations} it, relres {rc.residual:.3e} (the default sweeps: {r.iterations} it, not pinned)")
            if not (rc.converged and rc.residual <= 10 * TOL):
                raise AssertionError(f"{label} ({sweeps} sweeps): not converged, relres {rc.residual}")
            _pin(f"{label} ({sweeps} sweeps)", rc.iterations, expect)
            del M, rc
        if n == N3_Q2 // 2:
            h = _weak3(pt, n, 2, "cpu").assemble()
            _check_tags3(s, h, label)
            _hold(label, _against_cpu3(s, h))
            del h
        del s
        torch.cuda.empty_cache()
    ratio = errs[N3_Q2 // 2]["l2"] / errs[N3_Q2]["l2"]
    print(f"[weak3 Q2] L2(16) / L2(32) = {ratio:.2f} (> 6: O(h^3))")
    if not ratio > 6.0:
        raise AssertionError(f"weak3 Q2 convergence: {errs}")
    uc = lambda x: x[..., 0] ** 3 - 3.0 * x[..., 0] * x[..., 1] ** 2 + x[..., 2] ** 3 + 0.5 * x[..., 1]
    fc = lambda x: -6.0 * x[..., 2]
    _reset3()
    s, t_build = _sync_time(lambda: _weak3(pt, N3_Q3, 3, DEVICE, u=uc, f=fc).assemble())
    r, t_solve = _sync_time(s.solve, method="sparse")
    e = s.l2_h1_errors(uc)
    counts["Q3"] = _counts3()
    print(f"[weak3 Q3 n={N3_Q3}] ndofs={2 * s.b['u'].numel()}: setup + assemble {t_build:.3f} s, sparse solve "
          f"{t_solve:.3f} s, relres {r.residual:.3e}; cubic reproduced to L2 {e['l2']:.3e}, H10 {e['h10']:.3e} "
          f"(< 1e-9); launches {counts['Q3']}")
    if not (r.converged and e["l2"] < 1e-9 and e["h10"] < 1e-9):
        raise AssertionError(f"Q3 cubic exactness: {e}, relres {r.residual}")
    return counts


def phase_strong3(pt) -> dict:
    """S2-3D on the sphere at n=64: Jacobi-equilibrated BiCGStab to 1e-10
    in exactly STRONG3_IT iterations, the interior error checked."""
    u, f = _strong3_data()
    _reset3()
    g = pt.Grid3(N3_STRONG, N3_STRONG, N3_STRONG, BOX3, device=DEVICE)
    s, t_build = _sync_time(lambda: pt.StrongDirichletPoisson3(g).setup(_p3().phi, f).assemble())
    r0, t_cold = _sync_time(s.solve, tol=TOL, maxiter=8000)
    r, t_warm = _sync_time(s.solve, tol=TOL, maxiter=8000)
    e = s.l2_h1_errors(u)
    print(f"[strong3 n={N3_STRONG}] ndofs={g.num_vertices} ({int(s.active['w'].sum())} active): setup + assemble "
          f"{t_build:.3f} s; bicgstab tol {TOL:.0e}: cold {t_cold:.3f} s ({r0.iterations} it), warm {t_warm:.3f} s, "
          f"{r.iterations} it, relres {r.residual:.3e}; relative L2 {e['l2']:.4e}, H10 {e['h10']:.4e}")
    for res in (r0, r):
        if not (res.converged and res.residual <= 10 * TOL):
            raise AssertionError(f"strong3: relres {res.residual}")
        if res.iterations != STRONG3_IT:
            raise AssertionError(f"strong3: {res.iterations} iterations, not {STRONG3_IT}")
    if not e["l2"] < 0.05:
        raise AssertionError(f"strong3 error {e}")
    return _counts3()


def run_slice_f1(pt) -> tuple:
    """Every 3D phase; returns (the two kernel lines, launches per path)."""
    t0 = time.perf_counter()
    hex_line = phase_kernel_hex3(pt)
    lat_line = phase_kernel_lattice3(pt)
    print(f"[time] 3D kernel phases {time.perf_counter() - t0:.1f} s")
    paths = {}
    for n in (N3_BOX, N3_BOX_LARGE):
        t0 = time.perf_counter()
        _reset3()
        torch.cuda.reset_peak_memory_stats()
        phase_box3(pt, n)
        paths[f"box3 n={n}"] = _counts3()
        torch.cuda.empty_cache()
        print(f"[time] box3 n={n} {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for n, c in phase_weak3_q1(pt).items():
        paths[f"weak3 Q1 n={n}"] = c
    print(f"[time] weak3 Q1 {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for n, c in phase_weak3_q2(pt).items():
        paths[f"weak3 Q2 n={n}" if n != "Q3" else f"weak3 Q3 n={N3_Q3} sparse"] = c
    print(f"[time] weak3 Q2 / Q3 {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paths[f"strong3 n={N3_STRONG}"] = phase_strong3(pt)
    print(f"[time] strong3 {time.perf_counter() - t0:.1f} s")
    print(f"[main path 3D] kernel launches per path: {paths}")
    for p, c in paths.items():
        if p.startswith("weak3") and c["hex3"] <= 0:
            raise AssertionError(f"{p} never launched the hex3 kernel")
        if p.startswith(("box3", "weak3 Q1", "weak3 Q2")) and c["lattice3"] <= 0:
            raise AssertionError(f"{p} never launched the lattice3 kernel")
    hex_line["launches"] = sum(c["hex3"] for c in paths.values())
    hex_line["launches_by_path"] = {p: c["hex3"] for p, c in paths.items()}
    lat_line["launches"] = sum(c["lattice3"] for c in paths.values())
    lat_line["launches_by_path"] = {p: c["lattice3"] for p, c in paths.items()}
    return [hex_line, lat_line], paths


# ------------------------------------------------------------- slice F2
# 3D Neumann and Robin (S3 / S4 on demo/poisson3d's sphere, R0 = 0.7 in
# [-1, 1]^3, u = cos x e^{(y+z)/2}, f = -Δu + u = 3u/2, tol 1e-10) and S5-3D
# (the data of tests/test_interface_elasticity3.py: the sphere r = 1 in
# [-1.5, 1.5]^3, contrast E_in / E_out = 1000, flexible GMRES with the rigid
# modes deflated and lattice_preconditioner(), tol 1e-8)
# the largest Neumann run is n=64 (1.4M DoFs), not the 10.7M of n=128: its
# preconditioned solve took 98.6 s at n=96 (100 it, 4.5M DoFs) and 46.9 s at
# n=80 (80 it, 2.6M) on an H100 (PERF.md), and the whole script must stay
# within its time limit (n=96 until slice I's phases came, n=80 until slice
# H's)
N3_NEU_CPU, N3_NEU_JAC, N3_NEU = 16, 32, 64
# the port's iteration counts on the H100 (PERF.md): Neumann n=16 BiCGStab
# with lattice_preconditioner() (JAX's ceiling on the CPU: <= 25 at n=16;
# the CPU lanes take 8-18: the inner band solve's rounding), n=32 Jacobi
# BiCGStab (the demo's path), n=64 flexible GMRES with
# lattice_preconditioner() (BiCGStab with it stalls there: relres 0.22 /
# 0.028 after 201 / 300 it at n=64, Neumann / Robin; the inner band solve
# makes the preconditioner nonlinear); Robin n=32 Jacobi, n=64 fgmres.
# Neumann n=16 at the default inner sweeps (59) is reported, not pinned: it
# took 11 before the band kernels, 31 with them, 7 in a third summation
# order on an H100 (scripts/compare_band_counts.py); with the inner solve
# converged, 400 sweeps, it takes NEU_CPU_IT on the card and on the CPU
# (below)
NEU_IT = {N3_NEU_CPU: None, N3_NEU_JAC: 496, N3_NEU: 40}
# n=16 against the CPU lane: the inner band solve (m=5,566) run to
# convergence, 400 sweeps (within 1e-6 of 1,500 sweeps on a CPU); one
# application then differs by rounding (the float32 bulk cycle) and what
# 400 sweeps leave
NEU_CPU_SWEEPS, NEU_PRECOND_TOL, NEU_CPU_IT = 400, 1e-5, 5
ROB_IT = {N3_NEU_JAC: 388, N3_NEU: 40}
S53D_BOX = ((-1.5, -1.5, -1.5), (1.5, 1.5, 1.5))
S53D_E_IN, S53D_E_OUT, S53D_NU, S53D_TOL = 1.0, 0.001, 0.3, 1e-8
# the JAX package on the CPU, contrast 1000, as (its count or None, its cap
# or None, L2, H10 or None): docs/s53d_results.csv level 0, n=8 20 it, L2
# 0.6558, H10 0.9675; docs/s53d_convergence.md:31-33, n=12 40 it (cap 55,
# tests/test_interface_elasticity3.py), L2 0.4281; the CSV's level 1, n=16
# L2 0.2942, H10 0.8396 (100 it with the round-4 coarse space; 40 with
# today's harmonic one, cap 55).  A count is held within max(3, 0.25 it),
# the errors within 1%
S53D_REF = {8: (20, None, 0.6557739137168582, 0.9675130155212593), 12: (40, 55, 0.4281, None),
            16: (None, 55, 0.29418185952797904, 0.8395930040423457)}
# the S5-3D scale run is at n=24 (421,875 DoFs), not level 2 (n=32, 970,299
# DoFs, never finished in the JAX package; docs/s53d_convergence.md): n=32
# took 190 s of fgmres (160 it) on an H100 (PERF.md), n=24 65 s
# (scripts/profile_torch_s53d.py runs n=32)
N_S53D_LARGE = 24
N3_BLOCK_LATTICE = (128, 64)  # the block sweep's checks: the S5-3D bulk at n=128 and 64
N3_BLOCK_HEX = (32, 64)  # the block hex stencil's checks: S5-3D's masks, timed at the second
# the port's S5-3D counts on the H100 (PERF.md), n=8, 12 and 16 also held to
# the JAX package's records (S53D_REF).  n=24 is reported, not pinned: it
# took 120 before the band kernels and 160 with them, and with twice the
# inner sweeps (442) 120 with the kernels and 140 / 160 in the former
# summation order in two calls on an H100 (scripts/compare_band_counts.py):
# its inner band solve stops far from convergence at any sweep count the run
# can afford, and rounding sets the count.  Its errors, which rounding does
# not move, are held within 1% of the ones the port took on an H100 before
# the band kernels (L2, H10; 120 it) and with them (160 it), equal to 5
# digits
S53D_IT = {8: 20, 12: 40, 16: 40, N_S53D_LARGE: None}
S53D_ERR = {N_S53D_LARGE: (0.16213, 0.70342)}


def _du_dn(x):
    """d u_smooth / dn with n = x / |x|: the closed form of demo/poisson3d's
    ``du_dn`` (torch.func there, which rounds differently in the last bit);
    the Neumann / Robin counts below are pinned with this one."""
    u = _p3().u_smooth(x)
    g = torch.stack([-torch.sin(x[..., 0]) * torch.exp((x[..., 1] + x[..., 2]) / 2.0), 0.5 * u, 0.5 * u], -1)
    return torch.sum(g * x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=1e-12), dim=-1)


def _neumann3(pt, n: int, device: str, robin: bool = False):
    g = pt.Grid3(n, n, n, BOX3, device=device)
    p3 = _p3()
    f = lambda x: 1.5 * p3.u_smooth(x)
    if robin:
        return pt.RobinPoisson3(g, robin_coef=1.0).setup(p3.phi, f, lambda x: _du_dn(x) + p3.u_smooth(x))
    return pt.NeumannPoisson3(g).setup(p3.phi, f, _du_dn)


def _s53d_data():
    """S5-3D's exact solution (cos r - cos 1) / E per side and its source
    -div sigma_in(cos r (1, 1, 1)) / E_in (torch.func)."""
    from torch.func import jacfwd, vmap

    from phifem_tpu_torch.models.interface_elasticity import lame

    lmbda, mu = lame(S53D_E_IN, S53D_NU)

    def exact(x):
        r = torch.sqrt(x[..., 0] ** 2 + x[..., 1] ** 2 + x[..., 2] ** 2 + 1e-30)
        val = (torch.cos(r) - math.cos(1.0)) / S53D_E_IN
        val = torch.where(r < 1.0, val * (S53D_E_IN / S53D_E_OUT), val)
        return torch.stack([val, val, val], dim=-1)

    def _sigma(p):
        G = jacfwd(lambda q: torch.cos(torch.sqrt(q[0] ** 2 + q[1] ** 2 + q[2] ** 2 + 1e-30)) * torch.ones_like(q))(p)
        return lmbda * torch.trace(G) * torch.eye(3, dtype=p.dtype, device=p.device) + mu * (G + G.T)

    def source(x):
        Dg = vmap(jacfwd(_sigma))(x.reshape(-1, 3))
        return (-torch.einsum("nijj->ni", Dg) / S53D_E_IN).reshape(x.shape[:-1] + (3,))

    return exact, source


def _s53d(pt, n: int, device: str):
    exact, source = _s53d_data()
    g = pt.Grid3(n, n, n, S53D_BOX, device=device)
    s = pt.InterfaceElasticity3(g, E_in=S53D_E_IN, E_out=S53D_E_OUT, nu_in=S53D_NU, nu_out=S53D_NU)
    return s.setup(lambda x: 1.0 - (x[..., 0] ** 2 + x[..., 1] ** 2 + x[..., 2] ** 2), source, exact), exact


def _hex3_block_csr(mask: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """The float64 CUDA CSR matrix of the 3-channel block hex stencil (the
    library call's input; the port never builds it)."""
    nz, ny, nx = mask.shape
    R, C = ny + 1, nx + 1
    N = (nz + 1) * R * C
    c = torch.nonzero(mask != 0)
    base = (c[:, 0] * R + c[:, 1]) * C + c[:, 2]
    off = torch.tensor([(oz * R + oy) * C + ox for ox, oy, oz in _k3()[0].hex_offsets(1)], device=mask.device)
    nodes = base[:, None] + off[None, :]  # (ne, 8)
    dofs = torch.cat([ch * N + nodes for ch in range(3)], dim=1)  # (ne, 24), channel-major
    rows = dofs[:, :, None].expand(-1, 24, 24).reshape(-1)
    cols = dofs[:, None, :].expand(-1, 24, 24).reshape(-1)
    vals = K.to(torch.float64)[None] * mask[c[:, 0], c[:, 1], c[:, 2]].to(torch.float64)[:, None, None]
    coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals.reshape(-1), (3 * N, 3 * N))
    del rows, cols, vals
    return coo.coalesce().to_sparse_csr()


def phase_kernel_hex3_block(pt) -> dict:
    """The 3-channel block hex-cell stencil against its plain version on the
    card, on both sides' masks of the S5-3D sphere at n=32 and n=64 with
    their own elasticity cell matrices, float32 and float64; at n=64 timed
    beside its bound (x read and y written, 3 channels, and the mask read),
    its no-FMA floor, the plain version and torch.mv of the operator's CSR
    matrix in the value type."""
    from phifem_tpu_torch.models.interface_elasticity import lame
    from phifem_tpu_torch.models.interface_elasticity3 import _elastic_element_matrix
    from phifem_tpu_torch.tagging3 import compute_tags3

    ch, _ = _k3()
    rng = np.random.default_rng(SEED + 3)
    tol = {torch.float32: 1e-5, torch.float64: 1e-13}
    worst, out = 0.0, {}
    for n in N3_BLOCK_HEX:
        g = pt.Grid3(n, n, n, S53D_BOX, device=DEVICE)
        tags = compute_tags3(g, lambda x: 1.0 - (x[..., 0] ** 2 + x[..., 1] ** 2 + x[..., 2] ** 2))
        for side, region, E in (("in", (1, 2), S53D_E_IN), ("out", (2, 3), S53D_E_OUT)):
            K64 = torch.as_tensor(_elastic_element_matrix(*g.spacing, *lame(E, S53D_NU)))
            for dt in (torch.float32, torch.float64):
                mask = torch.as_tensor(tags.region_mask(region), dtype=dt, device=DEVICE).contiguous()
                x = torch.as_tensor(rng.standard_normal((3, n + 1, n + 1, n + 1)), dtype=dt, device=DEVICE)
                K = K64.to(dt).to(DEVICE).contiguous()
                yk = ch.hex_block_stencil3(x, mask, K)
                yr = ch.hex_block_stencil3_ref(x, mask, K)
                torch.cuda.synchronize()
                err = float((yk - yr).abs().max())
                rel = err / float(yr.abs().max())
                worst = max(worst, err)
                ncell = int((mask != 0).sum())
                print(f"[kernel hex3 block] n={n} {side:3s} {str(dt)[6:]:7s} {ncell} masked cells: max|dy|/max|y| = "
                      f"{rel:.3e} (tol {tol[dt]:.0e}) {'ok' if rel <= tol[dt] else 'FAIL'}")
                if rel > tol[dt]:
                    raise AssertionError(f"hex3 block kernel disagrees with its plain version: {rel} > {tol[dt]}")
                if n != N3_BLOCK_HEX[-1]:
                    continue
                nbytes = (2 * x.numel() + mask.numel()) * x.element_size()
                bound = _bound(nbytes, 2 * 24 * 24 * ncell, dt)
                call = lambda: ch.hex_block_stencil3(x, mask, K)
                # the device time of a launch counts its copy of K into the constant bank
                t = {"device_ms": _device_ms(call, 20, "hexblock_stencil3_kernel", also="Memcpy"),
                     "kernel_only_device_ms": _device_ms(call, 20, "hexblock_stencil3_kernel"),
                     "ms": _event_ms(call, 20),
                     "host_ms": _host_ms(call, 20), "plain_ms": _event_ms(lambda: ch.hex_block_stencil3_ref(x, mask, K), 2),
                     "library_ms": None, "bound_ms": bound[0], "bound_by": bound[1]}
                floor_ms = _floor(2 * 24 * 24 * ncell, dt)
                # the library call: the operator as a CUDA CSR matrix in the value type
                A = _hex3_block_csr(mask, K)
                if dt is not torch.float64:
                    A = torch.sparse_csr_tensor(A.crow_indices(), A.col_indices(), A.values().to(dt), A.shape)
                yl = torch.mv(A, x.reshape(-1))
                rel_l = float((yl - yr.reshape(-1)).abs().max()) / float(yr.abs().max())
                if rel_l > {torch.float32: 1e-5, torch.float64: 1e-12}[dt]:
                    raise AssertionError(f"the hex3 block CSR is not the kernel's operator: {rel_l}")
                t["library_ms"] = _event_ms(lambda: torch.mv(A, x.reshape(-1)), 10)
                lib = f"; CSR torch.mv {t['library_ms']:.4f} ms ({A._nnz()} nonzeros)"
                del A, yl
                out[side, dt] = t
                print(f"[kernel hex3 block] time n={n} {side} {str(dt)[6:]}: {t['ms']:.4f} ms per call (CUDA events), "
                      f"{t['device_ms']:.4f} ms device per launch with its copy of K (profiler; the kernel alone "
                      f"{t['kernel_only_device_ms']:.4f}), {t['host_ms']:.4f} ms host per call; "
                      f"bound {bound[0]:.4f} ms by {bound[1]} ({nbytes / 1e6:.1f} MB), {bound[0] / t['device_ms']:.1%} "
                      f"of it by device time, {bound[0] / t['ms']:.1%} by ms; no-FMA floor {floor_ms:.4f} ms, "
                      f"{floor_ms / t['device_ms']:.1%} of it; plain {t['plain_ms']:.3f} ms{lib}")
        torch.cuda.empty_cache()
    keys = ("ms", "device_ms", "host_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    f64, f32 = torch.float64, torch.float32
    return {
        "name": "hex_block_stencil3",
        "route": "cuda",
        "source": "phifem_tpu_torch/csrc/hex_stencil3.cu",
        "replaces": "phifem_tpu/models/interface_elasticity3.py:122 (_masked_block_stencil_apply, XLA-fused; not a "
                    "Pallas kernel)",
        "max_abs_err": worst,
        **{k: out["in", f64][k] for k in keys},
        "library": "torch.mv of the operator as a CUDA CSR matrix (cuSPARSE SpMV)",
        "shape": f"S5-3D in-side mask n={N3_BLOCK_HEX[-1]} (3 x {N3_BLOCK_HEX[-1] + 1}^3 nodes), float64",
        **{f"out_{k}": out["out", f64][k] for k in keys},
        **{f"f32_{k}": out["in", f32][k] for k in keys},
        **{f"out_f32_{k}": out["out", f32][k] for k in keys},
    }


def phase_kernel_lattice3_block(pt) -> dict:
    """The 3-channel block lattice sweep against its plain version on the
    card at 129^3 and 65^3 x 3 channels (the S5-3D bulk at n=128 and 64) in
    its modes, float32 and float64, each timed beside its bound (x and b
    read, out written, 3 channels, and the mask), its no-FMA floor, the
    plain version and, for the matvec, torch.nn.functional.conv3d with 3 in
    and 3 out channels."""
    from phifem_tpu_torch.models.interface_elasticity import lame
    from phifem_tpu_torch.models.interface_elasticity3 import _elastic_element_matrix
    from phifem_tpu_torch.ops.lattice3 import _block_terms3, block_vertex_stencil_weights3

    _, cl = _k3()
    rng = np.random.default_rng(SEED + 4)
    tol = {torch.float32: 1e-5, torch.float64: 1e-13}
    worst, times = 0.0, {}
    for n in N3_BLOCK_LATTICE:
        D = n + 1
        h = 3.0 / n
        terms = _block_terms3(block_vertex_stencil_weights3(_elastic_element_matrix(h, h, h, *lame(1.0, S53D_NU)), 3))
        dinv = np.linalg.inv(next(W for a, b, c, W in terms if (a, b, c) == (1, 1, 1)))
        packed = cl.pack_block_terms(terms, dinv)
        for dt in (torch.float32, torch.float64):
            x = torch.zeros((3,) + (D + 2,) * 3, dtype=dt, device=DEVICE)
            x[:, 2:D, 2:D, 2:D] = torch.as_tensor(rng.standard_normal((3,) + (D - 2,) * 3), dtype=dt, device=DEVICE)
            b = torch.zeros_like(x)
            b[:, 2:D, 2:D, 2:D] = torch.as_tensor(rng.standard_normal((3,) + (D - 2,) * 3), dtype=dt, device=DEVICE)
            mask = torch.as_tensor(rng.random((D,) * 3) < 0.7, dtype=dt, device=DEVICE)
            for mode, name, m in ((cl.MATVEC, "matvec", None), (cl.RESIDUAL, "residual", mask),
                                  (cl.JACOBI, "jacobi masked", mask), (cl.JACOBI, "jacobi", None)):
                yk = cl.lattice3_block_sweep(mode, x, packed, b, m, 0.6)
                yr = cl.lattice3_block_sweep_ref(mode, x, packed, b, m, 0.6)
                torch.cuda.synchronize()
                err = float((yk - yr).abs().max())
                rel = err / float(yr.abs().max())
                worst = max(worst, err)
                if rel > tol[dt]:
                    raise AssertionError(f"lattice3 block kernel ({name}) disagrees with its plain version: {rel}")
                nb = (2 + (mode != cl.MATVEC)) * x.numel() + (0 if m is None else m.numel())
                ops = 2 * 9 * len(terms) * (D - 2) ** 3
                bound = _bound(nb * x.element_size(), ops, dt)
                call = lambda: cl.lattice3_block_sweep(mode, x, packed, b, m, 0.6)
                t = {"ms": _event_ms(call, 20), "plain_ms": _event_ms(
                    lambda: cl.lattice3_block_sweep_ref(mode, x, packed, b, m, 0.6), 2),
                     "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None,
                     "device_ms": _device_ms(call, 10, "lattice3_block_kernel"), "host_ms": _host_ms(call, 20)}
                floor_ms = _floor(ops, dt)
                if mode == cl.MATVEC:
                    Wc = torch.zeros((3, 3, 3, 3, 3), dtype=dt, device=DEVICE)
                    for a, bb, c, W in terms:
                        Wc[:, :, a, bb, c] = torch.as_tensor(W, dtype=dt, device=DEVICE)
                    conv = lambda: torch.nn.functional.conv3d(x[None], Wc)
                    yl = conv()[0, :, 1:-1, 1:-1, 1:-1]
                    rel_l = float((yl - yk[:, 2:D, 2:D, 2:D]).abs().max()) / float(yr.abs().max())
                    if rel_l > 10 * tol[dt]:
                        raise AssertionError(f"conv3d is not the block kernel's matvec: {rel_l}")
                    t["library_ms"] = _event_ms(conv, 20)
                times[n, dt, name] = t
                extra = "".join(f", {k} {t[k]:.4f}" for k in ("device_ms", "host_ms", "library_ms")
                                if t.get(k) is not None)
                print(f"[kernel lattice3 block] {name:13s} {str(dt)[6:]:7s} 3 x {D}^3: max|dy|/max|y| = {rel:.3e} "
                      f"(tol {tol[dt]:.0e}) ok; ms {t['ms']:.4f} (bound {bound[0]:.4f} by {bound[1]}, "
                      f"{bound[0] / t['device_ms']:.1%} by device time, {bound[0] / t['ms']:.1%} by ms; no-FMA floor "
                      f"{floor_ms:.4f}, {floor_ms / t['device_ms']:.1%} of it), plain "
                      f"{t['plain_ms']:.4f}{extra}")
            del x, b, mask, yk, yr
            torch.cuda.empty_cache()
    keys = ("ms", "device_ms", "host_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    main = times[N3_BLOCK_LATTICE[0], torch.float32, "jacobi masked"]
    line = {
        "name": "lattice3_block_sweep",
        "route": "cuda",
        "source": "phifem_tpu_torch/csrc/lattice3_sweep.cu",
        "replaces": "phifem_tpu/ops/lattice3.py:381 (_conv_interior3_block in Lattice3BlockMG._smooth :464 and "
                    "_cycle :493; XLA-fused, not a Pallas kernel)",
        "max_abs_err": worst,
        **{k: main.get(k) for k in keys},
        "library_ms": times[N3_BLOCK_LATTICE[0], torch.float32, "matvec"]["library_ms"],
        "library": "torch.nn.functional.conv3d, 3 in / 3 out channels, 3x3x3 weights (matvec mode; cuDNN, TF32 off)",
        "shape": "3 x 129^3 masked block Jacobi sweep, float32 (the S5-3D bulk cycle's finest level at n=128)",
    }
    for (n, dt, name), t in times.items():
        tag = f"{name.replace(' ', '_')}_{n + 1}_{str(dt)[6:]}"
        for k in keys:
            if t.get(k) is not None:
                line[f"{tag}_{k}"] = t[k]
    return line


def _hold_lattice3_block_levels(mg, label: str) -> None:
    """The block sweep against its plain version on every smoothed level of
    a Lattice3BlockMG, with that level's packed blocks and pooled mask, in
    the cycle's dtype: the masked block Jacobi sweep and the residual.
    Random interior inputs; these launches are not counted."""
    _, cl = _k3()
    n0 = cl.block_launches
    rng = np.random.default_rng(SEED + 5)
    tol = {torch.float32: 1e-5, torch.float64: 1e-13}
    worst = 0.0
    for k, lvl in enumerate(mg.levels[:-1]):
        D, R, C = lvl.D, lvl.R, lvl.C
        m = None if mg.masks is None else mg.masks[k]
        for mode in (cl.JACOBI, cl.RESIDUAL):
            x = torch.zeros((3, D + 2, R + 2, C + 2), dtype=mg.dtype, device=DEVICE)
            b = torch.zeros_like(x)
            x[:, 2:D, 2:R, 2:C] = torch.as_tensor(rng.standard_normal((3, D - 2, R - 2, C - 2)), dtype=mg.dtype,
                                                  device=DEVICE)
            b[:, 2:D, 2:R, 2:C] = torch.as_tensor(rng.standard_normal((3, D - 2, R - 2, C - 2)), dtype=mg.dtype,
                                                  device=DEVICE)
            yk = cl.lattice3_block_sweep(mode, x, mg._packed[k], b, m, mg.omega)
            yr = cl.lattice3_block_sweep_ref(mode, x, mg._packed[k], b, m, mg.omega)
            rel = float((yk - yr).abs().max()) / max(float(yr.abs().max()), 1e-300)
            worst = max(worst, rel)
            if rel > tol[mg.dtype]:
                raise AssertionError(f"{label}: lattice3 block kernel disagrees with its plain version on level {k}: "
                                     f"{rel}")
    cl.block_launches = n0
    print(f"[{label}] lattice3 block kernel against its plain version on {len(mg.levels) - 1} smoothed levels: "
          f"max|dy|/max|y| = {worst:.3e}")


def _profile_steps3(s, M, label: str, deflate=None, steps: int = 2) -> None:
    """A device trace of ``steps`` Arnoldi steps of the flexible GMRES that
    ``s.solve(method="fgmres")`` runs on a 3D scheme (its equilibrated
    operator, ``M`` and ``deflate``; one cycle of ``restart=steps``)."""
    from phifem_tpu_torch.models.lattice_core import make_equilibrated_runner

    run_eq = make_equilibrated_runner(s.matvec, s.diag, s.active, method="fgmres", tol=0.0, maxiter=steps,
                                      precond=M, deflate=deflate, restart=steps)
    run = lambda: run_eq(s.b)
    _, wall = _sync_time(run)
    _trace_report(label, _device_kernels(run, 1), wall, steps, "fgmres", KERNELS_3D, top=10)


def _hold_hex3_scheme(label: str, cases) -> None:
    """hex3 (an 8 x 8 cell matrix, d=1) or the block hex stencil (24 x 24)
    against its plain version on a scheme's own cell masks and matrices,
    ``cases = [(mask, A), ...]``, with a seeded x in A's dtype; these
    launches are not counted."""
    ch, _ = _k3()
    n0, nb0 = ch.launches, ch.block_launches
    rng = np.random.default_rng(SEED + 6)
    tol = {torch.float32: 1e-5, torch.float64: 1e-13}
    worst = {}
    for mask, A in cases:
        block = A.shape[0] == 24
        x = torch.as_tensor(rng.standard_normal(((3,) if block else ()) + tuple(k + 1 for k in mask.shape)),
                            dtype=A.dtype, device=DEVICE)
        if block:
            yk, yr = ch.hex_block_stencil3(x, mask, A), ch.hex_block_stencil3_ref(x, mask, A)
        else:
            yk, yr = ch.hex_stencil3(x, mask, A, 1), ch.hex_stencil3_ref(x, mask, A, 1)
        rel = float((yk - yr).abs().max()) / max(float(yr.abs().max()), 1e-300)
        name = "hex3 block" if block else "hex3"
        worst[name] = max(worst.get(name, 0.0), rel)
        if rel > tol[A.dtype]:
            raise AssertionError(f"{label}: {name} kernel disagrees with its plain version on the scheme's mask "
                                 f"{tuple(mask.shape)}: {rel}")
    ch.launches, ch.block_launches = n0, nb0
    print(f"[{label}] " + ", ".join(f"{k} kernel against its plain version on the scheme's own masks and cell "
                                     f"matrices: max|dy|/max|y| = {v:.3e}" for k, v in worst.items()))


def _pin(label: str, got: int, expect: int) -> None:
    if got != expect:
        raise AssertionError(f"{label}: {got} iterations, not {expect}")


def _neumann3_against_cpu(pt, s, label: str, robin: bool) -> None:
    """The card's scheme against the CPU lane's: tags equal, b and one
    matvec to 1e-12; then lattice_preconditioner(sweeps=NEU_CPU_SWEEPS) on
    both, one application to a seeded residual to NEU_PRECOND_TOL and the
    whole BiCGStab solve with it: an equal count, u to 1e-6.  At the default
    sweeps the inner band solve stops far from convergence, and its rounding
    moves the count (11 on an H100; 8 and 18 on two CPUs, PERF.md); run to
    convergence, the preconditioner is a fixed operator up to rounding."""
    h = _neumann3(pt, s.grid.nx, "cpu", robin).assemble()
    if not np.array_equal(s.tags.cell_tags, h.tags.cell_tags):
        raise AssertionError(f"{label}: cell tags differ from the CPU lane's")
    ec = _against_cpu3(s, h)
    Mc, Mh = s.lattice_preconditioner(sweeps=NEU_CPU_SWEEPS), h.lattice_preconditioner(sweeps=NEU_CPU_SWEEPS)
    rng = np.random.default_rng(SEED + 7)
    r = {k: torch.where(h.active[k], torch.as_tensor(rng.standard_normal(tuple(v.shape))), 0.0) for k, v in h.b.items()}
    zc, zh = Mc({k: v.to(DEVICE) for k, v in r.items()}), Mh(r)
    e_pre = max(_rel(zc[k], zh[k]) for k in zh)
    rc = s.solve(tol=TOL, maxiter=400, precond=Mc)
    rh = h.solve(tol=TOL, maxiter=400, precond=Mh)
    ec["u"] = _rel(rc.x["u"], rh.x["u"])
    _hold(label, ec)
    print(f"[{label}] tags equal the CPU lane's; lattice_preconditioner(sweeps={NEU_CPU_SWEEPS}) (interface "
          f"m={Mc.iface.m}): one application max rel diff {e_pre:.3e} (tol {NEU_PRECOND_TOL:.0e}), BiCGStab "
          f"{rc.iterations} it on the card, {rh.iterations} on the CPU")
    if e_pre > NEU_PRECOND_TOL:
        raise AssertionError(f"{label}: the preconditioner on the card disagrees with the CPU lane's: {e_pre}")
    if not (rc.converged and rc.iterations == rh.iterations):
        raise AssertionError(f"{label}: {rc.iterations} iterations on the card, {rh.iterations} on the CPU")
    _pin(f"{label} ({NEU_CPU_SWEEPS} sweeps)", rc.iterations, NEU_CPU_IT)


def phase_neumann3(pt, robin: bool = False) -> dict:
    """S3-3D (or S4-3D with ``robin``) on the sphere: (Neumann) n=16,
    BiCGStab with lattice_preconditioner(), and against the CPU lane
    (:func:`_neumann3_against_cpu`); n=32 Jacobi-equilibrated BiCGStab (the
    demo's path); n=64 flexible GMRES with lattice_preconditioner(), for
    Neumann with a trace of two fgmres steps; every count pinned (Neumann
    n=16 with the inner band solve converged, NEU_CPU_IT); hex3 and the lattice
    sweep held against their plain versions on each n's own mask, cell
    matrix and cycle levels; L2(32) / L2(64) > 2^1.3."""
    name = "robin3" if robin else "neumann3"
    pins = ROB_IT if robin else NEU_IT
    ns = (N3_NEU_JAC, N3_NEU) if robin else (N3_NEU_CPU, N3_NEU_JAC, N3_NEU)
    counts, errs = {}, {}
    for n in ns:
        label = f"{name} n={n}"
        _reset3()
        torch.cuda.reset_peak_memory_stats()
        s, t_tag = _sync_time(_neumann3, pt, n, DEVICE, robin)
        _, t_asm = _sync_time(s.assemble)
        nd = sum(v.numel() for v in s.b.values())
        kw = dict(tol=TOL, maxiter=20000 if n == N3_NEU_JAC else 400)
        if n == N3_NEU_JAC:
            M, t_pre = None, 0.0
        else:
            M, t_pre = _sync_time(s.lattice_preconditioner)
            kw["precond"] = M
        if n >= N3_NEU:
            kw["method"] = "fgmres"
        r0, t_cold = _sync_time(s.solve, **kw)
        # the large runs once; the small ones cold and warm
        r, t_warm = (r0, t_cold) if n >= N3_NEU else _sync_time(s.solve, **kw)
        counts[n] = _counts3()
        e = errs[n] = s.l2_h1_errors(_p3().u_smooth)
        band = ""
        if M is not None:
            bd = getattr(M.iface, "band", None)
            band = (f"; interface m={M.iface.m}, " + ("dense inverse" if bd is None else
                    f"{bd.band_tables.nb} blocks of <= {bd.band_tables.K}, {bd.schwarz_sweeps} sweeps"))
        print(f"[{label}] ndofs={nd} ({sum(int(v.sum()) for v in s.active.values())} active, "
              f"{s.tags.num_cut_cells} cut cells): tag {t_tag:.3f} s, assemble {t_asm:.3f} s, "
              f"{'Jacobi' if M is None else 'lattice_preconditioner() %.3f s' % t_pre}{band}; "
              f"{kw.get('method', 'bicgstab')} tol {TOL:.0e}: cold {t_cold:.3f} s ({r0.iterations} it), warm "
              f"{t_warm:.3f} s, {r.iterations} it, relres "
              f"{r.residual:.3e}; relative L2 {e['l2']:.4e}, H10 {e['h10']:.4e}; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {counts[n]}")
        for res in (r0, r):
            if not (res.converged and res.residual <= 10 * TOL):
                raise AssertionError(f"{label}: not converged, relres {res.residual}, {res.iterations} it")
        if r0.iterations != r.iterations:
            raise AssertionError(f"{label}: cold {r0.iterations} and warm {r.iterations} iterations")
        if pins[n] is not None:
            _pin(label, r.iterations, pins[n])
        _hold_hex3_scheme(label, [(s.bulk_mask, s.A8)])
        if M is not None:
            _hold_lattice3_levels(M.mg, label)
        if n == N3_NEU_CPU:
            _neumann3_against_cpu(pt, s, label, robin)
        if n == N3_NEU and not robin:
            _profile_steps3(s, M, label)
        del s, M, r, r0
        torch.cuda.empty_cache()
    rate = math.log2(errs[N3_NEU_JAC]["l2"] / errs[N3_NEU]["l2"])
    print(f"[{name}] L2 rate between n={N3_NEU_JAC} and n={N3_NEU}: {rate:.3f} (> 1.3)")
    if not rate > 1.3:
        raise AssertionError(f"{name} convergence: {errs}")
    return counts


def phase_s53d(pt) -> dict:
    """S5-3D: flexible GMRES to 1e-8 with the rigid modes deflated and the
    default lattice_preconditioner() (block V-cycles on both bulks, the band
    solve on per-vertex blocks, the solid-harmonic coarse step) at n=8, 12
    and 16 (counts and errors against the JAX package's records, S53D_REF)
    and at n=24 (the scale run: its errors held, S53D_ERR, its count
    reported), the other counts pinned; at each n the block hex stencil and hex3 held
    against their plain versions on the scheme's own masks and cell
    matrices and the block sweep on every smoothed level of both cycles; at
    n=24 set-up, solve wall and a trace of two fgmres steps."""
    counts = {}
    for n in (8, 12, 16, N_S53D_LARGE):
        label = f"s53d n={n}"
        _reset3()
        torch.cuda.reset_peak_memory_stats()
        (s, exact), t_tag = _sync_time(_s53d, pt, n, DEVICE)
        _, t_asm = _sync_time(s.assemble)
        M, t_pre = _sync_time(s.lattice_preconditioner)
        modes = s.rigid_modes()
        kw = dict(method="fgmres", tol=S53D_TOL, maxiter=2000, precond=M, deflate=modes)
        r, t_solve = _sync_time(s.solve, **kw)
        counts[n] = _counts3()
        e = s.l2_h1_errors(exact)
        nd = sum(v.numel() for v in s.b.values())
        print(f"[{label}] ndofs={nd} ({sum(int(v.sum()) for v in s.active.values())} active, "
              f"{s.tags.num_cut_cells} cut cells): tag {t_tag:.3f} s, assemble {t_asm:.3f} s, "
              f"lattice_preconditioner() {t_pre:.3f} s (interface m={M.iface.m}, "
              f"{M.iface.band.band_tables.nb} vertex blocks, {M.iface.band.schwarz_sweeps} inner sweeps; "
              f"coarse basis k={s._coarse_Z.shape[0]}); fgmres tol {S53D_TOL:.0e}: {t_solve:.3f} s, "
              f"{r.iterations} it, relres {r.residual:.3e}; relative L2 {e['l2']:.4e}, H10 {e['h10']:.4e}; peak "
              f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {counts[n]}")
        if not (r.converged and r.residual <= 10 * S53D_TOL):
            raise AssertionError(f"{label}: not converged, relres {r.residual}, {r.iterations} it")
        if n in S53D_REF:
            it_ref, cap, l2, h10 = S53D_REF[n]
            ok_it = ((it_ref is None or abs(r.iterations - it_ref) <= max(3, 0.25 * it_ref))
                     and (cap is None or r.iterations <= cap))
            ok_e = abs(e["l2"] - l2) <= 0.01 * l2 and (h10 is None or abs(e["h10"] - h10) <= 0.01 * h10)
            h10_vs = "" if h10 is None else f", H10 {e['h10']:.4f} (JAX {h10:.4f})"
            print(f"[{label}] against the JAX package: {r.iterations} it (JAX {it_ref}, cap {cap}), L2 {e['l2']:.4f} "
                  f"(JAX {l2:.4f}){h10_vs}")
            if not (ok_it and ok_e):
                raise AssertionError(f"{label}: {r.iterations} it, errors {e}, against {S53D_REF[n]}")
        if n in S53D_ERR:
            l2, h10 = S53D_ERR[n]
            print(f"[{label}] {r.iterations} it (not pinned); L2 {e['l2']:.5f}, H10 {e['h10']:.5f} (held within 1% "
                  f"of {l2}, {h10})")
            if not (abs(e["l2"] - l2) <= 0.01 * l2 and abs(e["h10"] - h10) <= 0.01 * h10):
                raise AssertionError(f"{label}: errors {e}, against {S53D_ERR[n]}")
        if S53D_IT[n] is not None:
            _pin(label, r.iterations, S53D_IT[n])
        A8 = torch.as_tensor(np.random.default_rng(SEED + 8).standard_normal((8, 8)), device=DEVICE)
        _hold_hex3_scheme(label, [(s.mask_in, s.K_in), (s.mask_out, s.K_out), (s.mask_in, A8), (s.mask_out, A8)])
        for mg in M.mgs.values():
            _hold_lattice3_block_levels(mg, label)
        if n == N_S53D_LARGE:
            _profile_steps3(s, M, label, deflate=modes)
            t0 = time.perf_counter()
            _hold_band(label, M.iface.band.band_tables, M.iface.band.schwarz_sweeps)
            print(f"[time] {label} band kernels {time.perf_counter() - t0:.1f} s")
        del s, M, r, modes
        torch.cuda.empty_cache()
    return counts


def run_slice_f2(pt) -> tuple:
    """Every slice-F2 phase; returns (the two block kernels' lines, launches
    per path)."""
    t0 = time.perf_counter()
    hexb = phase_kernel_hex3_block(pt)
    latb = phase_kernel_lattice3_block(pt)
    print(f"[time] 3D block kernel phases {time.perf_counter() - t0:.1f} s")
    paths = {}
    for robin in (False, True):
        t0 = time.perf_counter()
        name = "robin3" if robin else "neumann3"
        for n, c in phase_neumann3(pt, robin).items():
            paths[f"{name} n={n}"] = c
        print(f"[time] {name} {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for n, c in phase_s53d(pt).items():
        paths[f"s53d n={n}"] = c
    print(f"[time] s53d {time.perf_counter() - t0:.1f} s")
    print(f"[main path F2] kernel launches per path: {paths}")
    for p, c in paths.items():
        if c["hex3"] <= 0:
            raise AssertionError(f"{p} never launched the hex3 kernel")
        if p.startswith(("neumann3", "robin3")) and not p.endswith(f"n={N3_NEU_JAC}") and c["lattice3"] <= 0:
            raise AssertionError(f"{p} never launched the lattice3 kernel")
        if p.startswith("s53d") and (c["hex3_block"] <= 0 or c["lattice3_block"] <= 0):
            raise AssertionError(f"{p} never launched the block kernels")
    hexb["launches"] = sum(c["hex3_block"] for c in paths.values())
    hexb["launches_by_path"] = {p: c["hex3_block"] for p, c in paths.items() if c["hex3_block"]}
    latb["launches"] = sum(c["lattice3_block"] for c in paths.values())
    latb["launches_by_path"] = {p: c["lattice3_block"] for p, c in paths.items() if c["lattice3_block"]}
    return [hexb, latb], paths


# ------------------------------------------------------------- slice G1a
# imported triangle meshes (UMesh, host tagging, uassembly):
# demo/unstructured/main.py's four schemes on its fallback mesh (n=24,
# amplitude 0.25 h, seed 0, the circle r^2 = 0.49, bg mode, Jacobi BiCGStab
# to 1e-10) and S1-U with amg_preconditioner() on tests/test_amg.py's
# perturbed mesh (the circle R = 0.7, u = cos x sin y, BiCGStab to 1e-10)
U_BOX = ((-1.0, -1.0), (1.0, 1.0))
N_U_DEMO, U_DEMO_R2 = 24, 0.49
# the JAX package on the CPU, (it, relative L2, relative H10): `JAX_PLATFORMS=cpu
# python demo/unstructured/main.py s1` (and s2, s3, s4)
JAX_U_DEMO = {"s1": (122, 5.611608e-02, 8.397702e-02), "s2": (68, 2.435475e-02, 1.057248e-01),
              "s3": (364, 4.488036e-03, 2.475809e-02), "s4": (277, 4.127471e-03, 2.221986e-02)}
# the JAX package's S1-U counts with amg_preconditioner() on the CPU:
# `JAX_PLATFORMS=cpu python scripts/reference_amg_counts.py 40 80 160`
JAX_AMG_IT = {40: 14, 80: 16, 160: 18}
# the demo's solution (u, or w for S2) is held to 1e-6 of the CPU lane's, as
# in _hold; its auxiliary fields (S1's p, S3 / S4's flux y and p) to 1e-5:
# their readings on the H100 (PERF.md) were at most 1.823e-06 (S3's p),
# 7.841e-08 (y) and 1.098e-08 (S1's p)
U_AUX_TOL = 1e-5
# the scale run: 641,601 vertices, 1,280,000 triangles
N_AMG_LARGE = 800
# the port's counts on the H100 (PERF.md): exact, since every sum on the
# solve path runs in a fixed order
U_DEMO_IT = {"s1": 114, "s2": 76, "s3": 319, "s4": 266}
# n=800 (a Schwarz band) took 66 before the band kernels, 2,112 launches
AMG_IT = {40: 14, 80: 15, 160: 17, N_AMG_LARGE: 48}
# the AMG kernel's launches on each S1-U path: 4 per level and V-cycle
# (residual, R, P with the prolongation's add, the post sweep; the first
# sweep from zero needs no launch)
AMG_LAUNCHES = {40: 112, 80: 240, 160: 272, N_AMG_LARGE: 1536}
# the AMG cycle runs the ELL kernel in float32, the band's product in
# float64 (a name demangled or not)
KERNELS_G1A = {"amg_ell": ("amg_ell_kernel<float", "amg_ell_kernelIf"),
               "band ELL (amg_ell f64)": ("amg_ell_kernel<double", "amg_ell_kernelId"),
               **{k: v for k, v in KERNELS_BAND.items() if "ELL" not in k}}


def _u_mesh(pt, n: int, device: str, amp: float = 0.25, seed: int = 0, quad: bool = False):
    """The demo's fallback mesh: the n x n triangle (or quadrilateral) grid
    of [-1, 1]^2 with its interior vertices moved by amp h (U[0, 1) - 1/2)."""
    ct = pt.CellType.quadrilateral if quad else pt.CellType.triangle
    um, _ = pt.UMesh.from_grid(pt.Grid(n, n, U_BOX, ct, device="cpu"))
    verts = um.verts.copy()
    rng = np.random.default_rng(seed)
    interior = (np.abs(np.abs(verts[:, 0]) - 1.0) > 1e-12) & (np.abs(np.abs(verts[:, 1]) - 1.0) > 1e-12)
    verts[interior] += amp * (2.0 / n) * (rng.random((int(interior.sum()), 2)) - 0.5)
    return pt.UMesh(verts, um.cells, device=device)


def _u_exact(x):
    return torch.cos(x[..., 0]) * torch.sin(x[..., 1])


def _u_scheme(pt, name: str, mesh, r2: float):
    """demo/unstructured/main.py's scheme ``name`` on ``mesh``, set up:
    ``(scheme, exact solution, error region)``."""
    from phifem_tpu_torch.models import NeumannPoissonU, RobinPoissonU, StrongDirichletPoissonU, WeakDirichletPoissonU

    ls = lambda x: x[..., 0] ** 2 + x[..., 1] ** 2 - r2

    def nderiv(x):
        g = torch.stack([-torch.sin(x[..., 0]) * torch.sin(x[..., 1]), torch.cos(x[..., 0]) * torch.cos(x[..., 1])], -1)
        gp = 2.0 * x
        return (g * gp).sum(-1) / torch.clamp(torch.linalg.norm(gp, dim=-1), min=1e-12)

    if name == "s1":
        s = WeakDirichletPoissonU(mesh, mode="bg").setup(ls, lambda x: 2.0 * _u_exact(x), u_D=_u_exact)
        return s, _u_exact, (1, 2)
    if name == "s2":
        uex = lambda x: torch.sin(x[..., 0] ** 2 + x[..., 1] ** 2 - r2)

        def f2(x):
            q = x[..., 0] ** 2 + x[..., 1] ** 2
            return 4.0 * q * torch.sin(q - r2) - 4.0 * torch.cos(q - r2)

        return StrongDirichletPoissonU(mesh, mode="bg").setup(ls, f2), uex, (1, 2)
    if name == "s3":
        s = NeumannPoissonU(mesh, mode="bg").setup(ls, lambda x: 3.0 * _u_exact(x), nderiv)
        return s, _u_exact, (1,)
    s = RobinPoissonU(mesh, mode="bg", robin_coef=1.0).setup(ls, lambda x: 3.0 * _u_exact(x),
                                                              lambda x: nderiv(x) + _u_exact(x))
    return s, _u_exact, (1,)


def _amg():
    from phifem_tpu_torch.ops import cuda_amg

    return cuda_amg


def _within_reference(label: str, it: int, jit: int, errs=None, jerrs=None) -> None:
    ok_it = abs(it - jit) <= max(3, 0.25 * jit)
    ok_e = jerrs is None or all(abs(e - j) <= 0.05 * j for e, j in zip(errs, jerrs))
    print(f"[{label}] against the JAX package on the CPU: {it} it (JAX {jit}, allowance max(3, 0.25 it))"
          + ("" if jerrs is None else f", L2 {errs[0]:.6e} (JAX {jerrs[0]:.6e}), H10 {errs[1]:.6e} "
                                      f"(JAX {jerrs[1]:.6e}), within 5%"))
    if not (ok_it and ok_e):
        raise AssertionError(f"{label}: {it} it, errors {errs}, against the JAX package's {jit}, {jerrs}")


def _u_check_tags(s, h, r2: float, label: str) -> None:
    """The card's tags against the CPU lane's: equal except at knife-edge
    cells (|phi| <= KNIFE_EDGE at a detection point) and their facets."""
    bad = np.where(s.cell_tags != h.cell_tags)[0]
    m = h.mesh
    if bad.size:
        pts = m.map_to_physical(m.detection_ref_points(1))[bad]
        if float(np.abs((pts ** 2).sum(-1) - r2).min(axis=1).max()) > KNIFE_EDGE:
            raise AssertionError(f"{label}: cell tags differ off the knife edge at {bad[:10]}")
    fbad = np.where(s.facet_tags != h.facet_tags)[0]
    if fbad.size and not np.isin(m.f2c[fbad], bad).any(axis=1).all():
        raise AssertionError(f"{label}: facet tags differ away from knife-edge cells at {fbad[:10]}")
    print(f"[{label}] tags: {bad.size} cell and {fbad.size} facet tags differ from the CPU lane (allowed only at "
          f"knife-edge cells, |phi| <= {KNIFE_EDGE:.0e})")


def phase_u_demo(pt) -> dict:
    """demo/unstructured/main.py's four schemes on its fallback mesh, on the
    card and on the CPU: tags, the solution to 1e-6 of the CPU lane's and
    its auxiliary fields to U_AUX_TOL, the counts (exact, and within the
    allowance of JAX's) and the L2 / H10 errors within 5% of JAX's."""
    ca = _amg()
    counts = {}
    for name in ("s1", "s2", "s3", "s4"):
        label = f"u-demo {name} n={N_U_DEMO}"
        ca.launches = 0
        _band_reset()
        (s, uex, region), t_set = _sync_time(_u_scheme, pt, name, _u_mesh(pt, N_U_DEMO, DEVICE), U_DEMO_R2)
        _, t_asm = _sync_time(s.assemble)
        r, t_solve = _sync_time(s.solve, method="bicgstab", tol=SCHEME_TOL)
        counts[name] = ca.launches
        BAND_U[f"u-demo {name}"] = _band_read()
        e = s.l2_h1_errors(s.u_h, uex, region=region)
        h, _, _ = _u_scheme(pt, name, _u_mesh(pt, N_U_DEMO, "cpu"), U_DEMO_R2)
        h.assemble()
        rh = h.solve(method="bicgstab", tol=SCHEME_TOL)
        print(f"[{label}] {s.mesh.num_vertices} vertices, {s.mesh.num_cells} triangles, "
              f"{sum(v.numel() for v in s.b.values())} DoFs: setup (tags) {t_set:.3f} s, assemble {t_asm:.3f} s, "
              f"bicgstab {t_solve:.3f} s, {r.iterations} it (CPU lane {rh.iterations}), relres {r.residual:.3e}; "
              f"L2 {e['l2']:.6e}, H10 {e['h10']:.6e}; AMG launches {counts[name]}")
        if not (r.converged and r.residual <= 10 * SCHEME_TOL):
            raise AssertionError(f"{label}: not converged, relres {r.residual}")
        _u_check_tags(s, h, U_DEMO_R2, label)
        primal = "w" if name == "s2" else "u"
        diffs = {k: _rel(r.x[k], rh.x[k]) for k in rh.x}
        print(f"[{label}] against the CPU lane: max rel diff "
              + ", ".join(f"{k} {v:.3e}" for k, v in diffs.items())
              + f" (tol {primal} 1e-6, the auxiliary fields {U_AUX_TOL:.0e})")
        if any(v > (1e-6 if k == primal else U_AUX_TOL) for k, v in diffs.items()):
            raise AssertionError(f"{label}: the solution differs from the CPU lane's: {diffs}")
        jit, jl2, jh10 = JAX_U_DEMO[name]
        _within_reference(label, r.iterations, jit, (e["l2"], e["h10"]), (jl2, jh10))
        _pin(label, r.iterations, U_DEMO_IT[name])
    return counts


def _amg_tables(vc) -> str:
    return "; ".join(f"{f}: " + ", ".join(f"n={n} w={w} (P {wp}, R {wr})" for n, w, wp, wr in lv)
                     for f, lv in vc.amg_levels.items())


def _ell_tables(amg) -> list:
    """``(label, cols, vals, n_x, lanes, level)`` of every ELL table of
    ``amg``: each level's operator, R and P, with the lanes per row the
    V-cycle launches it at."""
    out = []
    for k, lvl in enumerate(amg.levels):
        out.append((f"L{k} A", lvl.ecols, lvl.evals, lvl.n, lvl.e_lanes, lvl))
        if lvl.r_cols is not None:
            out.append((f"L{k} R", lvl.r_cols, lvl.r_vals, lvl.n, lvl.r_lanes, lvl))
            out.append((f"L{k} P", lvl.p_cols, lvl.p_vals, lvl.r_cols.shape[1], lvl.p_lanes, lvl))
    return out


def _hold_amg_levels(amg, label: str) -> float:
    """The ELL kernel against its plain version by torch.equal on every
    table of ``amg`` (the level operator in its three modes, R, P and P with
    the prolongation's add), at every group size the kernel has (the
    table's own among them), in float32 and float64 (the tables cast), with
    seeded vectors; these launches are not counted.  Returns the largest
    |difference| (0)."""
    ca = _amg()
    n0 = ca.launches
    rng = np.random.default_rng(SEED + 11)
    vec = lambda n, dt: torch.as_tensor(rng.standard_normal(n), dtype=dt, device=DEVICE)
    checked, used = 0, set()
    for dt in (torch.float32, torch.float64):
        for name, c, v, n_x, lanes, lvl in _ell_tables(amg):
            used.add(lanes)
            v = v.to(dt)
            n = c.shape[1]
            x, b = vec(n_x, dt), vec(n, dt)
            modes = ((ca.APPLY, ca.RESIDUAL, ca.JACOBI) if name.endswith("A") else
                     (ca.APPLY,) if name.endswith("R") else (ca.APPLY, ca.PROLONG_ADD))
            for mode in modes:
                d = lvl.jac_diag.to(dt) if mode == ca.JACOBI else None
                yr = ca.amg_ell_sweep_ref(mode, c, v, x, b, d)
                for g in ca.LANES:
                    yk = ca.amg_ell_sweep(mode, c, v, x, b, d, lanes=g)
                    if not torch.equal(yk, yr):
                        raise AssertionError(f"{label}: the AMG kernel differs from its plain version on {name} "
                                             f"(mode {mode}, {g} lanes, {dt}): {float((yk - yr).abs().max())}")
                    checked += 1
    torch.cuda.synchronize()
    ca.launches = n0
    print(f"[{label}] AMG kernel = plain version bit for bit on {checked} (table, mode, lanes, dtype) cases of "
          f"{len(amg.levels)} levels, at every group size {ca.LANES}; the V-cycle's tables use {sorted(used)}")
    return 0.0


#: synthetic ELL tables, case -> (rows, columns, width): every group size and
#: chunk remainder of the kernel, row counts off the CTA and off the groups
AMG_SYNTH = {"ragged": (1001, 1001, 9), "width1": (300, 300, 1), "wide64": (257, 257, 64), "rect": (100, 901, 12),
             "w5": (1003, 1003, 5), "w7": (777, 777, 7), "w8": (260, 260, 8), "w17": (131, 131, 17),
             "w23": (300, 905, 23), "w111": (45, 400, 111), "w130": (33, 500, 130)}


def _synthetic_ell(case: str, dt, seed: int = SEED):
    """A slot-major ELL table on the card made from ``seed`` (AMG_SYNTH's
    shape): padded slots, every 97th row empty (all pad), ``wide64`` one row
    of width 64 and the rest of 1-7."""
    rng = np.random.default_rng(seed)
    n, n_x, w = AMG_SYNTH[case]
    nnz = rng.integers(0, w + 1, n)
    if case == "wide64":
        nnz = rng.integers(1, 8, n)
        nnz[17] = 64
    nnz[::97] = 0
    cols = np.full((n, w), n_x, np.int64)
    vals = np.zeros((n, w))
    for i in range(n):
        cols[i, : nnz[i]] = np.sort(rng.choice(n_x, nnz[i], replace=False))
        vals[i, : nnz[i]] = rng.standard_normal(nnz[i])
    t = lambda a, d=dt: torch.as_tensor(np.ascontiguousarray(a), dtype=d, device=DEVICE)
    return t(cols.T, torch.int32), t(vals.T), t(rng.standard_normal(n_x)), t(rng.standard_normal(n)), \
        t(rng.uniform(0.1, 1.0, n))


def _hold_amg_synthetic() -> None:
    ca = _amg()
    n0 = ca.launches
    checked = 0
    for case, (n, n_x, _) in AMG_SYNTH.items():
        for dt in (torch.float32, torch.float64):
            c, v, x, b, d = _synthetic_ell(case, dt)
            for mode in ca.MODES:
                if mode == ca.JACOBI and n != n_x:
                    continue
                yr = ca.amg_ell_sweep_ref(mode, c, v, x, b, d)
                for g in ca.LANES:
                    if not torch.equal(ca.amg_ell_sweep(mode, c, v, x, b, d, lanes=g), yr):
                        raise AssertionError(f"the AMG kernel differs from its plain version on {case} {dt} mode "
                                             f"{mode} at {g} lanes")
                    checked += 1
    torch.cuda.synchronize()
    ca.launches = n0
    print(f"[kernel amg_ell] synthetic ELL tables (widths {sorted({w for _, _, w in AMG_SYNTH.values()})}, empty "
          f"and all-pad rows, rectangular R, row counts off the 256-thread CTA and the lane groups), four modes, "
          f"every group size {ca.LANES}: kernel = plain version bit for bit in {checked} cases")


def _ell_csr(c: torch.Tensor, v: torch.Tensor, n_x: int) -> torch.Tensor:
    """The slot-major ELL table as a CUDA CSR matrix (int32 indices): the
    library call's input (a yardstick; the port never builds it)."""
    w, n = c.shape
    rows = torch.arange(n, device=c.device).repeat(w)
    cc, vv = c.reshape(-1).long(), v.reshape(-1)
    keep = cc < n_x
    coo = torch.sparse_coo_tensor(torch.stack([rows[keep], cc[keep]]), vv[keep], (n, n_x)).coalesce()
    return _csr_as(coo.to_sparse_csr(), v.dtype)


def _graph_ms(fn, launches: int = 20, reps: int = 10) -> float:
    """Device milliseconds per call of ``fn`` from a CUDA graph of
    ``launches`` calls, replayed ``reps`` times between two CUDA events: no
    host issue between the launches, and the inputs as warm in the L2 as a
    caller that runs them back to back finds them.  A measuring tool only:
    the port runs eagerly."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(launches):
            fn()
    g.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * launches)
    del g
    return ms


def _ell_bound(mode, nnz: int, n: int, n_x: int, dt):
    """(bound ms, by, MB) of one sweep: each nonzero's value and int32
    column once, x, y and by mode b (residual, Jacobi, the prolongation's
    base) and d (Jacobi); 2 flops per nonzero and the mode's per row."""
    ca = _amg()
    es = torch.tensor([], dtype=dt).element_size()
    nbytes = nnz * (es + 4) + n_x * es + n * es + {ca.APPLY: 0, ca.RESIDUAL: 1, ca.JACOBI: 2,
                                                   ca.PROLONG_ADD: 1}[mode] * n * es
    flops = 2 * nnz + {ca.APPLY: 0, ca.RESIDUAL: n, ca.JACOBI: 3 * n, ca.PROLONG_ADD: n}[mode]
    return (*_bound(nbytes, flops, dt), nbytes / 1e6)


AMG_MODE_NAMES = {0: "apply", 1: "residual", 2: "jacobi", 3: "prolong-add"}


def _amg_table_times(amg, label: str = "kernel amg_ell", graphs: bool = True) -> dict:
    """The kernel on the scale run's hierarchy.  (1) Level 0's operator in
    three modes and its R, float32 and float64, with the L2 flushed before
    each launch (a 64 MB write, as before; and a 64 MB read, which leaves
    clean lines that the launch need not write back): device ms per launch
    from the profiler,
    ms per call back to back by CUDA events, host ms per call, the plain
    version, the byte bound, and torch.mv of the same CSR matrix (cuSPARSE)
    for the apply mode.  (2) Every launch the V-cycle makes, float32 (the
    cycle's dtype; A residual and Jacobi, R, P with its add, levels 0 to
    the last but one): device ms per launch from a CUDA graph of 20
    launches, the L2 warm as the cycle finds it, beside its byte bound and
    its launch floor (the same kernel, mode and group size on a 1-row,
    width-1 table); their sum over one V-cycle, and one whole V-cycle
    captured in a graph.  ``graphs=False`` stops after (1)."""
    ca = _amg()
    n0 = ca.launches
    lvl = amg.levels[0]
    rng = np.random.default_rng(SEED + 12)
    vec = lambda n, dt: torch.as_tensor(rng.standard_normal(n), dtype=dt, device=DEVICE)
    flush = torch.zeros(16 * 2**20, dtype=torch.float32, device=DEVICE)  # 64 MB > the 50 MB L2
    out = {}
    for dt in (torch.float32, torch.float64):
        for tab, (c, v, lanes), mode in (("A", (lvl.ecols, lvl.evals, lvl.e_lanes), ca.JACOBI),
                                         ("A", (lvl.ecols, lvl.evals, lvl.e_lanes), ca.APPLY),
                                         ("A", (lvl.ecols, lvl.evals, lvl.e_lanes), ca.RESIDUAL),
                                         ("R", (lvl.r_cols, lvl.r_vals, lvl.r_lanes), ca.APPLY)):
            v = v.to(dt).contiguous()
            w, n = c.shape
            n_x = lvl.n
            x, b, d = vec(n_x, dt), vec(n, dt), lvl.jac_diag.to(dt)
            call = lambda: ca.amg_ell_sweep(mode, c, v, x, b, d, lanes=lanes)
            nnz = int((c < n_x).sum())
            bound_ms, by, mb = _ell_bound(mode, nnz, n, n_x, dt)
            pad_bytes = (w * n - nnz) * (torch.tensor([], dtype=dt).element_size() + 4)
            t = {"ms": _event_ms(call, 50), "device_ms": _device_ms(call, 20, "amg_ell_kernel", flush=flush),
                 "device_ms_clean": _device_ms(call, 20, "amg_ell_kernel", flush=flush, clean=True),
                 "host_ms": _host_ms(call, 50),
                 "plain_ms": _event_ms(lambda: ca.amg_ell_sweep_ref(mode, c, v, x, b, d), 5),
                 "bound_ms": bound_ms, "bound_by": by, "library_ms": None, "rows": n, "width": w, "nnz": nnz,
                 "lanes": lanes}
            if mode == ca.APPLY:
                csr = _ell_csr(c, v, n_x)
                yl = torch.mv(csr, x)
                yk = call()
                if float((yl - yk).abs().max()) > (1e-4 if dt == torch.float32 else 1e-12) * float(yk.abs().max()):
                    raise AssertionError(f"torch.mv of the CSR copy is not the kernel's product ({tab})")
                t["library_ms"] = _event_ms(lambda: torch.mv(csr, x), 50)
                del csr
            name = AMG_MODE_NAMES[mode]
            out[tab, name, dt] = t
            lib = "" if t["library_ms"] is None else f", cuSPARSE CSR torch.mv {t['library_ms']:.4f}"
            print(f"[{label}] L0 {tab} {name:8s} {str(dt)[6:]:7s} {n} rows x width {w} ({nnz} nonzeros, "
                  f"{lanes} lanes per row): ms {t['ms']:.4f}, device {t['device_ms']:.4f} per launch (L2 flushed by a "
                  f"write; by a read, clean lines: {t['device_ms_clean']:.4f}), "
                  f"host {t['host_ms']:.4f} per call, plain {t['plain_ms']:.4f}{lib}; bound {bound_ms:.4f} by {by} "
                  f"({mb:.2f} MB: nonzeros, vectors; {bound_ms / t['device_ms']:.1%} by device time, "
                  f"{bound_ms / t['device_ms_clean']:.1%} with clean lines); the ELL's "
                  f"{w * n - nnz} padded slots add {pad_bytes / 1e6:.2f} MB")
    if not graphs:
        ca.launches = n0
        return out
    # every launch of the V-cycle, through CUDA graphs
    dt = amg.dtype
    floors, tables = {}, {}
    for name, c, v, n_x, lanes, lv in _ell_tables(amg):
        modes = ((ca.RESIDUAL, ca.JACOBI) if name.endswith("A") else
                 (ca.APPLY,) if name.endswith("R") else (ca.PROLONG_ADD,))
        if name.endswith("A") and lv.r_cols is None:
            continue  # the coarsest level: coarse_inv @ b
        w, n = c.shape
        nnz = int((c < n_x).sum())
        x, b = vec(n_x, dt), vec(n, dt)
        for mode in modes:
            d = lv.jac_diag if mode == ca.JACOBI else None
            ms = _graph_ms(lambda: ca.amg_ell_sweep(mode, c, v, x, b, d, lanes=lanes))
            if (mode, lanes) not in floors:
                one = torch.ones(1, dtype=dt, device=DEVICE)
                c1 = torch.zeros((1, 1), dtype=torch.int32, device=DEVICE)
                floors[mode, lanes] = _graph_ms(lambda: ca.amg_ell_sweep(mode, c1, one[None], one, one, one,
                                                                         lanes=lanes))
            bound_ms, by, mb = _ell_bound(mode, nnz, n, n_x, dt)
            key = f"{name} {AMG_MODE_NAMES[mode]}"
            tables[key] = {"ms": ms, "floor_ms": floors[mode, lanes]}
            print(f"[kernel amg_ell] graph {key:20s} {str(dt)[6:]} {n:7d} rows x {w:3d} ({nnz} nonzeros), "
                  f"{lanes:2d} lanes: {ms:.4f} ms per launch (L2 warm), launch floor {floors[mode, lanes]:.4f} "
                  f"({ms / floors[mode, lanes]:.2f}x), bound {bound_ms:.4f} by {by} ({mb:.3f} MB; "
                  f"{bound_ms / ms:.1%})")
    ell_sum = sum(t["ms"] for t in tables.values())
    bv = vec(lvl.n, dt)
    cycle_ms = _graph_ms(lambda: amg(bv), launches=5, reps=10)
    ca.launches = n0
    print(f"[kernel amg_ell] one V-cycle ({4 * (len(amg.levels) - 1)} ELL launches): the sum of its ELL launches "
          f"{ell_sum:.4f} ms; the whole V-cycle in a CUDA graph {cycle_ms:.4f} ms per call (with its coarse "
          f"product and first-sweep products)")
    out["tables"], out["vcycle_ell_ms"], out["vcycle_graph_ms"] = tables, ell_sum, cycle_ms
    return out


def _amg_trace(s, vc, label: str) -> None:
    """A device trace of two BiCGStab iterations (the equilibrated operator
    and vc), with the card's busy share; then the families by their own
    traces (the fullest of three): one operator matvec (the entity
    batches), one AMG V-cycle (the ELL kernel and its glue), one band solve
    (the plain sweeps)."""
    from phifem_tpu_torch.solvers import _eq_context, _pbicgstab, lift_rhs

    matvec, active, _, dinv_sqrt, mv_eq, M, _ = _eq_context(s.op, (), vc)
    b = lift_rhs(s.op, s.b, (), active, raw_matvec=matvec.raw)
    b_eq = {k: v * dinv_sqrt[k] for k, v in b.items()}
    x0 = {k: torch.zeros_like(v) for k, v in b_eq.items()}
    run = lambda: _pbicgstab(mv_eq, b_eq, x0, tol=0.0, atol=0.0, maxiter=2, M=M)
    _, wall = _sync_time(run)
    _trace_report(label, _device_kernels(run, 1), wall, 2, "bicgstab", KERNELS_G1A, top=10)
    r = {k: v.to(torch.float32) for k, v in s.b.items()}
    fams = {"operator matvec (entity batches, f64)": lambda: mv_eq(b_eq),
            "AMG V-cycle + Jacobi rows (f32)": lambda: vc._cycle(0, r)}
    xf = vc._flatten({k: torch.zeros_like(v) for k, v in r.items()})
    rf = vc._flatten(r)
    fams["band solve (the band kernels, f64)"] = lambda: vc._band_correct_flat(xf.clone(), rf)
    for fam, fn in fams.items():
        # a trace may lose launches (PERF.md): keep the fullest of three
        ker = max((_device_kernels(fn, 3) for _ in range(3)), key=lambda k: sum(c for c, _ in k.values()))
        busy = sum(t for _, t in ker.values()) / 3
        cnt = sum(c for c, _ in ker.values()) / 3
        amg_ms = sum(t for k, (_, t) in ker.items() if any(x in k for x in KERNELS_G1A["amg_ell"])) / 3
        print(f"[{label} profile] {fam}: {busy:.3f} ms of device time in {cnt:.0f} kernels per call"
              + (f", of which the AMG kernel {amg_ms:.3f} ms" if amg_ms else ""))


def phase_u_amg(pt) -> tuple:
    """S1-U with amg_preconditioner() at n=40, 80, 160 (counts exact and
    within the allowance of JAX's) and the scale run at N_AMG_LARGE (set-up
    broken down, count, solve wall, L2, a trace of two iterations); the
    kernel held against its plain version on every level of the scale run's
    hierarchy.  Returns (launches per path, the kernel's times)."""
    ca = _amg()
    counts, times = {}, None
    for n in (40, 80, 160, N_AMG_LARGE):
        label = f"u-amg s1 n={n}"
        ca.launches = 0
        _band_reset()
        torch.cuda.reset_peak_memory_stats()
        mesh, t_mesh = _sync_time(_u_mesh, pt, n, DEVICE)
        (s, _, _), t_tag = _sync_time(_u_scheme, pt, "s1", mesh, 0.49)
        _, t_asm = _sync_time(s.assemble)
        vc, t_pre = _sync_time(s.amg_preconditioner)
        kw = dict(method="bicgstab", tol=SCHEME_TOL, maxiter=500, precond=vc)
        r, t_solve = _sync_time(s.solve, **kw)
        counts[label] = ca.launches
        BAND_U[label] = _band_read()
        e, t_err = _sync_time(s.l2_h1_errors, s.u_h, _u_exact)
        su = vc.setup_seconds
        print(f"[{label}] {s.mesh.num_vertices} vertices, {s.mesh.num_cells} triangles, "
              f"{sum(v.numel() for v in s.b.values())} DoFs: mesh {t_mesh:.3f} s, setup (tags, spaces, "
              f"interpolation) {t_tag:.3f} s, assemble {t_asm:.3f} s, amg_preconditioner() {t_pre:.3f} s (bulk CSR "
              f"{su['bulk csr']:.3f} s, AMG build {su['amg build']:.3f} s, band {su['band']:.3f} s; {_band(vc)}); "
              f"AMG levels {_amg_tables(vc)}; bicgstab {t_solve:.3f} s, {r.iterations} it, relres {r.residual:.3e}; "
              f"L2 {e['l2']:.6e}, H10 {e['h10']:.6e} ({t_err:.3f} s); peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; AMG kernel launches {counts[label]}")
        if not (r.converged and r.residual <= 10 * SCHEME_TOL):
            raise AssertionError(f"{label}: not converged, relres {r.residual}")
        if counts[label] <= 0:
            raise AssertionError(f"{label} never launched the AMG kernel")
        _pin_launches(label, counts[label], AMG_LAUNCHES[n])
        if n in JAX_AMG_IT:
            _within_reference(label, r.iterations, JAX_AMG_IT[n])
        _pin(label, r.iterations, AMG_IT[n])
        if n == N_AMG_LARGE:
            t0 = time.perf_counter()
            _hold_amg_levels(vc.amgs["u"], label)
            t1 = time.perf_counter()
            times = _amg_table_times(vc.amgs["u"])
            t2 = time.perf_counter()
            _amg_trace(s, vc, label)
            t3 = time.perf_counter()
            _hold_band(label, vc.band_tables, vc.schwarz_sweeps)
            print(f"[time] {label}: kernel held on every table {t1 - t0:.1f} s, timed {t2 - t1:.1f} s, traced "
                  f"{t3 - t2:.1f} s, band kernels {time.perf_counter() - t3:.1f} s")
        del s, vc, r, mesh
        torch.cuda.empty_cache()
    return counts, times


def run_slice_g1a(pt) -> tuple:
    """Every slice-G1a phase; returns (the AMG kernel's line, launches per
    path)."""
    t0 = time.perf_counter()
    _hold_amg_synthetic()
    t1 = time.perf_counter()
    paths = {f"u-demo {k}": c for k, c in phase_u_demo(pt).items()}
    print(f"[time] AMG kernel on synthetic tables {t1 - t0:.1f} s; u-demo {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    amg_paths, times = phase_u_amg(pt)
    paths.update(amg_paths)
    print(f"[time] u-amg {time.perf_counter() - t1:.1f} s; slice G1a phases {time.perf_counter() - t0:.1f} s")
    print(f"[main path G1a] AMG kernel launches per path: {paths}")
    f32, f64 = torch.float32, torch.float64
    main = times["A", "jacobi", f32]
    line = {
        "name": "amg_ell",
        "route": "cuda",
        "source": "phifem_tpu_torch/csrc/amg_ell.cu",
        "replaces": "phifem_tpu/amg.py:149-160 (XLA-fused; not a Pallas kernel)",
        "launches": sum(paths.values()),
        "launches_by_path": paths,
        "max_abs_err": 0.0,
        **{k: main[k] for k in ("ms", "device_ms", "device_ms_clean", "host_ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": times["A", "apply", f32]["library_ms"],
        "library": "torch.mv of the level-0 operator as a CUDA CSR matrix (cuSPARSE SpMV; apply mode)",
        "shape": f"S1-U n={N_AMG_LARGE} AMG level 0: {main['rows']} rows x ELL width {main['width']}, Jacobi sweep, "
                 "float32",
        "vcycle_ell_ms": times["vcycle_ell_ms"],
        "vcycle_graph_ms": times["vcycle_graph_ms"],
        "table_device_ms": {k: t["ms"] for k, t in times["tables"].items()},
        "table_floor_ms": {k: t["floor_ms"] for k, t in times["tables"].items()},
    }
    for key, t in times.items():
        if not isinstance(key, tuple):
            continue
        tab, name, dt = key
        tag = f"{tab}_{name}_{str(dt)[6:]}"
        for k in ("ms", "device_ms", "device_ms_clean", "host_ms", "plain_ms", "bound_ms", "library_ms"):
            if t.get(k) is not None:
                line[f"{tag}_{k}"] = t[k]
    return line, paths


# ------------------------------------------------------ slices G1b and G2
# G1b: imported quadrilateral meshes (the bilinear geometry) and S5 on an
# imported triangle mesh; G2: imported tetrahedral meshes (UMesh3).  The JAX
# package's counts and errors on the CPU come from
# `JAX_PLATFORMS=cpu python scripts/reference_amg_counts.py` with the options
# named beside each constant.
# quads: tests/test_usolve.py's perturbed quad mesh (amplitude 0.2 h, seed 0),
# the circle R = 0.7, u = cos x sin y
N_QUAD, QUAD_AMP = 24, 0.2
# `--cell quad 40 80 160`
JAX_QUAD_AMG_IT = {40: 12, 80: 12, 160: 14}
# S5-U: tests/test_usolve.py's data (the perturbed triangle mesh, amplitude
# 0.25 h, E_in / E_out 1.0 / 0.1, u_vec / f_vec, the circle R = 0.7); n=10 as
# JAX's own test solves it (deflated BiCGStab to 1e-9, maxiter 400), n=32 to
# choose the preconditioner of the scale run at n=120 (the reference's level
# 3 of param1.yaml: 14,641 vertices, 204,974 DoF), deflated BiCGStab to 1e-8
N_S5U, N_S5U_PICK, N_S5U_LARGE = 10, 32, 120
# amg_preconditioner() (Jacobi + the band solve) takes fewer iterations at
# n=32 (166 against Jacobi's 378 on the H100; JAX 166 / 818), but its band,
# on the Schwarz branch at n=120 (m=8,204 > dense_max), makes deflated
# BiCGStab diverge there: 557 it to relres 8.0e-4 on the H100 (PERF.md), 808
# it to 1.4e-3 in JAX (`--mode s5 --tol 1e-8 --maxiter 5000 --precond amg
# 120`); the scale run takes Jacobi (JAX 1,808 it, `--mode s5 --tol 1e-8
# --maxiter 5000 120`)
S5U_SCALE_DIVERGES = ("amg",)
# `--mode s5 10`; `--mode s5 --tol 1e-8 --maxiter 5000 [--precond amg] 32`
JAX_S5U_IT = 142
JAX_S5U_PICK_IT = {"jacobi": 818, "amg": 166}
# tets: demo/unstructured/main.py's main3 (UMesh3.box of [-1, 1]^3, the sphere
# r = 0.61, level-set degree 2, BiCGStab to 1e-10, maxiter 5000)
N_TET, TET_R2 = 12, 0.61**2
TET_BOX = ((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0))
# `--cell tet --mode jacobi --scheme sN 12`: (it, relative L2, relative H10)
JAX_TET = {"s1": (107, 5.899055e-01, 6.545365e-01), "s2": (41, 8.607203e-02, 1.504443e-01),
           "s3": (216, 3.222113e-02, 5.382558e-02), "s4": (208, 4.206349e-02, 5.639023e-02)}
# `--cell tet 8 12 16`, and `--cell tet --amg-dtype float64 8 12 16`
JAX_TET_AMG_IT = {8: 3, 12: 16, 16: 15}
JAX_TET_AMG64_IT = {8: 1, 12: 7, 16: 11}
# under-resolved sizes (relative L2 error 1.31 / 0.59) where rounding sets
# the count: the card 5 / 9, JAX 3 / 16 with its float32 cycle and 1 / 7
# with a float64 one; reported beside JAX's, not held (PERF.md)
TET_AMG_ROUNDING = (8, 12)
# the tet scale run: 1,572,864 tets, 274,625 vertices, 549,250 DoF.  From
# n=32 on, the band (m > dense_max) takes the Schwarz branch, whose fixed
# inner sweeps make the preconditioner nonlinear: BiCGStab then diverges, in
# JAX too (n=32: 500 it to relres 1.5e-4, `--cell tet 24 32`; on the H100 at
# n=64, 183 it to relres 0.12: PERF.md), so the scale run takes flexible GMRES
N_TET_LARGE = 64
# the port's counts and the AMG kernel's launches on the H100 (PERF.md),
# exact; before the band kernels the quad n=800 run took 42 it (1,344
# launches), the tet n=64 run 180 (2,160)
QUAD_IT = {"s1": 79, "s3": 261}
QUAD_AMG_IT = {40: 12, 80: 12, 160: 12, N_AMG_LARGE: 34}
QUAD_AMG_LAUNCHES = {40: 96, 80: 96, 160: 192, N_AMG_LARGE: 1088}
S5U_IT = {N_S5U: 133, "jacobi": 1294}
TET_IT = {"s1": 104, "s2": 38, "s3": 180, "s4": 199}
TET_AMG_IT = {8: 5, 12: 9, 16: 16, N_TET_LARGE: 160}
# n=8: no AMG (a bulk under 32 DoFs); n=12 and 16: a one-level AMG (its
# coarse inverse alone)
TET_AMG_LAUNCHES = {8: 0, 12: 0, 16: 0, N_TET_LARGE: 1920}


def _pin_launches(label: str, got: int, expect: int) -> None:
    if got != expect:
        raise AssertionError(f"{label}: {got} AMG kernel launches, not {expect}")


def _u_solution_against_cpu(label: str, r, rh, primal: str) -> None:
    """The card's solution against the CPU lane's: the primal field to
    1e-6, the auxiliary fields to U_AUX_TOL (relative to max|x|)."""
    diffs = {k: _rel(r.x[k], rh.x[k]) for k in rh.x}
    print(f"[{label}] solution against the CPU lane: max rel diff " + ", ".join(f"{k} {v:.3e}" for k, v in diffs.items())
          + f" (tol {primal} 1e-6, the others {U_AUX_TOL:.0e})")
    if any(v > (1e-6 if k == primal else U_AUX_TOL) for k, v in diffs.items()):
        raise AssertionError(f"{label}: the solution differs from the CPU lane's: {diffs}")


def _amg_against_jax(label: str, it: int, jit: int, held: bool = True, jit64: int = None) -> None:
    """The count against JAX's within max(3, 0.25 it); ``held=False``
    reports it beside JAX's counts with the cycle in float32 (its default)
    and float64 (``jit64``) without holding it: on an under-resolved
    problem, where rounding sets the count (PERF.md)."""
    if held:
        _within_reference(label, it, jit)
        return
    print(f"[{label}] against the JAX package on the CPU, not held (rounding sets the count here): {it} it; JAX "
          f"{jit} with its float32 cycle, {jit64} with amg_preconditioner(dtype=float64)")


def _amg_run(label: str, s, uex, t_mesh: float, t_tag: float, cells: str, method: str = "bicgstab"):
    """Assemble, amg_preconditioner() and ``method`` to SCHEME_TOL on the
    card: ``(vc, result, errors, launches)``, with the set-up parts
    printed."""
    ca = _amg()
    _, t_asm = _sync_time(s.assemble)
    vc, t_pre = _sync_time(s.amg_preconditioner)
    r, t_solve = _sync_time(s.solve, method=method, tol=SCHEME_TOL, maxiter=500, precond=vc)
    launches = ca.launches
    e = s.l2_h1_errors(s.u_h, uex)
    su = vc.setup_seconds
    print(f"[{label}] {s.mesh.num_vertices} vertices, {s.mesh.num_cells} {cells}, "
          f"{sum(v.numel() for v in s.b.values())} DoFs: mesh {t_mesh:.3f} s, setup (tags, spaces, interpolation) "
          f"{t_tag:.3f} s, assemble {t_asm:.3f} s, amg_preconditioner() {t_pre:.3f} s (bulk CSR {su['bulk csr']:.3f} s, "
          f"AMG build {su['amg build']:.3f} s, band {su['band']:.3f} s; {_band(vc)}); AMG levels {_amg_tables(vc)}; "
          f"{method} {t_solve:.3f} s, {r.iterations} it, relres {r.residual:.3e}; L2 {e['l2']:.6e}, H10 "
          f"{e['h10']:.6e} ({method}); peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; AMG kernel "
          f"launches {launches}")
    if not (r.converged and r.residual <= 10 * SCHEME_TOL):
        raise AssertionError(f"{label}: not converged, relres {r.residual}")
    # a bulk under 32 DoFs gets no AMG, and a one-level AMG is its coarse
    # inverse alone (as in JAX): no ELL launch then
    if any(len(a.levels) > 1 for a in vc.amgs.values()) != (launches > 0):
        raise AssertionError(f"{label}: {launches} AMG kernel launches on levels {_amg_tables(vc)}")
    return vc, r, e, launches


def _amg_scale_checks(label: str, vc, key: str) -> dict:
    """The kernel held against its plain version on every table of the
    scale run's hierarchy, then level 0 timed (no CUDA-graph table)."""
    t0 = time.perf_counter()
    _hold_amg_levels(vc.amgs["u"], label)
    t1 = time.perf_counter()
    times = _amg_table_times(vc.amgs["u"], label=f"kernel amg_ell {key}", graphs=False)
    print(f"[time] {label}: kernel held on every table {t1 - t0:.1f} s, level 0 timed {time.perf_counter() - t1:.1f} s")
    return times


def phase_quad(pt) -> dict:
    """Imported quadrilaterals: S1-U and S3-U at N_QUAD by Jacobi BiCGStab
    against the CPU lane (tags, b and one matvec to 1e-12, u to 1e-6, the
    auxiliary fields to U_AUX_TOL); S1-U with amg_preconditioner() at n=40,
    80, 160 (against JAX's counts) and N_AMG_LARGE (641,601 vertices,
    1,283,202 DoF), the kernel held on every level of its hierarchy and its
    level 0 timed.  Returns (launches per path, the level-0 times)."""
    ca = _amg()
    paths, times = {}, None
    for name in ("s1", "s3"):
        label = f"u-quad {name} n={N_QUAD}"
        ca.launches = 0
        _band_reset()
        mesh = _u_mesh(pt, N_QUAD, DEVICE, amp=QUAD_AMP, quad=True)
        (s, uex, region), t_set = _sync_time(_u_scheme, pt, name, mesh, 0.49)
        _, t_asm = _sync_time(s.assemble)
        r, t_solve = _sync_time(s.solve, method="bicgstab", tol=SCHEME_TOL, maxiter=5000)
        paths[label] = ca.launches
        BAND_U[label] = _band_read()
        e = s.l2_h1_errors(s.u_h, uex, region=region)
        h, _, _ = _u_scheme(pt, name, _u_mesh(pt, N_QUAD, "cpu", amp=QUAD_AMP, quad=True), 0.49)
        h.assemble()
        rh = h.solve(method="bicgstab", tol=SCHEME_TOL, maxiter=5000)
        print(f"[{label}] {s.mesh.num_vertices} vertices, {s.mesh.num_cells} quadrilaterals, "
              f"{sum(v.numel() for v in s.b.values())} DoFs: setup (tags) {t_set:.3f} s, assemble {t_asm:.3f} s, "
              f"bicgstab {t_solve:.3f} s, {r.iterations} it (CPU lane {rh.iterations}), relres {r.residual:.3e}; "
              f"L2 {e['l2']:.6e}, H10 {e['h10']:.6e}; AMG launches {paths[label]}")
        if not (r.converged and r.residual <= 10 * SCHEME_TOL):
            raise AssertionError(f"{label}: not converged, relres {r.residual}")
        _u_check_tags(s, h, 0.49, label)
        _hold(label, _against_cpu(s, h, taps=False))
        _u_solution_against_cpu(label, r, rh, "u")
        _pin(label, r.iterations, QUAD_IT[name])
    for n in (40, 80, 160, N_AMG_LARGE):
        label = f"u-quad-amg s1 n={n}"
        ca.launches = 0
        _band_reset()
        torch.cuda.reset_peak_memory_stats()
        mesh, t_mesh = _sync_time(_u_mesh, pt, n, DEVICE, amp=QUAD_AMP, quad=True)
        (s, uex, _), t_tag = _sync_time(_u_scheme, pt, "s1", mesh, 0.49)
        vc, r, _, launches = _amg_run(label, s, uex, t_mesh, t_tag, "quadrilaterals")
        paths[label] = launches
        BAND_U[label] = _band_read()
        _pin_launches(label, launches, QUAD_AMG_LAUNCHES[n])
        if n in JAX_QUAD_AMG_IT:
            _amg_against_jax(label, r.iterations, JAX_QUAD_AMG_IT[n])
        _pin(label, r.iterations, QUAD_AMG_IT[n])
        if n == N_AMG_LARGE:
            times = _amg_scale_checks(label, vc, "quad")
        del s, vc, r, mesh
        torch.cuda.empty_cache()
    return paths, times


def _s5u_data():
    """tests/test_usolve.py's u_vec, f_vec and the Jacobian of u_vec."""

    def u_vec(x):
        return torch.stack([torch.sin(x[..., 0]) * torch.cos(x[..., 1]), x[..., 0] * x[..., 1]], -1)

    def f_vec(x):
        return torch.stack([torch.cos(x[..., 0]) + x[..., 1], torch.sin(x[..., 1]) - x[..., 0]], -1)

    def u_grad(x):
        sx, cx, sy, cy = torch.sin(x[..., 0]), torch.cos(x[..., 0]), torch.sin(x[..., 1]), torch.cos(x[..., 1])
        return torch.stack([torch.stack([cx * cy, -sx * sy], -1), torch.stack([x[..., 1], x[..., 0]], -1)], -2)

    return u_vec, f_vec, u_grad


def _s5u(pt, n: int, device: str):
    from phifem_tpu_torch.models import InterfaceElasticityU

    u_vec, f_vec, _ = _s5u_data()
    s = InterfaceElasticityU(_u_mesh(pt, n, device), mode="bg", E_in=1.0, E_out=0.1)
    return s.setup(lambda x: x[..., 0] ** 2 + x[..., 1] ** 2 - 0.49, f_vec, u_vec)


def _s5u_scale(pt, n: int, pre: str, label: str, paths: dict):
    """S5-U at ``n`` by deflated BiCGStab to 1e-8 (maxiter 5000) with the
    preconditioner ``pre``: the set-up parts, the count, L2 / H10 against
    u_vec.  Returns (result, converged)."""
    ca = _amg()
    ca.launches = 0
    _band_reset()
    torch.cuda.reset_peak_memory_stats()
    s, t_set = _sync_time(_s5u, pt, n, DEVICE)
    _, t_asm = _sync_time(s.assemble)
    kw, t_pre = {}, 0.0
    if pre == "amg":
        vc, t_pre = _sync_time(s.amg_preconditioner)
        kw = {"precond": vc}
    r, t_solve = _sync_time(s.solve, method="bicgstab", tol=1e-8, maxiter=5000, **kw)
    paths[label] = ca.launches
    BAND_U[label] = _band_read()
    u_vec, _, u_grad = _s5u_data()
    e = s.l2_h1_errors(s.u_h, u_vec, exact_grad=u_grad, region=(1, 2, 3))
    print(f"[{label}] {s.mesh.num_vertices} vertices, {s.mesh.num_cells} triangles, "
          f"{sum(v.numel() for v in s.b.values())} DoFs: setup (tags, spaces) {t_set:.3f} s, assemble {t_asm:.3f} s, "
          f"preconditioner {t_pre:.3f} s" + ("" if pre == "jacobi" else f" ({_band(kw['precond'])})")
          + f"; deflated bicgstab {t_solve:.3f} s, {r.iterations} it ({1e3 * t_solve / max(r.iterations, 1):.2f} ms "
          f"per iteration), relres {r.residual:.3e}; L2 {e['l2']:.6e}, H10 {e['h10']:.6e} against u_vec (the "
          f"solution's rigid-motion gauge is the deflation's); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del s
    torch.cuda.empty_cache()
    return r, bool(r.converged and r.residual <= 10 * 1e-8)


def phase_s5u(pt) -> dict:
    """S5 on an imported triangle mesh: at N_S5U JAX's test path (deflated
    BiCGStab to 1e-9, maxiter 400), held against the CPU lane (tags, b and
    one matvec to 1e-12) and JAX's count; at N_S5U_PICK deflated BiCGStab to
    1e-8 with the default Jacobi and with amg_preconditioner() (Jacobi plus
    the band solve: no AMG on vector fields); the one of fewer iterations
    runs the scale run at N_S5U_LARGE, its count pinned, L2 / H10 against
    u_vec reported.  No path launches the AMG kernel."""
    ca = _amg()
    paths = {}
    label = f"u-s5 n={N_S5U}"
    ca.launches = 0
    _band_reset()
    s, t_set = _sync_time(_s5u, pt, N_S5U, DEVICE)
    _, t_asm = _sync_time(s.assemble)
    r, t_solve = _sync_time(s.solve, method="bicgstab", tol=1e-9, maxiter=400)
    paths[label] = ca.launches
    BAND_U[label] = _band_read()
    h = _s5u(pt, N_S5U, "cpu").assemble()
    rh = h.solve(method="bicgstab", tol=1e-9, maxiter=400)
    print(f"[{label}] {s.mesh.num_vertices} vertices, {sum(v.numel() for v in s.b.values())} DoFs: setup {t_set:.3f} s, "
          f"assemble {t_asm:.3f} s, deflated bicgstab {t_solve:.3f} s, {r.iterations} it (CPU lane {rh.iterations}), "
          f"relres {r.residual:.3e}")
    if not r.converged:
        raise AssertionError(f"{label}: not converged, relres {r.residual}")
    _u_check_tags(s, h, 0.49, label)
    _hold(label, _against_cpu(s, h, taps=False))
    _within_reference(label, r.iterations, JAX_S5U_IT)
    _pin(label, r.iterations, S5U_IT[N_S5U])
    picks = {}
    for pre in ("jacobi", "amg"):
        label = f"u-s5 n={N_S5U_PICK} {pre}"
        ca.launches = 0
        _band_reset()
        s = _s5u(pt, N_S5U_PICK, DEVICE).assemble()
        kw = {} if pre == "jacobi" else {"precond": s.amg_preconditioner()}
        r, t_solve = _sync_time(s.solve, method="bicgstab", tol=1e-8, maxiter=5000, **kw)
        paths[label] = ca.launches
        BAND_U[label] = _band_read()
        picks[pre] = r.iterations if r.converged else 10**9
        print(f"[{label}] deflated bicgstab to 1e-8: {r.iterations} it in {t_solve:.3f} s, relres {r.residual:.3e} "
              f"(JAX {JAX_S5U_PICK_IT[pre]} on the CPU)" + ("" if pre == "jacobi" else f"; {_band(kw['precond'])}"))
    # the scale run with the preconditioner of fewer iterations at
    # N_S5U_PICK, unless it is known to diverge at N_S5U_LARGE
    pre = min(picks, key=picks.get)
    if pre in S5U_SCALE_DIVERGES:
        other = "jacobi" if pre == "amg" else "amg"
        print(f"[u-s5 n={N_S5U_LARGE}] {pre} takes fewer iterations at n={N_S5U_PICK} ({picks[pre]} against "
              f"{picks[other]}) but diverges at n={N_S5U_LARGE}, in JAX too (S5U_SCALE_DIVERGES): the scale run "
              f"takes {other}")
        pre = other
    label = f"u-s5 n={N_S5U_LARGE} {pre}"
    r, ok = _s5u_scale(pt, N_S5U_LARGE, pre, label, paths)
    if not ok:
        raise AssertionError(f"{label}: not converged to 1e-8 within 5000 it, relres {r.residual}")
    _pin(label, r.iterations, S5U_IT[pre])
    if any(paths.values()):
        raise AssertionError(f"S5-U launched the AMG kernel (it has no vector AMG): {paths}")
    return paths


def _tet_scheme(pt, name: str, mesh):
    """demo/unstructured/main.py's main3 scheme ``name`` on ``mesh``, set
    up: ``(scheme, exact solution, error region)``."""
    from phifem_tpu_torch.models import NeumannPoissonU, RobinPoissonU, StrongDirichletPoissonU, WeakDirichletPoissonU

    ls = lambda x: (x**2).sum(-1) - TET_R2
    u = lambda x: torch.cos(x[..., 0]) * torch.sin(x[..., 1]) * torch.cos(x[..., 2])
    fex = lambda x: 3.0 * u(x)

    def nderiv(x):
        g = torch.stack([-torch.sin(x[..., 0]) * torch.sin(x[..., 1]) * torch.cos(x[..., 2]),
                         torch.cos(x[..., 0]) * torch.cos(x[..., 1]) * torch.cos(x[..., 2]),
                         -torch.cos(x[..., 0]) * torch.sin(x[..., 1]) * torch.sin(x[..., 2])], -1)
        return (g * x).sum(-1) / torch.clamp(torch.linalg.norm(x, dim=-1), min=1e-12)

    if name == "s1":
        return WeakDirichletPoissonU(mesh, mode="bg", levelset_degree=2).setup(ls, fex, u_D=u), u, (1, 2)
    if name == "s2":
        uex = lambda x: torch.sin((x**2).sum(-1) - TET_R2)

        def f2(x):
            q = (x**2).sum(-1)
            return 4.0 * q * torch.sin(q - TET_R2) - 6.0 * torch.cos(q - TET_R2)

        return StrongDirichletPoissonU(mesh, mode="bg", levelset_degree=2).setup(ls, f2), uex, (1, 2)
    if name == "s3":
        return NeumannPoissonU(mesh, mode="bg", levelset_degree=2).setup(ls, lambda x: fex(x) + u(x), nderiv), u, (1,)
    s = RobinPoissonU(mesh, mode="bg", levelset_degree=2, robin_coef=1.0)
    return s.setup(ls, lambda x: fex(x) + u(x), lambda x: nderiv(x) + u(x)), u, (1,)


def phase_tet(pt) -> dict:
    """main3's S1-S4 at N_TET by Jacobi BiCGStab (maxiter 5000): counts
    exact and within max(3, 0.25 it) of JAX's, L2 / H10 within 5% of JAX's;
    against the CPU lane: tags, b and one matvec to 1e-12, u to 1e-6 and the
    auxiliary fields to U_AUX_TOL."""
    ca = _amg()
    paths = {}
    for name in ("s1", "s2", "s3", "s4"):
        label = f"u-tet {name} n={N_TET}"
        ca.launches = 0
        _band_reset()
        mesh = pt.UMesh3.box(N_TET, N_TET, N_TET, TET_BOX, device=DEVICE)
        (s, uex, region), t_set = _sync_time(_tet_scheme, pt, name, mesh)
        _, t_asm = _sync_time(s.assemble)
        r, t_solve = _sync_time(s.solve, method="bicgstab", tol=SCHEME_TOL, maxiter=5000)
        paths[label] = ca.launches
        BAND_U[label] = _band_read()
        e = s.l2_h1_errors(s.u_h, uex, region=region)
        t0 = time.perf_counter()
        h, _, _ = _tet_scheme(pt, name, pt.UMesh3.box(N_TET, N_TET, N_TET, TET_BOX, device="cpu"))
        h.assemble()
        rh = h.solve(method="bicgstab", tol=SCHEME_TOL, maxiter=5000)
        print(f"[{label}] {s.mesh.num_vertices} vertices, {s.mesh.num_cells} tets, "
              f"{sum(v.numel() for v in s.b.values())} DoFs: setup (tags) {t_set:.3f} s, assemble {t_asm:.3f} s, "
              f"bicgstab {t_solve:.3f} s, {r.iterations} it (CPU lane {rh.iterations}, {time.perf_counter() - t0:.1f} "
              f"s), relres {r.residual:.3e}; L2 {e['l2']:.6e}, H10 {e['h10']:.6e}")
        if not (r.converged and r.residual <= 10 * SCHEME_TOL):
            raise AssertionError(f"{label}: not converged, relres {r.residual}")
        _u_check_tags(s, h, TET_R2, label)
        _hold(label, _against_cpu(s, h, taps=False))
        _u_solution_against_cpu(label, r, rh, "w" if name == "s2" else "u")
        jit, jl2, jh10 = JAX_TET[name]
        _within_reference(label, r.iterations, jit, (e["l2"], e["h10"]), (jl2, jh10))
        _pin(label, r.iterations, TET_IT[name])
    return paths


def phase_tet_amg(pt) -> tuple:
    """main3's S1 with amg_preconditioner() by BiCGStab at n=8, 12, 16
    (against JAX's counts) and by flexible GMRES at N_TET_LARGE (TET_SCALE:
    BiCGStab diverges there), the kernel held on every level of the scale
    run's hierarchy and its level 0 timed.  Returns (launches per path, the
    level-0 times)."""
    ca = _amg()
    paths, times = {}, None
    for n in (8, 12, 16, N_TET_LARGE):
        label = f"u-tet-amg s1 n={n}"
        ca.launches = 0
        _band_reset()
        torch.cuda.reset_peak_memory_stats()
        mesh, t_mesh = _sync_time(pt.UMesh3.box, n, n, n, TET_BOX, device=DEVICE)
        (s, uex, _), t_tag = _sync_time(_tet_scheme, pt, "s1", mesh)
        vc, r, _, launches = _amg_run(label, s, uex, t_mesh, t_tag, "tets",
                                      "fgmres" if n == N_TET_LARGE else "bicgstab")
        paths[label] = launches
        BAND_U[label] = _band_read()
        _pin_launches(label, launches, TET_AMG_LAUNCHES[n])
        if n in JAX_TET_AMG_IT:
            _amg_against_jax(label, r.iterations, JAX_TET_AMG_IT[n], held=n not in TET_AMG_ROUNDING,
                             jit64=JAX_TET_AMG64_IT[n])
        _pin(label, r.iterations, TET_AMG_IT[n])
        if n == N_TET_LARGE:
            times = _amg_scale_checks(label, vc, "tet")
        del s, vc, r, mesh
        torch.cuda.empty_cache()
    return paths, times


def run_slices_g1b_g2(pt) -> tuple:
    """Every slice-G1b and G2 phase; returns (the AMG launches per path,
    {"quad": level-0 times, "tet": level-0 times})."""
    t0 = time.perf_counter()
    paths, quad_times = phase_quad(pt)
    t1 = time.perf_counter()
    print(f"[time] u-quad (S1 / S3 n={N_QUAD}, AMG n=40-{N_AMG_LARGE}) {t1 - t0:.1f} s")
    paths.update(phase_s5u(pt))
    t2 = time.perf_counter()
    print(f"[time] u-s5 (n={N_S5U}, {N_S5U_PICK}, {N_S5U_LARGE}) {t2 - t1:.1f} s")
    paths.update(phase_tet(pt))
    t3 = time.perf_counter()
    print(f"[time] u-tet (S1-S4 n={N_TET}) {t3 - t2:.1f} s")
    tet_paths, tet_times = phase_tet_amg(pt)
    paths.update(tet_paths)
    print(f"[time] u-tet-amg (n=8-{N_TET_LARGE}) {time.perf_counter() - t3:.1f} s; slices G1b and G2 phases "
          f"{time.perf_counter() - t0:.1f} s")
    print(f"[main path G1b / G2] AMG kernel launches per path: {paths}")
    return paths, {"quad": quad_times, "tet": tet_times}


# ------------------------------------------------------------- slice I
# the demo CLIs (phifem_tpu_torch.demo), each run in-process through its
# main() with --device cuda and --out under the checkout's output folder, at
# its default size: the 2D demos at n=200 in bg and sub mode (but S2's sub
# mode, which phase_s2 solves at n=200), the S5 demo on param_quick (levels
# n=12 and 24), poisson3d's four Poisson schemes at n=32 and its elasticity
# case at n=16, the unstructured demo's S1 on its perturbed triangle mesh and
# on the n=12 tet box; then S5 n=64 with lattice_preconditioner(ritz_modes=12),
# P2 S1-U with p_multigrid_preconditioner() by fgmres, and device_trace
# around one solve (the Timer check runs after the S1 n=N phase)
N_DEMO_EL3 = 16
DEMO_2D = [(d, m) for d in ("weak_dirichlet_flower", "strong_dirichlet_flower", "neumann_square", "robin_square")
           for m in ("bg", "sub") if (d, m) != ("strong_dirichlet_flower", "sub")]
DEMO_RUNS = (
    [(f"demo {d} {m}", d, [m]) for d, m in DEMO_2D]
    + [("demo interface_elasticity param_quick", "interface_elasticity", ["param_quick", "--precond", "none"])]
    + [(f"demo poisson3d {s}", "poisson3d", [s]) for s in ("weak", "strong", "neumann", "robin")]
    + [(f"demo poisson3d elasticity n={N_DEMO_EL3}", "poisson3d", ["elasticity", "--n", str(N_DEMO_EL3)])]
    + [("demo unstructured s1", "unstructured", ["s1"]), ("demo unstructured s1 3d", "unstructured",
                                                           ["s1", "--dim", "3"])]
)
# the port's counts on the H100, exact (every sum on the path runs in a fixed
# order); the S5 demo's per level
DEMO_IT = {
    **{f"demo weak_dirichlet_flower {m}": 563 for m in ("bg", "sub")},
    "demo strong_dirichlet_flower bg": S2_IT,
    **{f"demo neumann_square {m}": 1500 for m in ("bg", "sub")},
    **{f"demo robin_square {m}": 1843 for m in ("bg", "sub")},
    "demo interface_elasticity param_quick": [178, 362],
    "demo poisson3d weak": 6, "demo poisson3d strong": 59, "demo poisson3d neumann": 428,
    "demo poisson3d robin": 341, f"demo poisson3d elasticity n={N_DEMO_EL3}": 60,
    "demo unstructured s1": U_DEMO_IT["s1"], "demo unstructured s1 3d": TET_IT["s1"],
}
# the kernels each demo path must launch (the unstructured demo solves by
# Jacobi BiCGStab on entity batches: none of the seven)
DEMO_KERNELS = {
    **{f"demo {d} {m}": ("taps",) for d, m in DEMO_2D},
    "demo interface_elasticity param_quick": ("taps",),
    "demo poisson3d weak": ("hex3", "lattice3"),
    "demo poisson3d strong": (),
    "demo poisson3d neumann": ("hex3",),
    "demo poisson3d robin": ("hex3",),
    f"demo poisson3d elasticity n={N_DEMO_EL3}": ("hex3_block", "lattice3_block"),
    "demo unstructured s1": (),
    "demo unstructured s1 3d": (),
}
# S5 at n=N_S5_COUPLED with 12 Ritz modes on each level of the coupled
# hierarchy; the JAX package's record (docs/s5_preconditioner.md:71, the
# flat cycle of its time): 14 -> 20 outer iterations with 12 modes
RITZ_MODES = 12
RITZ_IT = 14
JAX_RITZ_RECORD = (14, 20)
# P2 S1-U (primal and level set) on the perturbed triangle mesh of the AMG
# phases (circle R = 0.7), fgmres to 1e-10 with p_multigrid_preconditioner():
# JAX's count at n=40 on the CPU (`JAX_PLATFORMS=cpu python
# scripts/reference_amg_counts.py --mode pmg 40`), the port's at n=40 / 160
N_UPMG, N_UPMG_LARGE = 40, 160
JAX_UPMG_IT = 40
UPMG_IT = {N_UPMG: 40, N_UPMG_LARGE: 80}
# the Timer check's tap-kernel calls, queued back to back (S1 n=N, float64:
# ~0.12 ms each on the card, ~0.05 ms to queue)
TIMER_LAUNCHES = 200


def _reset_all(cs) -> None:
    _reset(cs)
    _reset3()
    _amg().launches = 0


def _counts_all(cs) -> dict:
    return {**_counts(cs), **_counts3(), "amg": _amg().launches}


def _read_written(path: str, name: str) -> np.ndarray:
    """The field ``name`` as written: the HDF5 dataset next to an XDMF, else
    the ASCII line of a VTU (%.17g) or a VTI (%.10g)."""
    if path.endswith(".xdmf"):
        import h5py

        with h5py.File(path[: -len(".xdmf")] + ".h5") as h5:
            return np.asarray(h5[f"/Function/{name}"]).reshape(-1)
    lines = Path(path).read_text().split("\n")
    i = next(k for k, s in enumerate(lines) if f'Name="{name}"' in s)
    return np.array(lines[i + 1].split(), np.float64)


def _hold_written(label: str, r: dict) -> str:
    """The field the demo wrote, read back, against the scheme's own: exact
    for XDMF / VTU, to the VTI's ten digits."""
    from phifem_tpu_torch.utils.io import _p1_point_data

    s = r["scheme"]
    path = [p for p in r["paths"] if p.endswith((".xdmf", ".vtu", ".vti"))][-1]  # the last level's
    if path.endswith(".vti"):
        lat = s.u_lat.detach().cpu().numpy()
        fields = {"u": lat} if lat.ndim == 3 else {c: lat[k] for k, c in enumerate(("ux", "uy", "uz"))}
        for name, ref in fields.items():
            got, ref = _read_written(path, name), ref.reshape(-1)
            if not (got.shape == ref.shape and np.all(np.abs(got - ref) <= 5e-10 * np.abs(ref) + 1e-300)):
                raise AssertionError(f"{label}: the VTI's {name} is not the scheme's field")
        return path
    if hasattr(s, "mesh"):
        ref = s.u_h.data[: s.mesh.num_vertices].detach().cpu().numpy().reshape(-1)
    else:
        ref = _p1_point_data(s.u_h).reshape(-1)
    if not np.array_equal(_read_written(path, "solution"), ref):
        raise AssertionError(f"{label}: the written solution is not the scheme's field")
    return path


def phase_demo(cs, label: str, module: str, argv: list, out_root: Path) -> tuple:
    """One demo CLI through its main(): its launches, exact count, written
    field; returns (counts, result)."""
    import importlib

    mod = importlib.import_module(f"phifem_tpu_torch.demo.{module}")
    out = out_root / label.replace(" ", "_").replace("=", "")
    _reset_all(cs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = mod.main(list(argv) + ["--device", DEVICE, "--out", str(out)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts_all(cs)
    path = _hold_written(label, r)
    its = r["iterations"]
    print(f"[{label}] {wall:.1f} s (phases {', '.join(f'{k} {v:.3f}' for k, v in r['phases'].items())}); "
          f"{its} it, converged {r['converged']}; errors "
          f"{r['errors'] if not isinstance(r['errors'], list) else r['errors'][-1]}; launches {counts}; wrote "
          f"{[str(Path(p).relative_to(out)) for p in r['paths']]} ({Path(path).suffix}: the field read back "
          f"equals the scheme's)")
    if not r["converged"]:
        raise AssertionError(f"{label}: not converged ({r['residual']})")
    if DEMO_IT.get(label) is not None:
        _pin(label, its, DEMO_IT[label])
    for k in DEMO_KERNELS[label]:
        if counts[k] <= 0:
            raise AssertionError(f"{label} never launched the {k} kernel")
    return counts, r


def phase_ritz(pt, cs) -> dict:
    """S5 n=N_S5_COUPLED, lattice_preconditioner(ritz_modes=RITZ_MODES) (the
    coupled hierarchy with the Ritz harvest on each smoothing level), deflated
    BiCGStab: the count against the coupled phase's and JAX's record."""
    import phifem_tpu_torch.mg as tmg

    label = f"s5 n={N_S5_COUPLED} ritz"
    real, spent = tmg.attach_ritz_modes, []

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real(*a, **kw)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t)
        return out

    _reset_all(cs)
    s, t_tag = _sync_time(_s5, pt, N_S5_COUPLED, DEVICE)
    _, t_asm = _sync_time(s.assemble)
    tmg.attach_ritz_modes = timed
    try:
        vc, t_pre = _sync_time(s.lattice_preconditioner, ritz_modes=RITZ_MODES)
    finally:
        tmg.attach_ritz_modes = real
    r, t_solve = _sync_time(s.solve, tol=S5_TOL, precond=vc)
    counts = _counts_all(cs)
    e = _s5_errors(s)
    lam = [np.round(lv["M"].ritz_lambdas, 4).tolist() for lv in vc.levels]
    print(f"[{label}] lattice_preconditioner(ritz_modes={RITZ_MODES}) {t_pre:.3f} s, of it the Ritz harvests "
          f"{[round(t, 3) for t in spent]} s on levels {[lv['grid'].nx for lv in vc.levels]}; kept |lambda| "
          f"per level {lam}; deflated bicgstab tol {S5_TOL:.0e}: {r.iterations} it (without Ritz modes "
          f"{S5_COUPLED_IT}; JAX's record {JAX_RITZ_RECORD[0]} -> {JAX_RITZ_RECORD[1]}), relres "
          f"{r.residual:.3e}, {t_solve:.3f} s; L2 {e['l2']:.4e}, H10 {e['h10']:.4f}; tag {t_tag:.3f} s, "
          f"assemble {t_asm:.3f} s; launches {counts}")
    if len(spent) != len(vc.levels) or any(lv["M"].ritz_lambdas is None for lv in vc.levels):
        raise AssertionError(f"{label}: a level kept no Ritz mode")
    if not r.converged:
        raise AssertionError(f"{label}: {r.iterations} it, relres {r.residual}")
    if RITZ_IT is not None:
        _pin(label, r.iterations, RITZ_IT)
    if counts["taps"] <= 0:
        raise AssertionError(f"{label} never launched the tap kernel")
    return counts


def phase_upmg(pt, cs) -> dict:
    """P2 S1-U on the perturbed triangle mesh with p_multigrid_preconditioner()
    and fgmres to 1e-10: n=N_UPMG held to JAX's count, n=N_UPMG_LARGE pinned."""
    from phifem_tpu_torch.models import WeakDirichletPoissonU

    paths = {}
    for n in (N_UPMG, N_UPMG_LARGE):
        label = f"u-pmg P2 s1 n={n}"
        _reset_all(cs)
        mesh, t_mesh = _sync_time(_u_mesh, pt, n, DEVICE)
        circle = lambda x: x[..., 0] ** 2 + x[..., 1] ** 2 - 0.49
        s = WeakDirichletPoissonU(mesh, mode="bg", primal_degree=2, levelset_degree=2)
        _, t_setup = _sync_time(s.setup, circle, lambda x: 2.0 * _u_exact(x), u_D=_u_exact)
        _, t_asm = _sync_time(s.assemble)
        vc, t_pre = _sync_time(s.p_multigrid_preconditioner)
        r, t_solve = _sync_time(s.solve, method="fgmres", tol=SCHEME_TOL, maxiter=200, precond=vc)
        counts = _counts_all(cs)
        e = s.l2_h1_errors(s.u_h, _u_exact, region=(1, 2))
        print(f"[{label}] ndofs={s.system.num_dofs}: mesh {t_mesh:.3f} s, setup {t_setup:.3f} s, assemble "
              f"{t_asm:.3f} s, p_multigrid_preconditioner() {t_pre:.3f} s; fgmres {r.iterations} it, relres "
              f"{r.residual:.3e}, {t_solve:.3f} s; L2 {e['l2']:.6e}, H10 {e['h10']:.6e}; launches {counts}")
        if not r.converged:
            raise AssertionError(f"{label}: {r.iterations} it, relres {r.residual}")
        if UPMG_IT[n] is not None:
            _pin(label, r.iterations, UPMG_IT[n])
        if n == N_UPMG and JAX_UPMG_IT is not None:
            _within_reference(label, r.iterations, JAX_UPMG_IT)
        paths[label] = counts
    return paths


def phase_timer(ct, top, launches: int = TIMER_LAUNCHES) -> None:
    """Timer around ``launches`` calls of the tap kernel on ``top`` (the S1
    n=N tap form), work that only queues on the card with no host read in
    between: the phase's time is at least the CUDA-event time of the same
    calls, less 5%.  A timer that does not wait for the card reads only the
    time to queue them, which must stay under that 95% (with a margin, 90%)
    for the check to tell the two apart."""
    from phifem_tpu_torch.utils import Timer

    rng = np.random.default_rng(SEED)
    x = {sp.name: torch.as_tensor(rng.standard_normal((sp.shape[0] * sp.shape[1] * sp.nblocks,) + sp.vshape),
                                  dtype=top.W.dtype, device=top.W.device) for sp in top.specs}
    ct.tap_matvec(top, top.W, x)
    timer = Timer(DEVICE)
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with timer.phase("taps"):
        e0.record()
        t0 = time.perf_counter()
        for _ in range(launches):
            ct.tap_matvec(top, top.W, x)
        queued = time.perf_counter() - t0
        e1.record()
    ev = e0.elapsed_time(e1) / 1e3
    print(f"[timer] Timer phase {timer.phases['taps']:.4f} s, CUDA events {ev:.4f} s over the same {launches} "
          f"tap-kernel calls (S1 n={N} tap form, {str(top.W.dtype)[6:]}); queueing them took {queued:.4f} s "
          f"({queued / ev:.1%} of the events: what a timer that does not wait would read)")
    if timer.phases["taps"] < 0.95 * ev:
        raise AssertionError("the Timer's phase ended before the work it queued")
    if queued > 0.9 * ev:
        raise AssertionError("queueing the calls took as long as running them: the check cannot tell a Timer "
                             "that waits from one that does not")
    del x
    torch.cuda.empty_cache()


def phase_trace(s, out_root: Path) -> None:
    """device_trace around four iterations of the S1 demo's solve (Jacobi
    BiCGStab, the tap kernel): the trace names the port's kernel."""
    from phifem_tpu_torch.utils import device_trace

    with device_trace(str(out_root / "trace")) as path:
        s.solve(tol=SCHEME_TOL, maxiter=4)
    with open(path) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"}
    taps = sorted(n for n in names if KERNELS_2D["tap"] in n)
    print(f"[trace] device_trace wrote {Path(path).name} ({Path(path).stat().st_size} bytes, {len(names)} kernel "
          f"names, the tap kernel's: {taps[:1]})")
    if not taps:
        raise AssertionError("the device trace names no kernel of the port")


def run_slice_i(pt, cs) -> dict:
    """Every slice-I phase; returns the launches of every kernel per path."""
    import tempfile

    t0 = time.perf_counter()
    out_root = Path(tempfile.mkdtemp(prefix="phifem_demos_"))  # removed at the end
    try:
        import h5py  # noqa: F401

        print("[demo] h5py present: write_xdmf writes XDMF + HDF5")
    except ImportError:
        print("[demo] no h5py here: write_xdmf writes VTU (the JAX package's fallback)")
    paths, times, s1 = {}, {}, None
    for label, module, argv in DEMO_RUNS:
        t = time.perf_counter()
        paths[label], r = phase_demo(cs, label, module, argv, out_root)
        times[label] = time.perf_counter() - t
        if label == "demo weak_dirichlet_flower bg":
            s1 = r["scheme"]
        del r
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    phase_trace(s1, out_root)
    del s1
    t2 = time.perf_counter()
    paths[f"s5 n={N_S5_COUPLED} ritz"] = phase_ritz(pt, cs)
    torch.cuda.empty_cache()
    t3 = time.perf_counter()
    paths.update(phase_upmg(pt, cs))
    t4 = time.perf_counter()
    print(f"[time] slice I: demos {t1 - t0:.1f} s ({', '.join(f'{k[5:]} {v:.1f}' for k, v in times.items())}), "
          f"trace {t2 - t1:.1f} s, ritz {t3 - t2:.1f} s, u-pmg {t4 - t3:.1f} s; slice I phases "
          f"{t4 - t0:.1f} s")
    print(f"[main path I] kernel launches per path: {paths}")
    shutil.rmtree(out_root)
    return paths


# ---------------------------------------------------------------- slice H
# the sharded solves of phifem_tpu_torch.parallel: SH_SHARDS shards on the
# one card (a shard mesh may repeat a device); each run is held to the
# port's single-device solve of the same system
SH_SHARDS = 4
N_SH_FLOWER = 200  # the S1 flower of bench.py's s1 section, through halo_solve
N_SH_U = 160  # S1-U on the G1a mesh, partitioned and element-sharded
N_SH_P2 = 9  # the degree-2 S1 of tests/test_torch_parallel_halo.py: sharded_solve's whole-vector branch
N_SH_S5U = N_S5U  # tests/test_parallel.py's deflated partitioned S5-U size
SH_P2_TOL = 1e-12
SH_REL_U = 1e-6  # x against the single-device solve, relative to max |x|
SH_REL_S5U = 1e-5  # the same for the deflated S5-U solve (tests/test_parallel.py's bar)
# the sharded solves' counts, pinned (the single-device counts are printed
# beside them: 8, 563, 6, 318, 514 and 133 on the card)
SH_IT = {"box": 8, "halo": 499, "box3": 6, "partitioned": 331, "element": 320, "p2": 490, "s5u": 135}


def _sh_line(label: str, mesh, n: int, ndofs: int, it: int, rel: float, warm: float, moved: int, counts: dict,
             extra: str = "") -> None:
    devs = ", ".join(sorted({str(d) for d in mesh.devices}))
    per_it = moved / max(it, 1)
    print(f"[{label}] {mesh.size} shards on {devs}; n={n}, {ndofs} DoF; {it} it, relres {rel:.3e}; warm "
          f"{warm:.3f} s; {per_it:,.0f} bytes between shards an iteration; launches {counts}{extra}")


def _sh_pin(label: str, key: str, it: int) -> None:
    if SH_IT[key] is not None:
        _pin(label, it, SH_IT[key])


def _sh_hold(label: str, x: dict, ref: dict, tol: float, floor: float = 1e-300) -> float:
    """max over the fields of max |x - ref| / max(max |ref|, floor), raising
    past ``tol``."""
    worst = 0.0
    for k in ref:
        scale = max(float(ref[k].abs().max()), floor)
        worst = max(worst, float((x[k] - ref[k]).abs().max()) / scale)
    if worst > tol:
        raise AssertionError(f"{label}: the sharded solution differs from the single-device one by {worst:.3e}")
    return worst


def _sh_runs(fn, *args, **kw):
    """A short call (2 iterations: the path's operator built and its
    kernels, copies and dots run once) and the warm call; the warm call's
    result, its seconds and its stats.  A whole cold solve would cost the
    script's time limit as much as the warm one."""
    fn(*args, **dict(kw, maxiter=2))
    stats = {}
    out, t = _sync_time(fn, *args, stats=stats, **kw)
    return out, t, stats


def phase_sh_box(pt, cs, tpar, mesh) -> dict:
    """Box Poisson n=N through sharded_lattice_solve (row slabs, one halo row
    a transfer, the tail agglomerated), against the single-device
    solve_lattice at the same n."""
    from phifem_tpu_torch.ops.lattice import vertex_stencil_weights
    from phifem_tpu_torch.ops.stencil import _TRI_OFFS

    label = f"H box Poisson n={N}"
    g, _, f = _problem(pt)
    s = pt.BoxPoisson(g)
    s.setup(f)
    s.assemble()
    mg1 = s.lattice_solver(min_n=16, dtype=torch.float32)
    s.solve_lattice(tol=TOL, maxiter=40, mg=mg1)
    r1, t1 = _sync_time(s.solve_lattice, tol=TOL, maxiter=40, mg=mg1)
    w = vertex_stencil_weights(s.op.batches[0].matrices.numpy(), _TRI_OFFS)
    mg, t_mg = _sync_time(tpar.build_sharded_lattice_mg, N, N, w, mesh, min_n=16, replicate_rows=32,
                          dtype=torch.float32)
    b2d = s.b["u"].reshape(N + 1, N + 1)
    _reset_all(cs)
    (u, rel, it), t_warm, stats = _sh_runs(tpar.sharded_lattice_solve, mg, mesh, b2d, tol=TOL, maxiter=40)
    counts = _counts_all(cs)
    diff = _sh_hold(label, {"u": u.reshape(-1)}, {"u": r1.x["u"]}, 1e-8)
    _sh_line(label, mesh, N, s.system.num_dofs, it, rel, t_warm, stats["bytes_moved"], counts,
             f"; single device {r1.iterations} it in {t1:.3f} s; levels m={[l.m for l in mg.levels]}, tail "
             f"{'LatticeMG' if mg.tail is not None else 'dense'}; build {t_mg:.3f} s; max|u - u_1|/max|u_1| {diff:.3e}")
    if not rel < 1e-10:
        raise AssertionError(f"{label}: relres {rel}")
    _sh_pin(label, "box", it)
    return {label: counts}


def _hold_slab_stencil(cs, H) -> float:
    """The stencil kernel on one shard's slab (the halo path's shape) against
    its plain version, f64; its launches are put back."""
    n0, m0, s0 = cs.launches, cs.masked_launches, cs.shape_launches.copy()
    st = H._stencils[1][0]
    rng = np.random.default_rng(SEED)
    x = torch.as_tensor(rng.standard_normal(st.nv), device=DEVICE)
    y0 = torch.as_tensor(rng.standard_normal(st.nv), device=DEVICE)
    y = cs.stencil_matvec(st.grid, x, st.masks, st.mats, y=y0.clone(), packed=st.packed)
    ref = cs.stencil_matvec_ref(st.grid, x, st.masks, st.mats, y=y0.clone())
    torch.cuda.synchronize()
    cs.launches, cs.masked_launches, cs.shape_launches = n0, m0, s0
    err = float((y - ref).abs().max() / ref.abs().max())
    if err > 1e-13:
        raise AssertionError(f"stencil kernel on a slab ({st.grid.ny} x {st.grid.nx} cells): {err}")
    return err


def phase_sh_halo(pt, cs, tpar, mesh) -> dict:
    """S1 flower n=N_SH_FLOWER through sharded_solve -> halo_solve: one halo
    matvec against the single-device masked operator, then Jacobi-equilibrated
    BiCGStab to SCHEME_TOL against the single-device solve."""
    from phifem_tpu_torch.solvers import masked_operator

    label = f"H S1 halo n={N_SH_FLOWER}"
    s = _flower_s1(pt, N_SH_FLOWER, DEVICE)
    s.assemble()
    H = tpar.HaloOperator(s.op, s.grid, mesh)
    rng = np.random.default_rng(SEED)
    x = {k: torch.as_tensor(rng.standard_normal(tuple(v.shape)), device=DEVICE) for k, v in s.b.items()}
    y = H.unpad(H.matvec(H.pad(x)))
    y_ref = masked_operator(s.op)[0](x)
    mv_err = max(float((y[k] - y_ref[k]).abs().max() / y_ref[k].abs().max()) for k in y)
    if mv_err > 1e-13:
        raise AssertionError(f"{label}: the halo matvec differs from the masked operator by {mv_err}")
    k_err = _hold_slab_stencil(cs, H)
    r1, t1 = _sync_time(s.solve, tol=SCHEME_TOL)
    _reset_all(cs)
    (xs, rel), t_warm, stats = _sh_runs(tpar.sharded_solve, s.op, s.b, mesh, tol=SCHEME_TOL,
                                        maxiter=25 * int(math.isqrt(s.system.num_dofs)) + 1000)
    counts = _counts_all(cs)
    it = stats["iterations"]
    diff = _sh_hold(label, xs, r1.x, SH_REL_U)
    _sh_line(label, mesh, N_SH_FLOWER, s.system.num_dofs, it, rel, t_warm, stats["bytes_moved"], counts,
             f"; path {stats['path']}, slabs of {stats['slab_rows']} rows, halo {stats['halo_rows']}; single "
             f"device {r1.iterations} it in {t1:.3f} s; max|x - x_1|/max|x_1| {diff:.3e}; one halo matvec against "
             f"the masked operator {mv_err:.3e}, the stencil kernel on a slab against its plain version {k_err:.3e}")
    if stats["path"] != "halo" or not rel <= 10 * SCHEME_TOL:
        raise AssertionError(f"{label}: path {stats['path']}, relres {rel}")
    if counts["stencil"] <= 0 or counts["masked"] <= 0:
        raise AssertionError(f"{label} never launched the masked stencil kernel")
    _sh_pin(label, "halo", it)
    return {label: counts}


def _hold_slab_sweep(mg) -> float:
    """The lattice sweep kernel on one slab frame (the sharded path's
    shape, matvec mode) against its plain version, bit for bit; its launch is
    put back."""
    from phifem_tpu_torch.ops import cuda_lattice3 as cl

    lvl = mg.levels[0]
    n0 = cl.launches
    rng = np.random.default_rng(SEED)
    slab = torch.as_tensor(rng.standard_normal((lvl.m + 4, lvl.R + 2, lvl.C + 2)), device=DEVICE)
    got = cl.lattice3_sweep(cl.MATVEC, slab, mg._packed[0])
    ref = cl.lattice3_sweep_ref(cl.MATVEC, slab, mg._packed[0])
    torch.cuda.synchronize()
    cl.launches = n0
    if not torch.equal(got, ref):
        raise AssertionError(f"lattice sweep kernel on a slab frame {tuple(slab.shape)}: not its plain version's bits")
    return 0.0


def phase_sh_box3(pt, cs, tpar, mesh) -> dict:
    """Box Poisson 3D n=N3_BOX through sharded_lattice3_solve (z-plane slabs,
    each slab's stencil the lattice sweep kernel), against the single-device
    solve_lattice."""
    label = f"H box3 n={N3_BOX}"
    g, _, f = _box3(pt, N3_BOX)
    s = pt.BoxPoisson3(g)
    s.setup(f)
    s.assemble()
    mg1 = s.lattice_solver(min_n=8, dtype=torch.float32)
    s.solve_lattice(tol=TOL, maxiter=40, mg=mg1)
    r1, t1 = _sync_time(s.solve_lattice, tol=TOL, maxiter=40, mg=mg1)
    n = N3_BOX
    mg, t_mg = _sync_time(tpar.build_sharded_lattice3_mg, n, n, n, g.spacing, mesh, min_n=8, replicate_planes=8,
                          dtype=torch.float32)
    _hold_slab_sweep(mg)
    _reset_all(cs)
    (u, rel, it), t_warm, stats = _sh_runs(tpar.sharded_lattice3_solve, mg, mesh, s.b_lat, tol=TOL, maxiter=40)
    counts = _counts_all(cs)
    diff = _sh_hold(label, {"u": u}, {"u": s.u_lat}, 1e-8)
    _sh_line(label, mesh, n, g.num_vertices, it, rel, t_warm, stats["bytes_moved"], counts,
             f"; single device {r1.iterations} it in {t1:.3f} s; levels m={[l.m for l in mg.levels]}, tail "
             f"{'Lattice3MG' if mg.tail is not None else 'dense'}; build {t_mg:.3f} s; max|u - u_1|/max|u_1| "
             f"{diff:.3e}; the sweep kernel on a slab frame equal to its plain version")
    if not rel < 1e-10:
        raise AssertionError(f"{label}: relres {rel}")
    if counts["lattice3"] <= 0:
        raise AssertionError(f"{label} never launched the lattice sweep kernel")
    _sh_pin(label, "box3", it)
    return {label: counts}


def phase_sh_u(pt, cs, tpar, mesh) -> dict:
    """S1-U n=N_SH_U on the G1a mesh by Jacobi-equilibrated BiCGStab through
    partitioned_solve and element_sharded_solve, each against the
    single-device solve."""
    mesh_u = _u_mesh(pt, N_SH_U, DEVICE)
    s, _, _ = _u_scheme(pt, "s1", mesh_u, 0.49)
    s.assemble()
    r1, t1 = _sync_time(s.solve, tol=SCHEME_TOL)
    paths = {}
    for name, fn in (("partitioned", tpar.partitioned_solve), ("element", tpar.element_sharded_solve)):
        label = f"H S1-U {name} n={N_SH_U}"
        _reset_all(cs)
        (xs, rel, it), t_warm, stats = _sh_runs(fn, s.op, s.b, mesh, tol=SCHEME_TOL)
        paths[label] = _counts_all(cs)
        diff = _sh_hold(label, xs, r1.x, SH_REL_U)
        _sh_line(label, mesh, N_SH_U, s.system.num_dofs, it, rel, t_warm, stats["bytes_moved"], paths[label],
                 f"; single device {r1.iterations} it in {t1:.3f} s; max|x - x_1|/max|x_1| {diff:.3e}")
        if not rel <= 10 * SCHEME_TOL:
            raise AssertionError(f"{label}: relres {rel}")
        _sh_pin(label, name, it)
    return paths


def phase_sh_p2(pt, cs, tpar, mesh) -> dict:
    """S1 at degree 2 (tests/test_parallel.py's circle, n=N_SH_P2) through
    sharded_solve's whole-vector branch to SH_P2_TOL, against the
    single-device solve.  Not tests/test_parallel.py's n=17: there the two
    runs take 1,118 iterations each, 26.8 s of the script's time limit."""
    label = f"H S1 P2 n={N_SH_P2} whole-vector"
    g = pt.Grid(N_SH_P2, N_SH_P2, U_BOX, pt.CellType.triangle, device=DEVICE)
    s = pt.WeakDirichletPoisson(g, mode="bg", primal_degree=2, levelset_degree=2)
    s.setup(lambda x: x[..., 0] ** 2 + x[..., 1] ** 2 - 0.49, lambda x: 2.0 * _u_exact(x), u_D=_u_exact)
    s.assemble()
    # both to 1e-12: the branch stops on the unscaled residual, the
    # single-device solve on the equilibrated one
    r1, t1 = _sync_time(s.solve, tol=SH_P2_TOL, maxiter=4000)
    _reset_all(cs)
    (xs, rel), t_warm, stats = _sh_runs(tpar.sharded_solve, s.op, s.b, mesh, tol=SH_P2_TOL, maxiter=4000)
    counts = _counts_all(cs)
    diff = _sh_hold(label, xs, r1.x, SH_REL_U)
    _sh_line(label, mesh, N_SH_P2, s.system.num_dofs, stats["iterations"], rel, t_warm, stats["bytes_moved"],
             counts, f"; single device {r1.iterations} it in {t1:.3f} s; max|x - x_1|/max|x_1| {diff:.3e}")
    if stats["path"] != "whole-vector" or not rel <= 10 * SH_P2_TOL:
        raise AssertionError(f"{label}: path {stats['path']}, relres {rel}")
    _sh_pin(label, "p2", stats["iterations"])
    return {label: counts}


def phase_sh_s5u(pt, cs, tpar, mesh) -> dict:
    """S5-U n=N_SH_S5U through partitioned_solve with rigid-mode deflation
    (BiCGStab to 1e-9), against the single-device deflated solve."""
    label = f"H S5-U partitioned deflated n={N_SH_S5U}"
    s = _s5u(pt, N_SH_S5U, DEVICE)
    s.assemble()
    r1, t1 = _sync_time(s.solve, method="bicgstab", tol=1e-9, maxiter=2000)
    _reset_all(cs)
    (xs, rel, it), t_warm, stats = _sh_runs(tpar.partitioned_solve, s.op, s.b, mesh, bcs=s.bcs, tol=1e-9,
                                            maxiter=2000, deflate=s.rigid_modes())
    counts = _counts_all(cs)
    diff = _sh_hold(label, xs, r1.x, SH_REL_S5U, floor=1.0)
    _sh_line(label, mesh, N_SH_S5U, s.system.num_dofs, it, rel, t_warm, stats["bytes_moved"], counts,
             f"; single device {r1.iterations} it in {t1:.3f} s; max|x - x_1|/max(|x_1|, 1) {diff:.3e}")
    if not rel <= 1e-8:
        raise AssertionError(f"{label}: relres {rel}")
    _sh_pin(label, "s5u", it)
    return {label: counts}


def run_slice_h(pt, cs) -> dict:
    """Every slice-H phase on SH_SHARDS shards of the one card; returns the
    launches of every kernel per path."""
    import phifem_tpu_torch.parallel as tpar

    mesh = tpar.make_mesh(devices=[f"{DEVICE}:0"] * SH_SHARDS)
    paths, times = {}, {}
    for key, phase in (("box", phase_sh_box), ("halo", phase_sh_halo), ("box3", phase_sh_box3),
                       ("u", phase_sh_u), ("p2", phase_sh_p2), ("s5u", phase_sh_s5u)):
        t0 = time.perf_counter()
        paths.update(phase(pt, cs, tpar, mesh))
        times[key] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    print(f"[time] slice H: {', '.join(f'{k} {v:.1f}' for k, v in times.items())}; slice H phases "
          f"{sum(times.values()):.1f} s (four shards on one card: the partitioning and the per-shard dispatch, "
          "not NVLink)")
    print(f"[main path H] kernel launches per path: {paths}")
    return paths


def _band_lines(counts: dict) -> list:
    """The band kernels' launch checks over every path's counts (a path
    that built a Schwarz band launched each band kernel; one that built
    none launched none) and their lines of the kernels record, with the
    S1 n=N band's times."""
    band = {p: {k: c[k] for k in ("band", "band_ras", "band_ell", "band_dots", "band_update", "band_tables")}
            for p, c in counts.items()}
    schwarz = [p for p, c in band.items() if c["band_tables"]]
    print(f"[main path band] band kernel launches on the {len(schwarz)} paths that build a Schwarz band: "
          + "; ".join(f"{p}: {c['band']} ({c['band_ras']} RAS, {c['band_ell']} ELL, {c['band_dots']} dots, "
                      f"{c['band_update']} updates; {c['band_tables']} bands)" for p, c in band.items() if c["band_tables"])
          + f"; no Schwarz band, no band launch: {[p for p in band if p not in schwarz]}")
    for p, c in band.items():
        if c["band_tables"] and min(c[k] for k in ("band_ras", "band_ell", "band_dots", "band_update")) <= 0:
            raise AssertionError(f"{p} built a Schwarz band but did not launch every band kernel: {c}")
        if not c["band_tables"] and c["band"]:
            raise AssertionError(f"{p} built no Schwarz band but launched the band kernels: {c}")
    main = f"S1 n={N}"
    lines = []
    for name, _, source, replaces in BAND_KERNELS:
        t = BAND_TIMES[main][name]
        line = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(c[name] for c in band.values()),
                "launches_by_path": {p: c[name] for p, c in band.items() if c[name]}, "max_abs_err": 0.0,
                **{k: t[k] for k in ("ms", "device_ms", "host_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
                "shape": f"{main} band: {BAND_TIMES[main]['shape']}"}
        if name == "band_update":
            line["inner_solve"] = BAND_TIMES[main]["solve"]
        lines.append(line)
    return lines


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
    from phifem_tpu_torch.ops import cuda_amg, cuda_band, cuda_hex3, cuda_lattice3

    phase_build(cs, ct, cuda_hex3, cuda_lattice3, cuda_amg, cuda_band)
    kernel = phase_kernel(pt, cs)

    # each main path counts its own launches, from 0 just before it
    paths = {}
    _reset(cs)
    s, r_gen = phase_generic(pt)
    phase_lattice(pt, s, r_gen)
    del s, r_gen
    phase_ir(pt)
    paths["box Poisson"] = _counts(cs)
    # how many of the path's stencil launches run at the full lattice, how
    # many on the multigrid's coarse levels
    by_lattice = {f"{r}x{c}": k for (r, c), k in sorted(cs.shape_launches.items(), reverse=True)}
    print(f"[box Poisson] stencil launches by lattice: {by_lattice}")
    if sum(by_lattice.values()) != paths["box Poisson"]["stencil"]:
        raise AssertionError("the launches by lattice do not add up to the path's launches")
    _reset(cs)
    paths[f"S1 n={N_S1}"], s1, vc1, r1 = phase_s1_small(pt, cs)
    _reset(cs)
    paths[f"S1 n={N_S1} gmres"] = phase_gmres(pt, cs, s1, vc1, r1)
    del s1, vc1, r1
    _reset(cs)
    paths[f"S1 n={N}"], s1 = phase_s1_large(pt, cs)
    taps_s1 = _tap_kernel_check(ct, s1.op.lattice_form(), f"s1 n={N}")
    phase_timer(ct, s1.op.lattice_form())  # slice I's Timer check, on the largest tap form
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
    torch.cuda.empty_cache()
    t_s5 = time.perf_counter()
    _reset(cs)
    paths[f"S5 n={N_S5} sparse"], s5, e5 = phase_s5_direct(pt, cs)
    print(f"[time] S5 direct {time.perf_counter() - t_s5:.1f} s")
    t0 = time.perf_counter()
    _reset(cs)
    paths[f"S5 n={N_S5} flat"] = phase_s5_flat(pt, cs, s5, e5)
    del s5
    print(f"[time] S5 flat {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _reset(cs)
    paths[f"S5 n={N_S5_COUPLED} coupled"] = phase_s5_coupled(pt, cs)
    print(f"[time] S5 coupled {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    taps_s5 = phase_s5_taps(pt, ct)
    torch.cuda.empty_cache()
    print(f"[time] S5 tap kernel {time.perf_counter() - t0:.1f} s; S5 phases {time.perf_counter() - t_s5:.1f} s")

    # slice E: degree 2 and 3 through p-multigrid + flexible GMRES
    t_e = time.perf_counter()
    for degree, n, it, cpu, trace in ((2, N_PMG, S1_P2_IT, "solve", False),
                                      (3, N_PMG, S1_P3_IT, "operator", False),
                                      (2, N_PMG_LARGE, S1_P2_LARGE_IT, "", True)):
        t0 = time.perf_counter()
        _reset(cs)
        paths[f"S1 P{degree} n={n}"] = phase_pmg(pt, cs, degree, n, it, cpu=cpu, trace=trace)
        torch.cuda.empty_cache()
        print(f"[time] S1 P{degree} n={n} {time.perf_counter() - t0:.1f} s")
    _reset(cs)
    paths["S1 Q3 circle"] = phase_q3(pt, cs)
    print(f"[time] slice E phases {time.perf_counter() - t_e:.1f} s")

    # slice F1: 3D box Poisson, weak Dirichlet Q1-Q3, strong Dirichlet; its
    # paths count the two 3D kernels (and launch neither 2D kernel)
    t_f = time.perf_counter()
    kernels3, paths3 = run_slice_f1(pt)
    print(f"[time] slice F1 phases {time.perf_counter() - t_f:.1f} s")

    # slice F2: 3D Neumann and Robin, S5-3D; the block kernels on S5-3D
    t_f = time.perf_counter()
    kernels3b, paths3b = run_slice_f2(pt)
    print(f"[time] slice F2 phases {time.perf_counter() - t_f:.1f} s")
    # the F2 paths run the two scalar 3D kernels too: their lines count them
    for line, key in zip(kernels3, ("hex3", "lattice3")):
        line["launches"] += sum(c[key] for c in paths3b.values())
        line["launches_by_path"].update({p: c[key] for p, c in paths3b.items()})

    # slice G1a: imported triangle meshes, S1-S4 and S1-U with AMG; its
    # paths count the AMG kernel (and launch none of the lattice kernels)
    t_g = time.perf_counter()
    amg_line, _ = run_slice_g1a(pt)
    print(f"[time] slice G1a phases {time.perf_counter() - t_g:.1f} s")

    # slices G1b and G2: imported quadrilaterals, S5-U, imported tetrahedra;
    # the S1-U AMG paths on quads and tets count the AMG kernel too
    t_g = time.perf_counter()
    paths_u, times_u = run_slices_g1b_g2(pt)
    print(f"[time] slices G1b and G2 phases {time.perf_counter() - t_g:.1f} s")
    amg_line["launches"] += sum(paths_u.values())
    amg_line["launches_by_path"].update(paths_u)
    for cell, t_u in times_u.items():
        jac = t_u["A", "jacobi", torch.float32]
        amg_line[f"{cell}_shape"] = (f"S1-U {cell} n={N_AMG_LARGE if cell == 'quad' else N_TET_LARGE} AMG level 0: "
                                     f"{jac['rows']} rows x ELL width {jac['width']}, {jac['lanes']} lanes per row")
        for (tab, mode, dt), t in t_u.items():
            for k in ("ms", "device_ms", "device_ms_clean", "host_ms", "plain_ms", "bound_ms", "library_ms"):
                if t.get(k) is not None:
                    amg_line[f"{cell}_{tab}_{mode}_{str(dt)[6:]}_{k}"] = t[k]

    # slice I: the demo CLIs, the Ritz modes, p-MG on an imported mesh; its
    # paths count all seven kernels
    t_i = time.perf_counter()
    paths_i = run_slice_i(pt, cs)
    print(f"[time] slice I phases {time.perf_counter() - t_i:.1f} s")

    # slice H: the sharded solves, four shards on the one card; the halo
    # path counts the stencil kernel, the 3D slabs the lattice sweep kernel
    t_h = time.perf_counter()
    paths_h = run_slice_h(pt, cs)
    print(f"[time] slice H phases {time.perf_counter() - t_h:.1f} s")

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
    kernel["masked_launches_by_path"] = {p: c["masked"] for p, c in paths.items()}
    kernel["poisson_launches_by_lattice"] = by_lattice
    f64, f32 = torch.float64, torch.float32
    taps = {
        "name": "tap_matvec",
        "route": "cuda",
        "source": "phifem_tpu_torch/csrc/tap_matvec.cu",
        "replaces": "phifem_tpu/ops/taps.py:305 (per-tap loop, XLA-fused; not a Pallas kernel)",
        "launches": sum(c["taps"] for c in paths.values()),
        "launches_by_path": {p: c["taps"] for p, c in paths.items()},
        "max_abs_err": max(v["err"] for d in (taps_s1, taps_s4, taps_s5) for v in d.values()),
        **{k: taps_s1[f64][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                        "active_tile_fraction")},
        "library": "torch.mv of the operator as a CUDA CSR matrix (cuSPARSE SpMV)",
        "tile": list(ct.TILE),
        "shape": f"S1 flower n={N} tap form, float64",
        "device_ms": taps_s1[f64]["device_ms"],
        "host_ms": taps_s1[f64]["host_ms"],
        **{f"{k}_f32": taps_s1[f32][k] for k in TAP_TIMES},
        **{f"s4_{k}": taps_s4[f64][k] for k in TAP_TIMES + ("active_tile_fraction",)},
        **{f"s4_{k}_f32": taps_s4[f32][k] for k in TAP_TIMES},
        "s4_shape": f"S4 Robin square n={N_S4_TAPS} tap form",
        **{f"s5_{k}": taps_s5[f64][k] for k in TAP_TIMES + ("active_tile_fraction",)},
        **{f"s5_{k}_f32": taps_s5[f32][k] for k in TAP_TIMES},
        "s5_shape": f"S5 interface elasticity n={N_S5_TAPS} tap form (blocks of 2/2/4/4/2 channels)",
        "s5_launches_by_path": {p: c["taps"] for p, c in paths.items() if p.startswith("S5")},
    }
    for line, key in ((kernel, "stencil"), (taps, "taps"), (kernels3[0], "hex3"), (kernels3[1], "lattice3"),
                      (kernels3b[0], "hex3_block"), (kernels3b[1], "lattice3_block"), (amg_line, "amg")):
        line["launches"] += sum(c[key] for c in paths_i.values())
        line["launches_by_path"].update({p: c[key] for p, c in paths_i.items()})
    kernel["masked_launches_by_path"].update({p: c["masked"] for p, c in paths_i.items()})
    for line, key in ((kernel, "stencil"), (taps, "taps"), (kernels3[0], "hex3"), (kernels3[1], "lattice3"),
                      (kernels3b[0], "hex3_block"), (kernels3b[1], "lattice3_block"), (amg_line, "amg")):
        line["launches"] += sum(c[key] for c in paths_h.values())
        line["launches_by_path"].update({p: c[key] for p, c in paths_h.items() if c[key]})
    kernel["masked_launches_by_path"].update({p: c["masked"] for p, c in paths_h.items() if c["masked"]})
    band_lines = _band_lines({**paths, **paths3, **paths3b, **paths_i, **paths_h, **BAND_U})
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    lines = [kernel, taps, *kernels3, *kernels3b, amg_line, *band_lines]
    print(json.dumps({"kernels": [_mark_sources(e) for e in lines]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
