"""Where the time goes in the PyTorch port's S1 flower pipeline on one card.

    python3 scripts/profile_torch_s1.py

The S1 weak-Dirichlet flower of ``chip_smoke.py`` phase 7 at n=3200
(20,492,802 DoFs).  Prints, on stdout: the set-up phases timed apart (the
one-off cost of the first ``torch.func`` call measured alone first; the
preconditioner split into its bulk lattice cycle and the host-built
interface tables), then the warm wall times of 3 BiCGStab solves and a
``torch.profiler`` trace of one more: kernels launched in all and per outer
iteration, device time summed over kernels against the warm median wall,
the stencil and tap kernels' shares, the peak device memory, and the kernels that take the most device
time.  Needs a CUDA device.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

N = 3200
REPS = 3
TOP = 14
BOX = ((-4.5, -4.5), (4.5, 4.5))


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_s1: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import phifem_tpu_torch as pt
    from phifem_tpu_torch.mg import attach_interface_solve
    from phifem_tpu_torch.models import flower
    from phifem_tpu_torch.solvers import masked_operator

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[device] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    torch.func.grad(lambda a: (a * a).sum())(torch.ones(2, dtype=torch.float64))
    print(f"[setup] first torch.func call (one-off imports): {time.perf_counter() - t0:.3f} s")
    g = pt.Grid(N, N, BOX, pt.CellType.triangle, device="cuda")
    s = pt.WeakDirichletPoisson(g, mode="bg", detection_degree=1, single_layer_cut=True)
    _, t_tag = _timed(lambda: s.setup(flower.levelset, flower.source_term,
                                      detection_levelset=flower.detection_levelset))
    _, t_asm = _timed(s.assemble)
    s.op.reassemble()
    _, t_reasm = _timed(s.op.reassemble)
    bulk, t_bulk = _timed(lambda: s.lattice_preconditioner(min_n=13, interface=False))
    active = masked_operator(s.op)[2]
    vc, t_band = _timed(lambda: attach_interface_solve(bulk, s.op, active))
    sizes = [b.num_entities for b in s.op.batches[1:]]
    print(f"[setup] n={N} ndofs={s.system.num_dofs}: tag {t_tag:.3f} s, assemble {t_asm:.3f} s "
          f"(cut cells, ghost facets, Gamma_h facets: {sizes}), warm reassemble {t_reasm:.4f} s, "
          f"preconditioner: bulk lattice cycle {t_bulk:.3f} s + interface tables {t_band:.3f} s "
          f"(m={vc.band_ids.numel()}, {vc.schwarz_ids.shape[0]} blocks, "
          f"{vc.schwarz_sweeps} sweeps)")

    def run():
        return s.solve(method="bicgstab", tol=1e-8, maxiter=200, precond=vc)

    run()
    res, walls = None, []
    for _ in range(REPS):
        res, t = _timed(run)
        walls.append(t)
    # device activity only: ~600,000 kernels per solve, and host events on
    # top make the trace's post-processing take minutes
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, t_prof = _timed(run)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_ms = lambda e: e.self_device_time_total / 1e3
    busy = sum(dev_ms(e) for e in kernels)
    count = sum(e.count for e in kernels)
    stencil = sum(dev_ms(e) for e in kernels if "stencil_matvec_kernel" in e.key)
    taps = sum(dev_ms(e) for e in kernels if "tap_matvec_kernel" in e.key)
    med = float(np.median(walls))
    print(f"== S1 n={N} bicgstab: {res.iterations} it, recurrence relres {res.recurrence:.3e}; "
          f"warm walls [{', '.join(f'{t:.4f}' for t in walls)}] s, median {med:.4f} s; profiled "
          f"run: wall {t_prof:.4f} s, {count} kernels ({count / max(res.iterations, 1):.0f} per "
          f"iteration), device busy {busy:.3f} ms = {busy / 1e3 / med:.1%} of the warm median, "
          f"stencil kernel {stencil:.3f} ms, tap kernel {taps:.3f} ms; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for e in sorted(kernels, key=dev_ms, reverse=True)[:TOP]:
        print(f"   {e.key[:70]:70s} n={e.count:7d} dev={dev_ms(e):9.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
