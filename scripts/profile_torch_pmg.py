"""Where the time goes in the PyTorch port's degree >= 2 S1 solve on one card.

    python3 scripts/profile_torch_pmg.py [--degree 2] [--n 800]

The S1 weak-Dirichlet flower of ``chip_smoke.py``'s slice E phases (bg
mode, detection degree 1, single-layer cut, level set of the primal
degree) at ``--n``, solved by ``p_multigrid_preconditioner()`` + flexible
GMRES to 1e-8.  Prints, on stdout: the set-up parts (the cycle's
``setup_seconds``: the P1 twin's build, its lattice preconditioner, the
transfers, the high-degree band's interface tables), the walls of a cold
and a warm solve, the per-call times of the parts of one fgmres iteration,
then a device-only ``torch.profiler`` trace of one more whole solve:
kernels in all and per fgmres iteration, device time summed over kernels
against the warm wall, the stencil and tap kernels' shares, peak device
memory, and the kernels that take the most device time.  A P2 solve at
n=800 launches over a million kernels; reading the trace back takes
minutes (printed).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

TOP = 16


def breakdown(C, s, vc, label: str) -> None:
    """Per-call times (CUDA events, calls back to back) of the parts of one
    fgmres iteration with p-MG: the high-degree operator's matvec (the
    generic entity-batch path; 7 an iteration: 2 + 2 smoothing sweeps, the
    cycle's residual, the band residual, the Arnoldi step's), the p
    transfers (one P and one P^T per field), the P1 twin's inner solve,
    the high-degree band solve, the two Gram-Schmidt passes at j = 10."""
    from phifem_tpu_torch.pmg import _apply_P, _apply_PT

    gen = torch.Generator(device="cuda").manual_seed(C.SEED)
    lvl = vc.levels[0]
    r = {k: torch.randn(v.shape, dtype=v.dtype, device="cuda", generator=gen) for k, v in s.b.items()}
    rc = {f: _apply_PT(vc.transfers[f], r[f]) for f in r}
    rf = vc._flatten(r)
    V = torch.randn((11, rf.numel()), dtype=rf.dtype, device="cuda", generator=gen)

    def gram_schmidt():
        w = rf
        for _ in range(2):
            w = w - V.T @ (V @ w)
        return torch.linalg.vector_norm(w)

    nf, ms = len(r), C._event_ms
    parts = {
        "operator matvec (entity batches)": (7, ms(lambda: lvl.matvec(r), 5)),
        "P^T restriction": (nf, ms(lambda: _apply_PT(vc.transfers["u"], r["u"]), 5)),
        "P prolongation": (nf, ms(lambda: _apply_P(vc.transfers["u"], rc["u"]), 5)),
        "twin inner solve (low_apply)": (1, ms(lambda: vc.low_apply(rc), 3)),
        "high-degree band solve": (1, ms(lambda: vc._band_correct_flat(vc._flatten(r), rf), 3)),
        "Gram-Schmidt, 2 passes at j=10": (1, ms(gram_schmidt, 5)),
    }
    whole = ms(lambda: lvl.matvec(vc(r)), 3)
    timed = sum(c * t for k, (c, t) in parts.items() if not k.startswith("Gram"))
    print(f"[{label} breakdown] one p-MG application + one matvec {whole:.2f} ms, of which the parts timed "
          f"alone {timed:.2f} ms; per fgmres iteration: "
          + "; ".join(f"{k} {c} x {t:.3f} ms = {c * t:.2f} ms" for k, (c, t) in
                      sorted(parts.items(), key=lambda kv: -kv[1][0] * kv[1][1])))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--degree", type=int, default=2)
    ap.add_argument("--n", type=int, default=800)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_pmg: no CUDA device", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    import chip_smoke as C
    import phifem_tpu_torch as pt
    from phifem_tpu_torch.ops import cuda_stencil as cs
    from phifem_tpu_torch.ops import cuda_taps as ct

    torch.backends.cuda.matmul.allow_tf32 = False
    C.phase_device()
    C.phase_build(cs, ct)
    label = f"s1 P{args.degree} n={args.n}"
    s, t_tag = C._sync_time(C._flower_s1, pt, args.n, "cuda", args.degree)
    _, t_asm = C._sync_time(s.assemble)
    vc, t_pre = C._sync_time(s.p_multigrid_preconditioner)
    print(f"[setup] {label} ndofs={s.system.num_dofs}: tag {t_tag:.3f} s, assemble {t_asm:.3f} s, "
          f"p_multigrid_preconditioner() {t_pre:.3f} s ("
          + ", ".join(f"{k} {v:.3f} s" for k, v in vc.setup_seconds.items()) + f"; {C._band(vc)})")

    def run():
        return s.solve(method="fgmres", tol=C.S1_TOL, maxiter=400, precond=vc)

    r0, t_cold = C._sync_time(run)
    r, t_warm = C._sync_time(run)
    print(f"[solve] {label} fgmres: cold {t_cold:.3f} s ({r0.iterations} it), warm {t_warm:.3f} s "
          f"({r.iterations} it), recurrence relres {r.recurrence:.3e}, true relres {r.residual:.3e}")
    breakdown(C, s, vc, label)
    # device activity only: host events on top of ~1M kernels make the
    # trace unreadable in any time
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        rp, t_prof = C._sync_time(run)
        t_stop = time.perf_counter()
    kernels = {e.key: (e.count, e.self_device_time_total / 1e3)
               for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
    print(f"== {label} profiled solve: {rp.iterations} it, wall {t_prof:.3f} s under the profiler, trace "
          f"read back in {time.perf_counter() - t_stop:.1f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    C._trace_report(label, kernels, t_warm, rp.iterations, top=TOP)
    return 0


if __name__ == "__main__":
    sys.exit(main())
