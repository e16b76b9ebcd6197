"""S5-3D (two-material interface elasticity on the hex lattice) at one size on one card.

    python3 scripts/profile_torch_s53d.py [--n 32]

The problem of ``chip_smoke.py``'s s53d phase (the sphere r = 1 in
[-1.5, 1.5]^3, contrast E_in / E_out = 1000; ``--n 32`` is level 2 of
``docs/s53d_convergence.md``, 970,299 DoFs, which the JAX package never
finished), solved as there: flexible GMRES to 1e-8 with the rigid modes
deflated and ``lattice_preconditioner()``.  Prints the card's name and power
limit, the set-up parts (tag, assemble, preconditioner), the solve's wall,
iterations, relative residual and L2 / H10 errors, peak device memory, the
launches of the 3D kernels, and a device-only trace of two steps of the same
flexible GMRES (kernels per step, busy share, top kernels).
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=32)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_s53d: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as C
    import phifem_tpu_torch as pt
    from phifem_tpu_torch.ops import cuda_hex3, cuda_lattice3

    torch.backends.cuda.matmul.allow_tf32 = False
    C.phase_device()
    C.phase_build(cuda_hex3, cuda_lattice3)
    n = args.n
    label = f"s53d n={n}"
    C._reset3()
    torch.cuda.reset_peak_memory_stats()
    (s, exact), t_tag = C._sync_time(C._s53d, pt, n, C.DEVICE)
    _, t_asm = C._sync_time(s.assemble)
    M, t_pre = C._sync_time(s.lattice_preconditioner)
    modes = s.rigid_modes()
    r, t_solve = C._sync_time(s.solve, method="fgmres", tol=C.S53D_TOL, maxiter=2000, precond=M, deflate=modes)
    e = s.l2_h1_errors(exact)
    nd = sum(v.numel() for v in s.b.values())
    print(f"[{label}] ndofs={nd} ({sum(int(v.sum()) for v in s.active.values())} active, "
          f"{s.tags.num_cut_cells} cut cells): tag {t_tag:.3f} s, assemble {t_asm:.3f} s, "
          f"lattice_preconditioner() {t_pre:.3f} s (interface m={M.iface.m}, coarse basis k={s._coarse_Z.shape[0]}); "
          f"fgmres tol {C.S53D_TOL:.0e}: {t_solve:.3f} s, {r.iterations} it, relres {r.residual:.3e}, converged "
          f"{r.converged}; relative L2 {e['l2']:.4e}, H10 {e['h10']:.4e}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {C._counts3()}")
    t0 = time.perf_counter()
    C._profile_steps3(s, M, label, deflate=modes)
    print(f"[{label}] trace read back in {time.perf_counter() - t0:.1f} s")
    return 0 if r.converged else 1


if __name__ == "__main__":
    sys.exit(main())
