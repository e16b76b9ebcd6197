"""Where the time goes in the imported-mesh scale runs of ``chip_smoke.py``,
on the card.

The three problems of its slices G1b and G2, built as it builds them:

* ``quad``: S1-U on the perturbed quad mesh at n=800 (640,000 quads),
  ``amg_preconditioner()`` and BiCGStab to 1e-10;
* ``tet``: main3's S1 on ``UMesh3.box`` at n=64 (1,572,864 tets),
  ``amg_preconditioner()`` and flexible GMRES to 1e-10;
* ``s5``: ``InterfaceElasticityU`` at n=120 (204,974 DoF), Jacobi and
  rigid-mode deflated BiCGStab to 1e-8.

For each: the set-up parts, one solve to its tolerance (wall, iterations,
ms per iteration), then a device trace of the same solve capped at
``--steps`` iterations (its set-up included): kernels per iteration, the
AMG kernel's device time, and the card's busy share of the unprofiled wall.

    python3 scripts/profile_torch_u_scale.py [--cases quad,tet,s5] [--steps 4]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch

import chip_smoke as c
import phifem_tpu_torch as pt
from phifem_tpu_torch.ops import cuda_amg


def build(case: str):
    """(label, scheme, solve keyword arguments, set-up parts in s)."""
    parts = {}
    if case == "quad":
        mesh, parts["mesh"] = c._sync_time(c._u_mesh, pt, c.N_AMG_LARGE, "cuda", amp=c.QUAD_AMP, quad=True)
        (s, _, _), parts["setup"] = c._sync_time(c._u_scheme, pt, "s1", mesh, 0.49)
        kw = dict(method="bicgstab", tol=c.SCHEME_TOL, maxiter=500)
    elif case == "tet":
        mesh, parts["mesh"] = c._sync_time(pt.UMesh3.box, *(c.N_TET_LARGE,) * 3, c.TET_BOX, device="cuda")
        (s, _, _), parts["setup"] = c._sync_time(c._tet_scheme, pt, "s1", mesh)
        kw = dict(method="fgmres", tol=c.SCHEME_TOL, maxiter=500)
    else:
        s, parts["setup"] = c._sync_time(c._s5u, pt, c.N_S5U_LARGE, "cuda")
        kw = dict(method="bicgstab", tol=1e-8, maxiter=5000)
    _, parts["assemble"] = c._sync_time(s.assemble)
    if case != "s5":
        kw["precond"], parts["amg_preconditioner"] = c._sync_time(s.amg_preconditioner)
    return f"{case} n={c.N_TET_LARGE if case == 'tet' else c.N_S5U_LARGE if case == 's5' else c.N_AMG_LARGE}", \
        s, kw, parts


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", default="quad,tet,s5")
    ap.add_argument("--steps", type=int, default=4)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    c.phase_device()
    c.phase_build(cuda_amg)
    for case in a.cases.split(","):
        label, s, kw, parts = build(case)
        r, wall = c._sync_time(s.solve, **kw)
        print(f"[{label}] set-up " + ", ".join(f"{k} {v:.3f} s" for k, v in parts.items())
              + f"; {kw['method']} {wall:.3f} s, {r.iterations} it ({1e3 * wall / max(r.iterations, 1):.2f} ms per "
              f"iteration), relres {r.residual:.3e}", flush=True)
        capped = dict(kw, tol=0.0, maxiter=a.steps)
        r, wall = c._sync_time(s.solve, **capped)
        t0 = time.perf_counter()
        kernels = c._device_kernels(lambda: s.solve(**capped), 1)
        c._trace_report(label, kernels, wall, r.iterations, kw["method"], c.KERNELS_G1A, top=8)
        print(f"[time] {label}: traced in {time.perf_counter() - t0:.1f} s", flush=True)
        del s, kw
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
