"""The port's demo CLIs at the sizes ``chip_smoke.py`` leaves out, on the card.

    python3 scripts/run_torch_demos.py [--runs param_quick,param1,elasticity32] [--out DIR]

* ``param_quick``: the S5 demo's two-level study (n = 12, 24) with its
  default preconditioner (``chip_smoke.py`` runs it by Jacobi): the coupled
  hierarchy cannot halve n=24 below its ``min_n`` of 16, so its coarse
  solve is a host pseudo-inverse of the whole system (8,750 DoFs);
* ``param1``: ``python -m phifem_tpu_torch.demo.interface_elasticity param1``,
  the S5 convergence study of the reference's ``param1.yaml`` (5 levels,
  n = 15 to 240, the default coupled lattice preconditioner and deflated
  BiCGStab; every level from n=30 on has the n=30 system, 13,454 DoFs, as
  its coarsest, inverted on the host);
* ``elasticity32``: ``python -m phifem_tpu_torch.demo.poisson3d elasticity``
  at its defaults (n = 32, tol 1e-10, maxiter 20,000; fgmres, rigid modes
  deflated).

On an H100 ``param_quick`` takes ~150 s and ``param1`` ~28 min, nearly all
of it host pseudo-inverses; ``elasticity32`` ran 30 minutes without
finishing.  Give the call a time limit to match.

Each runs in this process through its ``main()`` with ``--device cuda``;
the script prints the demo's own lines, then one summary line per run: wall
time, the demo's phases, counts, errors and the launches of each of the
port's kernels on the run.  No card: it exits 2.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

RUNS = {
    "param_quick": ("interface_elasticity", ["param_quick"]),
    "param1": ("interface_elasticity", ["param1"]),
    "elasticity32": ("poisson3d", ["elasticity"]),
}


def _counters():
    from phifem_tpu_torch.ops import cuda_amg, cuda_hex3, cuda_lattice3, cuda_stencil, cuda_taps

    return {
        "stencil": (cuda_stencil, "launches"), "masked": (cuda_stencil, "masked_launches"),
        "taps": (cuda_taps, "launches"), "hex3": (cuda_hex3, "launches"), "lattice3": (cuda_lattice3, "launches"),
        "hex3_block": (cuda_hex3, "block_launches"), "lattice3_block": (cuda_lattice3, "block_launches"),
        "amg": (cuda_amg, "launches"),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", default=",".join(RUNS), help="comma-separated: " + ", ".join(RUNS))
    ap.add_argument("--out", default=None, help="output directory of the demos (default: a temporary one)")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("run_torch_demos: no CUDA device", file=sys.stderr)
        return 2
    import importlib

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi name, power.limit: {smi}")
    out_root = a.out or tempfile.mkdtemp(prefix="phifem_demos_")
    counters = _counters()
    for name in a.runs.split(","):
        module, argv = RUNS[name]
        mod = importlib.import_module(f"phifem_tpu_torch.demo.{module}")
        for m, attr in counters.values():
            setattr(m, attr, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = mod.main(argv + ["--device", "cuda", "--out", os.path.join(out_root, name)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: getattr(m, attr) for k, (m, attr) in counters.items()}
        print(f"[{name}] {wall:.1f} s; phases {', '.join(f'{k} {v:.3f}' for k, v in r['phases'].items())}; "
              f"iterations {r['iterations']}; converged {r['converged']}; errors {r['errors']}; "
              f"launches {launches}; wrote {len(r['paths'])} files", flush=True)
        if not r["converged"]:
            raise AssertionError(f"{name}: not converged")
        del r
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
