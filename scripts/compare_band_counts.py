"""Outer iteration counts of the port's Schwarz-band paths on the card: the
band solve's kernels against its former plain PyTorch forms, at the default
inner sweep count and with the inner solve run much further.

    python3 scripts/compare_band_counts.py [--paths q2_16,q2_32,neumann_16,s53d_24] [--factors q2_16=4,...]

The band kernels (``ops.cuda_band``) sum in another order than the former
plain forms (``einsum`` over every block entry, ``.sum`` over the ELL rows,
``torch.dot``; kept in ``tests/test_torch_band.py``: ``old_ops``,
``old_bicgstab``), which the script puts back in place of
``cuda_band.band_bicgstab``.  Everything else on the path is the same code on
the same card.  At the default sweep count the inner BiCGStab stops far
from convergence, the preconditioner is nonlinear in its input and the outer
count follows rounding; with ``factor`` times the sweeps the preconditioner
is close to a fixed operator and the two counts should agree.  The paths are
``chip_smoke.py``'s, built as it builds them: the weak-Dirichlet sphere at
Q2 n=16 / 32 (BiCGStab to 1e-10), 3D Neumann n=16 (BiCGStab to 1e-10),
S5-3D n=24 (rigid-mode deflated fgmres to 1e-8).  Prints one line per path,
form and sweep count: the inner sweeps, the outer count, the relative
residual and the wall.  Needs a CUDA device (about 15 minutes with the
defaults, most of it S5-3D).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import chip_smoke as c  # noqa: E402
import phifem_tpu_torch as pt  # noqa: E402
from phifem_tpu_torch.ops import cuda_band  # noqa: E402
from test_torch_band import old_bicgstab, old_ops  # noqa: E402

DEVICE = "cuda"
PATHS = ("q2_16", "q2_32", "neumann_16", "s53d_24")
FACTORS = {"q2_16": 4, "q2_32": 4, "neumann_16": 7, "s53d_24": 2}


def _former(tab, rb, sweeps):
    mv, ras = old_ops(tab)
    return old_bicgstab(mv, ras, rb, sweeps)


def _path(name: str):
    """``(build, solve, band)`` of path ``name``: the preconditioner with
    ``sweeps`` inner sweeps (None: the default), the solve with it, and the
    band a preconditioner holds."""
    kind, n = name.rsplit("_", 1)
    n = int(n)
    if kind == "q2":
        s = c._weak3(pt, n, 2, DEVICE).assemble()
        return (lambda sw: s.lattice_preconditioner(sweeps=sw),
                lambda M: s.solve(tol=c.TOL, maxiter=2000, precond=M), lambda M: s._band)
    if kind == "neumann":
        s = c._neumann3(pt, n, DEVICE).assemble()
        return (lambda sw: s.lattice_preconditioner(sweeps=sw),
                lambda M: s.solve(tol=c.TOL, maxiter=2000, precond=M), lambda M: M.iface.band)
    s, _ = c._s53d(pt, n, DEVICE)
    s.assemble()
    modes = s.rigid_modes()
    return (lambda sw: s.lattice_preconditioner(sweeps=sw),
            lambda M: s.solve(method="fgmres", tol=c.S53D_TOL, maxiter=2000, precond=M, deflate=modes),
            lambda M: M.iface.band)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--paths", default=",".join(PATHS))
    ap.add_argument("--factors", default="", help="name=factor,... over the defaults " + str(FACTORS))
    args = ap.parse_args()
    factors = dict(FACTORS, **{k: int(v) for k, v in (kv.split("=") for kv in args.factors.split(",") if kv)})
    if not torch.cuda.is_available():
        print("compare_band_counts: no CUDA device", file=sys.stderr)
        return 2
    c.phase_device()
    kernels = cuda_band.band_bicgstab
    for name in args.paths.split(","):
        build, solve, band = _path(name)
        default = band(build(None)).schwarz_sweeps
        for sweeps in (default, factors[name] * default):
            M = build(sweeps)
            for form, fn in (("kernels", kernels), ("former", _former)):
                cuda_band.band_bicgstab = fn
                try:
                    r, wall = c._sync_time(solve, M)
                finally:
                    cuda_band.band_bicgstab = kernels
                print(f"[{name}] {form:7s} {sweeps:4d} inner sweeps: {r.iterations} it, relres {r.residual:.3e}, "
                      f"converged {bool(r.converged)}, {wall:.2f} s", flush=True)
            del M
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
