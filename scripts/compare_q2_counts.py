"""Q2 iteration counts of the 3D weak-Dirichlet scheme, the JAX package
against the PyTorch port, as the inner band solve's sweeps grow.

    JAX_PLATFORMS=cpu python3 scripts/compare_q2_counts.py [--n 16] [--sweeps 37 150]

The sphere of ``tests/test_weak_dirichlet3.py`` (R0 = 0.7 in [-1, 1]^3,
u = sin x cos y e^{z/2}) at Q2, ``lattice_preconditioner(sweeps=s)`` and
BiCGStab to 1e-10 (maxiter 300), on the CPU in both packages.  The JAX side
runs with its Krylov and band dots made float64 (``solvers.tree_dot32`` and
``mg._band_bicgstab`` replaced), the port's choice, so that the two differ
only in summation order.  At the default sweep count (max(10, 0.3 sqrt(m)),
37 at n=16) the inner solve stops far from convergence and the outer count
follows rounding; with enough sweeps the preconditioner is close to a fixed
linear operator and the counts should agree.  Prints one line per package
and sweep count.  Needs the JAX package (a parity check, like the tests).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

R0 = 0.7
BOX = ((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0))


def phi(x):
    return x[..., 0] ** 2 + x[..., 1] ** 2 + x[..., 2] ** 2 - R0**2


def _band_bicgstab_f64(mv, M, b, iters):
    """``phifem_tpu.mg._band_bicgstab`` with float64 dots."""
    import jax
    import jax.numpy as jnp

    dt = b.dtype
    safe = lambda d: jnp.where(jnp.abs(d) > 1e-300, d, jnp.asarray(1e-300, dt))
    zeros, one = jnp.zeros_like(b), jnp.asarray(1.0, dt)

    def body(i, st):
        x, r, p, v, rho, alpha, omega, xb, rrb = st
        rho_new = jnp.vdot(b, r)
        beta = jnp.where(i == 0, 0.0, (rho_new / safe(rho)) * (alpha / safe(omega)))
        p = r + beta * (p - omega * v)
        ph = M(p)
        v = mv(ph)
        alpha = rho_new / safe(jnp.vdot(b, v))
        s = r - alpha * v
        sh = M(s)
        t = mv(sh)
        omega = jnp.vdot(t, s) / safe(jnp.vdot(t, t))
        x = x + alpha * ph + omega * sh
        r = s - omega * t
        rr = jnp.vdot(r, r)
        better = jnp.logical_and(jnp.isfinite(rr), rr < rrb)
        return x, r, p, v, rho_new, alpha, omega, jnp.where(better, x, xb), jnp.where(better, rr, rrb)

    return jax.lax.fori_loop(0, int(iters), body, (zeros, b, zeros, zeros, one, one, one, zeros, jnp.vdot(b, b)))[7]


def _jax_scheme(n: int):
    import jax.numpy as jnp
    import phifem_tpu as pf
    import phifem_tpu.mg as jmg
    import phifem_tpu.solvers as jsol
    from phifem_tpu.models import WeakDirichletPoisson3

    jmg._band_bicgstab = _band_bicgstab_f64
    jsol.tree_dot32 = jsol.tree_dot
    u = lambda x: jnp.sin(x[..., 0]) * jnp.cos(x[..., 1]) * jnp.exp(0.5 * x[..., 2])
    s = WeakDirichletPoisson3(pf.Grid3(n, n, n, BOX), degree=2)
    return s.setup(phi, lambda x: 1.75 * u(x), u_D=u).assemble()


def _port_scheme(n: int):
    import phifem_tpu_torch as pt

    u = lambda x: torch.sin(x[..., 0]) * torch.cos(x[..., 1]) * torch.exp(0.5 * x[..., 2])
    s = pt.WeakDirichletPoisson3(pt.Grid3(n, n, n, BOX, device="cpu"), degree=2)
    return s.setup(phi, lambda x: 1.75 * u(x), u_D=u).assemble()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--sweeps", type=int, nargs="+", default=[37, 150])
    args = ap.parse_args()
    for name, make in (("jax", _jax_scheme), ("port", _port_scheme)):
        s = make(args.n)
        for sw in args.sweeps:
            t0 = time.perf_counter()
            M = s.lattice_preconditioner(sweeps=sw)
            r = s.solve(method="bicgstab", tol=1e-10, maxiter=300, precond=M)
            print(f"{name} Q2 n={args.n} sweeps {sw}: {r.iterations} it, relres {float(r.residual):.3e}, "
                  f"converged {bool(r.converged)}, {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
