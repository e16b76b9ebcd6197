"""Outer BiCGStab counts of the JAX package's S1-U with ``amg_preconditioner()``.

The problem is ``tests/test_amg.py``'s: the perturbed triangle mesh of
[-1, 1]^2 (amplitude 0.25 h, seed 0), the circle R = 0.7 and
u = cos x sin y, solved to tol 1e-10.  ``chip_smoke.py`` holds the port's
counts to the ones this script prints.

    JAX_PLATFORMS=cpu python scripts/reference_amg_counts.py 40 80 160
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax.numpy as jnp
import numpy as np

import phifem_tpu as pf
from phifem_tpu.models.unstructured import WeakDirichletPoissonU
from phifem_tpu.umesh import UMesh

BOX = ((-1.0, -1.0), (1.0, 1.0))
R = 0.7


def perturbed_mesh(n, amp=0.25, seed=0):
    g = pf.Grid(n, n, BOX, pf.CellType.triangle)
    um, _ = UMesh.from_grid(g)
    verts = um.verts.copy()
    h = 2.0 / n
    rng = np.random.default_rng(seed)
    interior = (
        (np.abs(verts[:, 0] - BOX[0][0]) > 1e-12)
        & (np.abs(verts[:, 0] - BOX[1][0]) > 1e-12)
        & (np.abs(verts[:, 1] - BOX[0][1]) > 1e-12)
        & (np.abs(verts[:, 1] - BOX[1][1]) > 1e-12)
    )
    verts[interior] += amp * h * (rng.random((int(interior.sum()), 2)) - 0.5)
    return UMesh(verts, um.cells)


def main():
    u = lambda x: jnp.cos(x[..., 0]) * jnp.sin(x[..., 1])
    for n in [int(a) for a in sys.argv[1:]] or [40, 80]:
        t0 = time.perf_counter()
        s = WeakDirichletPoissonU(perturbed_mesh(n), mode="bg")
        s.setup(lambda x: x[..., 0] ** 2 + x[..., 1] ** 2 - R**2, lambda x: 2.0 * u(x), u_D=u)
        s.assemble()
        r = s.solve(method="bicgstab", tol=1e-10, maxiter=500, precond=s.amg_preconditioner())
        e = s.l2_h1_errors(pf.uassembly.UFunction(s.V, r.x["u"]), u)
        print(f"n={n} it={r.iterations} relres={r.residual:.3e} converged={r.converged} "
              f"l2={e['l2']:.6e} h10={e['h10']:.6e} ({time.perf_counter() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    main()
