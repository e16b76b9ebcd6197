"""The JAX package's counts and errors on the CPU for the imported-mesh
problems that ``chip_smoke.py`` holds the port to.

Modes (``--mode``):

* ``amg`` (default): S1-U with ``amg_preconditioner()``, BiCGStab to 1e-10.
  ``--cell tri`` is ``tests/test_amg.py``'s problem (the perturbed triangle
  mesh of [-1, 1]^2, amplitude 0.25 h, seed 0, the circle R = 0.7,
  u = cos x sin y); ``--cell quad`` the same on ``tests/test_usolve.py``'s
  perturbed quad mesh (amplitude 0.2 h); ``--cell tet`` is
  ``demo/unstructured/main.py``'s ``main3`` problem (``UMesh3.box`` of
  [-1, 1]^3, the sphere r = 0.61, level-set degree 2).
* ``jacobi``: ``--scheme s1|s2|s3|s4`` by Jacobi-equilibrated BiCGStab to
  1e-10 (maxiter 5000), as ``demo/unstructured/main.py`` runs it (``--cell
  tet``: ``main3``; ``--cell quad``: the quad mesh above with the circle
  R = 0.7); prints the count and the relative L2 / H10 errors.
* ``pmg``: S1-U at degree 2 (P2 primal and level set) on the triangle mesh
  of ``amg`` with ``p_multigrid_preconditioner()``, flexible GMRES to 1e-10
  (maxiter 200), ``tests/test_torch_upmg.py``'s problem at the scale of
  ``chip_smoke.py``'s p-MG phase.
* ``s5``: ``InterfaceElasticityU`` on ``tests/test_usolve.py``'s perturbed
  triangle mesh (amplitude 0.25 h, E_in / E_out 1.0 / 0.1, ``u_vec`` /
  ``f_vec``), rigid-mode deflated BiCGStab to ``--tol`` (default 1e-9) in
  at most ``--maxiter`` (default 400) iterations, with ``--precond jacobi``
  (the default) or ``amg``.

``--amg-dtype float64`` runs ``amg_preconditioner(dtype=jnp.float64)``: the
cycle, and with it the cut-band solve, in float64 (the port keeps the band
tables in float64 whatever the cycle's dtype: ROADMAP, "Deliberate
deviations").

    JAX_PLATFORMS=cpu python scripts/reference_amg_counts.py 40 80 160
    JAX_PLATFORMS=cpu python scripts/reference_amg_counts.py --cell quad 40 80 160
    JAX_PLATFORMS=cpu python scripts/reference_amg_counts.py --cell tet 8 12 16
    JAX_PLATFORMS=cpu python scripts/reference_amg_counts.py --cell tet --amg-dtype float64 8 12 16
    JAX_PLATFORMS=cpu python scripts/reference_amg_counts.py --cell tet --mode jacobi --scheme s3 12
    JAX_PLATFORMS=cpu python scripts/reference_amg_counts.py --mode s5 10
    JAX_PLATFORMS=cpu python scripts/reference_amg_counts.py --mode pmg 40
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

import phifem_tpu as pf
from phifem_tpu.models.unstructured import (
    InterfaceElasticityU,
    NeumannPoissonU,
    RobinPoissonU,
    StrongDirichletPoissonU,
    WeakDirichletPoissonU,
)
from phifem_tpu.umesh import UMesh

BOX = ((-1.0, -1.0), (1.0, 1.0))
R = 0.7
R3 = 0.61


def perturbed_mesh(n, amp=0.25, seed=0, quad=False):
    ct = pf.CellType.quadrilateral if quad else pf.CellType.triangle
    um, _ = UMesh.from_grid(pf.Grid(n, n, BOX, ct))
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


def u2(x):
    return jnp.cos(x[..., 0]) * jnp.sin(x[..., 1])


def u3(x):
    return jnp.cos(x[..., 0]) * jnp.sin(x[..., 1]) * jnp.cos(x[..., 2])


def scheme2(name, mesh, r2):
    """demo/unstructured/main.py's 2D scheme ``name`` on ``mesh``, set up."""
    ls = lambda x: x[..., 0] ** 2 + x[..., 1] ** 2 - r2

    def nderiv(x):
        g = jax.vmap(jax.grad(lambda p: u2(p)))(x)
        gp = 2.0 * x
        return jnp.sum(g * gp, axis=-1) / jnp.maximum(jnp.linalg.norm(gp, axis=-1), 1e-12)

    if name == "s1":
        return WeakDirichletPoissonU(mesh, mode="bg").setup(ls, lambda x: 2.0 * u2(x), u_D=u2), u2, (1, 2)
    if name == "s2":
        uex = lambda x: jnp.sin(x[..., 0] ** 2 + x[..., 1] ** 2 - r2)

        def f2(x):
            q = x[..., 0] ** 2 + x[..., 1] ** 2
            return 4.0 * q * jnp.sin(q - r2) - 4.0 * jnp.cos(q - r2)

        return StrongDirichletPoissonU(mesh, mode="bg").setup(ls, f2), uex, (1, 2)
    if name == "s3":
        return NeumannPoissonU(mesh, mode="bg").setup(ls, lambda x: 3.0 * u2(x), nderiv), u2, (1,)
    s = RobinPoissonU(mesh, mode="bg", robin_coef=1.0).setup(ls, lambda x: 3.0 * u2(x), lambda x: nderiv(x) + u2(x))
    return s, u2, (1,)


def scheme3(name, n):
    """demo/unstructured/main.py's main3 scheme ``name`` at box size n."""
    mesh = pf.UMesh3.box(n, n, n, ((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0)))
    r2 = R3**2
    ls = lambda x: (x**2).sum(-1) - r2
    fex = lambda x: 3.0 * u3(x)

    def nderiv(x):
        g = jax.vmap(jax.grad(lambda p: u3(p)))(x)
        nrm = x / jnp.maximum(jnp.linalg.norm(x, axis=-1, keepdims=True), 1e-12)
        return jnp.sum(g * nrm, axis=-1)

    if name == "s1":
        return WeakDirichletPoissonU(mesh, mode="bg", levelset_degree=2).setup(ls, fex, u_D=u3), u3, (1, 2)
    if name == "s2":
        uex = lambda x: jnp.sin((x**2).sum(-1) - r2)

        def f2(x):
            q = (x**2).sum(-1)
            return 4.0 * q * jnp.sin(q - r2) - 6.0 * jnp.cos(q - r2)

        return StrongDirichletPoissonU(mesh, mode="bg", levelset_degree=2).setup(ls, f2), uex, (1, 2)
    if name == "s3":
        return NeumannPoissonU(mesh, mode="bg", levelset_degree=2).setup(ls, lambda x: fex(x) + u3(x), nderiv), \
            u3, (1,)
    s = RobinPoissonU(mesh, mode="bg", levelset_degree=2, robin_coef=1.0)
    return s.setup(ls, lambda x: fex(x) + u3(x), lambda x: nderiv(x) + u3(x)), u3, (1,)


def u_vec(x):
    return jnp.stack([jnp.sin(x[..., 0]) * jnp.cos(x[..., 1]), x[..., 0] * x[..., 1]], axis=-1)


def f_vec(x):
    return jnp.stack([jnp.cos(x[..., 0]) + x[..., 1], jnp.sin(x[..., 1]) - x[..., 0]], axis=-1)


def u_vec_grad(x):
    """The Jacobian of ``u_vec``, rows the components."""
    sx, cx, sy, cy = jnp.sin(x[..., 0]), jnp.cos(x[..., 0]), jnp.sin(x[..., 1]), jnp.cos(x[..., 1])
    return jnp.stack([jnp.stack([cx * cy, -sx * sy], -1), jnp.stack([x[..., 1], x[..., 0]], -1)], -2)


def s5(n, tol, maxiter, precond, amg_kw):
    s = InterfaceElasticityU(perturbed_mesh(n), mode="bg", E_in=1.0, E_out=0.1)
    s.setup(lambda x: x[..., 0] ** 2 + x[..., 1] ** 2 - R**2, f_vec, u_vec)
    s.assemble()
    kw = {} if precond == "jacobi" else {"precond": s.amg_preconditioner(**amg_kw)}
    r = s.solve(method="bicgstab", tol=tol, maxiter=maxiter, **kw)
    e = s.l2_h1_errors(s.u_h, u_vec, exact_grad=u_vec_grad, region=(1, 2, 3))
    return r, e


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("n", type=int, nargs="*")
    p.add_argument("--cell", choices=["tri", "quad", "tet"], default="tri")
    p.add_argument("--mode", choices=["amg", "jacobi", "s5", "pmg"], default="amg")
    p.add_argument("--scheme", choices=["s1", "s2", "s3", "s4"], default="s1")
    p.add_argument("--tol", type=float, default=1e-9)
    p.add_argument("--maxiter", type=int, default=400)
    p.add_argument("--precond", choices=["jacobi", "amg"], default="jacobi")
    p.add_argument("--amg-dtype", choices=["float32", "float64"], default="float32")
    a = p.parse_args()
    amg_kw = {"dtype": getattr(jnp, a.amg_dtype)}
    for n in a.n or [40, 80]:
        t0 = time.perf_counter()
        if a.mode == "s5":
            r, e = s5(n, a.tol, a.maxiter, a.precond, amg_kw)
            label = f"s5 {a.precond}"
        elif a.mode == "pmg":
            s = WeakDirichletPoissonU(perturbed_mesh(n), mode="bg", primal_degree=2, levelset_degree=2)
            s.setup(lambda x: x[..., 0] ** 2 + x[..., 1] ** 2 - R**2, lambda x: 2.0 * u2(x), u_D=u2)
            s.assemble()
            r = s.solve(method="fgmres", tol=1e-10, maxiter=200, precond=s.p_multigrid_preconditioner())
            e = s.l2_h1_errors(s.u_h, u2, region=(1, 2))
            label = "tri pmg s1 P2"
        else:
            if a.cell == "tet":
                s, uex, region = scheme3(a.scheme if a.mode == "jacobi" else "s1", n)
            else:
                mesh = perturbed_mesh(n, amp=0.2 if a.cell == "quad" else 0.25, quad=a.cell == "quad")
                s, uex, region = scheme2(a.scheme if a.mode == "jacobi" else "s1", mesh, R**2)
            s.assemble()
            if a.mode == "amg":
                r = s.solve(method="bicgstab", tol=1e-10, maxiter=500, precond=s.amg_preconditioner(**amg_kw))
            else:
                r = s.solve(method="bicgstab", tol=1e-10, maxiter=5000)
            e = s.l2_h1_errors(s.u_h, uex, region=region)
            label = f"{a.cell} {a.mode} {a.scheme if a.mode == 'jacobi' else 's1'}"
        label += f" amg {a.amg_dtype}" if a.mode == "amg" or a.precond == "amg" else ""
        print(f"{label} n={n} it={r.iterations} relres={r.residual:.3e} converged={r.converged} "
              f"l2={e['l2']:.6e} h10={e['h10']:.6e} ({time.perf_counter() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    main()
