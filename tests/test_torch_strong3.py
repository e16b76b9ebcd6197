"""Port parity of S2 in 3D (``phifem_tpu.models.strong_dirichlet3``): the
sphere R0 = 0.7 in [-1, 1]^3, u = phi w with w = cos(x + y/2 - z/4), as in
``tests/test_strong_dirichlet3.py``.

Tolerances: the four batched term families, b, diag and one matvec 1e-12
relative to their max; the Jacobi-equilibrated BiCGStab to 1e-10 within
max(3, 0.25 it) of JAX's count (JAX: 25 / 44 at n=8 / 16; the port's dots are
float64, JAX's float32) and w to 1e-7."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import phifem_tpu as pf  # noqa: E402
from phifem_tpu.models.strong_dirichlet3 import StrongDirichletPoisson3 as JStrong3  # noqa: E402
import phifem_tpu_torch as pt  # noqa: E402
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

R0 = 0.7
BOX = ((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0))


def phi(x):
    return x[..., 0] ** 2 + x[..., 1] ** 2 + x[..., 2] ** 2 - R0**2


def f_j(x):
    w = lambda q: jnp.cos(q[..., 0] + 0.5 * q[..., 1] - 0.25 * q[..., 2])
    H = jax.vmap(jax.hessian(lambda q: (phi(q[None]) * w(q[None]))[0]))(x.reshape(-1, 3))
    return -jnp.trace(H, axis1=-2, axis2=-1).reshape(x.shape[:-1])


def f_t(x):
    from torch.func import hessian, vmap

    w = lambda q: torch.cos(q[..., 0] + 0.5 * q[..., 1] - 0.25 * q[..., 2])
    H = vmap(hessian(lambda q: (phi(q[None]) * w(q[None]))[0]))(x.reshape(-1, 3))
    return -torch.diagonal(H, dim1=-2, dim2=-1).sum(-1).reshape(x.shape[:-1])


def u_exact_t(x):
    return phi(x) * torch.cos(x[..., 0] + 0.5 * x[..., 1] - 0.25 * x[..., 2])


def _np(a):
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _rel(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.fixture(scope="module", params=[8, 16])
def pair(request):
    n = request.param
    sj = JStrong3(pf.Grid3(n, n, n, BOX)).setup(phi, f_j).assemble()
    st = pt.StrongDirichletPoisson3(pt.Grid3(n, n, n, BOX, device="cpu")).setup(phi, f_t).assemble()
    return n, sj, st


def test_assembly_matches_jax(pair):
    _, sj, st = pair
    assert np.array_equal(st.tags.cell_tags, sj.tags.cell_tags)
    for dofs, name in (("bulk_dofs", "E_bulk"), ("cut_dofs", "E_stab")):
        assert np.array_equal(_np(getattr(st, dofs)), _np(getattr(sj, dofs)))
        assert _rel(getattr(st, name), getattr(sj, name)) <= 1e-12, name
    for fam in ("ghost", "bdry"):
        assert len(getattr(st, fam)) == len(getattr(sj, fam))
        for (dt_, Et), (dj, Ej) in zip(getattr(st, fam), getattr(sj, fam)):
            assert np.array_equal(_np(dt_), _np(dj))
            assert _rel(Et, Ej) <= 1e-12, fam
    assert _rel(st.b["w"], sj.b["w"]) <= 1e-12
    assert _rel(st.diag["w"], sj.diag["w"]) <= 1e-12
    assert np.array_equal(_np(st.active["w"]), _np(sj.active["w"]))


def test_matvec_matches_jax(pair):
    n, sj, st = pair
    x = np.random.default_rng(n).standard_normal(st.b["w"].numel())
    assert _rel(st.matvec({"w": torch.as_tensor(x)})["w"], sj.matvec({"w": jnp.asarray(x)})["w"]) <= 1e-12


def test_solve_matches_jax(pair):
    n, sj, st = pair
    rj, rt = sj.solve(tol=1e-10), st.solve(tol=1e-10)
    assert rt.converged and rt.residual <= 1e-9
    assert abs(rt.iterations - rj.iterations) <= max(3, 0.25 * rj.iterations), (rt.iterations, rj.iterations)
    assert _rel(rt.x["w"], rj.x["w"]) <= 1e-7
    # u_h = phi w vanishes where phi does, and approximates u inside
    assert _rel(st.u_lat, sj.u_lat) <= 1e-7
    e = st.l2_h1_errors(u_exact_t)
    assert e["l2"] < (0.2 if n == 8 else 0.05), e
