"""Port parity for the whole slice: BoxPoisson at n=32 in both packages —
load vector, the generic CG with a float32 V-cycle, and the lattice solve."""

import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import phifem_tpu as pf  # noqa: E402
from phifem_tpu.models import BoxPoisson as JBoxPoisson  # noqa: E402
import phifem_tpu_torch as pt  # noqa: E402
from phifem_tpu_torch.utils.convert import function_from_numpy  # noqa: E402
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

N = 32


def _uex_j(x):
    return jnp.sin(jnp.pi * x[..., 0]) * jnp.sin(jnp.pi * x[..., 1])


def _uex_t(x):
    return torch.sin(math.pi * x[..., 0]) * torch.sin(math.pi * x[..., 1])


@pytest.fixture(scope="module")
def pair():
    sj = JBoxPoisson(pf.Grid(N, N, ((0.0, 0.0), (1.0, 1.0)), "triangle"))
    sj.setup(lambda x: 2.0 * jnp.pi**2 * _uex_j(x))
    sj.assemble()
    st = pt.BoxPoisson(pt.Grid(N, N, ((0.0, 0.0), (1.0, 1.0)), "triangle", device="cpu"))
    st.setup(lambda x: 2.0 * math.pi**2 * _uex_t(x)).assemble()
    return sj, st


def _close(a, b, rel):
    a, b = np.asarray(a), np.asarray(b)
    assert np.abs(a - b).max() <= rel * np.abs(b).max(), np.abs(a - b).max() / np.abs(b).max()


def test_load_vector(pair):
    sj, st = pair
    _close(st.b["u"].numpy(), sj.b["u"], 1e-12)
    np.testing.assert_array_equal(st.bcs[0].mask.numpy(), np.asarray(sj.bcs[0].mask))


def test_load_vector_of_random_data():
    """f and u_D given as nodal data from one seed, in both packages."""
    rng = np.random.default_rng(11)
    gj, gt = pf.Grid(12, 9, cell_type="quadrilateral"), pt.Grid(12, 9, cell_type="quadrilateral", device="cpu")
    f, uD = rng.standard_normal(gj.num_vertices), rng.standard_normal(gj.num_vertices)
    Vj, Vt = pf.Space.lagrange(gj, 1), pt.Space.lagrange(gt, 1)
    sj = JBoxPoisson(gj)
    sj.setup(pf.Function(Vj, jnp.asarray(f)), pf.Function(Vj, jnp.asarray(uD)))
    sj.assemble()
    st = pt.BoxPoisson(gt).setup(function_from_numpy(Vt, f), function_from_numpy(Vt, uD))
    st.assemble()
    _close(st.b["u"].numpy(), sj.b["u"], 1e-12)
    rt = st.solve_lattice(tol=1e-10, maxiter=40)
    rj = sj.solve_lattice(tol=1e-10, maxiter=40)
    assert rt.converged and abs(rt.iterations - rj.iterations) <= 2
    _close(rt.x["u"].numpy(), rj.x["u"], 1e-8)


def test_generic_cg_f32_vcycle(pair):
    sj, st = pair
    vj = sj.mg_preconditioner(min_n=8, dtype=jnp.float32)
    vt = st.mg_preconditioner(min_n=8, dtype=torch.float32)
    assert len(vt.levels) == len(vj.levels)
    rj = sj.solve(method="cg", tol=1e-10, maxiter=60, precond=vj)
    rt = st.solve(method="cg", tol=1e-10, maxiter=60, precond=vt)
    assert rt.converged and rt.residual <= 1e-10, rt.residual
    assert rt.recurrence <= 1e-10, rt.recurrence  # the loop's own stopping test
    assert abs(rt.iterations - rj.iterations) <= 2, (rt.iterations, rj.iterations)
    _close(rt.x["u"].numpy(), rj.x["u"], 1e-8)
    err = float((st.u_h.data - pt.interpolate(_uex_t, st.V).data).abs().max())
    assert err < 5e-3, err


def test_vcycle_application_f64(pair):
    """One V-cycle application (no Krylov) on a seeded residual, to 1e-12."""
    sj, st = pair
    vj = sj.mg_preconditioner(min_n=8)
    vt = st.mg_preconditioner(min_n=8)
    r = np.random.default_rng(8).standard_normal(st.V.num_dofs)
    zj = np.asarray(vj({"u": jnp.asarray(r)})["u"])
    zt = vt({"u": torch.as_tensor(r)})["u"].numpy()
    _close(zt, zj, 1e-12)


def test_lattice_solve(pair):
    sj, st = pair
    mj = sj.lattice_solver(min_n=8, dtype=jnp.float32)
    mt = st.lattice_solver(min_n=8, dtype=torch.float32)
    assert len(mt.levels) == len(mj.levels)
    rj = sj.solve_lattice(tol=1e-10, maxiter=40, mg=mj)
    rt = st.solve_lattice(tol=1e-10, maxiter=40, mg=mt)
    assert rt.converged and rt.residual <= 1e-10
    assert abs(rt.iterations - rj.iterations) <= 2, (rt.iterations, rj.iterations)
    _close(rt.x["u"].numpy(), rj.x["u"], 1e-8)


def test_warm_start_needs_no_iteration(pair):
    """x0 enters the equilibrated system: a converged x0 takes 0 CG
    iterations."""
    _, st = pair
    r = st.solve(method="cg", tol=1e-10, maxiter=60)
    r0 = st.solve(method="cg", tol=1e-9, maxiter=60, x0=r.x)
    assert r0.iterations == 0 and r0.converged
    _close(r0.x["u"].numpy(), r.x["u"].numpy(), 1e-12)
