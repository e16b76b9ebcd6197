"""Port parity of the re-discretized multigrid preconditioner
(``SchemeBase.mg_preconditioner``), mirroring tests/test_mg.py, and the
repairs of three faults of the port against the JAX package:

* ``solve`` without ``method`` runs BiCGStab, as JAX's does (the port ran
  CG, which the non-symmetric phi-FEM systems do not suit);
* ``build_hierarchy`` transfers vector P1 fields too (``v.shape[0] ==
  num_vertices``, as JAX): S4's ``y`` is a vertex field;
* ``attach_interface_solve`` takes JAX's ``dense_max``, ``sweeps`` and
  ``sweeps_coef``, routed from ``interface_*`` keywords.

Tolerances: one preconditioner application (float64 cycle in both
packages, the same coarse pseudo-inverse and interface inverse) to 1e-10
relative; solves as tests/test_mg.py holds them.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import phifem_tpu as pf  # noqa: E402
import phifem_tpu.models as jm  # noqa: E402
import phifem_tpu_torch as pt  # noqa: E402
import phifem_tpu_torch.mg as tmg  # noqa: E402
from phifem_tpu_torch.solvers import masked_operator, solve  # noqa: E402
from torch_s1_cases import flower, random_vec, rel  # noqa: E402

BOX = ((-1.0, -1.0), (1.0, 1.0))


def _phi(x):
    return x[..., 0] ** 2 + x[..., 1] ** 2 - 0.49


def _uex_t(x):
    return torch.cos(x[..., 0]) * torch.sin(x[..., 1])


def _uex_j(x):
    return jnp.cos(x[..., 0]) * jnp.sin(x[..., 1])


def _s1(n, jax_too=False):
    st = pt.WeakDirichletPoisson(pt.Grid(n, n, BOX, "triangle"), mode="bg")
    st.setup(_phi, lambda x: 2.0 * _uex_t(x), u_D=_uex_t).assemble()
    if not jax_too:
        return st
    sj = jm.WeakDirichletPoisson(pf.Grid(n, n, BOX, "triangle"), mode="bg")
    sj.setup(_phi, lambda x: 2.0 * _uex_j(x), u_D=_uex_j)
    sj.assemble()
    return sj, st


@pytest.fixture(scope="module")
def s1_32():
    return _s1(32)


@pytest.fixture(scope="module")
def s1_32_dense(s1_32):
    return solve(s1_32.op, s1_32.b, method="dense")


@pytest.fixture(scope="module")
def s4_16():
    def data_j(x):
        return jnp.abs(x[..., 0] + 0.13) + jnp.abs(x[..., 1] - 0.02) - 0.71

    def data_t(x):
        return torch.abs(x[..., 0] + 0.13) + torch.abs(x[..., 1] - 0.02) - 0.71

    sj = jm.RobinPoisson(pf.Grid(16, 16, BOX, "triangle"), mode="bg")
    sj.setup(data_j, lambda x: jnp.ones(x.shape[:-1]), lambda x: x[..., 0])
    sj.assemble()
    st = pt.RobinPoisson(pt.Grid(16, 16, BOX, "triangle"), mode="bg")
    st.setup(data_t, lambda x: torch.ones(x.shape[:-1], dtype=x.dtype), lambda x: x[..., 0])
    st.assemble()
    return sj, st


def test_transfers_of_vector_fields_match_columnwise():
    gf, gc = pt.Grid(8, 6, BOX), pt.Grid(4, 3, BOX)
    rng = np.random.default_rng(0)
    c = torch.as_tensor(rng.standard_normal((gc.num_vertices, 2)))
    f = torch.as_tensor(rng.standard_normal((gf.num_vertices, 2)))
    for k in range(2):
        assert torch.equal(tmg.prolong(c, gc, gf)[:, k], tmg.prolong(c[:, k].contiguous(), gc, gf))
        assert torch.equal(tmg.restrict(f, gf, gc)[:, k], tmg.restrict(f[:, k].contiguous(), gf, gc))


def test_mg_preconditioned_s1(s1_32, s1_32_dense):
    s = s1_32
    vc = s.mg_preconditioner(min_n=8)
    assert len(vc.levels) == 3  # 32 -> 16 -> 8
    res_mg = solve(s.op, s.b, method="bicgstab", tol=1e-10, maxiter=50, precond=vc)
    assert res_mg.converged, res_mg.residual
    res_jac = solve(s.op, s.b, method="bicgstab", tol=1e-10, maxiter=50)
    assert res_mg.residual < 1e-3 * res_jac.residual, (res_mg.residual, res_jac.residual)
    res_dense = s1_32_dense
    du = float((res_mg.x["u"] - res_dense.x["u"]).abs().max())
    assert du < 1e-6 * max(float(res_dense.x["u"].abs().max()), 1.0)


def test_mg_schwarz_interface_s1(s1_32, s1_32_dense):
    """interface_dense_max=0 forces the Schwarz branch (fault 3); it must
    converge where plain Jacobi stalls and match the dense solve."""
    s = s1_32
    vc = s.mg_preconditioner(min_n=8, interface_dense_max=0)
    assert vc.schwarz_inv is not None and vc.interface_inv is None
    res = solve(s.op, s.b, method="bicgstab", tol=1e-10, maxiter=240, precond=vc)
    assert res.converged, res.residual
    res_dense = s1_32_dense
    du = float((res.x["u"] - res_dense.x["u"]).abs().max())
    assert du < 1e-6 * max(float(res_dense.x["u"].abs().max()), 1.0)


def test_mg_preconditioner_memoized(s1_32):
    s = s1_32
    vc1 = s.mg_preconditioner(min_n=8)
    assert s.mg_preconditioner(min_n=8) is vc1
    vc3 = s.mg_preconditioner(min_n=8, refresh=True)
    assert vc3 is not vc1
    s.op.reassemble()  # a new data version builds anew
    assert s.mg_preconditioner(min_n=8) is not vc3


def test_mg_application_matches_jax():
    sj, st = _s1(16, jax_too=True)
    vj, vt = sj.mg_preconditioner(min_n=8), st.mg_preconditioner(min_n=8)
    assert len(vt.levels) == len(vj.levels) == 2
    assert sorted(vt.vertex_fields) == sorted(vj.vertex_fields) == ["p", "u"]
    xj, xt = random_vec(sj.system, 0)
    yj, yt = vj(xj), vt(xt)
    for k in yj:
        assert rel(yt[k], yj[k]) <= 1e-10, k


def test_hierarchy_transfers_vector_p1(s4_16):
    """Fault 2: S4's vector P1 y is a vertex field, as in JAX, and one
    application of the two-level cycle (vector transfers, DG0 held on the
    fine level) matches JAX's."""
    sj, st = s4_16
    vj = sj.mg_preconditioner(min_n=8, interface=False)
    vt = st.mg_preconditioner(min_n=8, interface=False)
    assert sorted(vt.vertex_fields) == sorted(vj.vertex_fields) == ["u", "y"]
    xj, xt = random_vec(sj.system, 1)
    yj, yt = vj(xj), vt(xt)
    for k in yj:
        assert rel(yt[k], yj[k]) <= 1e-10, k


def test_interface_solve_knobs(s4_16):
    """Fault 3: dense_max=0 takes the Schwarz branch, sweeps= pins the
    inner iterations, sweeps_coef scales the default."""
    _, st = s4_16
    _, _, active = masked_operator(st.op)
    base = tmg.VCycle([], ())
    vc = tmg.attach_interface_solve(base, st.op, active, dense_max=0, sweeps=7)
    assert vc.schwarz_inv is not None and vc.interface_inv is None
    assert vc.schwarz_sweeps == 7
    m = vc.band_ids.numel()
    vc2 = tmg.attach_interface_solve(tmg.VCycle([], ()), st.op, active, dense_max=0, sweeps_coef=3.0)
    assert vc2.schwarz_sweeps == max(10, int(3.0 * m**0.5))
    vc3 = tmg.attach_interface_solve(tmg.VCycle([], ()), st.op, active)
    assert vc3.interface_inv is not None  # m <= 4000: the dense default


def test_lattice_preconditioner_routes_interface_keywords(s4_16):
    _, st = s4_16
    vc = st.lattice_preconditioner(dense_max=0, sweeps=5)
    assert vc.schwarz_inv is not None and vc.schwarz_sweeps == 5
    assert st.lattice_preconditioner(dense_max=0, sweeps=5) is vc
    assert st.lattice_preconditioner(dense_max=0, sweeps=5, refresh=True) is not vc


def test_solve_defaults_to_bicgstab():
    """Fault 1: solve(op, b) runs BiCGStab (JAX's default), with the same
    iterations as method="bicgstab" on the small S1 flower case."""
    _, st = flower(24)
    vc = st.lattice_preconditioner()
    r_default = solve(st.op, st.b, tol=1e-8, maxiter=60, precond=vc)
    r_bicg = solve(st.op, st.b, method="bicgstab", tol=1e-8, maxiter=60, precond=vc)
    assert r_default.iterations == r_bicg.iterations
    assert torch.equal(r_default.x["u"], r_bicg.x["u"])
