"""Port parity of p-multigrid (``phifem_tpu_torch.pmg``, slice E).

* ``p_transfer`` equal to JAX's bit for bit; ``_apply_P`` / ``_apply_PT``
  (the ordered scatter) to 1e-14 of JAX's, exact on linears, adjoint to
  each other (the oracle of ``tests/test_pmg.py::test_p_transfer_
  reproduces_linears``), for P2 / P3 / Q2 / Q3;
* ``_p1_twin`` lowers the same degree fields as JAX's, scheme by scheme;
* one ``p_multigrid_preconditioner`` application against JAX's at float64,
  with the twin's lattice cycle alone (``low_iters=0``) and inside 10
  BiCGStab iterations (JAX's float32 recurrence dots patched to float64),
  to 1e-10;
* fgmres + p-MG at P2 n=12 (``tests/test_pmg.py::test_pmg_degree2_
  exactness``): 20 iterations as JAX, u to JAX's to 1e-9, L2 < 1e-9; P3 and
  Q3 at n=8 on the cos x e^{y/2} problem: converged, L2 within 1% of JAX's.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import phifem_tpu as pf  # noqa: E402
import phifem_tpu.models as jm  # noqa: E402
import phifem_tpu.solvers as jsolvers  # noqa: E402
import phifem_tpu_torch as pt  # noqa: E402
import phifem_tpu_torch.models as tm  # noqa: E402
from phifem_tpu.pmg import _apply_P as j_apply_P  # noqa: E402
from phifem_tpu.pmg import _apply_PT as j_apply_PT  # noqa: E402
from phifem_tpu.pmg import p_transfer as j_p_transfer  # noqa: E402
from phifem_tpu_torch.pmg import PMGVCycle, Transfer, _apply_P, _apply_PT, p_transfer  # noqa: E402
from torch_s1_cases import random_vec, rel  # noqa: E402
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

BOX = ((-1.5, -1.5), (1.5, 1.5))
ELEMENTS = [("triangle", 2), ("triangle", 3), ("quadrilateral", 2), ("quadrilateral", 3)]
IDS = ["P2", "P3", "Q2", "Q3"]


def phi(x):
    return x[..., 0] ** 2 + x[..., 1] ** 2 - 1.0


def quad_uex(x):
    return 1.0 + x[..., 0] - 0.5 * x[..., 1] + x[..., 0] * x[..., 1]


@pytest.mark.parametrize("ct, k", ELEMENTS, ids=IDS)
def test_p_transfer_matches_jax(ct, k):
    box = ((-1.0, -0.5), (2.0, 1.5))
    gj, gt = pf.Grid(7, 5, box, ct), pt.Grid(7, 5, box, ct, device="cpu")
    hj, lj = pf.Space.lagrange(gj, k), pf.Space.lagrange(gj, 1)
    ht, lt = pt.Space.lagrange(gt, k), pt.Space.lagrange(gt, 1)
    idx_j, wts_j = j_p_transfer(hj, lj)
    idx, wts = p_transfer(ht, lt)
    assert idx.dtype == idx_j.dtype and np.array_equal(idx, idx_j)
    assert np.array_equal(wts, wts_j)
    tr = Transfer.build(idx, wts, lt.num_scalar_dofs, "cpu")
    # linear functions transfer exactly
    f = lambda x: 0.75 * x[..., 0] - 1.25 * x[..., 1] + 0.5
    vh = _apply_P(tr, pt.interpolate(f, lt).data)
    assert np.abs(vh.numpy() - pt.interpolate(f, ht).data.numpy()).max() < 1e-12
    rng = np.random.default_rng(3)
    v = rng.standard_normal(lt.num_scalar_dofs)
    w = rng.standard_normal(ht.num_scalar_dofs)
    Pv, PTw = _apply_P(tr, torch.as_tensor(v)), _apply_PT(tr, torch.as_tensor(w))
    Pv_j = np.asarray(j_apply_P(jnp.asarray(idx_j), jnp.asarray(wts_j), jnp.asarray(v)))
    PTw_j = np.asarray(j_apply_PT(jnp.asarray(idx_j), jnp.asarray(wts_j), lj.num_scalar_dofs, jnp.asarray(w)))
    assert rel(Pv.numpy(), Pv_j) <= 1e-14 and rel(PTw.numpy(), PTw_j) <= 1e-14
    lhs, rhs = float(Pv @ torch.as_tensor(w)), float(torch.as_tensor(v) @ PTw)
    assert abs(lhs - rhs) < 1e-10 * max(1.0, abs(lhs))
    # vector-valued fields move component by component
    V2 = torch.as_tensor(rng.standard_normal((lt.num_scalar_dofs, 2)))
    assert torch.equal(_apply_P(tr, V2)[:, 1], _apply_P(tr, V2[:, 1].contiguous()))


@pytest.mark.parametrize(
    "name, kw",
    [
        ("WeakDirichletPoisson", dict(primal_degree=3, levelset_degree=3)),
        ("StrongDirichletPoisson", dict(primal_degree=2, levelset_degree=2, solution_degree=3)),
        ("NeumannPoisson", dict(primal_degree=2, vector_degree=2, auxiliary_degree=0)),
        ("RobinPoisson", dict(primal_degree=2, vector_degree=2, auxiliary_degree=0)),
        ("InterfaceElasticity", dict(primal_degree=2, flux_degree=2, auxiliary_degree=2)),
    ],
)
def test_p1_twin_lowers_the_same_degree_fields_as_jax(name, kw):
    """Only primal / flux / auxiliary degrees go to 1; S3 / S4's
    ``vector_degree`` stays, as in the JAX package."""
    tw = getattr(tm, name)(pt.Grid(4, 4, device="cpu"), **kw)._p1_twin()
    jw = getattr(jm, name)(pf.Grid(4, 4), **kw)._p1_twin()
    degrees = lambda s: {f.name: getattr(s, f.name) for f in dataclasses.fields(s) if f.name.endswith("degree")}
    assert degrees(tw) == degrees(jw)
    assert type(tw) is getattr(tm, name)


@functools.lru_cache(maxsize=None)
def quad_pair(n: int, k: int = 2, ct: str = "triangle"):
    """``tests/test_pmg.py``'s P2 exactness problem in both packages."""
    kw = dict(mode="bg", primal_degree=k, levelset_degree=k)
    sj = jm.WeakDirichletPoisson(pf.Grid(n, n, BOX, ct), **kw)
    sj.setup(phi, lambda x: jnp.zeros(x.shape[:-1]), u_D=quad_uex)
    st = pt.WeakDirichletPoisson(pt.Grid(n, n, BOX, ct, device="cpu"), **kw)
    st.setup(phi, lambda x: torch.zeros(x.shape[:-1], dtype=x.dtype), u_D=quad_uex)
    return sj.assemble(), st.assemble()


@pytest.mark.parametrize("low_iters", [0, 10])
def test_pmg_application_matches_jax(low_iters, monkeypatch):
    # JAX's inner BiCGStab takes float32 recurrence dots (tree_dot32); the
    # port's are float64: patch JAX's for the comparison
    monkeypatch.setattr(jsolvers, "tree_dot32", jsolvers.tree_dot)
    sj, st = quad_pair(8)
    vj = sj.p_multigrid_preconditioner(dtype=jnp.float64, low_iters=low_iters)
    vt = st.p_multigrid_preconditioner(dtype=torch.float64, low_iters=low_iters)
    assert isinstance(vt, PMGVCycle)
    assert st.p_multigrid_preconditioner(dtype=torch.float64, low_iters=low_iters) is vt  # memoized
    assert (vt.interface_inv is None) == (vj.interface_inv is None)
    rj, rt = random_vec(sj.system, seed=5)
    zj, zt = vj(rj), vt(rt)
    for f in zj:
        assert rel(zt[f].numpy(), np.asarray(zj[f])) <= 1e-10, f


@pytest.fixture(scope="module")
def p2_solves():
    sj, st = quad_pair(12)
    rj = sj.solve(method="fgmres", tol=1e-11, maxiter=200, precond=sj.p_multigrid_preconditioner())
    rt = st.solve(method="fgmres", tol=1e-11, maxiter=200, precond=st.p_multigrid_preconditioner())
    return sj, st, rj, rt


def test_pmg_fgmres_p2_matches_jax(p2_solves):
    sj, st, rj, rt = p2_solves
    assert rt.converged and rt.recurrence <= 1e-11, rt
    assert rt.iterations == rj.iterations == 20, (rt.iterations, rj.iterations)
    assert rel(rt.x["u"].numpy(), np.asarray(rj.x["u"])) <= 1e-9
    e = st.l2_h1_errors(st.u_h, quad_uex, region=(1, 2))
    assert e["l2"] < 1e-9 and e["h10"] < 1e-8, e


def test_pmg_twin_and_band(p2_solves):
    """The twin is S1 at P1 on the same grid with the P2 level set; the P2
    penalty band gets the interface solve; the restriction plans cover the
    twin's DoFs."""
    _, st, _, _ = p2_solves
    vc = st.p_multigrid_preconditioner()
    twin = st._p1_twin()
    assert (twin.primal_degree, twin.levelset_degree, twin.grid) == (1, 2, st.grid)
    assert vc.interface_inv is not None or vc.band_tables is not None
    tr = vc.transfers["u"]
    assert vc.transfers["p"] is tr and tr.nl == pt.Space.lagrange(st.grid, 1).num_scalar_dofs
    assert torch.equal(tr.uniq, torch.arange(tr.nl))


def _cos_exp(m):
    return lambda x: m.cos(x[..., 0]) * m.exp(x[..., 1] / 2.0)


@pytest.mark.parametrize("ct", ["triangle", "quadrilateral"], ids=["P3", "Q3"])
def test_pmg_fgmres_degree3_matches_jax_accuracy(ct):
    """P3 / Q3 at n=8 on the cos x e^{y/2} problem of tests/test_schemes.py
    (-Delta u = 0.75 u): converged, L2 error within 1% of JAX's."""
    kw = dict(mode="bg", primal_degree=3, levelset_degree=3)
    uj, ut = _cos_exp(jnp), _cos_exp(torch)
    sj = jm.WeakDirichletPoisson(pf.Grid(8, 8, BOX, ct), **kw)
    sj.setup(phi, lambda x: 0.75 * uj(x), u_D=uj)
    st = pt.WeakDirichletPoisson(pt.Grid(8, 8, BOX, ct, device="cpu"), **kw)
    st.setup(phi, lambda x: 0.75 * ut(x), u_D=ut)
    sj.assemble()
    st.assemble()
    rj = sj.solve(method="fgmres", tol=1e-10, maxiter=200, precond=sj.p_multigrid_preconditioner())
    rt = st.solve(method="fgmres", tol=1e-10, maxiter=200, precond=st.p_multigrid_preconditioner())
    assert rt.converged and rt.residual < 1e-9, (rt.iterations, rt.residual)
    assert rt.iterations == rj.iterations, (rt.iterations, rj.iterations)
    ej = sj.l2_h1_errors(sj.u_h, uj, region=(1, 2))
    et = st.l2_h1_errors(st.u_h, ut, region=(1, 2))
    assert abs(et["l2"] - ej["l2"]) <= 0.01 * ej["l2"], (et, ej)
