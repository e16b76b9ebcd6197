"""Port parity and accuracy of the S1 weak-Dirichlet scheme.

* S1 flower at n=40, lattice preconditioner (float32 cycle) + BiCGStab to
  1e-8: the port's u within 1e-6 relative of JAX's; iterations within
  max(3, 0.25 * JAX's) of JAX's (the port takes float64 Krylov dots and
  float64 interface tables, JAX float32 ones).
* On the circle of test_schemes.py: the affine patch test exact to 1e-10,
  the n=10/20 convergence rates, l2_h1_errors equal to JAX's to 1e-10 on
  the same u_h, and the dense solve against BiCGStab."""

import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import phifem_tpu as pf  # noqa: E402
import phifem_tpu.models as jm  # noqa: E402
import phifem_tpu_torch as pt  # noqa: E402
from torch_s1_cases import CIRCLE_BOX, flower, jphi_circle, rel, tphi_circle  # noqa: E402
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)


def u_mild(x):
    return torch.cos(x[..., 0]) * torch.sin(x[..., 1])


def f_mild(x):
    return 2.0 * u_mild(x)


def _circle(n, uex=u_mild, f=f_mild, method="dense", ct="triangle"):
    g = pt.Grid(n, n, CIRCLE_BOX, pt.CellType(ct), device="cpu")
    s = pt.WeakDirichletPoisson(g, mode="bg")
    s.setup(tphi_circle, f, u_D=uex).assemble()
    res = s.solve(method=method, tol=1e-12)
    assert res.converged, res.residual
    return s


def test_flower_lattice_bicgstab_matches_jax():
    sj, st = flower(40)
    rj = sj.solve(method="bicgstab", tol=1e-8, maxiter=60, precond=sj.lattice_preconditioner())
    vc = st.lattice_preconditioner()
    assert vc.dtype == torch.float32 and vc.interface_inv.dtype == torch.float64
    rt = st.solve(method="bicgstab", tol=1e-8, maxiter=60, precond=vc)
    assert rt.converged and rt.recurrence <= 1e-8
    assert abs(rt.iterations - rj.iterations) <= max(3, 0.25 * rj.iterations), (
        rt.iterations, rj.iterations,
    )
    assert rel(rt.x["u"].numpy(), np.asarray(rj.x["u"])) <= 1e-6


@pytest.mark.parametrize("ct", ["triangle", "quadrilateral"])
def test_weak_dirichlet_patch_exact(ct):
    """Affine solutions are reproduced to machine precision."""
    uex = lambda x: 1.0 + 2.0 * x[..., 0] - x[..., 1]
    fz = lambda x: torch.zeros(x.shape[:-1], dtype=x.dtype)
    s = _circle(10, uex=uex, f=fz, ct=ct)
    e = s.l2_h1_errors(s.u_h, uex)
    assert e["l2"] < 1e-10 and e["h10"] < 1e-10, e


def test_weak_dirichlet_convergence():
    s1, s2 = _circle(10), _circle(20)
    e1, e2 = s1.l2_h1_errors(s1.u_h, u_mild), s2.l2_h1_errors(s2.u_h, u_mild)
    rate_l2 = math.log2(e1["l2"] / e2["l2"])
    rate_h1 = math.log2(e1["h10"] / e2["h10"])
    assert e2["l2"] < 0.12, (e1, e2)
    assert rate_l2 > 1.5, (e1, e2)
    assert rate_h1 > 0.7, (e1, e2)


def test_l2_h1_errors_match_jax():
    st = _circle(10)
    gj = pf.Grid(10, 10, CIRCLE_BOX, pf.CellType.triangle)
    sj = jm.WeakDirichletPoisson(gj, mode="bg")
    sj.tag(jphi_circle)
    np.testing.assert_array_equal(st.cell_tags, np.asarray(sj.cell_tags))
    uh = pf.Function(pf.Space.lagrange(gj, 1), jnp.asarray(st.u_h.data.numpy()))
    ej = sj.l2_h1_errors(uh, lambda x: jnp.cos(x[..., 0]) * jnp.sin(x[..., 1]))
    et = st.l2_h1_errors(st.u_h, u_mild)
    for k in ("l2", "h10", "h1"):
        assert abs(et[k] - ej[k]) <= 1e-10 * ej[k], (k, et[k], ej[k])


def test_dense_matches_bicgstab():
    sd, si = _circle(10), _circle(10, method="bicgstab")
    ed, ei = sd.l2_h1_errors(sd.u_h, u_mild), si.l2_h1_errors(si.u_h, u_mild)
    assert np.isclose(ed["l2"], ei["l2"], rtol=1e-4), (ed, ei)
    assert si.result.iterations > 1 and sd.result.iterations == 1
