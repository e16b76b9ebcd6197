"""Port parity of S5's default preconditioner, the coupled multilevel
hierarchy (``lattice_preconditioner()`` -> ``coupled_preconditioner``,
``mg.CoupledVCycle``), and of deflated BiCGStab with it.

The demo's disk problem (``tests/torch_s5_cases.py``) at n=16, CPU, with
``min_n=4, max_coarse_dofs=2000``: one smoothing level (n=16, its own flat
lattice preconditioner) and the dense pseudo-inverse of the scheme
re-discretized at n=8.

* one application of the float64 hierarchy equals JAX's to 1e-10 (each
  package builds its own tables: the coarse pseudo-inverse and the coarse
  modes' Galerkin pseudo-inverse are computed, not carried);
* deflated BiCGStab with the same hierarchy converges to 1e-10 in JAX's
  iteration count within max(3, 0.25 it), with L2 and H10 errors within
  5% of the dense solution's.  (The float64 hierarchy serves both checks:
  a second, float32 build would cost JAX another compile of the whole
  solve; the float32 cycle is held to JAX in ``test_torch_s5_precond.py``,
  and the float32 hierarchy runs in ``chip_smoke.py``.)
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from phifem_tpu_torch.mg import CoupledVCycle  # noqa: E402
from phifem_tpu_torch.models import elasticity_disk as tdisk  # noqa: E402
from torch_s5_cases import random_fields, rel, s5  # noqa: E402
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

N = 16
KW = dict(min_n=4, max_coarse_dofs=2000)


@pytest.fixture(scope="module")
def coupled64():
    sj, st = s5(N)
    return sj.lattice_preconditioner(dtype=jnp.float64, **KW), st.lattice_preconditioner(dtype=torch.float64, **KW)


def test_coupled_application_matches_jax(coupled64):
    sj, st = s5(N)
    vj, vt = coupled64
    assert isinstance(vt, CoupledVCycle)
    assert [lv["grid"].nx for lv in vt.levels] == [16] and vt.coarse_level.grid.nx == 8
    assert vt.vertex_fields == tuple(st.system.fields)
    xn, xt = random_fields(st.system, 6)
    zj = vj({k: jnp.asarray(v) for k, v in xn.items()})
    zt = vt(xt)
    for k in zj:
        assert rel(zt[k].numpy(), zj[k]) <= 1e-10, k


def test_coupled_deflated_bicgstab_matches_jax(coupled64):
    sj, st = s5(N)
    rj = sj.solve(tol=1e-10, precond=coupled64[0])
    r = st.solve(tol=1e-10, precond=coupled64[1])
    assert r.converged and r.residual <= 1e-10 and rj.converged
    assert abs(r.iterations - rj.iterations) <= max(3, 0.25 * rj.iterations), (r.iterations, rj.iterations)
    e = st.l2_h1_errors(st.u_h, tdisk.exact_solution, region=None)
    st.solve(method="dense")
    ed = st.l2_h1_errors(st.u_h, tdisk.exact_solution, region=None)
    for k in ("l2", "h10"):
        assert abs(e[k] - ed[k]) / ed[k] < 0.05, (e, ed)
