"""Port parity of S5's flat lattice preconditioner
(``lattice_preconditioner(coupled=False)``) and of deflated BiCGStab with
it.

The demo's disk problem (``tests/torch_s5_cases.py``) at n=16, float64,
CPU:

* both displacement bulks take the free-boundary variable-stencil cycle
  (``LatticeVarMG``; the constant block cycle is not reached) and the
  flux / auxiliary fields none; the cycle's tables (stencils, block
  inverses, masks, coarse pseudo-inverse) equal JAX's to 1e-12, and one
  cycle with JAX's tables carried over equals JAX's to 1e-12;
* one application of the whole preconditioner (bulk cycles, rank-k
  Fourier coarse correction, band solve) with JAX's tables carried over
  equals JAX's to 1e-12 (float64 cycle);
* deflated BiCGStab with the default (float32) flat preconditioner
  converges to 1e-10 in JAX's iteration count within max(3, 0.25 it)
  (the port's Krylov dots are float64, JAX's float32), with L2 and H10
  errors within 5% of the dense solution's.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from phifem_tpu.ops.lattice import LatticeVarMG as JLatticeVarMG  # noqa: E402
from phifem_tpu_torch.models import elasticity_disk as tdisk  # noqa: E402
from phifem_tpu_torch.ops.lattice import LatticeVarMG  # noqa: E402
from phifem_tpu_torch.utils.convert import (  # noqa: E402
    coarse_correction_from_numpy,
    interface_tables_from_numpy,
    lattice_var_mg_from_numpy,
)
from torch_s5_cases import random_fields, rel, s5  # noqa: E402
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

N = 16
INTERFACE_FIELDS = (
    "interface_ids", "interface_inv", "schwarz_ids", "schwarz_inv", "schwarz_own", "schwarz_sweeps",
    "band_ids", "band_ell_cols", "band_ell_vals",
)


@pytest.fixture(scope="module")
def flat64():
    sj, st = s5(N)
    return sj.lattice_preconditioner(coupled=False, dtype=jnp.float64), st.lattice_preconditioner(
        coupled=False, dtype=torch.float64)


def _var_mg_from_jax(mj):
    return lattice_var_mg_from_numpy(
        [(l.R, l.C) for l in mj.levels], [np.asarray(w) for w in mj.Ws], [np.asarray(d) for d in mj.Dinvs],
        np.asarray(mj.coarse_inv), mj.vsz, [np.asarray(m) for m in mj.masks], torch.float64, device="cpu",
    )


def test_bulk_cycles_are_variable_stencil(flat64):
    vj, vt = flat64
    assert sorted(vt.mgs) == sorted(vj.mgs) == ["u_in", "u_out"]
    for f in ("u_in", "u_out"):
        assert isinstance(vj.mgs[f], JLatticeVarMG) and isinstance(vt.mgs[f], LatticeVarMG)
        assert vt.mgs[f].vsz == 2


@pytest.mark.parametrize("field", ["u_in", "u_out"])
def test_var_mg_tables_match_jax(flat64, field):
    mj, mt = flat64[0].mgs[field], flat64[1].mgs[field]
    assert [(l.R, l.C) for l in mt.levels] == [(l.R, l.C) for l in mj.levels]
    for a, b in zip(mj.Ws, mt.Ws):
        assert rel(b.numpy(), a) <= 1e-12
    for a, b in zip(mj.Dinvs, mt.Dinvs):
        assert rel(b.numpy(), a) <= 1e-12
    for a, b in zip(mj.masks, mt.masks):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert rel(mt.coarse_inv.numpy(), mj.coarse_inv) <= 1e-12


@pytest.mark.parametrize("field", ["u_in", "u_out"])
def test_var_mg_application_matches_jax(flat64, field):
    mj = flat64[0].mgs[field]
    mt = _var_mg_from_jax(mj)
    R, C = mj.levels[0].R, mj.levels[0].C
    rng = np.random.default_rng(4)
    bp = np.zeros((2, R + 2, C + 2))
    bp[:, 2:R, 2:C] = rng.standard_normal((2, R - 2, C - 2))
    assert rel(mt(torch.as_tensor(bp)).numpy(), mj(jnp.asarray(bp))) <= 1e-12


def test_flat_preconditioner_application_matches_jax(flat64):
    vj, vt = flat64
    assert vj.coarse_Z is not None and vt.coarse_Z is not None
    vt.mgs = {f: _var_mg_from_jax(m) for f, m in vj.mgs.items()}
    interface_tables_from_numpy(
        vt, vj._flat_meta, device="cpu",
        **{k: np.asarray(getattr(vj, k)) if k != "schwarz_sweeps" else vj.schwarz_sweeps
           for k in INTERFACE_FIELDS if getattr(vj, k) is not None},
    )
    coarse_correction_from_numpy(vt, vj._flat_meta, np.asarray(vj.coarse_Z), np.asarray(vj.coarse_AZ),
                                 np.asarray(vj.coarse_Ginv), device="cpu")
    sj, st = s5(N)
    xn, xt = random_fields(st.system, 5)
    zj = vj({k: jnp.asarray(v) for k, v in xn.items()})
    zt = vt(xt)
    for k in zj:
        assert rel(zt[k].numpy(), zj[k]) <= 1e-12, k


@pytest.fixture(scope="module")
def dense_errors():
    sj, st = s5(N)
    st.solve(method="dense")
    return st.l2_h1_errors(st.u_h, tdisk.exact_solution, region=None)


def test_flat_deflated_bicgstab_matches_jax(dense_errors):
    sj, st = s5(N)
    rj = sj.solve(tol=1e-10, precond=sj.lattice_preconditioner(coupled=False))
    r = st.solve(tol=1e-10, precond=st.lattice_preconditioner(coupled=False))
    assert r.converged and r.residual <= 1e-10 and rj.converged
    assert abs(r.iterations - rj.iterations) <= max(3, 0.25 * rj.iterations), (r.iterations, rj.iterations)
    e = st.l2_h1_errors(st.u_h, tdisk.exact_solution, region=None)
    for k in ("l2", "h10"):
        assert abs(e[k] - dense_errors[k]) / dense_errors[k] < 0.05, (e, dense_errors)
