"""Tet forms at their own quadrature degree: S1-S4 of
``demo/unstructured/main.py``'s ``main3`` on the perturbed tet box of
``tests/test_torch_utet.py`` at n = 3, assembled by both packages with no
cap on the rule (up to 125 points per cell).  XLA takes minutes to compile
JAX's tet forms at that degree, so JAX runs them eagerly
(``jax.disable_jit()``).  Tags equal; every batch's element matrices, b and
one operator matvec to 1e-12 relative (measured <= 8.1e-16 for S1).  S1
runs in the default lane; S2-S4 take minutes of eager JAX each and are
marked ``slow``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import phifem_tpu as pf
import phifem_tpu_torch as pt
from test_torch_utet import TOL, perturbed, scheme
from torch_u_cases import np_t, rel

N = 3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Under the suite's parallel workers torch's intra-op threads only
    contend for the cores: one thread a worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(name):
    import phifem_tpu.models as jmod
    import phifem_tpu_torch.models as tmod

    v, c = perturbed(N)
    with jax.disable_jit():
        sj = scheme(jmod, pf.UMesh3(v, c), name, jnp)
        sj.assemble()
        rng = np.random.default_rng(3)
        x = {n: rng.standard_normal(s.dof_shape) for n, s in sj.system.fields.items()}
        yj = sj.op.matvec({k: jnp.asarray(a) for k, a in x.items()})
    st = scheme(tmod, pt.UMesh3(v, c, device="cpu"), name, torch).assemble()
    yt = st.op.matvec({k: torch.as_tensor(a) for k, a in x.items()})
    return sj, st, yj, yt


def _hold(name):
    sj, st, yj, yt = _pair(name)
    assert np.array_equal(st.cell_tags, sj.cell_tags) and np.array_equal(st.facet_tags, sj.facet_tags)
    assert len(st.op.batches) == len(sj.op.batches)
    for bj, bt in zip(sj.op.batches, st.op.batches):
        assert bt.matrices.shape == tuple(bj.matrices.shape)
        assert rel(np_t(bt.matrices), bj.matrices) <= TOL, name
    for k in yj:
        assert rel(np_t(yt[k]), yj[k]) <= TOL, (name, k)
        assert rel(np_t(st.b[k]), sj.b[k]) <= TOL, (name, k)


def test_tet_s1_full_degree():
    _hold("s1")


@pytest.mark.slow
@pytest.mark.parametrize("name", ["s2", "s3", "s4"])
def test_tet_full_degree_slow(name):
    _hold(name)
