"""Port parity of S5, two-material interface elasticity: tagging, assembly,
tap form, null and coarse modes, direct solves.

The demo's disk problem (``tests/torch_s5_cases.py``) at n=16, built once
per module in both packages (float64, CPU):

* tags bit for bit;
* b, one seeded operator matvec (entity batches and the tap form's plain
  matvec) and the tap form's W to 1e-12 relative (sums in another order);
  JAX's W through the port's plain tap matvec reproduces JAX's tap matvec
  to 1e-12; the tap form has five block lattices of 2 / 2 / 4 / 4 / 2
  channels;
* rigid modes, ``s5_recombine``, the Fourier coarse modes and the device
  builder's basis to 1e-12;
* ``solve(method="sparse")`` and ``method="dense"``: x to 1e-8 relative
  to max|x| per field, residual below 1e-10 (sparse), the factor cached
  on the operator.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from phifem_tpu.ops.taps import build_tap_operator as jbuild  # noqa: E402
from phifem_tpu_torch.models.interface_elasticity import s5_recombine  # noqa: E402
from phifem_tpu_torch.utils.convert import tap_operator_from_numpy  # noqa: E402
from torch_s5_cases import random_fields, rel, s5  # noqa: E402
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

N = 16


@pytest.fixture(scope="module")
def pair():
    return s5(N)


def test_tags_bit_for_bit(pair):
    sj, st = pair
    np.testing.assert_array_equal(np.asarray(sj.cell_tags), st.cell_tags)
    np.testing.assert_array_equal(np.asarray(sj.facet_tags), st.facet_tags)
    for i in (100, 101):
        mj, mt = sj.tags.boundaries_measure(i), st.tags.boundaries_measure(i)
        np.testing.assert_array_equal(np.asarray(mj.facets), mt.facets.numpy())
        np.testing.assert_array_equal(np.asarray(mj.cells), mt.cells.numpy())


def test_rhs_matches_jax(pair):
    sj, st = pair
    for k in sj.b:
        assert st.b[k].shape == tuple(np.asarray(sj.b[k]).shape), k
        assert rel(st.b[k].numpy(), sj.b[k]) <= 1e-12, k


def test_matvec_matches_jax(pair):
    sj, st = pair
    xn, xt = random_fields(st.system, 0)
    yj = sj.op.matvec({k: jnp.asarray(v) for k, v in xn.items()})
    yt = st.op.matvec(xt)
    ytap = st.op.lattice_form().make_matvec(st.op)(xt)
    for k in yj:
        assert rel(yt[k].numpy(), yj[k]) <= 1e-12, k
        assert rel(ytap[k].numpy(), yj[k]) <= 1e-12, k


def test_tap_form_matches_jax(pair):
    sj, st = pair
    tj, tt = jbuild(sj.op), st.op.lattice_form()
    assert tt.blk_ch == [2, 2, 4, 4, 2] and list(tj.blk_ch) == tt.blk_ch
    assert tt.taps == [tuple(int(v) for v in t) for t in tj.taps]
    np.testing.assert_array_equal(tt.tap_offsets, np.asarray(tj.tap_offsets))
    assert tt.pad == tj.pad == 2
    assert rel(tt.W.numpy(), np.asarray(tj.W)) <= 1e-12
    # JAX's weights through the port's plain matvec, at 4 channels
    top = tap_operator_from_numpy(st.op, tj.taps, tj.tap_offsets, np.asarray(tj.W))
    xn, xt = random_fields(st.system, 1)
    yj = tj.make_matvec(sj.op)({k: jnp.asarray(v) for k, v in xn.items()})
    yt = top.make_matvec(st.op)(xt)
    for k in yj:
        assert rel(yt[k].numpy(), yj[k]) <= 1e-12, k


def test_rigid_modes_and_recombine(pair):
    sj, st = pair
    for mj, mt in zip(sj.rigid_modes(), st.rigid_modes()):
        for k in mj:
            assert rel(mt[k].numpy(), mj[k]) <= 1e-12, k
    from phifem_tpu.models.interface_elasticity import s5_recombine as jrecombine

    xn, xt = random_fields(st.system, 2)
    uj = jrecombine(sj.U, sj.cell_tags, jnp.asarray(xn["u_in"]), jnp.asarray(xn["u_out"]))
    ut = s5_recombine(st.U, st.cell_tags, xt["u_in"], xt["u_out"])
    assert rel(ut.numpy(), uj) <= 1e-12


def test_fourier_coarse_modes_match_jax(pair):
    sj, st = pair
    assert st._resolved_fourier_k() == sj._resolved_fourier_k() == 8
    mj, mt = sj._coarse_modes(), st._coarse_modes()
    assert len(mt) == len(mj) == 4 * (2 * 8 + 1)
    for a, b in zip(mj, mt):
        for k in a:
            assert rel(b[k].numpy(), a[k]) <= 1e-12, k
    (zj, kj), (zt, kt) = sj._coarse_matrix_builder(), st._coarse_matrix_builder()
    assert kj == kt
    Zj, Zt = np.asarray(zj()), zt().numpy()
    assert Zt.shape == Zj.shape and rel(Zt, Zj) <= 1e-12


@pytest.fixture(scope="module")
def direct(pair):
    sj, st = pair
    out = {}
    for method in ("sparse", "dense"):
        rj = sj.solve(method=method)
        rt = st.solve(method=method)
        out[method] = (rj, rt)
    return out


@pytest.mark.parametrize("method", ["sparse", "dense"])
def test_direct_solve_matches_jax(pair, direct, method):
    rj, rt = direct[method]
    if method == "sparse":
        assert rt.residual < 1e-10 and rj.residual < 1e-10
    for k in rj.x:
        assert rel(rt.x[k].numpy(), rj.x[k]) <= 1e-8, k


def test_sparse_factor_is_cached(pair, direct):
    _, st = pair
    st.solve(method="sparse")
    lu = st.op._splu_cache[1]
    r = st.solve(method="sparse")
    assert st.op._splu_cache[1] is lu and r.residual < 1e-10
