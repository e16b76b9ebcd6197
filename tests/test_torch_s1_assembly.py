"""Port parity: the S1 flower operator and load vector against
phifem_tpu.assembly (n=24, float64).  Element matrices and b to 1e-12
(relative to the largest entry), the dense operator to 1e-10 relative."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import phifem_tpu.mg as jmg  # noqa: E402
import phifem_tpu_torch as pt  # noqa: E402
import phifem_tpu_torch.mg as tmg  # noqa: E402
from phifem_tpu.solvers import masked_operator as jmasked  # noqa: E402
from phifem_tpu_torch.assembly import Batch  # noqa: E402
from phifem_tpu_torch.solvers import masked_operator as tmasked  # noqa: E402
from torch_s1_cases import flower, random_vec, rel  # noqa: E402

N = 24


@pytest.fixture(scope="module")
def s1():
    return flower(N)


@pytest.mark.parametrize("i", range(4), ids=["bulk_stencil", "cut_penalty", "ghost", "boundary_flux"])
def test_batches_match(s1, i):
    sj, st = s1
    assert len(st.op.batches) == len(sj.op.batches) == 4
    bj, bt = sj.op.batches[i], st.op.batches[i]
    assert type(bt).__name__ == type(bj).__name__
    Mj = np.asarray(bj.matrices)
    assert tuple(bt.matrices.shape) == Mj.shape
    assert rel(bt.matrices.numpy(), Mj) <= 1e-12
    if isinstance(bt, pt.StencilCellBatch):
        np.testing.assert_array_equal(bt.masks.numpy(), np.asarray(bj.masks))  # masked kernel body
    else:
        assert bt.dynamic
        for (nt, dt, _), (nj, dj, _) in zip(bt.segments, bj.segments):
            assert nt == nj
            np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))


def test_operator_rhs_and_matvec_match(s1):
    sj, st = s1
    Aj = sj.op.to_dense()
    assert rel(st.op.to_dense(), Aj) <= 1e-10
    for k in ("u", "p"):
        assert rel(st.b[k].numpy(), np.asarray(sj.b[k])) <= 1e-12
    xj, xt = random_vec(sj.system, 3)
    yj, yt = sj.op.matvec(xj), st.op.matvec(xt)
    dj, dt = sj.op.diagonal(), st.op.diagonal()
    for k in ("u", "p"):
        assert rel(yt[k].numpy(), np.asarray(yj[k])) <= 1e-12
        assert rel(dt[k].numpy(), np.asarray(dj[k])) <= 1e-12


def test_reassemble_equals_fresh_assembly(s1):
    """A new phi coefficient vector, then reassemble(): every data-dependent
    batch equals a fresh assembly with that phi."""
    _, st = s1
    phi0 = st.phi_h.data.clone()
    v0 = st.op.data_version
    rng = np.random.default_rng(11)
    try:
        st.phi_h.data.mul_(1.0 + 0.1 * torch.as_tensor(rng.random(phi0.shape)))
        st.op.reassemble()
        assert st.op.data_version == v0 + 1
        fresh = pt.WeakDirichletPoisson(st.grid, single_layer_cut=True)
        fresh.tags, fresh.cell_tags, fresh.facet_tags = st.tags, st.cell_tags, st.facet_tags
        fresh.system, fresh.V = st.system, st.V
        fresh.phi_h, fresh.f_h, fresh.u_D = st.phi_h, st.f_h, st.u_D
        fresh.assemble(rhs=False)
        assert st.op.dynamic_batch_ids() == (1, 2, 3)
        for a, b in zip(st.op.batches, fresh.op.batches):
            torch.testing.assert_close(a.matrices, b.matrices, rtol=0, atol=1e-14)
        assert rel(st.op.batches[1].matrices.numpy(), np.asarray(s1[0].op.batches[1].matrices)) > 1e-3
    finally:
        st.phi_h.data.copy_(phi0)
        st.op.reassemble()
    assert rel(st.op.batches[1].matrices.numpy(), np.asarray(s1[0].op.batches[1].matrices)) <= 1e-12


def test_restricted_blocks_match(s1):
    sj, st = s1
    _, _, aj = jmasked(sj.op)
    _, _, at = tmasked(st.op)
    selj = jmg.data_dependent_selection(sj.op, aj)
    selt = tmg.data_dependent_selection(st.op, at)
    for k in ("u", "p"):
        np.testing.assert_array_equal(selt[k], selj[k])
    Dj, idsj = sj.op.restricted_dense(selj)
    Dt, idst = st.op.restricted_dense(selt)
    np.testing.assert_array_equal(idst, idsj)
    assert rel(Dt, Dj) <= 1e-12
    Cj, _ = sj.op.restricted_csr(selj)
    Ct, _ = st.op.restricted_csr(selt)
    assert rel(Ct.toarray(), Cj.toarray()) <= 1e-12
    assert rel(Ct.toarray(), Dt) <= 1e-12


def test_batch_from_numpy(s1):
    """The JAX ghost batch carried across gives the same matvec."""
    from phifem_tpu_torch.utils.convert import batch_from_numpy

    sj, st = s1
    bj = sj.op.batches[2]
    bt = batch_from_numpy(
        st.system, [(n, np.asarray(d), vs) for n, d, vs in bj.segments], np.asarray(bj.matrices)
    )
    assert isinstance(bt, Batch)
    xj, xt = random_vec(sj.system, 5)
    yj = bj.matvec_into(xj, sj.system.zeros())
    yt = bt.matvec_into(xt, st.system.zeros())
    assert rel(yt["u"].numpy(), np.asarray(yj["u"])) <= 1e-12
