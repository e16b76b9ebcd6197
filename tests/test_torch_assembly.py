"""Port parity: uniform-term assembly (torch.func element matrices and the
stencil operator) against phifem_tpu.assembly, float64, to 1e-12."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import phifem_tpu as pf  # noqa: E402
import phifem_tpu.assembly as ja  # noqa: E402
import phifem_tpu_torch as pt  # noqa: E402
import phifem_tpu_torch.assembly as ta  # noqa: E402
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

BBOX = ((-1.0, -1.0), (1.0, 1.5))

FORMS = {
    "stiffness": (
        lambda u, v, d, x, ctx: jnp.dot(u["u"].grad, v["u"].grad),
        lambda u, v, d, x, ctx: torch.dot(u["u"].grad, v["u"].grad),
    ),
    "mass": (
        lambda u, v, d, x, ctx: u["u"].val * v["u"].val,
        lambda u, v, d, x, ctx: u["u"].val * v["u"].val,
    ),
    "bulk": (
        lambda u, v, d, x, ctx: jnp.dot(u["u"].grad, v["u"].grad) + 0.3 * u["u"].val * v["u"].val,
        lambda u, v, d, x, ctx: torch.dot(u["u"].grad, v["u"].grad) + 0.3 * u["u"].val * v["u"].val,
    ),
}


def _systems(ct, nx=6, ny=5, degree=1):
    gj, gt = pf.Grid(nx, ny, BBOX, ct), pt.Grid(nx, ny, BBOX, ct, device="cpu")
    sj = ja.System({"u": pf.Space.lagrange(gj, degree)})
    st = ta.System({"u": pt.Space.lagrange(gt, degree)})
    return gj, gt, sj, st


@pytest.mark.parametrize("degree", [1, 2])
@pytest.mark.parametrize("form", ["stiffness", "mass"])
@pytest.mark.parametrize("ct", ["triangle", "quadrilateral"])
def test_uniform_element_matrices(ct, form, degree):
    gj, gt, sj, st = _systems(ct, degree=degree)
    fj, ft = FORMS[form]
    Mj = np.asarray(ja.uniform_element_matrices(sj, gj, fj, 2 * degree))
    Mt = ta.uniform_element_matrices(st, gt, ft, 2 * degree).numpy()
    assert Mt.shape == Mj.shape
    np.testing.assert_allclose(Mt, Mj, rtol=0, atol=1e-12 * np.abs(Mj).max())


@pytest.mark.parametrize("ct", ["triangle", "quadrilateral"])
def test_stencil_operator_dense_and_diagonal(ct):
    gj, gt, sj, st = _systems(ct)
    fj, ft = FORMS["bulk"]
    opj = ja.assemble_operator(sj, gj, cell_terms=[(ja.CellTerm(fj, None, 2, True), {})])
    opt = ta.assemble_operator(st, gt, cell_terms=[(ta.CellTerm(ft, None, 2, True), {})])
    (bt,) = opt.batches
    assert isinstance(bt, pt.StencilCellBatch) and bt.masks is None
    np.testing.assert_allclose(opt.to_dense(), opj.to_dense(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        opt.diagonal()["u"].numpy(), np.asarray(opj.diagonal()["u"]), rtol=0, atol=1e-12
    )
    assert opt.lattice_form() is None


@pytest.mark.parametrize("ct", ["triangle", "quadrilateral"])
def test_region_term_masks(ct):
    """A region-restricted uniform term builds the same masks (simplex
    cells 0::2 lower, 1::2 upper) and the same operator as JAX."""
    gj, gt, sj, st = _systems(ct, nx=9, ny=7)
    tags = np.asarray(pf.tag_cells(gj, lambda x: x[..., 0] ** 2 + x[..., 1] ** 2 - 0.5, 1))
    fj, ft = FORMS["bulk"]
    opj = ja.assemble_operator(
        sj, gj, cell_terms=[(ja.CellTerm(fj, (1, 2), 2, True), {})], cell_tags=tags
    )
    opt = ta.assemble_operator(
        st, gt, cell_terms=[(ta.CellTerm(ft, (1, 2), 2, True), {})], cell_tags=tags
    )
    np.testing.assert_array_equal(
        opt.batches[0].masks.numpy(), np.asarray(opj.batches[0].masks)
    )
    np.testing.assert_allclose(opt.to_dense(), opj.to_dense(), rtol=0, atol=1e-12)
    rng = np.random.default_rng(5)
    x = rng.standard_normal(gj.num_vertices)
    np.testing.assert_allclose(
        opt.matvec({"u": torch.as_tensor(x)})["u"].numpy(),
        np.asarray(opj.matvec({"u": jnp.asarray(x)})["u"]),
        rtol=0, atol=1e-12,
    )


@pytest.mark.parametrize("kind", ["callable", "function"])
def test_uniform_term_with_constant_data(kind):
    """A uniform term reading data (a callable or a P1 Function, constant
    here) assembles the same element matrices as JAX."""
    from phifem_tpu_torch.utils.convert import function_from_numpy

    gj, gt, sj, st = _systems("triangle")
    if kind == "callable":
        dj = {"k": lambda x: 2.5 * jnp.ones(x.shape[:-1])}
        dt = {"k": lambda x: 2.5 * torch.ones(x.shape[:-1], dtype=x.dtype)}
    else:
        data = np.full(gj.num_vertices, 2.5)
        dj = {"k": pf.Function(pf.Space.lagrange(gj, 1), jnp.asarray(data))}
        dt = {"k": function_from_numpy(pt.Space.lagrange(gt, 1), data)}
    fj = lambda u, v, d, x, ctx: d["k"].val * jnp.dot(u["u"].grad, v["u"].grad)
    ft = lambda u, v, d, x, ctx: d["k"].val * torch.dot(u["u"].grad, v["u"].grad)
    opj = ja.assemble_operator(sj, gj, cell_terms=[(ja.CellTerm(fj, None, 2, True), dj)])
    opt = ta.assemble_operator(st, gt, cell_terms=[(ta.CellTerm(ft, None, 2, True), dt)])
    np.testing.assert_allclose(
        opt.batches[0].matrices.numpy(), np.asarray(opj.batches[0].matrices), rtol=0, atol=1e-12
    )


def test_operator_from_numpy():
    """The JAX operator's state carried across gives the same matvec."""
    from phifem_tpu_torch.utils.convert import operator_from_numpy

    gj, gt, sj, st = _systems("quadrilateral", nx=8, ny=6)
    tags = np.asarray(pf.tag_cells(gj, lambda x: x[..., 0] - 0.2, 1))
    fj, _ = FORMS["bulk"]
    opj = ja.assemble_operator(
        sj, gj, cell_terms=[(ja.CellTerm(fj, (1, 2), 2, True), {})], cell_tags=tags
    )
    opt = operator_from_numpy(
        st, [("u", np.asarray(b.matrices), np.asarray(b.masks)) for b in opj.batches]
    )
    x = np.random.default_rng(2).standard_normal(gj.num_vertices)
    np.testing.assert_allclose(
        opt.matvec({"u": torch.as_tensor(x)})["u"].numpy(),
        np.asarray(opj.matvec({"u": jnp.asarray(x)})["u"]),
        rtol=0, atol=1e-12,
    )
