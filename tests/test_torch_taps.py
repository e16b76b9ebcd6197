"""Port parity of the tap form (ops.taps) and its plain matvec.

Mirrors tests/test_taps.py on the schemes S1 (bg and sub mode), S2, S3
(quadrilaterals and triangles) and S4, built the same way in both packages
(float64, CPU):

* the port's tap matvec equals its own entity-batch matvec to 1e-12
  relative (the same sums in another order);
* the tap list, the offsets and the flat scatter ids equal JAX's exactly,
  W to 1e-12 relative (JAX adds each batch into W in turn, the port sums a
  weight's contributions first and adds them once);
* JAX's W run through the port's plain matvec reproduces JAX's matvec to
  1e-12;
* the float32 path to 1e-5 (float32 rounding of W and x);
* refresh after ``reassemble`` and ``lattice_form`` None where JAX has it.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import phifem_tpu as pf  # noqa: E402
import phifem_tpu.models as jm  # noqa: E402
import phifem_tpu_torch as pt  # noqa: E402
from phifem_tpu.ops.taps import build_tap_operator as jbuild  # noqa: E402
from phifem_tpu_torch.ops import cuda_taps  # noqa: E402
from phifem_tpu_torch.ops.taps import build_tap_operator, supports_tap_form  # noqa: E402
from phifem_tpu_torch.utils.convert import tap_operator_from_numpy  # noqa: E402
from torch_s1_cases import random_vec, rel  # noqa: E402
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

BOX = ((-1.0, -1.0), (1.0, 1.0))
CASES = ["s1_bg", "s1_sub", "s2", "s3_quad", "s3_tri", "s4"]


def _circle(x):
    return x[..., 0] ** 2 + x[..., 1] ** 2 - 0.49


def _diamond_j(x):
    return jnp.abs(x[..., 0] + 0.13) + jnp.abs(x[..., 1] - 0.02) - 0.71


def _diamond_t(x):
    return torch.abs(x[..., 0] + 0.13) + torch.abs(x[..., 1] - 0.02) - 0.71


def _ones_j(x):
    return jnp.ones(x.shape[:-1])


def _ones_t(x):
    return torch.ones(x.shape[:-1], dtype=x.dtype)


def _zeros_j(x):
    return jnp.zeros(x.shape[:-1])


def _zeros_t(x):
    return torch.zeros(x.shape[:-1], dtype=x.dtype)


def _build(name):
    """``(jax_scheme, port_scheme)``, set up and assembled."""
    if name.startswith("s1"):
        mode = name.split("_")[1]
        gj, gt = pf.Grid(24, 24, BOX, pf.CellType.triangle), pt.Grid(24, 24, BOX, pt.CellType.triangle, device="cpu")
        sj = jm.WeakDirichletPoisson(gj, mode=mode).setup(_circle, _ones_j)
        st = pt.WeakDirichletPoisson(gt, mode=mode).setup(_circle, _ones_t)
    elif name == "s2":
        gj, gt = pf.Grid(24, 24, BOX, pf.CellType.triangle), pt.Grid(24, 24, BOX, pt.CellType.triangle, device="cpu")
        sj = jm.StrongDirichletPoisson(gj, mode="bg").setup(_circle, _ones_j)
        st = pt.StrongDirichletPoisson(gt, mode="bg").setup(_circle, _ones_t)
    else:
        ct = "quadrilateral" if name == "s3_quad" else "triangle"
        gj, gt = pf.Grid(20, 20, BOX, pf.CellType(ct)), pt.Grid(20, 20, BOX, pt.CellType(ct), device="cpu")
        J, T = (jm.NeumannPoisson, pt.NeumannPoisson) if name.startswith("s3") else (jm.RobinPoisson, pt.RobinPoisson)
        sj = J(gj, mode="bg").setup(_diamond_j, _ones_j, _zeros_j)
        st = T(gt, mode="bg").setup(_diamond_t, _ones_t, _zeros_t)
    sj.assemble()
    st.assemble()
    return sj, st


@pytest.fixture(scope="module")
def schemes():
    return {name: _build(name) for name in CASES}


@pytest.mark.parametrize("name", CASES)
def test_tap_matvec_equals_batches(schemes, name):
    _, st = schemes[name]
    top = st.op.lattice_form()
    assert top is not None and supports_tap_form(st.system)
    _, x = random_vec(st.system, 0)
    y_ref = st.op.matvec(x)
    y_tap = top.make_matvec(st.op)(x)
    for k in y_ref:
        assert y_tap[k].shape == y_ref[k].shape
        assert rel(y_tap[k], y_ref[k]) <= 1e-12, k


@pytest.mark.parametrize("name", CASES)
def test_taps_and_weights_match_jax(schemes, name):
    sj, st = schemes[name]
    tj, tt = jbuild(sj.op), st.op.lattice_form()
    assert tt.taps == [tuple(int(v) for v in t) for t in tj.taps]
    np.testing.assert_array_equal(tt.tap_offsets, np.asarray(tj.tap_offsets))
    assert (tt.pad, tt.blk_shapes, tt.blk_ch) == (tj.pad, list(tj.blk_shapes), list(tj.blk_ch))
    assert [bi for bi, _ in tt._dyn] == [bi for bi, _ in tj._dyn]
    for (_, a), (_, b) in zip(tt._dyn, tj._dyn):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert rel(tt.W.numpy(), np.asarray(tj.W)) <= 1e-12


@pytest.mark.parametrize("name", ["s2", "s3_quad", "s4"])
def test_jax_weights_through_port_matvec(schemes, name):
    sj, st = schemes[name]
    tj = jbuild(sj.op)
    top = tap_operator_from_numpy(st.op, tj.taps, tj.tap_offsets, np.asarray(tj.W))
    xj, xt = random_vec(sj.system, 1)
    yj = tj.make_matvec(sj.op)(xj)
    yt = top.make_matvec(st.op)(xt)
    for k in yj:
        assert rel(yt[k], yj[k]) <= 1e-12, k


@pytest.mark.parametrize("name", ["s1_bg", "s4"])
def test_f32_path(schemes, name):
    _, st = schemes[name]
    _, x = random_vec(st.system, 2)
    y_ref = st.op.matvec(x)
    y32 = st.op.lattice_form().make_matvec(st.op, torch.float32)(x)
    for k in y_ref:
        assert y32[k].dtype == torch.float32
        assert rel(y32[k].double(), y_ref[k]) <= 1e-5, k


def test_refresh_after_reassemble():
    """A new level set reaches the cached tap form through data_version;
    the refresh is deterministic (the same W bit for bit twice)."""
    g = pt.Grid(24, 24, BOX, pt.CellType.triangle, device="cpu")
    s = pt.WeakDirichletPoisson(g, mode="bg").setup(_circle, _ones_t).assemble()
    top = s.op.lattice_form()
    W0 = top.W.clone()
    s.phi_h.data = s.phi_h.data * 1.3
    s.op.reassemble()
    top2 = s.op.lattice_form()
    assert top2 is top and top2.data_version == s.op.data_version
    assert not torch.allclose(top2.W, W0)
    W1 = top2.W.clone()
    top2.refresh(s.op)
    assert torch.equal(top2.W, W1)
    _, x = random_vec(s.system, 3)
    y_ref = s.op.matvec(x)
    y_tap = top2.make_matvec(s.op)(x)
    for k in y_ref:
        assert rel(y_tap[k], y_ref[k]) <= 1e-12, k


def test_none_for_pure_stencil_and_degree_two():
    g = pt.Grid(16, 16, ((0.0, 0.0), (1.0, 1.0)), pt.CellType.triangle, device="cpu")
    s = pt.BoxPoisson(g).setup(_ones_t).assemble()
    assert s.op.lattice_form() is None and build_tap_operator(s.op) is None
    g2 = pt.Grid(16, 16, BOX, pt.CellType.triangle, device="cpu")
    s2 = pt.WeakDirichletPoisson(g2, mode="bg", primal_degree=2).setup(_circle, _ones_t).assemble()
    assert not supports_tap_form(s2.system)
    assert s2.op.lattice_form() is None
    r = s2.solve(method="bicgstab", tol=1e-8, maxiter=2000)
    assert r.converged


def test_solve_runs_through_the_taps(schemes, monkeypatch):
    """masked_operator (the solve) and the float32 V-cycle both use the
    tap form: its plain matvec is what the CPU runs."""
    _, st = schemes["s4"]
    calls = []
    ref = cuda_taps.tap_matvec_ref
    monkeypatch.setattr(cuda_taps, "tap_matvec_ref", lambda *a: calls.append(a[1].dtype) or ref(*a))
    vc = st.lattice_preconditioner(refresh=True)
    r = st.solve(tol=1e-10, precond=vc)
    assert r.converged
    assert torch.float64 in calls and torch.float32 in calls


def test_kernel_path_refuses_other_devices(schemes):
    _, st = schemes["s1_bg"]
    top = st.op.lattice_form()
    with pytest.raises(ValueError, match="no kernel"):
        cuda_taps.tap_matvec(top, top.W.to("meta"), {})


@pytest.mark.parametrize("ct", ["triangle", "quadrilateral"])
def test_plain_matvec_reads_zero_outside_the_source(ct):
    """Every block pair (P1, vector P1, DG0; triangle DG0 as two
    orientation blocks) at every offset in [-2, 2]^2, against a direct
    evaluation of the tap sum: a P1 target reads a one-smaller DG0 source
    without clamping (1e-12 relative, summation order)."""
    from torch_tap_cases import direct_tap_sum, random_tap_operator

    top, x = random_tap_operator(7, 5, ct, torch.float64, "cpu")
    y = cuda_taps.tap_matvec(top, top.W, x)
    ref = direct_tap_sum(top, x)
    for k in ref:
        assert rel(y[k], ref[k]) <= 1e-12, k


@pytest.mark.parametrize("case", ["4x4", "4x2", "2x4", "mixed"])
def test_plain_matvec_four_channels(case):
    """The plain tap matvec on block pairs with tensor P1 (4-channel)
    blocks, against the direct tap sum (1e-12 relative)."""
    from torch_tap_cases import FOUR_CHANNEL_PAIRS, direct_tap_sum, random_tap_operator

    _, fields, chans = next(c for c in FOUR_CHANNEL_PAIRS if c[0] == case)
    top, x = random_tap_operator(7, 5, "triangle", torch.float64, "cpu", seed=3, fields=fields, chans=chans)
    assert 4 in top.blk_ch
    y = cuda_taps.tap_matvec(top, top.W, x)
    ref = direct_tap_sum(top, x)
    for k in ref:
        assert rel(y[k], ref[k]) <= 1e-12, k


def test_static_batch_taps_match_jax():
    """A geometry-uniform term on a vector P1 field is a static (never
    rebuilt) batch: its weights go to the static part, pairs that are zero
    on every cell are pruned; taps and W as JAX's, matvec as the batches'."""
    from phifem_tpu.assembly import CellTerm as JCellTerm, System as JSystem, assemble_operator as jasm
    from phifem_tpu_torch.assembly import CellTerm, System, assemble_operator

    def vmass_j(u, v, d, x, ctx):
        return jnp.dot(u["y"].val, v["y"].val) + jnp.sum(u["y"].grad * v["y"].grad)

    def vmass_t(u, v, d, x, ctx):
        return torch.dot(u["y"].val, v["y"].val) + torch.sum(u["y"].grad * v["y"].grad)

    gj, gt = pf.Grid(9, 7, BOX, pf.CellType.triangle), pt.Grid(9, 7, BOX, pt.CellType.triangle, device="cpu")
    opj = jasm(JSystem({"y": pf.Space.lagrange(gj, 1, (2,))}), gj,
               cell_terms=[(JCellTerm(vmass_j, None, degree=2, uniform=True), {})])
    opt = assemble_operator(System({"y": pt.Space.lagrange(gt, 1, (2,))}), gt,
                            cell_terms=[(CellTerm(vmass_t, None, degree=2, uniform=True), {})])
    tj, tt = jbuild(opj), opt.lattice_form()
    assert tt._static is not None and not tt._dyn
    assert tt.taps == [tuple(int(v) for v in t) for t in tj.taps]
    assert rel(tt.W.numpy(), np.asarray(tj.W)) <= 1e-12
    _, x = random_vec(opt.system, 4)
    y_ref = opt.matvec(x)
    y_tap = tt.make_matvec(opt)(x)
    assert rel(y_tap["y"], y_ref["y"]) <= 1e-12
