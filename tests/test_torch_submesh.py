"""Port parity of the submesh mode (``tagging.Submesh``,
``compute_tags_measures(box_mode=False)``, ``mode="sub"``).

* The submesh's entity lists, tags and exterior facet list equal JAX's
  exactly (integer data; the signs are +-1), on triangles and quads.
* S1 in sub mode assembles the same operator and load vector as JAX's sub
  mode (1e-12 relative, float64 sums in another order), and solves the
  same discrete problem as bg mode where the domain stays away from the
  box (relative L2 errors to 1e-8, as tests/test_schemes.py:87).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import phifem_tpu as pf  # noqa: E402
import phifem_tpu.models as jm  # noqa: E402
import phifem_tpu_torch as pt  # noqa: E402
from phifem_tpu.tagging import compute_tags_measures as jtags  # noqa: E402
from torch_s1_cases import CIRCLE_BOX, FLOWER_BOX, jflower, random_vec, rel  # noqa: E402
from phifem_tpu_torch.models import flower as tflower  # noqa: E402
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)


def _circle(x):
    return x[..., 0] ** 2 + x[..., 1] ** 2 - 0.49


def _u_mild(x):
    return torch.cos(x[..., 0]) * torch.sin(x[..., 1])


def _int(a):
    return np.asarray(a).astype(np.int64)


@pytest.mark.parametrize("ct", ["triangle", "quadrilateral"])
def test_submesh_matches_jax(ct):
    gj, gt = pf.Grid(30, 26, FLOWER_BOX, pf.CellType(ct)), pt.Grid(30, 26, FLOWER_BOX, pt.CellType(ct), device="cpu")
    rj = jtags(gj, jflower.detection_levelset, 1, box_mode=False)
    rt = pt.compute_tags_measures(gt, tflower.detection_levelset, 1, box_mode=False)
    sj, st = rj.submesh, rt.submesh
    assert st.num_cells == sj.num_cells > 0
    np.testing.assert_array_equal(_int(st.cells), _int(sj.cells))
    np.testing.assert_array_equal(_int(st.facets), _int(sj.facets))
    np.testing.assert_array_equal(rt.cells_tags.as_numpy(), np.asarray(rj.cells_tags.values))
    np.testing.assert_array_equal(rt.facets_tags.as_numpy(), np.asarray(rj.facets_tags.values))
    for a, b in zip(rt.submesh_maps, rj.submesh_maps):
        np.testing.assert_array_equal(_int(a), _int(b))
    et, ej = rt.boundaries_measure(0), rj.boundaries_measure(0)
    assert et is st.exterior
    for name in ("facets", "cells", "local_facets"):
        np.testing.assert_array_equal(_int(getattr(et, name).numpy()), _int(getattr(ej, name)))
    np.testing.assert_array_equal(et.signs.numpy(), np.asarray(ej.signs))
    # the exterior of Omega_h is closed
    L = et.lengths
    assert float((et.normals * L[:, None]).sum(0).abs().max() / L.sum()) <= 1e-12


def test_s1_sub_mode_matches_jax():
    n = 24
    gj = pf.Grid(n, n, CIRCLE_BOX, pf.CellType.triangle)
    gt = pt.Grid(n, n, CIRCLE_BOX, pt.CellType.triangle, device="cpu")
    sj = jm.WeakDirichletPoisson(gj, mode="sub").setup(_circle, lambda x: jnp.ones(x.shape[:-1]))
    sj.assemble()
    st = pt.WeakDirichletPoisson(gt, mode="sub").setup(_circle, lambda x: torch.ones(x.shape[:-1], dtype=x.dtype))
    st.assemble()
    np.testing.assert_array_equal(st.cell_tags, np.asarray(sj.cell_tags))
    np.testing.assert_array_equal(_int(st.boundary_measure().facets.numpy()), _int(sj.boundary_measure().facets))
    for k in st.b:
        assert rel(st.b[k], np.asarray(sj.b[k])) <= 1e-12, k
    xj, xt = random_vec(sj.system, 0)
    yj, yt = sj.op.matvec(xj), st.op.matvec(xt)
    for k in yj:
        assert rel(yt[k], yj[k]) <= 1e-12, k


def test_weak_dirichlet_sub_mode_matches_bg():
    errs = {}
    for mode in ("bg", "sub"):
        g = pt.Grid(12, 12, CIRCLE_BOX, pt.CellType.triangle, device="cpu")
        s = pt.WeakDirichletPoisson(g, mode=mode)
        s.setup(_circle, lambda x: 2.0 * _u_mild(x), u_D=_u_mild).assemble()
        s.solve(method="dense")
        errs[mode] = s.l2_h1_errors(s.u_h, _u_mild)
    assert np.isclose(errs["sub"]["l2"], errs["bg"]["l2"], rtol=1e-8), errs


@pytest.mark.parametrize("scheme", ["s2", "s4"])
def test_schemes_sub_mode_match_jax(scheme):
    """S2 (one P1 field, all terms data-dependent) and S4 (u, vector y,
    DG0 p) in sub mode: the boundary term runs over the submesh exterior;
    load vector and operator as JAX's to 1e-12."""
    n = 20
    gj = pf.Grid(n, n, CIRCLE_BOX, pf.CellType.triangle)
    gt = pt.Grid(n, n, CIRCLE_BOX, pt.CellType.triangle, device="cpu")
    one_j = lambda x: jnp.ones(x.shape[:-1])  # noqa: E731
    one_t = lambda x: torch.ones(x.shape[:-1], dtype=x.dtype)  # noqa: E731
    if scheme == "s2":
        sj = jm.StrongDirichletPoisson(gj, mode="sub").setup(_circle, one_j)
        st = pt.StrongDirichletPoisson(gt, mode="sub").setup(_circle, one_t)
    else:
        sj = jm.RobinPoisson(gj, mode="sub").setup(_circle, one_j, lambda x: x[..., 0])
        st = pt.RobinPoisson(gt, mode="sub").setup(_circle, one_t, lambda x: x[..., 0])
    sj.assemble()
    st.assemble()
    assert st.submesh is not None and st.boundary_measure() is st.submesh.exterior
    for k in sj.b:
        assert rel(st.b[k], np.asarray(sj.b[k])) <= 1e-12, k
    xj, xt = random_vec(sj.system, 1)
    yj, yt = sj.op.matvec(xj), st.op.matvec(xt)
    for k in yj:
        assert rel(yt[k], yj[k]) <= 1e-12, k
