"""Port parity: level-set tagging and one-sided measures against
phifem_tpu.tagging, on the S1 flower and the circle of test_schemes.py.
Tags bit-equal; normals and lengths to 1e-14; sum of n dL over Gamma_h
zero to 1e-12 of sum dL."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import phifem_tpu as pf  # noqa: E402
import phifem_tpu_torch as pt  # noqa: E402
from phifem_tpu_torch import tagging as tt  # noqa: E402
from torch_s1_cases import (  # noqa: E402
    CIRCLE_BOX,
    FLOWER_BOX,
    grids,
    jflower,
    jphi_circle,
    tphi_circle,
)
from phifem_tpu_torch.models import flower as tflower  # noqa: E402
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

CASES = [
    ("flower", 40, "triangle", slc) for slc in (True, False)
] + [("circle", 24, ct, slc) for ct in ("triangle", "quadrilateral") for slc in (True, False)]


def _both(geom, n, ct, slc):
    if geom == "flower":
        gj, gt = grids(n, FLOWER_BOX, ct)
        lj, lt = jflower.detection_levelset, tflower.detection_levelset
    else:
        gj, gt = grids(n, CIRCLE_BOX, ct)
        lj, lt = jphi_circle, tphi_circle
    rj = pf.compute_tags_measures(gj, lj, 1, box_mode=True, single_layer_cut=slc)
    rt = pt.compute_tags_measures(gt, lt, 1, box_mode=True, single_layer_cut=slc)
    return gt, rj, rt


@pytest.mark.parametrize("geom,n,ct,slc", CASES)
def test_tags_and_measures_match(geom, n, ct, slc):
    gt, rj, rt = _both(geom, n, ct, slc)
    ctags = rt.cells_tags.as_numpy()
    np.testing.assert_array_equal(ctags, rj.cells_tags.as_numpy())
    np.testing.assert_array_equal(rt.facets_tags.as_numpy(), rj.facets_tags.as_numpy())
    assert set(np.unique(ctags)) == {1, 2, 3}
    for ind in (100, 101):
        mj, mt = rj.boundaries_measure(ind), rt.boundaries_measure(ind)
        assert mt.num_facets == mj.num_facets > 0
        for name in ("facets", "cells", "local_facets"):
            np.testing.assert_array_equal(
                getattr(mt, name).numpy(), np.asarray(getattr(mj, name)), err_msg=name
            )
        np.testing.assert_allclose(mt.normals.numpy(), np.asarray(mj.normals), rtol=0, atol=1e-14)
        np.testing.assert_allclose(mt.lengths.numpy(), np.asarray(mj.lengths), rtol=0, atol=1e-14)
        np.testing.assert_array_equal(mt.integration_entities(), mj.integration_entities())
    m = rt.boundaries_measure(100)
    L = m.lengths
    closure = (m.normals * L[:, None]).sum(0).abs().max()
    assert float(closure) <= 1e-12 * float(L.sum())


def test_tags_from_numpy():
    """The JAX tags carried across build the same one-sided measures."""
    from phifem_tpu_torch.utils.convert import tags_from_numpy

    gt, rj, rt = _both("circle", 24, "triangle", True)
    rc = tags_from_numpy(gt, rj.cells_tags.as_numpy(), rj.facets_tags.as_numpy())
    np.testing.assert_array_equal(rc.cells_tags.values.numpy(), rt.cells_tags.as_numpy())
    for ind in (100, 101):
        for name in ("facets", "cells", "local_facets", "signs"):
            torch.testing.assert_close(
                getattr(rc.boundaries_measure(ind), name), getattr(rt.boundaries_measure(ind), name)
            )


def test_discrete_levelset_tags_match():
    """A P1 Function level set is evaluated through its basis per cell."""
    gj, gt = grids(20, CIRCLE_BOX, "quadrilateral")
    fj = pf.interpolate(jphi_circle, pf.Space.lagrange(gj, 1))
    ft = pt.interpolate(tphi_circle, pt.Space.lagrange(gt, 1))
    np.testing.assert_array_equal(ft.data.numpy(), np.asarray(fj.data))
    rj = pf.compute_tags_measures(gj, fj, 2, box_mode=True, single_layer_cut=True)
    rt = pt.compute_tags_measures(gt, ft, 2, box_mode=True, single_layer_cut=True)
    np.testing.assert_array_equal(rt.cells_tags.as_numpy(), rj.cells_tags.as_numpy())
    np.testing.assert_array_equal(rt.facets_tags.as_numpy(), rj.facets_tags.as_numpy())


def test_box_boundary_trace_tags():
    """A level set crossing the background box boundary exercises the
    boundary-trace rule of the facet table."""
    gj, gt = grids(16, CIRCLE_BOX, "triangle")
    rj = pf.compute_tags_measures(gj, lambda x: x[..., 0] - 0.3 * x[..., 1] - 0.1, 1, box_mode=True)
    rt = pt.compute_tags_measures(gt, lambda x: x[..., 0] - 0.3 * x[..., 1] - 0.1, 1, box_mode=True)
    ft = rt.facets_tags.as_numpy()
    np.testing.assert_array_equal(ft, rj.facets_tags.as_numpy())
    assert np.isin(2, ft[gt.boundary_facets_np()])


@pytest.mark.parametrize("ct", ["triangle", "quadrilateral"])
def test_closed_form_maps_match_tables(ct):
    g = pt.Grid(7, 5, CIRCLE_BOX, ct, device="cpu")
    f = np.arange(g.num_facets)
    np.testing.assert_array_equal(g.f2c_of_np(f), g.f2c_np)
    np.testing.assert_array_equal(g.c2f_of_np(np.arange(g.num_cells)), g.c2f_np)
    np.testing.assert_array_equal(g.boundary_facets_np(), np.where(g.boundary_facet_mask_np)[0])
    ft = torch.as_tensor(f)
    np.testing.assert_array_equal(g.facet_base_normals_of(ft).numpy(), g.facet_base_normals_np)
    np.testing.assert_array_equal(g.facet_lengths_of(ft).numpy(), g.facet_lengths_np)
    np.testing.assert_array_equal(g.facet_endpoints_of(ft).numpy(), g.facet_endpoints_np)
    sp = pt.Space.lagrange(g, 1)
    np.testing.assert_array_equal(
        sp.cell_dofs_of(torch.arange(g.num_cells)).numpy(), sp.cell_dofs_np
    )


def test_overwrite_and_debug_invariants(monkeypatch):
    gt = pt.Grid(12, 12, CIRCLE_BOX, device="cpu")
    res = pt.compute_tags_measures(
        gt, tphi_circle, 1, box_mode=True, overwrite={"cells": {7: [0, 1]}, "facets": {9: [3]}}
    )
    assert list(res.cells_tags.as_numpy()[:2]) == [7, 7] and res.facets_tags.as_numpy()[3] == 9
    with pytest.raises(ValueError, match="reserved"):
        pt.compute_tags_measures(gt, tphi_circle, 1, box_mode=True, overwrite={"cells": {2: [0]}})
    with pytest.warns(RuntimeWarning, match="identically-zero"):
        tt.compute_tags_measures(gt, lambda x: 0.0 * x[..., 0], 1, box_mode=True)
    monkeypatch.setenv("MODE", "debug")
    with pytest.raises(ValueError, match="interior cells"):
        pt.compute_tags_measures(gt, lambda x: 1.0 + 0.0 * x[..., 0], 1, box_mode=True)
