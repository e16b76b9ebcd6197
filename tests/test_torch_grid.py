"""Port parity: phifem_tpu_torch.grid against phifem_tpu.grid (exact maps)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import phifem_tpu as pf  # noqa: E402
import phifem_tpu_torch as pt  # noqa: E402
from phifem_tpu_torch.quadrature import cell_rule  # noqa: E402
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

BBOX = ((-1.0, -2.0), (2.0, 1.5))
HOST_MAPS = [
    "vertex_coords_np",
    "cell_vertices_np",
    "cell_orientations_np",
    "cell_origins_np",
    "c2f_np",
    "f2c_np",
    "facet_kind_np",
    "facet_base_normals_np",
    "facet_lengths_np",
    "facet_endpoints_np",
    "boundary_facet_mask_np",
]
SIZES = [
    "num_cells", "num_vertices", "num_facets", "num_vertices_per_cell",
    "num_facets_per_cell", "hx", "hy", "cell_volume", "cell_diameter",
]


@pytest.mark.parametrize("ct", ["triangle", "quadrilateral"])
def test_host_maps_equal(ct):
    gj, gt = pf.Grid(5, 3, BBOX, ct), pt.Grid(5, 3, BBOX, ct, device="cpu")
    for name in SIZES:
        assert getattr(gt, name) == getattr(gj, name), name
    for name in HOST_MAPS:
        a, b = getattr(gt, name), getattr(gj, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    cells = np.arange(gj.num_cells)
    facets = gj.c2f_np[:, 1]
    np.testing.assert_array_equal(
        gt.local_facet_index_np(cells, facets), gj.local_facet_index_np(cells, facets)
    )


@pytest.mark.parametrize("ct", ["triangle", "quadrilateral"])
def test_tensor_maps_equal(ct):
    gj, gt = pf.Grid(7, 4, BBOX, ct), pt.Grid(7, 4, BBOX, ct, device="cpu")
    np.testing.assert_array_equal(gt.vertex_coords.numpy(), np.asarray(gj.vertex_coords))
    np.testing.assert_array_equal(gt.cell_vertices.numpy(), np.asarray(gj.cell_vertices))
    np.testing.assert_array_equal(
        gt.cell_orientations.numpy(), np.asarray(gj.cell_orientations)
    )
    cells = np.random.default_rng(0).integers(0, gj.num_cells, 23)
    np.testing.assert_array_equal(
        gt.orientation_of(torch.as_tensor(cells)).numpy(),
        np.asarray(gj.orientation_of(cells)),
    )
    np.testing.assert_array_equal(
        gt.cell_vertex_coords_of(torch.as_tensor(cells)).numpy(),
        np.asarray(gj.cell_vertex_coords_of(cells)),
    )
    ref_pts, _ = cell_rule(ct, 4)
    # a few-term affine combination: exact up to FMA contraction
    np.testing.assert_allclose(
        gt.map_to_physical(torch.as_tensor(cells), ref_pts).numpy(),
        np.asarray(gj.map_to_physical(cells, ref_pts)),
        rtol=0, atol=1e-15,
    )
    Jt, dt = gt.cell_jacobians()
    Jj, dj = gj.cell_jacobians()
    np.testing.assert_array_equal(Jt.numpy(), np.asarray(Jj))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-15)


def test_refine_keeps_device_and_dtype():
    g = pt.Grid(3, 2, BBOX, "quadrilateral", dtype=torch.float32, device="cpu")
    f = g.refine()
    assert (f.nx, f.ny, f.device, f.dtype) == (6, 4, torch.device("cpu"), torch.float32)
    assert f.vertex_coords.dtype == torch.float32
    assert f.vertex_coords_np.dtype == np.float32
    np.testing.assert_array_equal(
        f.vertex_coords.numpy(), np.asarray(pf.Grid(6, 4, BBOX, "quadrilateral").vertex_coords_np, np.float32)
    )


@pytest.mark.parametrize("degree", [1, 2])
@pytest.mark.parametrize("ct", ["triangle", "quadrilateral"])
def test_space_maps_and_eval(ct, degree):
    """DoF maps equal exactly; interpolation and point evaluation (inside
    and outside the box: edge cells extrapolate) to 1e-13."""
    import jax.numpy as jnp

    gj, gt = pf.Grid(5, 4, BBOX, ct), pt.Grid(5, 4, BBOX, ct, device="cpu")
    Vj, Vt = pf.Space.lagrange(gj, degree), pt.Space.lagrange(gt, degree)
    assert Vt.dof_shape == Vj.dof_shape
    np.testing.assert_array_equal(Vt.cell_dofs_np, Vj.cell_dofs_np)
    np.testing.assert_array_equal(Vt.dof_coords_np, Vj.dof_coords_np)
    fj = pf.interpolate(lambda x: jnp.cos(x[..., 0]) * (1 + x[..., 1] ** 2), Vj)
    ft = pt.interpolate(lambda x: torch.cos(x[..., 0]) * (1 + x[..., 1] ** 2), Vt)
    np.testing.assert_allclose(ft.data.numpy(), np.asarray(fj.data), rtol=1e-15, atol=0)
    pts = np.random.default_rng(9).uniform(-1.5, 2.5, size=(40, 2))
    np.testing.assert_allclose(
        ft.eval(torch.as_tensor(pts)).numpy(), np.asarray(fj.eval(jnp.asarray(pts))),
        rtol=0, atol=1e-13,
    )
    np.testing.assert_array_equal(
        pt.spaces.boundary_dof_mask(Vt).numpy(), np.asarray(pf.spaces.boundary_dof_mask(Vj))
    )
