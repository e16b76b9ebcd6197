"""Port parity of imported meshes (``phifem_tpu_torch/umesh.py``) and
their tagging, against ``phifem_tpu.umesh``.

The perturbed meshes of ``tests/torch_u_cases.py`` (triangles and
quadrilaterals, n <= 16) in both packages; every comparison is bit for bit
(the same host numpy on the same arrays):

* connectivity: facets, ``c2f``, ``f2c``, the boundary mask, normals,
  lengths, centroids, ``from_grid``'s facet map;
* cell and facet tags of ``compute_tags_measures`` in box mode (callable
  and discrete level sets, detection degrees 1-2, the single-layer cut),
  the one-sided measures 100 / 101 and the submesh mode's tags and
  exterior;
* ``from_xdmf`` on both HDF5 layouts, written with h5py into ``tmp_path``.
"""

import warnings

import numpy as np
import pytest
import torch

import phifem_tpu as pf
import phifem_tpu_torch as pt
from torch_u_cases import BOX, circle, ellipse, meshes
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

N = 12


@pytest.fixture(scope="module", params=["tri", "quad"])
def pair(request):
    return meshes(N, quad=request.param == "quad")


def test_connectivity_bit_for_bit(pair):
    jm, tm = pair
    for name in ("facets", "c2f", "f2c", "boundary_facet_mask", "facet_endpoints", "facet_lengths",
                 "facet_base_normals", "cell_centroids"):
        a, b = getattr(tm, name), getattr(jm, name)
        assert (a.dtype == b.dtype) and np.array_equal(a, b), name
    cells = np.arange(tm.num_cells)[::3]
    facets = tm.c2f[cells, 1]
    assert np.array_equal(tm.local_facet_index(cells, facets), jm.local_facet_index(cells, facets))
    ref = np.array([[0.2, 0.3], [0.5, 0.25]])
    assert np.array_equal(tm.map_to_physical(ref), jm.map_to_physical(ref))
    # the port's names for the shared layers
    assert np.array_equal(tm.f2c_of_np([0, 5]), jm.f2c[[0, 5]])
    assert torch.equal(tm.facet_lengths_of(torch.tensor([3, 1])), torch.as_tensor(jm.facet_lengths[[3, 1]]))


@pytest.mark.parametrize("quad", [False, True], ids=["tri", "quad"])
def test_from_grid_facet_map(quad):
    ct = "quadrilateral" if quad else "triangle"
    jm, jmap = pf.UMesh.from_grid(pf.Grid(5, 4, BOX, pf.CellType(ct)))
    tm, tmap = pt.UMesh.from_grid(pt.Grid(5, 4, BOX, pt.CellType(ct), device="cpu"))
    assert np.array_equal(tm.verts, jm.verts) and np.array_equal(tm.cells, jm.cells)
    assert np.array_equal(tmap, jmap)
    assert tm.device == torch.device("cpu")


def _same_sides(a, b):
    for name in ("facets", "cells", "local_facets", "signs", "normals", "lengths"):
        assert np.array_equal(getattr(a, name), getattr(b, name)), name


CASES = {
    "circle-d1": (circle, 1, False, None),
    "circle-d2": (circle, 2, False, None),
    "ellipse-slc": (ellipse, 1, True, None),
    "discrete-p2": (circle, 2, False, 2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_tags_and_measures_box_mode(pair, case):
    jm, tm = pair
    ls, det, slc, disc = CASES[case]
    jls = ls if disc is None else pf.UDiscreteLevelset(jm, ls, disc)
    tls = ls if disc is None else pt.UDiscreteLevelset(tm, ls, disc)
    jr = pf.compute_tags_measures(jm, jls, det, box_mode=True, single_layer_cut=slc)
    tr = pt.compute_tags_measures(tm, tls, det, box_mode=True, single_layer_cut=slc)
    jc, tc = jr.cells_tags.as_numpy(), tr.cells_tags.as_numpy()
    assert np.array_equal(tc, jc) and np.array_equal(tr.facets_tags.as_numpy(), jr.facets_tags.as_numpy())
    assert set(np.unique(tc)) == {1, 2, 3}
    for ind in (100, 101):
        _same_sides(tr.boundaries_measure(ind), jr.boundaries_measure(ind))
        assert np.array_equal(tr.boundaries_measure(ind).integration_entities(),
                              jr.boundaries_measure(ind).integration_entities())


def test_submesh_mode(pair):
    jm, tm = pair
    jr = pf.compute_tags_measures(jm, circle, 1)
    tr = pt.compute_tags_measures(tm, circle, 1)
    assert np.array_equal(tr.submesh.cells, jr.submesh.cells)
    assert np.array_equal(tr.submesh.facets, jr.submesh.facets)
    for tmap, jmap in zip(tr.submesh_maps, jr.submesh_maps):
        assert np.array_equal(tmap, np.asarray(jmap))
    assert np.array_equal(tr.cells_tags.as_numpy(), jr.cells_tags.as_numpy())
    assert np.array_equal(tr.facets_tags.as_numpy(), jr.facets_tags.as_numpy())
    _same_sides(tr.boundaries_measure(0), jr.boundaries_measure(0))


def test_overwrite_and_degenerate_warning():
    jm, tm = meshes(6)
    over = {"cells": {7: np.array([0, 1])}, "facets": {9: np.array([2])}}
    jr = pf.compute_tags_measures(jm, circle, 1, box_mode=True, overwrite=over)
    tr = pt.compute_tags_measures(tm, circle, 1, box_mode=True, overwrite=over)
    assert np.array_equal(tr.cells_tags.as_numpy(), jr.cells_tags.as_numpy())
    assert np.array_equal(tr.facets_tags.as_numpy(), jr.facets_tags.as_numpy())
    # a level set that vanishes on a whole cell: the cell is cut, with a warning
    flat = lambda x: x[..., 0] * 0.0 + (x[..., 0] > 0.5) * 1.0 - (x[..., 0] < -0.5) * 1.0
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        tr = pt.compute_tags_measures(tm, flat, 1, box_mode=True)
    assert any("identically-zero" in str(x.message) for x in w)
    assert np.array_equal(tr.cells_tags.as_numpy(), pf.compute_tags_measures(jm, flat, 1, box_mode=True)
                          .cells_tags.as_numpy())


def _write_xdmf(tmp_path, verts, cells, layout: str, topology: str) -> str:
    h5py = pytest.importorskip("h5py")
    h5 = tmp_path / f"{layout}.h5"
    if layout == "meshio":
        geo, top = "data0", "data1"
        v = verts
    else:
        geo, top = "Mesh/mesh/geometry", "Mesh/mesh/topology"
        v = np.column_stack([verts, np.zeros(len(verts))])  # dolfinx pads 2D geometry to 3D
    with h5py.File(h5, "w") as f:
        f[geo] = v
        f[top] = cells.astype(np.int64)
    xml = f"""<?xml version="1.0"?>
<Xdmf Version="3.0"><Domain><Grid Name="mesh" GridType="Uniform">
<Topology TopologyType="{topology}" NumberOfElements="{len(cells)}">
<DataItem Dimensions="{len(cells)} {cells.shape[1]}" Format="HDF">{h5.name}:/{top}</DataItem></Topology>
<Geometry GeometryType="{'XY' if layout == 'meshio' else 'XYZ'}">
<DataItem Dimensions="{len(v)} {v.shape[1]}" Format="HDF">{h5.name}:/{geo}</DataItem></Geometry>
</Grid></Domain></Xdmf>"""
    path = tmp_path / f"{layout}.xdmf"
    path.write_text(xml)
    return str(path)


@pytest.mark.parametrize("layout,quad", [("meshio", False), ("dolfinx", False), ("dolfinx", True)],
                         ids=["meshio-tri", "dolfinx-tri", "dolfinx-quad"])
def test_from_xdmf_both_layouts(tmp_path, layout, quad):
    jm, _ = meshes(5, quad=quad)
    path = _write_xdmf(tmp_path, jm.verts, jm.cells, layout, "Quadrilateral" if quad else "Triangle")
    ja = pf.UMesh.from_xdmf(path)
    ta = pt.UMesh.from_xdmf(path, device="cpu")
    assert np.array_equal(ta.verts, ja.verts) and np.array_equal(ta.cells, ja.cells)
    assert np.array_equal(ta.verts, jm.verts) and np.array_equal(ta.cells, jm.cells)
    assert np.array_equal(pt.compute_tags_measures(ta, circle, 1, box_mode=True).facets_tags.as_numpy(),
                          pf.compute_tags_measures(ja, circle, 1, box_mode=True).facets_tags.as_numpy())
