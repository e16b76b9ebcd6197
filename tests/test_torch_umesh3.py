"""Port parity of imported tetrahedral meshes (``phifem_tpu_torch/umesh3.py``
and the tet branches of ``umesh.py`` / ``tagging.py``) against
``phifem_tpu.umesh3``, on the CPU.

* ``UMesh3.box`` (the Kuhn split; a small box of uneven sides, and its
  vertices moved by 0.2 h from a seed): connectivity (facets, ``c2f``,
  ``f2c``, edges, ``c2e``), face areas and normals, centroids and the
  physical map, bit for bit; the default device is the card;
* ``from_xdmf`` of a file written in ``tmp_path``;
* the detection lattices (``tet_boundary_points``, the boundary faces'
  triangle lattice) and ``UDiscreteLevelset3``;
* cell and facet tags against a half-space oracle (a plane level set,
  cells classified by their vertices) and against JAX for the sphere,
  callable and discrete, with and without ``single_layer_cut``;
* the one-sided measures (box mode, ds(100) / ds(101)) and the submesh's
  exterior: facets, cells, signs bit for bit, normals and areas to 1e-12,
  and sum(n dA) = 0 over the closed exterior.
"""

import numpy as np
import pytest
import torch

import phifem_tpu as pf
import phifem_tpu_torch as pt
from phifem_tpu.umesh3 import tet_boundary_points as j_tbp
from phifem_tpu.umesh3 import triangle_lattice_points as j_tlp
from phifem_tpu_torch.umesh3 import tet_boundary_points, triangle_lattice_points
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

BOX3 = ((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0))
R2 = 0.61**2


def sphere(x):
    return (x**2).sum(-1) - R2


def ellipsoid(x):
    return (x[..., 0] - 0.1) ** 2 + 2.0 * (x[..., 1] + 0.05) ** 2 + 1.5 * x[..., 2] ** 2 - 0.4


def perturbed(n: int, amp: float = 0.2, seed: int = 0):
    """(verts, cells) of JAX's ``UMesh3.box(n, n, n)`` on [-1, 1]^3 with its
    interior vertices moved by amp h (U[0, 1) - 1/2)."""
    m = pf.UMesh3.box(n, n, n, BOX3)
    v = m.verts.copy()
    interior = (np.abs(np.abs(v) - 1.0) > 1e-12).all(axis=1)
    v[interior] += amp * (2.0 / n) * (np.random.default_rng(seed).random((int(interior.sum()), 3)) - 0.5)
    return v, m.cells


@pytest.fixture(scope="module")
def pair():
    v, c = perturbed(6)
    return pf.UMesh3(v, c), pt.UMesh3(v, c, device="cpu")


CONN = ("facets", "c2f", "f2c", "edges", "c2e", "boundary_facet_mask", "facet_endpoints", "facet_lengths",
        "facet_base_normals", "cell_centroids")


@pytest.mark.parametrize("shape", [(3, 4, 5), (1, 1, 1)], ids=["3x4x5", "1x1x1"])
def test_box_connectivity_bit_for_bit(shape):
    bounds = ((0.0, -0.5, 0.25), (1.0, 0.5, 2.0))
    jm = pf.UMesh3.box(*shape, bounds)
    tm = pt.UMesh3.box(*shape, bounds, device="cpu")
    assert np.array_equal(tm.verts, jm.verts) and np.array_equal(tm.cells, jm.cells)
    assert tm.num_cells == 6 * int(np.prod(shape))
    for name in CONN:
        assert np.array_equal(getattr(tm, name), getattr(jm, name)), name
    ref = np.random.default_rng(1).random((5, 3)) / 3.0
    assert np.array_equal(tm.map_to_physical(ref), jm.map_to_physical(ref))
    idx = np.arange(0, tm.num_cells, 3)
    f = tm.c2f[idx, 2]
    assert np.array_equal(tm.local_facet_index(idx, f), jm.local_facet_index(idx, f))


def test_perturbed_connectivity_and_device(pair):
    jm, tm = pair
    for name in CONN:
        assert np.array_equal(getattr(tm, name), getattr(jm, name)), name
    assert tm.device == torch.device("cpu") and (tm.dim, tm.cell_name, tm.is_simplex) == (3, "tetrahedron", True)
    # the box's boundary: 6 sides of 6 x 6 squares, 2 triangles each
    assert int(tm.boundary_facet_mask.sum()) == 6 * 36 * 2
    # the default device is the card, with no fallback
    assert pt.UMesh3(tm.verts, tm.cells).device == torch.device("cuda")
    with pytest.raises(ValueError):
        pt.UMesh3(tm.verts[:, :2], tm.cells)


def test_from_xdmf(tmp_path, pair):
    h5py = pytest.importorskip("h5py")
    jm, _ = pair
    with h5py.File(tmp_path / "tets.h5", "w") as f:
        f["data0"] = jm.verts
        f["data1"] = jm.cells.astype(np.int64)
    nc, nv = len(jm.cells), len(jm.verts)
    (tmp_path / "tets.xdmf").write_text(f"""<?xml version="1.0"?>
<Xdmf Version="3.0"><Domain><Grid Name="mesh" GridType="Uniform">
<Topology TopologyType="Tetrahedron" NumberOfElements="{nc}">
<DataItem Dimensions="{nc} 4" Format="HDF">tets.h5:/data1</DataItem></Topology>
<Geometry GeometryType="XYZ"><DataItem Dimensions="{nv} 3" Format="HDF">tets.h5:/data0</DataItem></Geometry>
</Grid></Domain></Xdmf>""")
    ja = pf.UMesh3.from_xdmf(str(tmp_path / "tets.xdmf"))
    ta = pt.UMesh3.from_xdmf(str(tmp_path / "tets.xdmf"), device="cpu", dtype=torch.float32)
    assert np.array_equal(ta.verts, ja.verts) and np.array_equal(ta.cells, ja.cells)
    assert np.array_equal(ta.cells, jm.cells) and ta.dtype == torch.float32
    assert np.array_equal(ta.facets, ja.facets)


@pytest.mark.parametrize("N", [0, 1, 2, 3])
def test_detection_lattices(pair, N):
    jm, tm = pair
    assert np.array_equal(tet_boundary_points(N), j_tbp(N))
    assert np.array_equal(triangle_lattice_points(N), j_tlp(N))
    assert np.array_equal(tm.detection_ref_points(N), jm.detection_ref_points(N))
    pts = tet_boundary_points(N)
    if N:
        # every point on a face of the reference tet, and the whole face lattice
        lam = np.column_stack([1.0 - pts.sum(axis=1), pts])
        assert (np.isclose(lam, 0.0).any(axis=1)).all()
        # the whole lattice less its interior points (all 4 coordinates >= 1)
        assert len(pts) == (N + 1) * (N + 2) * (N + 3) // 6 - (N - 1) * (N - 2) * (N - 3) // 6
    # the discrete level set at the detection points
    jd = pf.UDiscreteLevelset3(jm, sphere, 2)
    td = pt.UDiscreteLevelset3(tm, sphere, 2)
    assert np.abs(td.nodal - jd.nodal).max() <= 1e-15
    assert np.abs(td.eval_ref(pts) - jd.eval_ref(pts)).max() <= 1e-14


def test_tags_half_space_oracle(pair):
    """A plane cuts the mesh: a cell is inside (1) when the level set is
    negative at one of its 4 vertices (the detection degree-1 lattice) and
    positive at none, outside (3) in the mirror case, else cut (2).  The
    plane passes through vertices, where the level set is exactly 0."""
    _, tm = pair
    a = np.array([0.3, -0.2, 0.5])
    plane = lambda x: x[..., 0] * a[0] + x[..., 1] * a[1] + x[..., 2] * a[2] - 0.1
    r = pt.compute_tags_measures(tm, plane, 1, box_mode=True)
    vals = tm.verts @ a - 0.1
    cv = vals[tm.cells]
    neg, pos = (cv < 0).any(axis=1), (cv > 0).any(axis=1)
    want = np.where(neg & ~pos, 1, np.where(pos & ~neg, 3, 2))
    assert (cv == 0).any()
    assert np.array_equal(r.cells_tags.as_numpy(), want)
    ft = r.facets_tags.as_numpy()
    interior = ~tm.boundary_facet_mask
    t0, t1 = want[tm.f2c[interior, 0]], want[tm.f2c[interior, 1]]
    assert np.array_equal(ft[interior][(t0 == 1) & (t1 == 1)], np.ones(((t0 == 1) & (t1 == 1)).sum()))
    assert (ft[interior][(np.minimum(t0, t1) == 2) & (np.maximum(t0, t1) == 3)] == 4).all()


def _same_sides(a, b):
    for name in ("facets", "cells", "local_facets", "signs"):
        assert np.array_equal(getattr(a, name), getattr(b, name)), name
    for name in ("normals", "lengths"):
        x, y = getattr(a, name), getattr(b, name)
        assert np.abs(x - y).max(initial=0.0) <= 1e-12 * max(np.abs(y).max(initial=0.0), 1e-300), name
    assert np.array_equal(a.integration_entities(), b.integration_entities())


CASES = {"sphere-d1": (sphere, 1, False, None), "sphere-d2": (sphere, 2, False, None),
         "ellipsoid-slc": (ellipsoid, 1, True, None), "discrete-p2": (sphere, 2, False, 2)}


@pytest.mark.parametrize("case", list(CASES))
def test_tags_and_measures_against_jax(pair, case):
    jm, tm = pair
    ls, det, slc, disc = CASES[case]
    jls = ls if disc is None else pf.UDiscreteLevelset3(jm, ls, disc)
    tls = ls if disc is None else pt.UDiscreteLevelset3(tm, ls, disc)
    jr = pf.compute_tags_measures(jm, jls, det, box_mode=True, single_layer_cut=slc)
    tr = pt.compute_tags_measures(tm, tls, det, box_mode=True, single_layer_cut=slc)
    tc = tr.cells_tags.as_numpy()
    assert np.array_equal(tc, jr.cells_tags.as_numpy())
    assert np.array_equal(tr.facets_tags.as_numpy(), jr.facets_tags.as_numpy())
    assert set(np.unique(tc)) == {1, 2, 3}
    for ind in (100, 101):
        assert tr.boundaries_measure(ind).num_facets > 0
        _same_sides(tr.boundaries_measure(ind), jr.boundaries_measure(ind))


def test_submesh_exterior_closed(pair):
    jm, tm = pair
    jr = pf.compute_tags_measures(jm, sphere, 1)
    tr = pt.compute_tags_measures(tm, sphere, 1)
    assert np.array_equal(tr.submesh.cells, jr.submesh.cells)
    assert np.array_equal(tr.submesh.facets, jr.submesh.facets)
    assert np.array_equal(tr.facets_tags.as_numpy(), jr.facets_tags.as_numpy())
    ext = tr.boundaries_measure(0)
    _same_sides(ext, jr.boundaries_measure(0))
    # the exterior of Omega_h is a closed surface: sum n dA = 0
    flux = (ext.normals * ext.lengths[:, None]).sum(axis=0)
    assert np.abs(flux).max() <= 1e-12 * ext.lengths.sum()
    # each face's outward normal points away from its chosen cell
    d = tm.facet_endpoints[ext.facets].mean(axis=1) - tm.cell_centroids[ext.cells]
    assert ((ext.normals * d).sum(axis=1) > 0).all()
