"""The port's writers (``phifem_tpu_torch.utils.io``) against the JAX
package's (``phifem_tpu.utils.io``): on the same grids, meshes and fields,
made from a numpy seed, each port file is byte-equal to JAX's; the XDMF's
XML is equal and its HDF5 datasets too; checkpoints round-trip; with h5py
hidden, ``write_xdmf`` writes JAX's VTU."""

import builtins

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import phifem_tpu as pf  # noqa: E402
import phifem_tpu.utils.io as jio  # noqa: E402
import phifem_tpu_torch as pt  # noqa: E402
import phifem_tpu_torch.utils.io as tio  # noqa: E402
from phifem_tpu.grid3 import Grid3 as JGrid3  # noqa: E402
from phifem_tpu.umesh3 import UMesh3 as JUMesh3  # noqa: E402
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

BOX = ((-1.0, -0.5), (2.0, 1.0))


def _grids(ct, n=(7, 5)):
    return pf.Grid(n[0], n[1], BOX, pf.CellType(ct)), pt.Grid(n[0], n[1], BOX, pt.CellType(ct), device="cpu")


def _functions(gj, gt, degree, value_shape=(), seed=0):
    """The same random coefficients on a Lagrange space of both packages."""
    sj, st = pf.Space.lagrange(gj, degree, value_shape), pt.Space.lagrange(gt, degree, value_shape)
    data = np.random.default_rng(seed).standard_normal(sj.dof_shape)
    return pf.Function(sj, jnp.asarray(data)), pt.Function(st, torch.as_tensor(data))


def _bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("ct", ["triangle", "quadrilateral"])
def test_write_vtu_bytes_equal(tmp_path, ct):
    gj, gt = _grids(ct)
    uj, ut = _functions(gj, gt, 1)
    vj, vt = _functions(gj, gt, 1, (2,), seed=1)
    tags = np.random.default_rng(2).integers(1, 5, gj.num_cells).astype(np.int8)
    jio.write_vtu(tmp_path / "j.vtu", gj, point_data={"u": uj, "v": vj}, cell_data={"tags": tags})
    tio.write_vtu(tmp_path / "t.vtu", gt, point_data={"u": ut, "v": vt}, cell_data={"tags": torch.as_tensor(tags)})
    assert _bytes(tmp_path / "t.vtu") == _bytes(tmp_path / "j.vtu")


@pytest.mark.parametrize("ct", ["triangle", "quadrilateral"])
def test_write_vtu_downsamples_degree_2(tmp_path, ct):
    """A degree-2 field is interpolated down to the vertices by evaluating its
    basis there, in each package's own summation order: every line of the
    file is equal but the field's, whose values agree to 2 ulp of its
    largest value (measured: 1 ulp at one vertex of 48 on triangles, none on
    quadrilaterals)."""
    gj, gt = _grids(ct)
    sj, st = pf.Space.lagrange(gj, 2), pt.Space.lagrange(gt, 2)
    uj = pf.interpolate(lambda x: x[..., 0] * x[..., 1] + x[..., 1], sj)
    ut = pt.interpolate(lambda x: x[..., 0] * x[..., 1] + x[..., 1], st)
    jio.write_vtu(tmp_path / "j.vtu", gj, point_data={"u": uj})
    tio.write_vtu(tmp_path / "t.vtu", gt, point_data={"u": ut})
    lj = _bytes(tmp_path / "j.vtu").decode().split("\n")
    lt = _bytes(tmp_path / "t.vtu").decode().split("\n")
    field = lj.index(next(s for s in lj if 'Name="u"' in s)) + 1
    assert len(lt) == len(lj) and all(a == b for i, (a, b) in enumerate(zip(lt, lj)) if i != field)
    vj = np.array(lj[field].split(), np.float64)
    vt = np.array(lt[field].split(), np.float64)
    assert vj.shape == (gj.num_vertices,)
    assert np.abs(vt - vj).max() <= 2 * np.spacing(np.abs(vj).max())


def _umeshes(kind):
    if kind == "tet":
        return JUMesh3.box(3, 2, 2, ((-1.0, -1.0, -1.0), (1.0, 0.5, 1.0))), pt.UMesh3.box(
            3, 2, 2, ((-1.0, -1.0, -1.0), (1.0, 0.5, 1.0)), device="cpu")
    gj, _ = _grids(kind)
    mj, _ = pf.UMesh.from_grid(gj)
    verts = mj.verts + 0.01 * np.random.default_rng(3).standard_normal(mj.verts.shape)
    return pf.UMesh(verts, mj.cells), pt.UMesh(verts, mj.cells, device="cpu")


@pytest.mark.parametrize("kind", ["triangle", "quadrilateral", "tet"])
def test_write_vtu_umesh_bytes_equal(tmp_path, kind):
    mj, mt = _umeshes(kind)
    assert np.array_equal(mj.verts, mt.verts) and np.array_equal(mj.cells, mt.cells)
    rng = np.random.default_rng(4)
    u = rng.standard_normal(mj.num_vertices + 5)  # a P2-like layout: the vertex head is written
    w = rng.standard_normal((mj.num_vertices, mj.verts.shape[1]))
    tags = rng.integers(1, 4, mj.num_cells)
    jio.write_vtu_umesh(tmp_path / "j.vtu", mj, point_data={"u": u, "w": w}, cell_data={"tag": tags})
    tio.write_vtu_umesh(tmp_path / "t.vtu", mt, point_data={"u": torch.as_tensor(u), "w": w},
                        cell_data={"tag": torch.as_tensor(tags)})
    assert _bytes(tmp_path / "t.vtu") == _bytes(tmp_path / "j.vtu")


def test_write_vti_bytes_equal(tmp_path):
    gj, gt = JGrid3(4, 3, 5, ((-1.0, -1.0, -1.0), (1.0, 0.5, 2.0))), pt.Grid3(
        4, 3, 5, ((-1.0, -1.0, -1.0), (1.0, 0.5, 2.0)), device="cpu")
    rng = np.random.default_rng(5)
    u = rng.standard_normal(gj.lattice_shape)
    v = rng.standard_normal(gj.num_vertices * 3)
    c = rng.standard_normal((gj.nz, gj.ny, gj.nx))
    jio.write_vti(tmp_path / "j.vti", gj, point_data={"u": u, "v": v}, cell_data={"c": c})
    tio.write_vti(tmp_path / "t.vti", gt, point_data={"u": torch.as_tensor(u), "v": v}, cell_data={"c": c})
    assert _bytes(tmp_path / "t.vti") == _bytes(tmp_path / "j.vti")
    jio.write_vti(tmp_path / "j0.vti", gj)
    tio.write_vti(tmp_path / "t0.vti", gt)
    assert _bytes(tmp_path / "t0.vti") == _bytes(tmp_path / "j0.vti")


@pytest.mark.parametrize("kind", ["grid", "triangle", "tet"])
def test_save_tags_bytes_equal(tmp_path, kind):
    if kind == "grid":
        mj, mt = _grids("triangle")
    else:
        mj, mt = _umeshes(kind)
    tags = np.random.default_rng(6).integers(1, 4, mj.num_cells).astype(np.int32)
    jio.save_tags(tmp_path / "j.vtu", mj, tags)
    tio.save_tags(tmp_path / "t.vtu", mt, torch.as_tensor(tags))
    assert _bytes(tmp_path / "t.vtu") == _bytes(tmp_path / "j.vtu")


@pytest.mark.parametrize("kind", ["grid", "quadrilateral", "tet"])
def test_save_levelset_callable_bytes_equal(tmp_path, kind):
    if kind == "grid":
        mj, mt = _grids("quadrilateral")
    else:
        mj, mt = _umeshes(kind)
    jio.save_levelset(tmp_path / "j.vtu", mj, lambda x: (x**2).sum(-1) - 0.3)
    tio.save_levelset(tmp_path / "t.vtu", mt, lambda x: (x**2).sum(-1) - 0.3)
    assert _bytes(tmp_path / "t.vtu") == _bytes(tmp_path / "j.vtu")


@pytest.mark.parametrize("kind", ["grid", "triangle"])
def test_save_levelset_discrete_bytes_equal(tmp_path, kind):
    if kind == "grid":
        mj, mt = _grids("triangle")
        phij, phit = _functions(mj, mt, 1, seed=7)
    else:
        mj, mt = _umeshes(kind)
        phij = np.random.default_rng(7).standard_normal(mj.num_vertices + 3)
        phit = torch.as_tensor(phij)
    jio.save_levelset(tmp_path / "j.vtu", mj, phij)
    tio.save_levelset(tmp_path / "t.vtu", mt, phit)
    assert _bytes(tmp_path / "t.vtu") == _bytes(tmp_path / "j.vtu")


@pytest.mark.parametrize("ct", ["triangle", "quadrilateral"])
def test_write_xdmf_xml_and_datasets_equal(tmp_path, ct):
    h5py = pytest.importorskip("h5py")
    gj, gt = _grids(ct)
    uj, ut = _functions(gj, gt, 1)
    vj, vt = _functions(gj, gt, 1, (2,), seed=1)
    tags = np.random.default_rng(2).integers(1, 5, gj.num_cells).astype(np.int8)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jio.write_xdmf(tmp_path / "j" / "out.xdmf", gj, point_data={"u": uj, "v": vj}, cell_data={"tags": tags})
    path = tio.write_xdmf(tmp_path / "t" / "out.xdmf", gt, point_data={"u": ut, "v": vt},
                          cell_data={"tags": torch.as_tensor(tags)})
    assert path == str(tmp_path / "t" / "out.xdmf")
    assert _bytes(tmp_path / "t" / "out.xdmf") == _bytes(tmp_path / "j" / "out.xdmf")
    with h5py.File(tmp_path / "j" / "out.h5") as hj, h5py.File(tmp_path / "t" / "out.h5") as ht:
        names = []
        hj.visit(names.append)
        tnames = []
        ht.visit(tnames.append)
        assert names == tnames
        for k in names:
            if isinstance(hj[k], h5py.Dataset):
                a, b = np.asarray(hj[k]), np.asarray(ht[k])
                assert a.dtype == b.dtype and np.array_equal(a, b), k


def test_write_xdmf_without_h5py_writes_jax_vtu(tmp_path, monkeypatch):
    gj, gt = _grids("triangle")
    uj, ut = _functions(gj, gt, 1)
    tags = np.arange(gj.num_cells) % 3
    real_import = builtins.__import__

    def no_h5py(name, *args, **kw):
        if name == "h5py":
            raise ImportError("h5py hidden")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_h5py)
    path = tio.write_xdmf(tmp_path / "t" / "out.xdmf", gt, point_data={"u": ut}, cell_data={"tags": tags})
    jio.write_xdmf(tmp_path / "j" / "out.xdmf", gj, point_data={"u": uj}, cell_data={"tags": tags})
    assert path == str(tmp_path / "t" / "out.vtu")
    assert not (tmp_path / "t" / "out.xdmf").exists() and not (tmp_path / "t" / "out.h5").exists()
    assert _bytes(path) == _bytes(tmp_path / "j" / "out.vtu")


def test_checkpoint_roundtrip(tmp_path):
    path = tmp_path / "ck" / "state.npz"
    u = torch.arange(5.0, dtype=torch.float64)
    tio.save_checkpoint(path, u=u, tags=np.array([1, 2, 3], np.int8), w=torch.ones(2, 3, dtype=torch.float32))
    back = tio.load_checkpoint(path)
    assert np.array_equal(back["u"], u.numpy()) and back["u"].dtype == np.float64
    assert back["tags"].dtype == np.int8 and back["w"].shape == (2, 3) and back["w"].dtype == np.float32
    # the JAX package reads the port's checkpoint the same
    jback = jio.load_checkpoint(path)
    assert all(np.array_equal(jback[k], back[k]) for k in back)
