"""The P1 cell-stencil matvec at the shapes the kernel's tiling makes risky.

The CUDA kernel gives a thread a vertical run of rows and a CTA a tile of
``cuda_stencil.BLOCK[0]`` columns by ``BLOCK[1] * ROWS[dtype]`` rows, with
an unchecked body for tiles that touch no lattice edge.  Here, on the CPU:

* lattices whose sides are no multiple of the run or the tile (37 x 53,
  4 x 3, 129 x 65) or smaller than one tile (1 x 1, 1 x 9, 9 x 1), both cell
  types, masked and maskless, float32 and float64: the same seeded inputs go
  through the JAX package's ``StencilCellBatch.matvec_into`` and its Pallas
  kernel in interpret mode, and through the port's plain version (what
  ``stencil_matvec`` runs for CPU tensors); 1e-12 in float64, 1e-5 of max|y|
  in float32 (summation order);
* a plain traversal of the kernel's tiles (``cuda_stencil.tile_grid``,
  ``tile_is_interior``), interior tiles without any bounds check and edge
  tiles with the kernel's checks, writes every output once and equals the
  plain version.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import phifem_tpu as pf  # noqa: E402
from phifem_tpu.ops.pallas_stencil import stencil_matvec_pallas  # noqa: E402
from phifem_tpu.ops.stencil import StencilCellBatch as JaxStencilCellBatch  # noqa: E402
import phifem_tpu_torch as pt  # noqa: E402
from phifem_tpu_torch.ops import cuda_stencil  # noqa: E402
from phifem_tpu_torch.ops.stencil import orientation_offsets  # noqa: E402
from phifem_tpu_torch.utils.convert import stencil_batch_from_numpy  # noqa: E402
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

BBOX = ((-1.0, -1.0), (1.0, 1.0))
SHAPES = [(37, 53), (4, 3), (129, 65), (1, 1), (1, 9), (9, 1)]  # (nx, ny)
# larger than one tile in both directions, and exact multiples of it
TILED_SHAPES = [(37, 53), (129, 65), (200, 70), (64, 16), (128, 32), (1, 1), (1, 9), (9, 1)]
DTYPES = {"f32": (np.float32, torch.float32), "f64": (np.float64, torch.float64)}


def _ids(shape):
    return f"{shape[0]}x{shape[1]}"


def _inputs(nx, ny, ct, masked, npdt, seed=11):
    """Seeded numpy inputs in ``npdt``: matrices, masks or None, x, y0."""
    tri = ct == "triangle"
    no, nl = (2, 3) if tri else (1, 4)
    rng = np.random.default_rng(seed)
    mats = rng.standard_normal((no, nl, nl)).astype(npdt)
    masks = (rng.random((no, ny, nx)) < 0.6).astype(npdt) if masked else None
    nv = (nx + 1) * (ny + 1)
    return mats, masks, rng.standard_normal(nv).astype(npdt), rng.standard_normal(nv).astype(npdt)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("masked", [True, False], ids=["masked", "maskless"])
@pytest.mark.parametrize("ct", ["triangle", "quadrilateral"])
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_plain_version_matches_jax(shape, ct, masked, dt):
    nx, ny = shape
    npdt, tdt = DTYPES[dt]
    mats, masks, x, y0 = _inputs(nx, ny, ct, masked, npdt)
    gj = pf.Grid(nx, ny, BBOX, ct)
    bj = JaxStencilCellBatch(gj, "u", jnp.asarray(mats), None if masks is None else jnp.asarray(masks))
    y_xla = np.asarray(bj.matvec_into({"u": jnp.asarray(x)}, {"u": jnp.asarray(y0)})["u"])
    y_pl = np.asarray(stencil_matvec_pallas(gj, jnp.asarray(x), bj.masks, bj.matrices, TY=8, interpret=True))
    assert y_xla.dtype == npdt and y_pl.dtype == npdt

    gt = pt.Grid(nx, ny, BBOX, ct, device="cpu", dtype=tdt)
    bt = stencil_batch_from_numpy(gt, "u", mats, masks)
    assert bt.matrices.dtype == tdt and (bt.masks is None or bt.masks.dtype == tdt)
    y_t = bt.matvec_into({"u": torch.as_tensor(x)}, {"u": torch.as_tensor(y0.copy())})["u"].numpy()
    y_ref = cuda_stencil.stencil_matvec_ref(gt, torch.as_tensor(x), bt.masks, bt.matrices).numpy()
    assert y_t.dtype == npdt
    if dt == "f64":
        np.testing.assert_allclose(y_t, y_xla, rtol=0, atol=1e-12)
        np.testing.assert_allclose(y_ref, y_pl, rtol=0, atol=1e-12)
    else:  # the two packages sum the 18 (16) products in other orders
        np.testing.assert_allclose(y_t, y_xla, rtol=0, atol=1e-5 * np.abs(y_xla).max())
        np.testing.assert_allclose(y_ref, y_pl, rtol=0, atol=1e-5 * max(np.abs(y_pl).max(), 1.0))


def tile_traversal(g, x, masks, mats, y0):
    """``y0 + A x`` by walking the kernel's tiles: every thread's column and
    run of rows, interior tiles with no check at all (their windows must lie
    inside the lattice), edge tiles with the kernel's checks.  Returns the
    result and how often each output was written."""
    nx, ny = g.nx, g.ny
    X = x.reshape(ny + 1, nx + 1)
    Y = y0.copy().reshape(ny + 1, nx + 1)
    written = np.zeros((ny + 1, nx + 1), int)
    A = mats.astype(np.float64) if x.dtype == np.float64 else mats
    offs = orientation_offsets(g)
    tiles_y, tiles_x, tr, tc = cuda_stencil.tile_grid(nx, ny, g.dtype)
    assert tiles_y * tr > ny and tiles_x * tc > nx  # the launch covers the lattice
    assert (tiles_y - 1) * tr <= ny and (tiles_x - 1) * tc <= nx  # and has no empty row of tiles
    for ty in range(tiles_y):
        for tx in range(tiles_x):
            rows, cols = np.arange(ty * tr, (ty + 1) * tr), np.arange(tx * tc, (tx + 1) * tc)
            interior = cuda_stencil.tile_is_interior(ty, tx, nx, ny, g.dtype)
            if interior:  # what the unchecked body relies on
                assert rows[0] - 1 >= 0 and rows[-1] + 1 <= ny and cols[0] - 1 >= 0 and cols[-1] + 1 <= nx
            else:  # threads outside the lattice return
                rows, cols = rows[rows <= ny], cols[cols <= nx]
            R, C = np.meshgrid(rows, cols, indexing="ij")
            acc = np.zeros(R.shape, x.dtype)
            for o, offs_o in enumerate(offs):
                for i, (dxi, dyi) in enumerate(offs_o):
                    cr, cc = R - dyi, C - dxi
                    real = (cr >= 0) & (cr < ny) & (cc >= 0) & (cc < nx)
                    if interior:
                        assert real.all()
                    cr, cc = np.where(real, cr, 0), np.where(real, cc, 0)
                    s = np.zeros(R.shape, x.dtype)
                    for j, (dxj, dyj) in enumerate(offs_o):
                        s = s + A[o, i, j] * X[cr + dyj, cc + dxj]
                    if masks is not None:
                        s = s * masks[o][cr, cc]
                    acc = acc + np.where(real, s, 0)
            Y[R, C] += acc
            written[R, C] += 1
    return Y.reshape(-1), written


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("masked", [True, False], ids=["masked", "maskless"])
@pytest.mark.parametrize("ct", ["triangle", "quadrilateral"])
@pytest.mark.parametrize("shape", TILED_SHAPES, ids=_ids)
def test_tile_traversal_matches_plain_version(shape, ct, masked, dt):
    nx, ny = shape
    npdt, tdt = DTYPES[dt]
    mats, masks, x, y0 = _inputs(nx, ny, ct, masked, npdt, seed=5)
    g = pt.Grid(nx, ny, BBOX, ct, device="cpu", dtype=tdt)
    y, written = tile_traversal(g, x, masks, mats, y0)
    assert (written == 1).all()
    want = cuda_stencil.stencil_matvec_ref(
        g, torch.as_tensor(x), None if masks is None else torch.as_tensor(masks), torch.as_tensor(mats),
        y=torch.as_tensor(y0.copy())).numpy()
    tol = 1e-13 if dt == "f64" else 1e-5
    assert np.abs(y - want).max() <= tol * np.abs(want).max()


def test_interior_tiles_exist_at_the_main_path_size():
    """At 3201 x 3201 all but the outer ring of tiles take the unchecked body."""
    for dt in (torch.float32, torch.float64):
        tiles_y, tiles_x, _, _ = cuda_stencil.tile_grid(3200, 3200, dt)
        inner = sum(cuda_stencil.tile_is_interior(ty, tx, 3200, 3200, dt)
                    for ty in range(tiles_y) for tx in range(tiles_x))
        assert inner == (tiles_y - 2) * (tiles_x - 2)
