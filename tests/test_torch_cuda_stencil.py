"""The hand-written CUDA stencil kernel against its plain PyTorch version.

The card tests carry the ``cuda`` marker and skip where there is no CUDA
device; run them on a machine with an NVIDIA Hopper card with
``python -m pytest tests/test_torch_cuda_stencil.py -q``.  No JAX here.

Beyond agreement with the plain version, the cases at the kernel's risky
shapes run inside guard bands (NaN around x and the masks, a sentinel around
y, views that are not 16-byte aligned), compare the bits of two calls, and
fill x and the masks with NaN outside one tile's halo to show that a tile
reads no further.
"""

import numpy as np
import pytest
import torch

import phifem_tpu_torch as pt
from phifem_tpu_torch.ops import cuda_stencil
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(g, masked, dt, device, seed=0):
    rng = np.random.default_rng(seed)
    nl = g.num_vertices_per_cell
    mats = torch.as_tensor(rng.standard_normal((g.num_orientations, nl, nl)), dtype=dt)
    masks = None
    if masked:
        m = rng.random((g.num_orientations, g.ny, g.nx)) < 0.6
        masks = torch.as_tensor(m, dtype=dt, device=device)
    x = torch.as_tensor(rng.standard_normal(g.num_vertices), dtype=dt, device=device)
    y0 = torch.as_tensor(rng.standard_normal(g.num_vertices), dtype=dt, device=device)
    return mats, masks, x, y0


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("masked", [True, False], ids=["masked", "maskless"])
@pytest.mark.parametrize("ct", ["triangle", "quadrilateral"])
def test_kernel_matches_plain(cuda, ct, masked, dt):
    g = pt.Grid(37, 53, cell_type=ct, device=cuda, dtype=dt)
    mats, masks, x, y0 = _inputs(g, masked, dt, cuda)
    before = cuda_stencil.launches
    yk = cuda_stencil.stencil_matvec(g, x, masks, mats, y=y0.clone())
    torch.cuda.synchronize()
    assert cuda_stencil.launches == before + 1
    yr = cuda_stencil.stencil_matvec_ref(g, x, masks, mats, y=y0.clone())
    tol = 1e-13 if dt == torch.float64 else 1e-5  # summation order and FMA
    assert float((yk - yr).abs().max()) <= tol * float(yr.abs().max())


# lattices (nx, ny) that are no multiple of the kernel's run or tile, smaller
# than one tile, and several tiles each way
TILING_SHAPES = [(37, 53), (4, 3), (129, 65), (1, 1), (1, 9), (9, 1), (269, 131)]
GUARD = 301  # elements around x, y and the masks; odd, so no view is 16-byte aligned


def _guarded(t, fill):
    """A contiguous view holding ``t`` inside a buffer with ``GUARD`` elements
    of ``fill`` on each side, and the buffer."""
    buf = torch.full((t.numel() + 2 * GUARD,), fill, dtype=t.dtype, device=t.device)
    view = buf[GUARD : GUARD + t.numel()].view(t.shape)
    view.copy_(t)
    return view, buf


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("masked", [True, False], ids=["masked", "maskless"])
@pytest.mark.parametrize("ct", ["triangle", "quadrilateral"])
@pytest.mark.parametrize("shape", TILING_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_kernel_at_tiling_shapes_inside_guard_bands(cuda, shape, ct, masked, dt):
    """Against the plain version at the shapes the tiling makes risky, with
    NaN all around x and the masks and a sentinel all around y: nothing
    outside the lattice is read into a result or written, and a second call
    gives the same bits."""
    g = pt.Grid(*shape, cell_type=ct, device=cuda, dtype=dt)
    mats, masks, x, y0 = _inputs(g, masked, dt, cuda)
    xg, _ = _guarded(x, float("nan"))
    mg = None if masks is None else _guarded(masks, float("nan"))[0]
    yg, ybuf = _guarded(y0, 7.0)
    yk = cuda_stencil.stencil_matvec(g, xg, mg, mats, y=yg)
    torch.cuda.synchronize()
    yr = cuda_stencil.stencil_matvec_ref(g, x, masks, mats, y=y0.clone())
    tol = 1e-13 if dt == torch.float64 else 1e-5  # summation order and FMA
    assert float((yk - yr).abs().max()) <= tol * float(yr.abs().max())
    assert bool((ybuf[:GUARD] == 7.0).all()) and bool((ybuf[-GUARD:] == 7.0).all())
    again = cuda_stencil.stencil_matvec(g, x, masks, mats, y=y0.clone())
    assert torch.equal(again, yk)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("masked", [True, False], ids=["masked", "maskless"])
@pytest.mark.parametrize("ct", ["triangle", "quadrilateral"])
def test_tile_reads_no_further_than_its_halo(cuda, ct, masked, dt):
    """With NaN everywhere in x and the masks except a tile's outputs and
    their one-point halo, that tile's outputs keep their bits: no thread of
    a corner, edge or interior tile uses a value past what it needs."""
    nx, ny = 269, 131
    g = pt.Grid(nx, ny, cell_type=ct, device=cuda, dtype=dt)
    mats, masks, x, y0 = _inputs(g, masked, dt, cuda)
    want = cuda_stencil.stencil_matvec(g, x, masks, mats, y=y0.clone()).view(ny + 1, nx + 1)
    tiles_y, tiles_x, tr, tc = cuda_stencil.tile_grid(nx, ny, dt)
    assert tiles_y >= 3 and tiles_x >= 3
    tiles = [(0, 0), (0, 1), (1, 0), (1, 1), (tiles_y // 2, 1), (tiles_y - 1, tiles_x - 1),
             (tiles_y - 1, 1), (1, tiles_x - 1)]
    assert cuda_stencil.tile_is_interior(1, 1, nx, ny, dt) and not cuda_stencil.tile_is_interior(0, 1, nx, ny, dt)
    for ty, tx in tiles:
        r0, r1 = ty * tr, min((ty + 1) * tr, ny + 1)  # the tile's rows and columns
        c0, c1 = tx * tc, min((tx + 1) * tc, nx + 1)
        xn = torch.full_like(x, float("nan")).view(ny + 1, nx + 1)
        lo_r, lo_c = max(r0 - 1, 0), max(c0 - 1, 0)
        xn[lo_r : r1 + 1, lo_c : c1 + 1] = x.view(ny + 1, nx + 1)[lo_r : r1 + 1, lo_c : c1 + 1]
        mn = None
        if masked:  # the cells around the tile's vertices
            mn = torch.full_like(masks, float("nan"))
            mn[:, lo_r:r1, lo_c:c1] = masks[:, lo_r:r1, lo_c:c1]
        got = cuda_stencil.stencil_matvec(g, xn.reshape(-1), mn, mats, y=y0.clone()).view(ny + 1, nx + 1)
        torch.cuda.synchronize()
        assert torch.equal(got[r0:r1, c0:c1], want[r0:r1, c0:c1]), (ty, tx)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    g = pt.Grid(8, 6, device=cuda)
    mats, masks, x, _ = _inputs(g, True, torch.float64, cuda)
    with pytest.raises(ValueError, match="CPU tensor"):
        cuda_stencil.stencil_matvec(g, x, None, mats.to(cuda))
    with pytest.raises(ValueError, match="masks"):
        cuda_stencil.stencil_matvec(g, x, masks.float(), mats)
    with pytest.raises(TypeError):
        cuda_stencil.stencil_matvec(g, x.half(), None, mats)
    with pytest.raises(ValueError, match="shape"):
        cuda_stencil.stencil_matvec(g, x[:-1], None, mats)


@pytest.mark.cuda
def test_solve_goes_through_kernel(cuda):
    g = pt.Grid(32, 32, device=cuda)
    s = pt.BoxPoisson(g).setup(lambda x: torch.ones_like(x[:, 0])).assemble()
    vc = s.mg_preconditioner(dtype=torch.float32)
    before = cuda_stencil.launches
    r = s.solve(method="cg", tol=1e-10, maxiter=60, precond=vc)
    assert r.converged and cuda_stencil.launches > before


def _flower_scheme(n, device):
    from phifem_tpu_torch.models import flower

    g = pt.Grid(n, n, ((-4.5, -4.5), (4.5, 4.5)), device=device)
    s = pt.WeakDirichletPoisson(g, single_layer_cut=True)
    return s.setup(flower.levelset, flower.source_term, detection_levelset=flower.detection_levelset)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("shape", [(200, 200), (150, 90)], ids=["n200", "150x90"])
def test_masked_kernel_on_flower_masks(cuda, shape, dt):
    """The masked body on the S1 bulk-region masks (cells tagged 1|2)."""
    from phifem_tpu_torch.models import flower
    from phifem_tpu_torch.tagging import tag_cells

    nx, ny = shape
    box = ((-4.5, -4.5 * ny / nx), (4.5, 4.5 * ny / nx))
    tags = tag_cells(pt.Grid(nx, ny, box, device="cpu"), flower.detection_levelset, 1, True).numpy()
    g = pt.Grid(nx, ny, box, device=cuda, dtype=dt)
    mats, _, x, y0 = _inputs(g, False, dt, cuda)
    b = pt.StencilCellBatch.build(g, "u", mats, tags, (1, 2))
    assert b.masks is not None and 0 < float(b.masks.mean()) < 1
    yk = cuda_stencil.stencil_matvec(g, x, b.masks, b.matrices, y=y0.clone())
    yr = cuda_stencil.stencil_matvec_ref(g, x, b.masks, b.matrices, y=y0.clone())
    torch.cuda.synchronize()
    tol = 1e-13 if dt == torch.float64 else 1e-5
    assert float((yk - yr).abs().max()) <= tol * float(yr.abs().max())


@pytest.mark.cuda
def test_s1_matvec_on_card_matches_cpu(cuda):
    """The S1 operator and RHS assembled and applied on the card against
    the CPU lane at n=64 (the card and the CPU contract multiply-adds
    differently, hence a relative tolerance of 1e-12)."""
    sc = _flower_scheme(64, cuda).assemble()
    sh = _flower_scheme(64, "cpu").assemble()
    np.testing.assert_array_equal(sc.cell_tags, sh.cell_tags)
    x = {k: torch.as_tensor(np.random.default_rng(1).standard_normal(v.shape)) for k, v in sh.b.items()}
    before = cuda_stencil.launches
    yc = sc.op.matvec({k: v.to(cuda) for k, v in x.items()})
    assert cuda_stencil.launches > before
    yh = sh.op.matvec(x)
    for k in ("u", "p"):
        assert float((yc[k].cpu() - yh[k]).abs().max()) <= 1e-12 * float(yh[k].abs().max())
        assert float((sc.b[k].cpu() - sh.b[k]).abs().max()) <= 1e-12 * float(sh.b[k].abs().max())


def test_cpu_tensors_launch_nothing():
    """On CPU tensors the wrapper runs the plain version: no launch."""
    cuda_stencil.launches = 0
    g = pt.Grid(9, 7, device="cpu")
    mats, masks, x, y0 = _inputs(g, True, torch.float64, "cpu")
    y = cuda_stencil.stencil_matvec(g, x, masks, mats, y=y0.clone())
    ref = cuda_stencil.stencil_matvec_ref(g, x, masks, mats, y=y0.clone())
    assert torch.equal(y, ref)
    pt.BoxPoisson(g).setup(lambda x: x[:, 0]).assemble().solve(method="cg")
    assert cuda_stencil.launches == 0
