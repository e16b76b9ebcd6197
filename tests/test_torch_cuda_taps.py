"""The hand-written CUDA tap-matvec kernel against its plain PyTorch
version.

The card tests carry the ``cuda`` marker and skip where there is no CUDA
device; run them on a machine with an NVIDIA Hopper card with
``python -m pytest tests/test_torch_cuda_taps.py -q``.  No JAX here.
Block pairs of 1, 2 and 4 channels (tensor P1) and the tap forms of S1,
S4 and S5.  Tolerances relative to max|y|: 1e-13 in float64, 1e-5 in
float32 (the kernel sums a thread's taps in another order than the plain
version's tap-by-tap accumulation, with FMA).  Outputs on tiles without an active
tap are exactly zero, and the kernel is deterministic bit for bit.
"""

import numpy as np
import pytest
import torch

import phifem_tpu_torch as pt
from phifem_tpu_torch.ops import cuda_taps
from torch_tap_cases import FOUR_CHANNEL_PAIRS, random_tap_operator, sparse_tap_operator
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

TOL = {torch.float64: 1e-13, torch.float32: 1e-5}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), torch.finfo(torch.float64).tiny)


def _empty_tiles(top):
    """Per field, True at the outputs of the tiles with no active tap."""
    base, ptr, _ = cuda_taps.tile_table(top)
    TR, TC = cuda_taps.TILE
    empty = np.diff(ptr) == 0
    masks = []
    for b, (R, C) in enumerate(top.blk_shapes):
        ntc = -(-C // TC)
        tiles = empty[base[b] : base[b + 1]].reshape(-1, ntc)
        m = np.repeat(np.repeat(tiles, TR, axis=0), TC, axis=1)[:R, :C]
        masks.append(torch.as_tensor(np.repeat(m[:, :, None], top.blk_ch[b], axis=2)))
    return top._recompose(masks)


def _scheme_tap_form(name, device):
    from phifem_tpu_torch.models import elasticity_disk as disk
    from phifem_tpu_torch.models import flower
    from phifem_tpu_torch.models import robin_square as rsq

    if name.startswith("s5"):
        n = int(name[3:])
        g = pt.Grid(n, n, ((-1.5, -1.5), (1.5, 1.5)), "triangle", device=device)
        s = pt.InterfaceElasticity(g, E_in=disk.E_in, nu_in=disk.nu_in, E_out=disk.E_out, nu_out=disk.nu_out)
        s.setup(disk.levelset, disk.source_term, disk.exact_solution)
    elif name == "s1":
        g = pt.Grid(64, 64, ((-4.5, -4.5), (4.5, 4.5)), "triangle", device=device)
        s = pt.WeakDirichletPoisson(g, mode="bg", detection_degree=1, single_layer_cut=True)
        s.setup(flower.levelset, flower.source_term, detection_levelset=flower.detection_levelset)
    else:
        g = pt.Grid(40, 40, ((-1.0, -1.0), (1.0, 1.0)), "triangle", device=device)
        s = pt.RobinPoisson(g, detection_degree=1, levelset_degree=2)
        s.setup(rsq.levelset, rsq.source_term, rsq.robin_data, detection_levelset=rsq.detection_levelset)
    s.assemble()
    return s.op.lattice_form()


def _random_x(top, dt, device, seed=0):
    rng = np.random.default_rng(seed)
    return {sp.name: torch.as_tensor(
        rng.standard_normal((sp.shape[0] * sp.shape[1] * sp.nblocks,) + sp.vshape), dtype=dt, device=device)
        for sp in top.specs}


def _check_against_plain(top, W, x, dt):
    yk = cuda_taps.tap_matvec(top, W, x)
    torch.cuda.synchronize()
    yr = cuda_taps.tap_matvec_ref(top, W, x)
    empty = _empty_tiles(top)
    for k in yr:
        assert yk[k].shape == yr[k].shape and yk[k].dtype == dt
        assert _rel(yk[k], yr[k]) <= TOL[dt], k
        assert torch.all(yk[k].cpu()[empty[k]] == 0), k
    return yk


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize(
    "fields", ["u", "uy", "up", "yp", "uyp"], ids=["P1-P1", "P1-vecP1", "P1-DG0", "vecP1-DG0", "all"]
)
@pytest.mark.parametrize("ct", ["triangle", "quadrilateral"])
def test_kernel_matches_plain(cuda, ct, fields, dt):
    top, x = random_tap_operator(37, 23, ct, dt, cuda, fields=fields)
    before = cuda_taps.launches
    yk = cuda_taps.tap_matvec(top, top.W, x)
    torch.cuda.synchronize()
    assert cuda_taps.launches == before + 1
    yr = cuda_taps.tap_matvec_ref(top, top.W, x)
    for k in yr:
        assert yk[k].shape == yr[k].shape and yk[k].dtype == dt
        assert _rel(yk[k], yr[k]) <= TOL[dt], k


@pytest.mark.cuda
def test_scheme_matvec_on_the_card_matches_the_cpu(cuda):
    """S4 on the card (taps through the kernel, bulk through the stencil
    kernel) against the same scheme on the CPU (plain versions)."""
    from phifem_tpu_torch.models import robin_square as rsq

    out = {}
    before = cuda_taps.launches
    for dev in ("cpu", cuda):
        g = pt.Grid(40, 40, ((-1.0, -1.0), (1.0, 1.0)), "triangle", device=dev)
        s = pt.RobinPoisson(g, detection_degree=1, levelset_degree=2)
        s.setup(rsq.levelset, rsq.source_term, rsq.robin_data, detection_levelset=rsq.detection_levelset).assemble()
        rng = np.random.default_rng(0)
        x = {k: torch.as_tensor(rng.standard_normal(v.shape), device=dev) for k, v in s.b.items()}
        out[str(dev)] = s.op.lattice_form().make_matvec(s.op)(x)
    assert cuda_taps.launches == before + 1
    for k, v in out["cpu"].items():
        assert _rel(out["cuda"][k].cpu(), v) <= 1e-12, k


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    top, x = random_tap_operator(6, 5, "triangle", torch.float64, cuda)
    with pytest.raises(ValueError, match="must be on"):
        cuda_taps.tap_matvec(top, top.W, {k: v.float() for k, v in x.items()})
    with pytest.raises(ValueError, match="shape"):
        cuda_taps.tap_matvec(top, top.W, {k: v[:-1] for k, v in x.items()})
    with pytest.raises(ValueError, match="flat weight buffer"):
        cuda_taps.tap_matvec(top, top.W[:-1], x)
    with pytest.raises(TypeError):
        cuda_taps.tap_matvec(top, top.W.half(), x)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("name", ["s1", "s4"], ids=["S1-flower-n64", "S4-n40"])
def test_kernel_matches_plain_on_schemes(cuda, name, dt):
    top = _scheme_tap_form(name, cuda)
    assert top.support is not None and cuda_taps.active_tile_fraction(top) < 1.0
    _check_against_plain(top, top.W.to(dt), _random_x(top, dt, cuda), dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("ct", ["triangle", "quadrilateral"])
def test_kernel_matches_plain_on_sparse_support(cuda, ct, dt):
    """Empty tiles, whole empty rows of tiles, ragged edges (37 x 23) and a
    target block without taps: zeros there, the plain version elsewhere."""
    top, x = sparse_tap_operator(37, 23, ct, dt, cuda)
    _check_against_plain(top, top.W, x, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", [c[0] for c in FOUR_CHANNEL_PAIRS])
def test_kernel_matches_plain_four_channels(cuda, case, dt):
    """Block pairs with tensor P1 (4-channel) blocks, every offset in
    [-2, 2]^2, ragged 37 x 23 lattices."""
    _, fields, chans = next(c for c in FOUR_CHANNEL_PAIRS if c[0] == case)
    top, x = random_tap_operator(37, 23, "triangle", dt, cuda, fields=fields, chans=chans)
    _check_against_plain(top, top.W, x, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("name", ["s5_16", "s5_33"], ids=["S5-n16", "S5-n33"])
def test_kernel_matches_plain_on_s5(cuda, name, dt):
    """S5's own tap form (five blocks of 2 / 2 / 4 / 4 / 2 channels, pad 2;
    n=33 is odd and not a tile multiple); the same bits on two calls."""
    top = _scheme_tap_form(name, cuda)
    assert top.blk_ch == [2, 2, 4, 4, 2]
    W, x = top.W.to(dt), _random_x(top, dt, cuda, seed=7)
    y1 = _check_against_plain(top, W, x, dt)
    y2 = cuda_taps.tap_matvec(top, W, x)
    for k in y1:
        assert torch.equal(y1[k], y2[k]), k


@pytest.mark.cuda
def test_s1_matvec_same_bits_twice(cuda):
    top = _scheme_tap_form("s1", cuda)
    x = _random_x(top, torch.float64, cuda, seed=3)
    y1 = cuda_taps.tap_matvec(top, top.W, x)
    y2 = cuda_taps.tap_matvec(top, top.W, x)
    for k in y1:
        assert torch.equal(y1[k], y2[k]), k
