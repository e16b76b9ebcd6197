"""The 3-channel block forms of the two 3D kernels: their plain versions
against the JAX package, and the hand-written CUDA kernels against their
plain versions.

* the block hex-cell stencil (``ops/cuda_hex3.py: hex_block_stencil3``)
  against S5-3D's ``_masked_block_stencil_apply`` (1e-13 relative to
  max|y|: the same sums);
* the block lattice sweep (``ops/cuda_lattice3.py: lattice3_block_sweep``):
  its plain version is held against JAX in ``tests/test_torch_lattice3_block
  .py``; here the argument checks.

The card cases carry the ``cuda`` marker and skip where there is no CUDA
device; on a machine with an NVIDIA Hopper card run them with
``python -m pytest tests/test_torch_block3_kernels.py -q -m cuda``.  Kernel
and plain version round every product and sum on their own in the same
order, so they agree to the bit up to the sign of a zero; the stated
tolerances (1e-13 f64, 1e-5 f32, relative to max|y|) are the acceptance
bound.  Sizes: odd and ragged, smaller than one CTA and exact multiples of
one; masks full, empty and random.
"""

import numpy as np
import pytest
import torch

from phifem_tpu_torch.ops import cuda_hex3, cuda_lattice3 as cl
from phifem_tpu_torch.ops.lattice3 import _block_terms3, block_vertex_stencil_weights3
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

# (nz, ny, nx): odd, one cell, ragged, a grid of one CTA, nodes an exact
# multiple of the default tiles (8 x 16 x 32), the tile walks' own shapes
HEX_SHAPES = [(3, 4, 5), (1, 1, 1), (7, 5, 6), (13, 7, 9), (16, 8, 16), (17, 9, 33), (2, 2, 2), (7, 15, 31),
              (9, 6, 20), (12, 12, 12)]
# logical (D, R, C): ragged, one interior node, an interior that is an exact
# multiple of the default tiles (32 x 8 x 16), no interior at all
LATTICE_SHAPES = [(5, 6, 7), (3, 3, 3), (9, 17, 11), (37, 37, 37), (14, 6, 62), (18, 10, 34), (1, 1, 1), (3, 5, 4),
                  (65, 33, 129)]
MASKS = ("random", "full", "empty")
TOL = {torch.float32: 1e-5, torch.float64: 1e-13}
DTS = [torch.float32, torch.float64]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _ids(s):
    return "x".join(map(str, s))


def _elasticity_K(h=(0.3, 0.25, 0.2)):
    from phifem_tpu_torch.models.interface_elasticity import lame
    from phifem_tpu_torch.models.interface_elasticity3 import _elastic_element_matrix

    return _elastic_element_matrix(*h, *lame(1.0, 0.3))


def _hex_inputs(shape, kind, seed):
    rng = np.random.default_rng(seed)
    nz, ny, nx = shape
    x = rng.standard_normal((3, nz + 1, ny + 1, nx + 1))
    mask = {"random": (rng.random(shape) < 0.5).astype(np.float64), "full": np.ones(shape),
            "empty": np.zeros(shape)}[kind]
    K = rng.standard_normal((24, 24))
    return x, mask, K


def _block_inputs(shape, seed, masked):
    rng = np.random.default_rng(seed)
    D, R, C = shape
    x = np.zeros((3, D + 2, R + 2, C + 2))
    b = np.zeros_like(x)
    if min(shape) > 2:  # an interior
        x[:, 2:D, 2:R, 2:C] = rng.standard_normal((3, D - 2, R - 2, C - 2))
        b[:, 2:D, 2:R, 2:C] = rng.standard_normal((3, D - 2, R - 2, C - 2))
    x[:, 0], x[:, :, -1] = 1.5, -2.5  # a shell that the Jacobi sweep keeps
    mask = (rng.random(shape) < 0.7).astype(np.float64) if masked else None
    terms = _block_terms3(block_vertex_stencil_weights3(_elasticity_K(), 3))
    dinv = np.linalg.inv(next(W for a, bb, c, W in terms if (a, bb, c) == (1, 1, 1)))
    return x, b, mask, cl.pack_block_terms(terms, dinv)


def _rel(a, b) -> float:
    """max|a - b| / max|b| in float64 (0 when both vanish)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    d = np.abs(a - b).max()
    return float(d / np.abs(b).max()) if d else 0.0


# -------------------------------------------------- plain versions (CPU)
@pytest.mark.parametrize("shape", HEX_SHAPES[:4], ids=_ids)
def test_hex_block_stencil3_plain_matches_jax(shape):
    jnp = pytest.importorskip("jax.numpy")
    from phifem_tpu.models.interface_elasticity3 import _masked_block_stencil_apply

    x, mask, K = _hex_inputs(shape, "random", seed=sum(shape))
    yj = np.asarray(_masked_block_stencil_apply(jnp.asarray(x), jnp.asarray(K), jnp.asarray(mask)))
    yt = cuda_hex3.hex_block_stencil3(torch.as_tensor(x), torch.as_tensor(mask), torch.as_tensor(K))
    assert _rel(yt.numpy(), yj) <= 1e-13


def test_block_kernels_reject_bad_inputs():
    x, mask, K = _hex_inputs((2, 2, 2), "full", 0)
    with pytest.raises(ValueError, match="no kernel"):
        cuda_hex3.hex_block_stencil3(torch.as_tensor(x, device="meta"), torch.as_tensor(mask), torch.as_tensor(K))
    xb, bb, _, packed = _block_inputs((4, 4, 4), 0, False)
    with pytest.raises(ValueError, match="need b"):
        cl.lattice3_block_sweep(cl.RESIDUAL, torch.as_tensor(xb), packed)
    with pytest.raises(ValueError, match="unknown mode"):
        cl.lattice3_block_sweep(7, torch.as_tensor(xb), packed)
    with pytest.raises(ValueError, match="dinv"):
        cl.lattice3_block_sweep(cl.JACOBI, torch.as_tensor(xb), cl.pack_block_terms(list(packed)), torch.as_tensor(bb))
    with pytest.raises(ValueError, match="no kernel"):
        cl.lattice3_block_sweep(cl.MATVEC, torch.as_tensor(xb, device="meta"), packed)


# ------------------------------------------------ kernels vs plain (card)
@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTS, ids=["f32", "f64"])
@pytest.mark.parametrize("kind", MASKS)
@pytest.mark.parametrize("shape", HEX_SHAPES, ids=_ids)
def test_hex_block_stencil3_kernel_matches_plain(cuda, shape, kind, dt):
    x, mask, K = _hex_inputs(shape, kind, seed=sum(shape))
    xt, mt, Kt = (torch.as_tensor(v, dtype=dt, device=cuda).contiguous() for v in (x, mask, K))
    before = cuda_hex3.block_launches
    yk = cuda_hex3.hex_block_stencil3(xt, mt, Kt)
    torch.cuda.synchronize()
    assert cuda_hex3.block_launches == before + 1
    yr = cuda_hex3.hex_block_stencil3_ref(xt, mt, Kt)
    if kind == "empty":
        assert not yk.any()
    else:
        assert _rel(yk.cpu().numpy(), yr.cpu().numpy()) <= TOL[dt]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTS, ids=["f32", "f64"])
@pytest.mark.parametrize("mode", ["matvec", "residual", "jacobi_masked", "jacobi"])
@pytest.mark.parametrize("shape", LATTICE_SHAPES, ids=_ids)
def test_lattice3_block_sweep_kernel_matches_plain(cuda, shape, mode, dt):
    md, masked = {"matvec": (cl.MATVEC, False), "residual": (cl.RESIDUAL, True),
                  "jacobi_masked": (cl.JACOBI, True), "jacobi": (cl.JACOBI, False)}[mode]
    x, b, mask, packed = _block_inputs(shape, sum(shape), masked)
    t = lambda a: None if a is None else torch.as_tensor(a, dtype=dt, device=cuda).contiguous()
    before = cl.block_launches
    yk = cl.lattice3_block_sweep(md, t(x), packed, t(b), t(mask), 0.6)
    torch.cuda.synchronize()
    assert cl.block_launches == before + 1
    yr = cl.lattice3_block_sweep_ref(md, t(x), packed, t(b), t(mask), 0.6)
    assert _rel(yk.cpu().numpy(), yr.cpu().numpy()) <= TOL[dt]


# block term sets with positions (oz, oy, ox) dropped, the centre kept: the
# kernel's instantiation with a branch per absent term
PARTIAL_TERMS = {"no_corners": lambda a, b, c: not {a, b, c} <= {0, 2},
                 "star": lambda a, b, c: sorted((a, b, c)) in ([1, 1, 1], [0, 1, 1], [1, 1, 2]),
                 "no_top_plane": lambda a, b, c: a != 2}


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTS, ids=["f32", "f64"])
@pytest.mark.parametrize("mode", ["matvec", "residual", "jacobi_masked", "jacobi"])
@pytest.mark.parametrize("terms", list(PARTIAL_TERMS))
@pytest.mark.parametrize("shape", LATTICE_SHAPES, ids=_ids)
def test_lattice3_block_sweep_kernel_partial_terms_match_plain(cuda, shape, terms, mode, dt):
    md, masked = {"matvec": (cl.MATVEC, False), "residual": (cl.RESIDUAL, True),
                  "jacobi_masked": (cl.JACOBI, True), "jacobi": (cl.JACOBI, False)}[mode]
    x, b, mask, full = _block_inputs(shape, sum(shape), masked)
    packed = cl.pack_block_terms([t for t in full if PARTIAL_TERMS[terms](*t[:3])], full.dinv)
    t = lambda a: None if a is None else torch.as_tensor(a, dtype=dt, device=cuda).contiguous()
    before = cl.block_launches
    yk = cl.lattice3_block_sweep(md, t(x), packed, t(b), t(mask), 0.6)
    torch.cuda.synchronize()
    assert cl.block_launches == before + 1
    assert torch.equal(yk, cl.lattice3_block_sweep_ref(md, t(x), packed, t(b), t(mask), 0.6))


@pytest.mark.cuda
def test_hex_block_stencil3_refuses_a_second_stream(cuda):
    """K lives in one constant array per device: a launch on another stream
    than the first one's raises instead of racing it."""
    x, mask, K = (torch.as_tensor(v, device=cuda) for v in _hex_inputs((3, 3, 3), "full", 0))
    cuda_hex3.hex_block_stencil3(x, mask, K)
    with torch.cuda.stream(torch.cuda.Stream()):
        with pytest.raises(RuntimeError, match="one stream"):
            cuda_hex3.hex_block_stencil3(x, mask, K)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_block_kernels_refuse_wrong_shapes(cuda):
    x, mask, K = _hex_inputs((3, 3, 3), "full", 0)
    with pytest.raises(ValueError):
        cuda_hex3.hex_block_stencil3(torch.as_tensor(x[:2], device=cuda), torch.as_tensor(mask, device=cuda),
                                     torch.as_tensor(K, device=cuda))
    xb, _, _, packed = _block_inputs((4, 4, 4), 0, False)
    with pytest.raises(ValueError):
        cl.lattice3_block_sweep(cl.MATVEC, torch.as_tensor(xb[:2], device=cuda).contiguous(), packed)
