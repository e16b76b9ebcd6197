"""The plain versions of the two 3D kernels against the JAX package, and the
hand-written CUDA kernels against their plain versions.

* the masked hex-cell stencil (``ops/cuda_hex3.py``) against
  ``WeakDirichletPoisson3._masked_stencil_apply`` at odd lattices and every
  degree (1e-13 relative to max|y|: the sums are the same, in the same
  order);
* the 27-point lattice sweep (``ops/cuda_lattice3.py``) against JAX's
  ``_conv_interior3`` and the sweeps of ``Lattice3MG`` built on it, in its
  three modes (1e-14).

The card cases carry the ``cuda`` marker and skip where there is no CUDA
device; on a machine with an NVIDIA Hopper card run them with
``python -m pytest tests/test_torch_hex3_kernels.py -q -m cuda`` (the JAX
cases then skip: JAX is imported only inside them).  Kernel and plain version
round every product and sum on their own, so they agree to the bit up to the
sign of a zero; the stated tolerances (1e-13 f64, 1e-5 f32, relative to
max|y|) are the acceptance bound.
"""

import numpy as np
import pytest
import torch

from phifem_tpu_torch.ops import cuda_hex3, cuda_lattice3
from phifem_tpu_torch.ops.lattice3 import _terms3, hex_element_matrix, vertex_stencil_weights3
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

HEX_SHAPES = [(3, 4, 5), (7, 5, 6), (1, 1, 1), (9, 2, 4)]  # (nz, ny, nx)
LATTICE_SHAPES = [(5, 6, 7), (3, 3, 3), (9, 17, 11)]  # padded logical (D, R, C)
TOL = {torch.float32: 1e-5, torch.float64: 1e-13}
# the kernels' tilings at risky sizes: sides smaller than a tile, ragged,
# exact multiples of a tile (hex3: 12 cells; lattice3: a 16 x 8 x 64 padded array)
HEX_RAGGED = [(3, 4, 3), (5, 5, 5), (12, 12, 12), (13, 7, 9)]
LATTICE_RAGGED = [(3, 5, 4), (37, 37, 37), (14, 6, 62)]


@pytest.fixture
def jnp():
    return pytest.importorskip("jax.numpy")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _hex_inputs(shape, degree, seed=0, density=0.6):
    rng = np.random.default_rng(seed)
    nz, ny, nx = shape
    nodes = (degree * nz + 1, degree * ny + 1, degree * nx + 1)
    nloc = (degree + 1) ** 3
    x = rng.standard_normal(nodes)
    mask = (rng.random(shape) < density).astype(np.float64)
    A = rng.standard_normal((nloc, nloc))
    return x, mask, A


def _sweep_inputs(shape, seed=0, masked=True):
    rng = np.random.default_rng(seed)
    D, R, C = shape
    x = np.zeros((D + 2, R + 2, C + 2))
    x[2:D, 2:R, 2:C] = rng.standard_normal((D - 2, R - 2, C - 2))
    b = np.zeros_like(x)
    b[2:D, 2:R, 2:C] = rng.standard_normal((D - 2, R - 2, C - 2))
    mask = (rng.random(shape) < 0.7).astype(np.float64) if masked else None
    terms = _terms3(vertex_stencil_weights3(hex_element_matrix(0.3, 0.2, 0.25, stiffness=1.0, mass=2.0)))
    return x, b, mask, terms


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


# -------------------------------------------------- plain versions vs JAX
@pytest.mark.parametrize("degree", [1, 2, 3])
@pytest.mark.parametrize("shape", HEX_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_hex_stencil3_plain_matches_jax(jnp, shape, degree):
    from phifem_tpu.models.weak_dirichlet3 import WeakDirichletPoisson3

    x, mask, A = _hex_inputs(shape, degree, seed=sum(shape) + degree)
    s = WeakDirichletPoisson3(None, degree=degree)  # the slice loop reads only the degree
    yj = np.asarray(s._masked_stencil_apply(jnp.asarray(x), jnp.asarray(A), jnp.asarray(mask)))
    yt = cuda_hex3.hex_stencil3(torch.as_tensor(x), torch.as_tensor(mask), torch.as_tensor(A), degree)
    assert _rel(yt.numpy(), yj) <= 1e-13


def test_hex_stencil3_rejects_bad_inputs():
    x, mask, A = _hex_inputs((2, 2, 2), 1)
    with pytest.raises(ValueError):
        cuda_hex3.hex_stencil3(torch.as_tensor(x, device="meta"), torch.as_tensor(mask), torch.as_tensor(A), 1)


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "maskless"])
@pytest.mark.parametrize("shape", LATTICE_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_lattice3_sweep_plain_matches_jax(jnp, shape, masked):
    from phifem_tpu.ops import lattice3 as jl

    x, b, mask, terms = _sweep_inputs(shape, seed=sum(shape), masked=masked)
    D, R, C = shape
    conv = np.asarray(jl._conv_interior3(jnp.asarray(x), terms, D, R, C))
    xt, bt = torch.as_tensor(x), torch.as_tensor(b)
    mt = None if mask is None else torch.as_tensor(mask)
    m_int = 1.0 if mask is None else mask[1 : D - 1, 1 : R - 1, 1 : C - 1]
    out = cuda_lattice3.lattice3_sweep(cuda_lattice3.MATVEC, xt, terms).numpy()
    assert _rel(out[2:D, 2:R, 2:C], conv) <= 1e-14
    assert not out[[0, 1, -2, -1]].any()
    res = cuda_lattice3.lattice3_sweep(cuda_lattice3.RESIDUAL, xt, terms, bt, mt).numpy()
    assert _rel(res[2:D, 2:R, 2:C], (b[2:D, 2:R, 2:C] - conv) * m_int) <= 1e-14
    # the Jacobi sweep is JAX's Lattice3MG._smooth, one sweep, on level 0
    od = 0.8 / next(w for a, bb, c, w in terms if (a, bb, c) == (1, 1, 1))
    levels = [jl._Level3(D, R, C, tuple(terms))]
    jmg = jl.Lattice3MG(levels, None, dtype=jnp.float64, masks=None if mask is None else [jnp.asarray(mask)])
    xj = np.asarray(jmg._smooth(jnp.asarray(x), jnp.asarray(b), levels[0], 0, 1))
    jac = cuda_lattice3.lattice3_sweep(cuda_lattice3.JACOBI, xt, terms, bt, mt, od).numpy()
    assert _rel(jac, xj) <= 1e-14


def test_lattice3_sweep_rejects_bad_inputs():
    x, b, mask, terms = _sweep_inputs((4, 4, 4))
    with pytest.raises(ValueError):
        cuda_lattice3.lattice3_sweep(cuda_lattice3.RESIDUAL, torch.as_tensor(x), terms)
    with pytest.raises(ValueError):
        cuda_lattice3.lattice3_sweep(7, torch.as_tensor(x), terms)
    with pytest.raises(ValueError):
        cuda_lattice3.pack_terms([])


# ------------------------------------------------ kernels vs plain (card)
@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("degree", [1, 2, 3])
@pytest.mark.parametrize("shape", HEX_SHAPES + [(37, 37, 37)] + HEX_RAGGED, ids=lambda s: "x".join(map(str, s)))
def test_hex_stencil3_kernel_matches_plain(cuda, shape, degree, dt):
    x, mask, A = _hex_inputs(shape, degree, seed=sum(shape) + degree)
    xt, mt, At = (torch.as_tensor(v, dtype=dt, device=cuda).contiguous() for v in (x, mask, A))
    before = cuda_hex3.launches
    yk = cuda_hex3.hex_stencil3(xt, mt, At, degree)
    torch.cuda.synchronize()
    assert cuda_hex3.launches == before + 1
    yr = cuda_hex3.hex_stencil3_ref(xt, mt, At, degree)
    assert float((yk - yr).abs().max()) <= TOL[dt] * float(yr.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("mode", [0, 1, 2], ids=["matvec", "residual", "jacobi"])
@pytest.mark.parametrize("masked", [True, False], ids=["masked", "maskless"])
@pytest.mark.parametrize("shape", LATTICE_SHAPES + [(129, 65, 33)] + LATTICE_RAGGED,
                         ids=lambda s: "x".join(map(str, s)))
def test_lattice3_sweep_kernel_matches_plain(cuda, shape, masked, mode, dt):
    x, b, mask, terms = _sweep_inputs(shape, seed=sum(shape), masked=masked)
    xt, bt = (torch.as_tensor(v, dtype=dt, device=cuda) for v in (x, b))
    mt = None if mask is None else torch.as_tensor(mask, dtype=dt, device=cuda)
    od = 0.8 / next(w for a, bb, c, w in terms if (a, bb, c) == (1, 1, 1))
    before = cuda_lattice3.launches
    yk = cuda_lattice3.lattice3_sweep(mode, xt, terms, bt, mt, od)
    torch.cuda.synchronize()
    assert cuda_lattice3.launches == before + 1
    yr = cuda_lattice3.lattice3_sweep_ref(mode, xt, terms, bt, mt, od)
    assert float((yk - yr).abs().max()) <= TOL[dt] * float(yr.abs().max())
