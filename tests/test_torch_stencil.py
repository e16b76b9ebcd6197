"""Port parity: the P1 cell-stencil matvec.  The port's plain version
(``stencil_matvec_ref``, which ``stencil_matvec`` runs for CPU tensors) and
``StencilCellBatch.matvec_into/diagonal_into`` against the JAX package's
Pallas kernel (interpret mode) and its XLA stencil, 20x12 grids, float64,
atol 1e-12."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import phifem_tpu as pf  # noqa: E402
from phifem_tpu.assembly import CellTerm, System, assemble_operator  # noqa: E402
from phifem_tpu.ops.pallas_stencil import stencil_matvec_pallas  # noqa: E402
import phifem_tpu_torch as pt  # noqa: E402
from phifem_tpu_torch.ops import cuda_stencil  # noqa: E402
from phifem_tpu_torch.utils.convert import stencil_batch_from_numpy  # noqa: E402

BBOX = ((-1.0, -1.0), (1.0, 1.0))


def _bulk(u, v, d, x, ctx):
    return jnp.dot(u["u"].grad, v["u"].grad) + u["u"].val * v["u"].val


def _jax_batch(ct, masked):
    g = pf.Grid(20, 12, BBOX, ct)
    tags = None
    region = None
    if masked:
        tags = pf.tag_cells(g, lambda x: x[..., 0] ** 2 + x[..., 1] ** 2 - 0.3, 1)
        region = (1, 2)
    op = assemble_operator(
        System({"u": pf.Space.lagrange(g, 1)}), g,
        cell_terms=[(CellTerm(_bulk, region, degree=2, uniform=True), {})],
        cell_tags=tags,
    )
    (batch,) = op.batches
    assert (batch.masks is None) == (not masked)
    return g, batch


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "maskless"])
@pytest.mark.parametrize("ct", ["triangle", "quadrilateral"])
def test_matvec_matches_jax(ct, masked):
    gj, bj = _jax_batch(ct, masked)
    gt = pt.Grid(20, 12, BBOX, ct)
    masks = None if bj.masks is None else np.asarray(bj.masks)
    bt = stencil_batch_from_numpy(gt, "u", np.asarray(bj.matrices), masks)
    rng = np.random.default_rng(3)
    x = rng.standard_normal(gj.num_vertices)
    y0 = rng.standard_normal(gj.num_vertices)

    y_pl = np.asarray(stencil_matvec_pallas(
        gj, jnp.asarray(x), bj.masks, bj.matrices, TY=8, interpret=True))
    y_xla = np.asarray(bj.matvec_into({"u": jnp.asarray(x)}, {"u": jnp.asarray(y0)})["u"])

    y_ref = cuda_stencil.stencil_matvec_ref(gt, torch.as_tensor(x), bt.masks, bt.matrices)
    np.testing.assert_allclose(y_ref.numpy(), y_pl, rtol=0, atol=1e-12)
    # matvec_into accumulates into y, as the JAX batch does
    y_t = bt.matvec_into({"u": torch.as_tensor(x)}, {"u": torch.as_tensor(y0.copy())})["u"]
    np.testing.assert_allclose(y_t.numpy(), y_xla, rtol=0, atol=1e-12)

    d_j = np.asarray(bj.diagonal_into({"u": jnp.asarray(y0)})["u"])
    d_t = bt.diagonal_into({"u": torch.as_tensor(y0.copy())})["u"]
    np.testing.assert_allclose(d_t.numpy(), d_j, rtol=0, atol=1e-12)


@pytest.mark.parametrize("ct", ["triangle", "quadrilateral"])
def test_maskless_equals_all_ones_mask(ct):
    """The maskless branch must not let padded 'cells' leak at the lattice
    boundary: it equals the masked branch with all-ones masks."""
    g = pt.Grid(20, 12, BBOX, ct)
    rng = np.random.default_rng(7)
    nl = g.num_vertices_per_cell
    mats = torch.as_tensor(rng.standard_normal((g.num_orientations, nl, nl)))
    x = torch.as_tensor(rng.standard_normal(g.num_vertices))
    ones = torch.ones((g.num_orientations, g.ny, g.nx), dtype=torch.float64)
    y_full = cuda_stencil.stencil_matvec(g, x, None, mats)
    y_ones = cuda_stencil.stencil_matvec(g, x, ones, mats)
    np.testing.assert_allclose(y_full.numpy(), y_ones.numpy(), rtol=0, atol=1e-12)


def test_batch_packs_its_matrices_for_the_kernel():
    """A batch holds the kernel's float64 row-major form of its matrices,
    repacked when a copy is cast (the float32 cycle's batches)."""
    g = pt.Grid(5, 4)
    mats = np.random.default_rng(5).standard_normal((2, 3, 3))
    b = stencil_batch_from_numpy(g, "u", mats, None)
    assert b.packed.dtype == np.float64 and b.packed.flags.c_contiguous
    np.testing.assert_array_equal(b.packed, mats.reshape(-1))
    b32 = b.astype(torch.float32)
    np.testing.assert_array_equal(b32.packed, mats.astype(np.float32).reshape(-1))
    with pytest.raises(ValueError, match="shape"):
        cuda_stencil.pack_matrices(g, torch.zeros(1, 4, 4))


def test_non_cpu_non_cuda_device_raises():
    g = pt.Grid(3, 2)
    x = torch.zeros(g.num_vertices, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        cuda_stencil.stencil_matvec(g, x, None, torch.zeros(2, 3, 3))
