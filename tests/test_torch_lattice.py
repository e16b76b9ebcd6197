"""Port parity: lattice multigrid (ops.lattice) and the flat-vector grid
transfers (mg.prolong/restrict) against the JAX package."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import phifem_tpu as pf  # noqa: E402
import phifem_tpu.mg as jmg  # noqa: E402
import phifem_tpu.ops.lattice as jl  # noqa: E402
import phifem_tpu_torch as pt  # noqa: E402
import phifem_tpu_torch.mg as tmg  # noqa: E402
import phifem_tpu_torch.ops.lattice as tl  # noqa: E402
from phifem_tpu_torch.utils.convert import lattice_mg_from_numpy  # noqa: E402
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

# triangle P1 stiffness stencil (5-point) plus a mass-like diagonal coupling
W = np.array([[0.0, -1.0, 0.1], [-1.0, 4.2, -1.0], [0.1, -1.0, 0.0]])


def test_restrict_prolong_exact():
    rng = np.random.default_rng(1)
    Rc, Cc = 9, 7
    R, C = 2 * Rc - 1, 2 * Cc - 1
    ec = np.zeros((Rc + 2, Cc + 2))
    ec[2:Rc, 2:Cc] = rng.standard_normal((Rc - 2, Cc - 2))
    rf = rng.standard_normal((R - 2, C - 2))
    np.testing.assert_array_equal(
        tl._prolong(torch.as_tensor(ec), Rc, Cc).numpy(),
        np.asarray(jl._prolong(jnp.asarray(ec), Rc, Cc)),
    )
    np.testing.assert_array_equal(
        tl._restrict(torch.as_tensor(rf), Rc, Cc).numpy(),
        np.asarray(jl._restrict(jnp.asarray(rf), Rc, Cc)),
    )


@pytest.mark.parametrize("ct", ["triangle", "quadrilateral"])
def test_flat_transfers_exact(ct):
    gcj, gct = pf.Grid(5, 4, cell_type=ct), pt.Grid(5, 4, cell_type=ct, device="cpu")
    gfj, gft = gcj.refine(), gct.refine()
    rng = np.random.default_rng(2)
    c = rng.standard_normal(gcj.num_vertices)
    f = rng.standard_normal(gfj.num_vertices)
    np.testing.assert_array_equal(
        tmg.prolong(torch.as_tensor(c), gct, gft).numpy(),
        np.asarray(jmg.prolong(jnp.asarray(c), gcj, gfj)),
    )
    np.testing.assert_allclose(
        tmg.restrict(torch.as_tensor(f), gft, gct).numpy(),
        np.asarray(jmg.restrict(jnp.asarray(f), gfj, gcj)),
        rtol=0, atol=1e-14,
    )


def test_build_matches():
    mj = jl.build_lattice_mg(64, 48, W, min_n=8, dtype=jnp.float64)
    mt = tl.build_lattice_mg(64, 48, W, min_n=8, dtype=torch.float64, device="cpu")
    assert [(l.R, l.C) for l in mt.levels] == [(l.R, l.C) for l in mj.levels]
    assert mt.terms == mj.terms
    np.testing.assert_allclose(mt.coarse_inv.numpy(), np.asarray(mj.coarse_inv), rtol=0, atol=1e-12)


@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
def test_vcycle_application_f32(masked):
    """One LatticeMG application in float32, the port's cycle built from the
    JAX cycle's state through convert.py, to 1e-5 relative."""
    nx, ny = 64, 48
    mask = None
    if masked:
        yy, xx = np.mgrid[0 : ny + 1, 0 : nx + 1]
        mask = (xx - nx / 2) ** 2 + (yy - ny / 2) ** 2 < (0.4 * ny) ** 2
    mj = jl.build_lattice_mg(nx, ny, W, min_n=8, dtype=jnp.float32, mask=mask)
    mt = lattice_mg_from_numpy(
        [(l.R, l.C) for l in mj.levels], mj.terms, np.asarray(mj.coarse_inv),
        None if mj.masks is None else [np.asarray(m) for m in mj.masks], torch.float32,
        device="cpu",
    )
    rng = np.random.default_rng(4)
    R, C = ny + 1, nx + 1
    bp = np.zeros((R + 2, C + 2))
    bp[2:R, 2:C] = rng.standard_normal((R - 2, C - 2))
    zj = np.asarray(mj(jnp.asarray(bp)))
    zt = mt(torch.as_tensor(bp)).numpy()
    assert zt.dtype == np.float64
    assert np.abs(zt - zj).max() <= 1e-5 * np.abs(zj).max()


def test_lattice_cg_matches():
    """lattice_cg (float64 dots here, float32 in JAX) on a random RHS."""
    nx = ny = 32
    mj = jl.build_lattice_mg(nx, ny, W, min_n=8, dtype=jnp.float32)
    mt = tl.build_lattice_mg(nx, ny, W, min_n=8, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(6)
    bp = np.zeros((ny + 3, nx + 3))
    bp[2 : ny + 1, 2 : nx + 1] = rng.standard_normal((ny - 1, nx - 1))
    xj, relj, itj = jl.lattice_cg(mj, jnp.asarray(bp), tol=1e-10, maxiter=40)
    xt, relt, itt = tl.lattice_cg(mt, torch.as_tensor(bp), tol=1e-10, maxiter=40)
    assert relt <= 1e-10 and abs(itt - int(itj)) <= 2
    xj = np.asarray(xj)
    assert np.abs(xt.numpy() - xj).max() <= 1e-8 * np.abs(xj).max()
    # warm start from the converged iterate: no iteration needed
    _, _, it0 = tl.lattice_cg(mt, torch.as_tensor(bp), tol=1e-9, maxiter=40, x0=xt)
    assert it0 == 0
