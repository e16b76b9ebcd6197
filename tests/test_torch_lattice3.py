"""Port parity of the 3D lattice multigrid and box Poisson 3D against the JAX
package (``phifem_tpu.ops.lattice3``, ``phifem_tpu.models.poisson3``).

Tolerances: the host element matrix and stencil, the shifted-slice
convolution and the transfers 1e-13 (the same sums); one V-cycle in float64,
masked and unmasked, 1e-12; the box-Poisson solves |Δit| <= 2 and u to 1e-8
(the port's CG dots are float64, JAX's float32)."""

import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import phifem_tpu as pf  # noqa: E402
from phifem_tpu.models.poisson3 import BoxPoisson3 as JBoxPoisson3  # noqa: E402
from phifem_tpu.ops import lattice3 as jl  # noqa: E402
import phifem_tpu_torch as pt  # noqa: E402
from phifem_tpu_torch.ops import lattice3 as tl  # noqa: E402
from phifem_tpu_torch.utils.convert import lattice3_mg_from_numpy  # noqa: E402
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)


def _rel(a, b) -> float:
    a = a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize("h", [(0.1, 0.1, 0.1), (0.3, 0.2, 0.25)])
@pytest.mark.parametrize("coef", [(1.0, 0.0), (0.0, 1.0), (2.0, 3.0)], ids=["stiffness", "mass", "mixed"])
def test_element_matrix_and_stencil_match_jax(h, coef):
    Aj = jl.hex_element_matrix(*h, stiffness=coef[0], mass=coef[1])
    At = tl.hex_element_matrix(*h, stiffness=coef[0], mass=coef[1])
    assert _rel(At, Aj) <= 1e-13
    wj, wt = jl.vertex_stencil_weights3(Aj), tl.vertex_stencil_weights3(At)
    assert _rel(wt, wj) <= 1e-13
    assert tl._terms3(wt) == jl._terms3(wj)


@pytest.mark.parametrize("shape", [(5, 7, 9), (9, 9, 9), (3, 5, 4)], ids=lambda s: "x".join(map(str, s)))
def test_conv_and_transfers_match_jax(shape):
    rng = np.random.default_rng(sum(shape))
    D, R, C = shape
    terms = jl._terms3(jl.vertex_stencil_weights3(jl.hex_element_matrix(0.2, 0.3, 0.4, 1.0, 0.5)))
    xp = rng.standard_normal((D + 2, R + 2, C + 2))
    conv = tl._conv_interior3(torch.as_tensor(xp), terms, D, R, C)
    assert _rel(conv, jl._conv_interior3(jnp.asarray(xp), terms, D, R, C)) <= 1e-13
    if D % 2 and R % 2 and C % 2:
        Dc, Rc, Cc = (D + 1) // 2, (R + 1) // 2, (C + 1) // 2
        r_int = rng.standard_normal((D - 2, R - 2, C - 2))
        rj = jl._restrict3(jnp.asarray(r_int), Dc, Rc, Cc)
        assert _rel(tl._restrict3(torch.as_tensor(r_int), Dc, Rc, Cc), rj) <= 1e-13
        ec = rng.standard_normal((Dc + 2, Rc + 2, Cc + 2))
        pj = jl._prolong3(jnp.asarray(ec), Dc, Rc, Cc)
        assert _rel(tl._prolong3(torch.as_tensor(ec), Dc, Rc, Cc), pj) <= 1e-13


def test_coarse_inverse_and_mask_coarsening_match_jax():
    rng = np.random.default_rng(3)
    terms = jl._terms3(jl.vertex_stencil_weights3(jl.hex_element_matrix(0.5, 0.5, 0.5)))
    mask = rng.random((7, 6, 5)) < 0.7
    for m in (None, mask):
        assert _rel(tl._dense_coarse_inv3(terms, 7, 6, 5, m), jl._dense_coarse_inv3(terms, 7, 6, 5, m)) <= 1e-12
    assert np.array_equal(tl._coarsen_mask3(mask), jl._coarsen_mask3(mask))


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_vcycle_application_matches_jax(masked):
    """One Lattice3MG application in float64: the port's own build (level
    stencils, masks) and the tables carried across from JAX's build, both
    against JAX's cycle."""
    n = 16
    rng = np.random.default_rng(7)
    mask = None
    if masked:
        mask = np.zeros((n + 1,) * 3, bool)
        mask[2:-2, 1:-3, 3:-1] = rng.random((n - 3, n - 3, n - 3)) < 0.85
    kw = dict(stiffness=1.0, mass=0.5, min_n=4, mask=mask)
    jmg = jl.build_lattice3_mg(n, n, n, (0.1, 0.1, 0.1), dtype=jnp.float64, **kw)
    tmg = tl.build_lattice3_mg(n, n, n, (0.1, 0.1, 0.1), dtype=torch.float64, device="cpu", **kw)
    assert [(l.D, l.R, l.C, l.terms) for l in tmg.levels] == [(l.D, l.R, l.C, l.terms) for l in jmg.levels]
    assert _rel(tmg.coarse_inv, jmg.coarse_inv) <= 1e-12
    carried = lattice3_mg_from_numpy(
        [(l.D, l.R, l.C, l.terms) for l in jmg.levels], np.asarray(jmg.coarse_inv),
        None if jmg.masks is None else [np.asarray(m) for m in jmg.masks], torch.float64, device="cpu",
    )
    bp = np.zeros((n + 3,) * 3)
    bp[2:-2, 2:-2, 2:-2] = rng.standard_normal((n - 1,) * 3)
    zj = np.asarray(jmg(jnp.asarray(bp)))
    for mg in (tmg, carried):
        assert _rel(mg(torch.as_tensor(bp)), zj) <= 1e-12


def _uex_j(x):
    return jnp.sin(jnp.pi * x[..., 0]) * jnp.sin(jnp.pi * x[..., 1]) * jnp.sin(jnp.pi * x[..., 2]) + x[..., 0]


def _uex_t(x):
    return torch.sin(math.pi * x[..., 0]) * torch.sin(math.pi * x[..., 1]) * torch.sin(math.pi * x[..., 2]) + x[..., 0]


@pytest.mark.parametrize("n", [16, 32])
def test_box_poisson3_matches_jax(n):
    fj = lambda x: 3 * jnp.pi**2 * (_uex_j(x) - x[..., 0])
    ft = lambda x: 3 * math.pi**2 * (_uex_t(x) - x[..., 0])
    sj = JBoxPoisson3(pf.Grid3(n, n, n)).setup(fj, _uex_j).assemble()
    st = pt.BoxPoisson3(pt.Grid3(n, n, n, device="cpu")).setup(ft, _uex_t).assemble()
    assert _rel(st.b_lat, sj.b_lat) <= 1e-13
    rj, rt = sj.solve_lattice(tol=1e-10), st.solve_lattice(tol=1e-10)
    assert rt.converged and rt.residual <= 1e-10
    assert abs(rt.iterations - rj.iterations) <= 2, (rt.iterations, rj.iterations)
    assert _rel(st.u_lat, sj.u_lat) <= 1e-8
    exact = _uex_t(torch.stack(torch.broadcast_tensors(*st.grid.vertex_coords_lattice()), -1))
    assert float((st.u_lat - exact).abs().max()) <= 5.0 / n**2


def test_box_poisson3_helmholtz_float32_cycle():
    """alpha (-Δ) + beta I with a float32 V-cycle inside the float64 CG."""
    n = 16
    ft = lambda x: (3 * math.pi**2 * 2.0 + 1.5) * (_uex_t(x) - x[..., 0]) + 1.5 * x[..., 0]
    fj = lambda x: (3 * jnp.pi**2 * 2.0 + 1.5) * (_uex_j(x) - x[..., 0]) + 1.5 * x[..., 0]
    sj = JBoxPoisson3(pf.Grid3(n, n, n), alpha=2.0, beta=1.5).setup(fj, _uex_j).assemble()
    st = pt.BoxPoisson3(pt.Grid3(n, n, n, device="cpu"), alpha=2.0, beta=1.5).setup(ft, _uex_t).assemble()
    rj, rt = sj.solve_lattice(), st.solve_lattice()
    assert rt.converged and abs(rt.iterations - rj.iterations) <= 2
    assert _rel(st.u_lat, sj.u_lat) <= 1e-8
