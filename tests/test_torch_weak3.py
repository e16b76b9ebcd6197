"""Port parity of 3D tagging and the 3D weak-Dirichlet scheme (Q1-Q3)
against the JAX package (``phifem_tpu.tagging3``,
``phifem_tpu.models.weak_dirichlet3``), on the geometry of
``tests/test_weak_dirichlet3.py``: the sphere R0 = 0.7 in [-1, 1]^3,
u = sin x cos y e^{z/2}.

Tolerances: tags bit for bit; element tables, b, diag and one matvec 1e-12
relative to their max; the interface block's ids and RAS blocks equal, its
matrix 1e-12; one preconditioner application (float64 cycle) on tables
carried across from JAX 1e-10; BiCGStab counts within max(3, 0.25 it) of
JAX's (the port's Krylov and band-solve dots are float64, JAX's float32)
and u to 1e-8; the Q2 / Q3 sparse exactness L2 and H10 < 1e-9."""

import warnings

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import phifem_tpu as pf  # noqa: E402
from phifem_tpu.models import WeakDirichletPoisson3 as JWeak3  # noqa: E402
from phifem_tpu.tagging3 import compute_tags3 as jcompute_tags3  # noqa: E402
import phifem_tpu_torch as pt  # noqa: E402
from phifem_tpu_torch.tagging3 import compute_tags3  # noqa: E402
from phifem_tpu_torch.utils.convert import scheme3_data_from_numpy  # noqa: E402
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

R0 = 0.7
BOX = ((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0))


def phi(x):
    return x[..., 0] ** 2 + x[..., 1] ** 2 + x[..., 2] ** 2 - R0**2


def uex_j(x):
    return jnp.sin(x[..., 0]) * jnp.cos(x[..., 1]) * jnp.exp(0.5 * x[..., 2])


def uex_t(x):
    return torch.sin(x[..., 0]) * torch.cos(x[..., 1]) * torch.exp(0.5 * x[..., 2])


def _np(a):
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _rel(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


_PAIRS = {}


def _pair(n: int, degree: int = 1):
    """The same scheme assembled in both packages (built once per module)."""
    if (n, degree) not in _PAIRS:
        sj = JWeak3(pf.Grid3(n, n, n, BOX), degree=degree).setup(phi, lambda x: 1.75 * uex_j(x), u_D=uex_j)
        st = pt.WeakDirichletPoisson3(pt.Grid3(n, n, n, BOX, device="cpu"), degree=degree)
        st.setup(phi, lambda x: 1.75 * uex_t(x), u_D=uex_t)
        _PAIRS[n, degree] = (sj.assemble(), st.assemble())
    return _PAIRS[n, degree]


@pytest.mark.parametrize("n", [8, 12, 16])
def test_tags_bit_equal(n):
    tj = jcompute_tags3(pf.Grid3(n, n, n, BOX), phi)
    tt = compute_tags3(pt.Grid3(n, n, n, BOX, device="cpu"), phi)
    assert tt.cell_tags.dtype == np.int8 and np.array_equal(tt.cell_tags, tj.cell_tags)
    for ax in range(3):
        assert np.array_equal(tt.ghost_faces[ax], tj.ghost_faces[ax])
        for a, b in zip(tt.boundary_faces[ax], tj.boundary_faces[ax]):
            assert np.array_equal(a, b)
    for ax in range(3):
        for a, b in zip(tt.faces_between((1,), (2, 3))[ax], tj.faces_between((1,), (2, 3))[ax]):
            assert np.array_equal(a, b)
        assert np.array_equal(tt.jump_faces_between((1,), (2,))[ax], tj.jump_faces_between((1,), (2,))[ax])


def test_containment_warning():
    with pytest.warns(RuntimeWarning, match="containment"):
        compute_tags3(pt.Grid3(6, 6, 6, BOX, device="cpu"), phi)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        compute_tags3(pt.Grid3(8, 8, 8, BOX, device="cpu"), phi)


@pytest.mark.parametrize("degree", [1, 2, 3])
def test_assembly_and_matvec_match_jax(degree):
    sj, st = _pair(8, degree)
    for name in ("A8", "E_uu", "E_up", "E_pp", "bulk_mask", "phi_lat", "f_lat", "uD_lat"):
        assert _rel(getattr(st, name), getattr(sj, name)) <= 1e-12, name
    assert np.array_equal(_np(st.cut_dofs), _np(sj.cut_dofs))
    for fam in ("ghost", "bdry"):
        assert len(getattr(st, fam)) == len(getattr(sj, fam))
        for (dt_, Et), (dj, Ej) in zip(getattr(st, fam), getattr(sj, fam)):
            assert np.array_equal(_np(dt_), _np(dj))
            assert _rel(Et, Ej) <= 1e-12, fam
    for k in ("u", "p"):
        assert _rel(st.b[k], sj.b[k]) <= 1e-12
        assert _rel(st.diag[k], sj.diag[k]) <= 1e-12
        assert np.array_equal(_np(st.active[k]), _np(sj.active[k]))
    rng = np.random.default_rng(degree)
    x = {k: rng.standard_normal(st.b[k].numel()) for k in ("u", "p")}
    yt = st.matvec({k: torch.as_tensor(v) for k, v in x.items()})
    yj = sj.matvec({k: jnp.asarray(v) for k, v in x.items()})
    for k in ("u", "p"):
        assert _rel(yt[k], yj[k]) <= 1e-12


@pytest.mark.parametrize(
    "n, degree", [pytest.param(16, 1, id="16"), pytest.param(32, 1, id="32"), pytest.param(16, 2, id="16-q2")]
)
def test_interface_csr_matches_jax(n, degree):
    """Ids, CSR matrix and RAS blocks of the interface block; at Q2 n=16
    the band has 15,400 DoFs in 3,932 blocks of up to 54 (Schwarz)."""
    sj, st = _pair(n, degree)
    ids_j, A_j, blocks_j = sj._interface_csr()
    ids_t, A_t, bids_t = st._interface_csr()
    assert np.array_equal(ids_t, ids_j)
    assert A_t.shape == A_j.shape and np.array_equal(A_t.indptr, A_j.indptr)
    assert np.array_equal(A_t.indices, A_j.indices)
    assert _rel(A_t.data, A_j.data) <= 1e-12
    m = ids_j.shape[0]
    assert bids_t.shape[0] == len(blocks_j)
    K = max(b.size for b in blocks_j)
    want = np.full((len(blocks_j), K), m, np.int64)
    for i, b in enumerate(blocks_j):
        want[i, : b.size] = b
    assert np.array_equal(bids_t, want)


def _band_bicgstab_f64(mv, M, b, iters):
    """JAX's ``phifem_tpu.mg._band_bicgstab`` with float64 dots (JAX's own
    rounds them to float32), the port's choice."""
    dt = b.dtype
    dot = jnp.vdot
    safe = lambda d: jnp.where(jnp.abs(d) > 1e-300, d, jnp.asarray(1e-300, dt))
    zeros, one = jnp.zeros_like(b), jnp.asarray(1.0, dt)
    rhat = b

    def body(i, st):
        x, r, p, v, rho, alpha, omega, xb, rrb = st
        rho_new = dot(rhat, r)
        beta = jnp.where(i == 0, 0.0, (rho_new / safe(rho)) * (alpha / safe(omega)))
        p = r + beta * (p - omega * v)
        ph = M(p)
        v = mv(ph)
        alpha = rho_new / safe(dot(rhat, v))
        s = r - alpha * v
        sh = M(s)
        t = mv(sh)
        omega = dot(t, s) / safe(dot(t, t))
        x = x + alpha * ph + omega * sh
        r = s - omega * t
        rr = dot(r, r)
        better = jnp.logical_and(jnp.isfinite(rr), rr < rrb)
        return x, r, p, v, rho_new, alpha, omega, jnp.where(better, x, xb), jnp.where(better, rr, rrb)

    return jax.lax.fori_loop(0, int(iters), body, (zeros, b, zeros, zeros, one, one, one, zeros, dot(b, b)))[7]


def test_build_interface_block_matches_jax():
    """The generic block builder on the full Q1 system at n=8 (what the
    sparse direct path factors): ids, CSR matrix and RAS blocks."""
    from phifem_tpu.models.lattice_core import build_interface_block as jbuild
    from phifem_tpu_torch.models.lattice_core import build_interface_block

    sj, st = _pair(8)
    act = np.concatenate([_np(st.active["u"]), _np(st.active["p"])])
    ids_j, A_j, blocks_j = jbuild(sj._all_term_blocks(), act.shape[0], act)
    ids_t, A_t, bids_t = build_interface_block(st._all_term_blocks(), act.shape[0], act)
    assert np.array_equal(ids_t, ids_j)
    assert np.array_equal(A_t.indptr, A_j.indptr) and np.array_equal(A_t.indices, A_j.indices)
    assert _rel(A_t.data, A_j.data) <= 1e-12
    m = ids_j.shape[0]
    assert [b[b < m].tolist() for b in bids_t] == [b.tolist() for b in blocks_j]


@pytest.mark.parametrize(
    "n, degree, sweeps",
    [pytest.param(16, 1, None, id="dense"), pytest.param(32, 1, 4, id="schwarz"),
     pytest.param(16, 2, 4, id="q2-schwarz")],
)
def test_preconditioner_application_on_carried_tables(n, degree, sweeps, monkeypatch):
    """The port's lattice preconditioner (float64 cycle) on the JAX
    scheme's own assembled tables, applied to one seeded residual: Q1 at
    n=16 (dense band inverse) and n=32 (Schwarz), and Q2 at n=16 (the
    low-order-refined cycle on the 33^3 node grid and the Schwarz band solve
    on its degree-2 blocks).

    The Schwarz cases run 4 inner band sweeps, with the JAX side's band
    dots in float64: the inner solve is a fixed number of BiCGStab steps
    far from convergence (relative residual ~1e-2 after the default 30 at
    n=32), which amplifies rounding, so that at 30 sweeps a mere change of
    the port's own dot summation order moves the output by ~5e-5."""
    import phifem_tpu.mg as jmg

    monkeypatch.setattr(jmg, "_band_bicgstab", _band_bicgstab_f64)
    sj, _ = _pair(n, degree)
    st = pt.WeakDirichletPoisson3(pt.Grid3(n, n, n, BOX, device="cpu"), degree=degree)
    st.setup(phi, lambda x: 1.75 * uex_t(x), u_D=uex_t).assemble()
    scheme3_data_from_numpy(
        st, A8=_np(sj.A8), E_uu=_np(sj.E_uu), E_up=_np(sj.E_up), E_pp=_np(sj.E_pp),
        bulk_mask=_np(sj.bulk_mask), cut_dofs=_np(sj.cut_dofs),
        ghost=[(_np(d), _np(E)) for d, E in sj.ghost], bdry=[(_np(d), _np(E)) for d, E in sj.bdry],
        b={k: _np(v) for k, v in sj.b.items()}, diag={k: _np(v) for k, v in sj.diag.items()},
        active={k: _np(v) for k, v in sj.active.items()},
    )
    Mj = sj.lattice_preconditioner(dtype=jnp.float64, sweeps=sweeps)
    Mt = st.lattice_preconditioner(dtype=torch.float64, sweeps=sweeps)
    assert (st._band.interface_inv is not None) == (sweeps is None)
    rng = np.random.default_rng(n + degree - 1)
    r = {k: rng.standard_normal(st.b[k].numel()) * _np(st.active[k]) for k in ("u", "p")}
    zj = Mj({k: jnp.asarray(v) for k, v in r.items()})
    zt = Mt({k: torch.as_tensor(v) for k, v in r.items()})
    for k in ("u", "p"):
        assert _rel(zt[k], zj[k]) <= 1e-10, k


@pytest.mark.parametrize("n", [16, 32], ids=["dense", "schwarz"])
def test_preconditioned_bicgstab_matches_jax(n):
    sj, st = _pair(n)
    rj = sj.solve(method="bicgstab", tol=1e-11, maxiter=60, precond=sj.lattice_preconditioner())
    rt = st.solve(method="bicgstab", tol=1e-11, maxiter=60, precond=st.lattice_preconditioner())
    assert rt.converged and rt.residual <= 1e-10
    assert abs(rt.iterations - rj.iterations) <= max(3, 0.25 * rj.iterations), (rt.iterations, rj.iterations)
    assert _rel(rt.x["u"], rj.x["u"]) <= 1e-8
    et, ej = st.l2_h1_errors(uex_t), sj.l2_h1_errors(uex_j)
    assert abs(et["l2"] - ej["l2"]) <= 1e-8 * ej["l2"] and abs(et["h10"] - ej["h10"]) <= 1e-8 * ej["h10"]


def test_q2_lor_preconditioner_matches_jax():
    """Degree 2: the low-order-refined bulk cycle (JAX: 7 iterations at n=8,
    tol 1e-11)."""
    sj, st = _pair(8, 2)
    rj = sj.solve(method="bicgstab", tol=1e-11, maxiter=30, precond=sj.lattice_preconditioner())
    rt = st.solve(method="bicgstab", tol=1e-11, maxiter=30, precond=st.lattice_preconditioner())
    assert rt.converged and 0 <= rt.iterations <= 14
    assert abs(rt.iterations - rj.iterations) <= max(3, 0.25 * rj.iterations), (rt.iterations, rj.iterations)
    assert _rel(rt.x["u"], rj.x["u"]) <= 1e-8


def test_other_krylov_methods_and_unknown_method():
    _, st = _pair(16)
    M = st.lattice_preconditioner()
    ref = st.solve(tol=1e-11, maxiter=60, precond=M).x["u"]
    r = st.solve(method="fgmres", tol=1e-11, maxiter=200, precond=M)
    assert r.converged and _rel(r.x["u"], ref) <= 1e-8
    with pytest.raises(ValueError, match="unknown method"):
        st.solve(method="minres")


@pytest.mark.parametrize("degree", [2, 3])
def test_sparse_exactness(degree):
    """Q2 reproduces quadratics, Q3 cubics, to direct-solver precision
    (the polynomials and data of tests/test_weak_dirichlet3.py)."""
    if degree == 2:
        ua = lambda x: 0.3 + x[..., 0] ** 2 - 0.5 * x[..., 1] ** 2 + 0.25 * x[..., 2] ** 2 + x[..., 0] * x[..., 1]
        fa = lambda x: -1.5 * torch.ones_like(x[..., 0])
    else:
        ua = lambda x: x[..., 0] ** 3 - 3.0 * x[..., 0] * x[..., 1] ** 2 + x[..., 2] ** 3 + 0.5 * x[..., 1]
        fa = lambda x: -6.0 * x[..., 2]
    s = pt.WeakDirichletPoisson3(pt.Grid3(8, 8, 8, BOX, device="cpu"), degree=degree).setup(phi, fa, u_D=ua)
    r = s.assemble().solve(method="sparse")
    assert r.converged, r.residual
    e = s.l2_h1_errors(ua)
    assert e["l2"] < 1e-9 and e["h10"] < 1e-9, e


def test_q2_sparse_matches_jax():
    sj, st = _pair(8, 2)
    rj, rt = sj.solve(method="sparse"), st.solve(method="sparse")
    assert rt.converged and _rel(rt.x["u"], rj.x["u"]) <= 1e-9
    et, ej = st.l2_h1_errors(uex_t), sj.l2_h1_errors(uex_j)
    assert abs(et["l2"] - ej["l2"]) <= 1e-8 * ej["l2"]


def test_default_device_is_the_card():
    g = pt.Grid3(4, 4, 4, BOX)
    assert g.device.type == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            g.eval_at_vertices(phi)
