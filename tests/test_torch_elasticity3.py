"""Port parity of S5-3D (``InterfaceElasticity3``, two-material interface
elasticity on the hex lattice) and of ``lattice_core.
lattice_l2_h1_errors_vec`` against the JAX package, on the data of
``tests/test_interface_elasticity3.py``: the sphere r = 1 in [-1.5, 1.5]^3
(phi = 1 - r^2), u = (cos r - cos 1) / E per side, contrast E_in / E_out =
1000, at n=8.

Tolerances: tags bit for bit; K_in / K_out, E_stat / E_phi, the face
tables, b, diag, x_bc, one matvec and the rigid modes 1e-12 relative to
their max; the interface ids equal and the per-vertex RAS blocks equal, in
the same order; the coarse basis Z (built on the device in the port, on the
host in JAX) and its Galerkin matrix G = Z A Z^T 1e-12; one full
preconditioner application (bulk block cycles, band solve, harmonic degree
2) on tables carried across from JAX 1e-10 (float64 cycle, 4 inner sweeps,
JAX's band dots in float64); the vector error norm on a fixed field 1e-12.
The flexible GMRES solve itself is held on the card (``chip_smoke.py``,
phase s53d): on a CPU its band solve's plain gathers take seconds per
preconditioner application at n=8."""

import inspect

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import phifem_tpu as pf  # noqa: E402
from phifem_tpu.models import lattice_core as jlc  # noqa: E402
from phifem_tpu.models.interface_elasticity3 import InterfaceElasticity3 as JIE3  # noqa: E402
import phifem_tpu_torch as pt  # noqa: E402
from phifem_tpu_torch.models import interface_elasticity3 as tie3  # noqa: E402
from phifem_tpu_torch.models import lattice_core  # noqa: E402
from phifem_tpu_torch.models.interface_elasticity import lame  # noqa: E402
from phifem_tpu_torch.utils.convert import scheme3_data_from_numpy  # noqa: E402

from test_torch_weak3 import _band_bicgstab_f64  # noqa: E402
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

BOX = ((-1.5, -1.5, -1.5), (1.5, 1.5, 1.5))
E_IN, E_OUT, NU = 1.0, 0.001, 0.3
FIELDS = ("ui", "uo", "yi", "yo", "p")


def phi(x):
    return 1.0 - (x[..., 0] ** 2 + x[..., 1] ** 2 + x[..., 2] ** 2)


def _jax_data():
    lmbda, mu = lame(E_IN, NU)

    def exact(x):
        r = jnp.sqrt(x[..., 0] ** 2 + x[..., 1] ** 2 + x[..., 2] ** 2 + 1e-30)
        val = (jnp.cos(r) - jnp.cos(1.0)) / E_IN
        val = jnp.where(r < 1.0, val * (E_IN / E_OUT), val)
        return jnp.stack([val, val, val], axis=-1)

    def _sigma(p):
        G = jax.jacfwd(lambda q: jnp.cos(jnp.sqrt(q[0] ** 2 + q[1] ** 2 + q[2] ** 2 + 1e-30)) * jnp.ones(3))(p)
        return lmbda * jnp.trace(G) * jnp.eye(3) + mu * (G + G.T)

    def source(x):
        shape = x.shape[:-1]
        Dg = jax.vmap(jax.jacfwd(_sigma))(x.reshape(-1, 3))
        return (-jnp.einsum("nijj->ni", Dg) / E_IN).reshape(shape + (3,))

    return exact, source


def _torch_data():
    from torch.func import jacfwd, vmap

    lmbda, mu = lame(E_IN, NU)

    def exact(x):
        r = torch.sqrt(x[..., 0] ** 2 + x[..., 1] ** 2 + x[..., 2] ** 2 + 1e-30)
        val = (torch.cos(r) - np.cos(1.0)) / E_IN
        val = torch.where(r < 1.0, val * (E_IN / E_OUT), val)
        return torch.stack([val, val, val], dim=-1)

    def _sigma(p):
        G = jacfwd(lambda q: torch.cos(torch.sqrt(q[0] ** 2 + q[1] ** 2 + q[2] ** 2 + 1e-30)) * torch.ones_like(q))(p)
        return lmbda * torch.trace(G) * torch.eye(3, dtype=p.dtype) + mu * (G + G.T)

    def source(x):
        shape = x.shape[:-1]
        Dg = vmap(jacfwd(_sigma))(x.reshape(-1, 3))
        return (-torch.einsum("nijj->ni", Dg) / E_IN).reshape(shape + (3,))

    return exact, source


def _np(a):
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _rel(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


_PAIRS = {}


def _port(n: int):
    exact, source = _torch_data()
    s = pt.InterfaceElasticity3(pt.Grid3(n, n, n, BOX, device="cpu"), E_in=E_IN, E_out=E_OUT, nu_in=NU, nu_out=NU)
    return s.setup(phi, source, exact).assemble()


def _pair(n: int = 8):
    if n not in _PAIRS:
        exact, source = _jax_data()
        sj = JIE3(pf.Grid3(n, n, n, BOX), E_in=E_IN, E_out=E_OUT, nu_in=NU, nu_out=NU)
        _PAIRS[n] = (sj.setup(phi, source, exact).assemble(), _port(n))
    return _PAIRS[n]


def _carried(n: int = 8):
    """A port scheme whose tables are the JAX scheme's."""
    sj, _ = _pair(n)
    st = _port(n)
    scheme3_data_from_numpy(
        st, K_in=_np(sj.K_in), K_out=_np(sj.K_out), mask_in=_np(sj.mask_in), mask_out=_np(sj.mask_out),
        E_stat=_np(sj.E_stat), E_phi=_np(sj.E_phi), idxU=_np(sj.idxU), idxY=_np(sj.idxY),
        ghost=[(_np(d), _np(E), f) for d, E, f in sj.ghost], flux=[(_np(d), _np(E), k, f) for d, E, k, f in sj.flux],
        b={k: _np(v) for k, v in sj.b.items()}, diag={k: _np(v) for k, v in sj.diag.items()},
        x_bc={k: _np(v) for k, v in sj.x_bc.items()}, active={k: _np(v) for k, v in sj.active.items()},
    )
    return sj, st


def test_assembly_and_matvec_match_jax():
    sj, st = _pair()
    assert np.array_equal(st.tags.cell_tags, sj.tags.cell_tags)
    for name in ("K_in", "K_out", "mask_in", "mask_out", "E_stat", "E_phi"):
        assert _rel(getattr(st, name), getattr(sj, name)) <= 1e-12, name
    assert np.array_equal(_np(st.idxU), _np(sj.idxU)) and np.array_equal(_np(st.idxY), _np(sj.idxY))
    assert len(st.ghost) == len(sj.ghost) and len(st.flux) == len(sj.flux)
    for (dt_, Et, ft), (dj, Ej, fj) in zip(st.ghost, sj.ghost):
        assert ft == fj and np.array_equal(_np(dt_), _np(dj)) and _rel(Et, Ej) <= 1e-12
    for (dt_, Et, kt, ft), (dj, Ej, kj, fj) in zip(st.flux, sj.flux):
        assert (kt, ft) == (kj, fj) and np.array_equal(_np(dt_), _np(dj)) and _rel(Et, Ej) <= 1e-12
    for k in FIELDS:
        for name in ("b", "diag", "x_bc"):
            assert _rel(getattr(st, name)[k], getattr(sj, name)[k]) <= 1e-12, (name, k)
        assert np.array_equal(_np(st.active[k]), _np(sj.active[k])), k
    rng = np.random.default_rng(6)
    x = {k: rng.standard_normal(st.b[k].shape) for k in FIELDS}
    yt = st.matvec({k: torch.as_tensor(v) for k, v in x.items()})
    yj = sj.matvec({k: jnp.asarray(v) for k, v in x.items()})
    for k in FIELDS:
        assert _rel(yt[k], yj[k]) <= 1e-12, k
    for mt, mj in zip(st.rigid_modes(), sj.rigid_modes()):
        for k in FIELDS:
            assert _rel(mt[k], mj[k]) <= 1e-12 if np.abs(_np(mj[k])).max() else not _np(mt[k]).any()


def test_interface_ids_and_vertex_blocks_match_jax():
    """The interface block and its RAS blocks regrouped per lattice vertex:
    the same ids, and the same blocks in the same order as the JAX
    package's dict regrouping (``interface_elasticity3.py:688-691``)."""
    _, st = _carried()
    N = st._N
    sel = np.concatenate([_np(st.active[k]) for k in FIELDS])
    blocks = st._interface_blocks()
    ids, A, _ = lattice_core.build_interface_block(blocks, 27 * N, sel)
    jids, jA, _ = jlc.build_interface_block(blocks, 27 * N, sel)
    assert np.array_equal(ids, jids) and abs(A - jA).max() <= 1e-12 * abs(jA).max()
    by_vertex = {}
    for compact, gid in enumerate(jids):
        by_vertex.setdefault(int(gid) % N, []).append(compact)
    jras = list(by_vertex.values())
    vb = tie3.vertex_blocks(ids, N)
    assert vb.shape == (len(jras), max(len(b) for b in jras))
    for row, bl in zip(vb, jras):
        assert row[row < len(ids)].tolist() == bl


_PRECONDS = {}


def _preconds():
    """The full preconditioner (both bulk block cycles, the band solve on
    per-vertex blocks with 4 inner sweeps, the harmonic coarse step of
    degree 2: 60 modes), float64 cycle, built once in both packages on the
    same tables."""
    if not _PRECONDS:
        sj, st = _carried()
        kw = dict(sweeps=4, coarse_harmonic_degree=2)
        _PRECONDS["j"] = sj.lattice_preconditioner(dtype=jnp.float64, **kw)
        _PRECONDS["t"] = st.lattice_preconditioner(dtype=torch.float64, **kw)
        _PRECONDS["schemes"] = (sj, st)
    return _PRECONDS


def test_coarse_basis_matches_jax():
    """Z and G = Z A Z^T of the rank-k step (60 modes)."""
    P = _preconds()
    sj, st = P["schemes"]
    Zj = np.asarray(inspect.getclosurevars(P["j"]).nonlocals["Z"])
    N = st._N
    assert Zj.shape == tuple(st._coarse_Z.shape) == (60, 27 * N)
    assert _rel(st._coarse_Z, Zj) <= 1e-12
    # A Z^T of JAX's basis by the port's matvec on JAX's tables (held to
    # JAX's matvec at 1e-12 above)
    AZ = np.stack([_np(st._flat(st.matvec(st._split(torch.as_tensor(z))))) for z in Zj])
    assert _rel(st._coarse_G, Zj @ AZ.T) <= 1e-12


def test_preconditioner_application_on_carried_tables(monkeypatch):
    """One application of the full preconditioner in float64 on JAX's
    tables."""
    import phifem_tpu.mg as jmg

    monkeypatch.setattr(jmg, "_band_bicgstab", _band_bicgstab_f64)
    P = _preconds()
    _, st = P["schemes"]
    assert set(P["t"].mgs) == {"ui", "uo"} and P["t"].iface.__name__ == "apply"
    rng = np.random.default_rng(8)
    r = {k: rng.standard_normal(st.b[k].shape) * _np(st.active[k]) for k in FIELDS}
    zj = P["j"]({k: jnp.asarray(v) for k, v in r.items()})
    zt = P["t"]({k: torch.as_tensor(v) for k, v in r.items()})
    for k in FIELDS:
        assert _rel(zt[k], zj[k]) <= 1e-10, k


def test_vector_error_norm_matches_jax():
    sj, st = _pair()
    exact_j, _ = _jax_data()
    exact_t, _ = _torch_data()
    g = st.grid
    D, R, C = g.lattice_shape
    u = np.random.default_rng(9).standard_normal((3, D, R, C)) * 0.1
    mask = st.tags.region_mask((1, 2, 3))
    et = lattice_core.lattice_l2_h1_errors_vec(g, mask, torch.as_tensor(u), exact_t)
    ej = jlc.lattice_l2_h1_errors_vec(sj.grid, mask, jnp.asarray(u), exact_j)
    for k in ("l2", "h10"):
        assert abs(et[k] - ej[k]) <= 1e-12 * ej[k], k
