"""Port parity of the 3D Neumann and Robin schemes (``NeumannPoisson3``,
``RobinPoisson3``) and of ``lattice_core.make_interface_apply`` against the
JAX package, on the data of ``tests/test_neumann3.py``: the sphere R = 0.7
in [-1, 1]^3, u = cos x e^{(y+z)/2}, f = -Δu + u = 3u/2.

Tolerances: tags bit for bit; the element and face tables, diag, b and one
matvec 1e-12 relative to their max; Jacobi-equilibrated BiCGStab counts
within max(3, 0.25 it) of JAX's (the port's Krylov dots are float64, JAX's
float32) and u to 1e-6; one ``lattice_preconditioner`` application (float64
cycle) on tables carried across from JAX 1e-10, with the dense interface
inverse and with the Schwarz band solve forced (``dense_max=0``, 4 inner
sweeps, JAX's band dots in float64); ``make_interface_apply`` on the same
blocks in both inner modes 1e-10."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import phifem_tpu as pf  # noqa: E402
from phifem_tpu.models import lattice_core as jlc  # noqa: E402
from phifem_tpu.models.neumann3 import NeumannPoisson3 as JNeumann3  # noqa: E402
from phifem_tpu.models.robin3 import RobinPoisson3 as JRobin3  # noqa: E402
import phifem_tpu_torch as pt  # noqa: E402
from phifem_tpu_torch.models import lattice_core  # noqa: E402
from phifem_tpu_torch.utils.convert import scheme3_data_from_numpy  # noqa: E402

from test_torch_weak3 import _band_bicgstab_f64  # noqa: E402
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

R = 0.7
BOX = ((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0))


def phi(x):
    return x[..., 0] ** 2 + x[..., 1] ** 2 + x[..., 2] ** 2 - R**2


def u_j(x):
    return jnp.cos(x[..., 0]) * jnp.exp((x[..., 1] + x[..., 2]) / 2.0)


def u_t(x):
    return torch.cos(x[..., 0]) * torch.exp((x[..., 1] + x[..., 2]) / 2.0)


def un_j(x):
    """du/dn, n = x / |x| (the JAX test's own form)."""
    shape = x.shape[:-1]
    p = x.reshape(-1, 3)
    g = jax.vmap(jax.grad(lambda q: u_j(q[None])[0]))(p)
    n = p / jnp.maximum(jnp.linalg.norm(p, axis=-1, keepdims=True), 1e-12)
    return jnp.sum(g * n, axis=-1).reshape(shape)


def un_t(x):
    u = u_t(x)
    g = torch.stack([-torch.sin(x[..., 0]) * torch.exp((x[..., 1] + x[..., 2]) / 2.0), 0.5 * u, 0.5 * u], -1)
    n = x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=1e-12)
    return torch.sum(g * n, dim=-1)


SCHEMES = {
    "neumann": (JNeumann3, pt.NeumannPoisson3, {}, un_j, un_t),
    "robin": (JRobin3, pt.RobinPoisson3, {"robin_coef": 1.0}, lambda x: un_j(x) + u_j(x),
              lambda x: un_t(x) + u_t(x)),
}
FIELDS = ("u", "y", "p")


def _np(a):
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _rel(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


_PAIRS = {}


def _pair(scheme: str, n: int):
    """The same scheme assembled in both packages (built once per module)."""
    if (scheme, n) not in _PAIRS:
        J, T, kw, gj, gt = SCHEMES[scheme]
        sj = J(pf.Grid3(n, n, n, BOX), **kw).setup(phi, lambda x: 1.5 * u_j(x), gj).assemble()
        st = T(pt.Grid3(n, n, n, BOX, device="cpu"), **kw).setup(phi, lambda x: 1.5 * u_t(x), gt).assemble()
        _PAIRS[scheme, n] = (sj, st)
    return _PAIRS[scheme, n]


def _carried(scheme: str, n: int):
    """A port scheme whose tables are the JAX scheme's."""
    sj, _ = _pair(scheme, n)
    _, T, kw, _, gt = SCHEMES[scheme]
    st = T(pt.Grid3(n, n, n, BOX, device="cpu"), **kw).setup(phi, lambda x: 1.5 * u_t(x), gt).assemble()
    scheme3_data_from_numpy(
        st, A8=_np(sj.A8), E_stat=_np(sj.E_stat), E_phi=_np(sj.E_phi), bulk_mask=_np(sj.bulk_mask),
        cut_dofs=_np(sj.cut_dofs), cut_cells_flat=_np(sj.cut_cells_flat),
        ghost=[(_np(d), _np(E)) for d, E in sj.ghost], flux=[(_np(d), _np(E), k) for d, E, k in sj.flux],
        b={k: _np(v) for k, v in sj.b.items()}, diag={k: _np(v) for k, v in sj.diag.items()},
        active={k: _np(v) for k, v in sj.active.items()},
    )
    return sj, st


@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_assembly_and_matvec_match_jax(scheme):
    sj, st = _pair(scheme, 8)
    assert np.array_equal(st.tags.cell_tags, sj.tags.cell_tags)
    for name in ("A8", "bulk_mask", "E_stat", "E_phi", "f_lat"):
        assert _rel(getattr(st, name), getattr(sj, name)) <= 1e-12, name
    assert np.array_equal(_np(st.cut_dofs), _np(sj.cut_dofs))
    assert np.array_equal(_np(st.cut_cells_flat), _np(sj.cut_cells_flat))
    assert len(st.ghost) == len(sj.ghost) and len(st.flux) == len(sj.flux)
    for (dt_, Et), (dj, Ej) in zip(st.ghost, sj.ghost):
        assert np.array_equal(_np(dt_), _np(dj)) and _rel(Et, Ej) <= 1e-12
    for (dt_, Et, kt), (dj, Ej, kj) in zip(st.flux, sj.flux):
        assert kt == kj and np.array_equal(_np(dt_), _np(dj)) and _rel(Et, Ej) <= 1e-12
    for k in FIELDS:
        assert _rel(st.b[k], sj.b[k]) <= 1e-12, k
        assert _rel(st.diag[k], sj.diag[k]) <= 1e-12, k
        assert np.array_equal(_np(st.active[k]), _np(sj.active[k])), k
    rng = np.random.default_rng(3)
    x = {k: rng.standard_normal(st.b[k].shape) for k in FIELDS}
    yt = st.matvec({k: torch.as_tensor(v) for k, v in x.items()})
    yj = sj.matvec({k: jnp.asarray(v) for k, v in x.items()})
    for k in FIELDS:
        assert _rel(yt[k], yj[k]) <= 1e-12, k


@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_jacobi_bicgstab_matches_jax(scheme):
    """The demo's own path (``main.py neumann|robin``): Jacobi-equilibrated
    BiCGStab to 1e-10, at n=8."""
    sj, st = _pair(scheme, 8)
    rj = sj.solve(tol=1e-10, maxiter=4000)
    rt = st.solve(tol=1e-10, maxiter=4000)
    assert rt.converged and rt.residual <= 1e-9
    assert abs(rt.iterations - rj.iterations) <= max(3, 0.25 * rj.iterations), (rt.iterations, rj.iterations)
    assert _rel(rt.x["u"], rj.x["u"]) <= 1e-6
    et, ej = st.l2_h1_errors(u_t), sj.l2_h1_errors(u_j)
    assert abs(et["l2"] - ej["l2"]) <= 1e-5 * ej["l2"] and abs(et["h10"] - ej["h10"]) <= 1e-5 * ej["h10"]


@pytest.mark.parametrize("sweeps", [None, 4], ids=["dense", "schwarz"])
def test_preconditioner_application_on_carried_tables(sweeps, monkeypatch):
    """One ``lattice_preconditioner`` application (float64 bulk cycle) on the
    JAX scheme's own tables at n=12: the dense interface inverse, and the
    band solve forced (``dense_max=0``) with 4 inner sweeps and JAX's band
    dots in float64 (the fixed-sweep inner BiCGStab amplifies rounding)."""
    import phifem_tpu.mg as jmg

    monkeypatch.setattr(jmg, "_band_bicgstab", _band_bicgstab_f64)
    sj, st = _carried("neumann", 12)
    kw = {} if sweeps is None else {"dense_max": 0, "sweeps": sweeps}
    Mj = sj.lattice_preconditioner(dtype=jnp.float64, **kw)
    Mt = st.lattice_preconditioner(dtype=torch.float64, **kw)
    assert (Mt.iface.__name__ == "apply_dense") == (sweeps is None)
    rng = np.random.default_rng(12)
    r = {k: rng.standard_normal(st.b[k].shape) * _np(st.active[k]) for k in FIELDS}
    zj = Mj({k: jnp.asarray(v) for k, v in r.items()})
    zt = Mt({k: torch.as_tensor(v) for k, v in r.items()})
    for k in FIELDS:
        assert _rel(zt[k], zj[k]) <= 1e-10, k


def test_interface_block_matches_jax():
    """The port's interface block (ids, CSR, per-entity RAS blocks) equals
    JAX's on the n=12 Neumann scheme."""
    sj, st = _carried("neumann", 12)
    total, blocks = st._interface_blocks()
    sel = np.concatenate([_np(st.active[k]).reshape(-1) for k in FIELDS])
    ids, A, ras = lattice_core.build_interface_block(blocks, total, sel)
    jids, jA, jras = jlc.build_interface_block(blocks, total, sel)
    assert np.array_equal(ids, jids) and abs(A - jA).max() <= 1e-12 * abs(jA).max()
    assert ras.shape[0] == len(jras)
    for row, bl in zip(ras, jras):
        assert np.array_equal(row[row < len(ids)], bl)


@pytest.mark.parametrize("inner", ["krylov", "richardson"])
def test_make_interface_apply_matches_jax(inner, monkeypatch):
    """``make_interface_apply`` on the same n=12 Neumann blocks (the JAX
    package's list of RAS blocks, given to both): the band solve (6
    sweeps, float64 dots on both sides; Richardson with omega 0.7) and the
    dense inverse."""
    import phifem_tpu.mg as jmg

    monkeypatch.setattr(jmg, "_band_bicgstab", _band_bicgstab_f64)
    _, st = _carried("neumann", 12)
    total, blocks = st._interface_blocks()
    sel = np.concatenate([_np(st.active[k]).reshape(-1) for k in FIELDS])
    ids, A, ras = jlc.build_interface_block(blocks, total, sel)
    rf = np.random.default_rng(5).standard_normal(total)
    for dense_max in (0, 10**6):
        kw = dict(dense_max=dense_max, sweeps=6, inner=inner, inner_omega=0.7)
        idj, cj = jlc.make_interface_apply(ids, A, ras, **kw)(jnp.asarray(rf))
        idt, ct = lattice_core.make_interface_apply(ids, A, ras, device="cpu", **kw)(torch.as_tensor(rf))
        assert np.array_equal(_np(idt), _np(idj))
        assert _rel(ct, cj) <= 1e-10, dense_max
    with pytest.raises(ValueError, match="inner"):
        lattice_core.make_interface_apply(ids, A, ras, dense_max=0, inner="jacobi", device="cpu")
