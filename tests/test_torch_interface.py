"""Port parity: the cut-band interface solve of the lattice preconditioner
against phifem_tpu.mg (S1 flower, n=24).  Both packages build the
preconditioner with dtype=float64, so the JAX interface tables, which it
stores in the cycle's dtype, coincide with the port's float64 tables:
tables to 1e-12, one preconditioner application to 1e-10.  The JAX band
BiCGStab takes its dots in float32; where a test holds the port's band
solve to 1e-10 it lifts those dots to float64 for the JAX run."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import phifem_tpu.mg as jmg  # noqa: E402
import phifem_tpu_torch.mg as tmg  # noqa: E402
from phifem_tpu.solvers import masked_operator as jmasked  # noqa: E402
from phifem_tpu_torch.solvers import masked_operator as tmasked  # noqa: E402
from phifem_tpu_torch.utils.convert import interface_tables_from_numpy  # noqa: E402
from torch_s1_cases import flower, random_vec, rel  # noqa: E402
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

N = 24
DENSE = ("interface_ids", "interface_inv")
SCHWARZ = ("schwarz_ids", "schwarz_inv", "band_ids", "band_ell_cols", "band_ell_vals")


class _F64Dots:
    """Stands in for ``jnp`` in phifem_tpu.mg with float32 read as float64,
    so its band BiCGStab takes float64 dots like the port's."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.fixture(scope="module")
def s1():
    return flower(N)


@pytest.fixture(scope="module")
def precs(s1):
    sj, st = s1
    return {
        kind: (
            sj.lattice_preconditioner(dtype=jnp.float64, kind=kind),
            st.lattice_preconditioner(dtype=torch.float64, kind=kind),
        )
        for kind in ("dense", "schwarz")
    }


def test_data_dependent_selection(s1):
    sj, st = s1
    selj = jmg.data_dependent_selection(sj.op, jmasked(sj.op)[2])
    selt = tmg.data_dependent_selection(st.op, tmasked(st.op)[2])
    for k in ("u", "p"):
        np.testing.assert_array_equal(selt[k], selj[k])
    assert sum(int(v.sum()) for v in selt.values()) > 0


def _port_table(vt, name):
    """The port's copy of the JAX package's table ``name``: the Schwarz
    tables live in ``vt.band_tables``, the band matrix slot-major there."""
    tab = vt.band_tables
    views = {"schwarz_ids": lambda: tab.ids, "schwarz_inv": lambda: tab.inv,
             "band_ell_cols": lambda: tab.ell_cols.T, "band_ell_vals": lambda: tab.ell_vals.T}
    return views[name]() if name in views else getattr(vt, name)


@pytest.mark.parametrize("kind", ["dense", "schwarz"])
def test_tables_match(precs, kind):
    vj, vt = precs[kind]
    for name in DENSE if kind == "dense" else SCHWARZ:
        t = _port_table(vt, name)
        a, b = np.asarray(getattr(vj, name)), t.cpu().numpy()
        assert b.shape == a.shape, name
        if b.dtype.kind == "f":
            assert t.dtype == torch.float64
            assert rel(b, a) <= 1e-12, name
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)
    if kind == "schwarz":
        assert vt.schwarz_sweeps == vj.schwarz_sweeps
        owner = tmg.ras_owner(np.asarray(vj.schwarz_ids), np.asarray(vj.schwarz_own), vt.band_ids.numel())
        np.testing.assert_array_equal(vt.band_tables.owner.numpy(), owner)


def test_ras_gather_equals_masked_scatter(precs):
    """The port's RAS apply gathers each band DoF's owning block entry; the
    JAX package scatter-adds the ownership-masked block outputs.  With one
    owner per DoF the two are equal bit for bit."""
    vj, vt = precs["schwarz"]
    bids, own = np.asarray(vj.schwarz_ids), np.asarray(vj.schwarz_own)
    m = vt.band_ids.numel()
    cb = np.random.default_rng(2).standard_normal(bids.shape)
    scattered = np.zeros(m + 1)
    np.add.at(scattered, bids, np.where(own, cb, 0.0))
    gathered = np.concatenate([cb.reshape(-1), [0.0]])[vt.band_tables.owner.numpy()]
    np.testing.assert_array_equal(gathered, scattered[:m])
    assert (vt.band_tables.owner.numpy() < cb.size).all()  # every band DoF has an owner


@pytest.mark.parametrize("kind", ["dense", "schwarz"])
def test_application_matches(s1, precs, kind, monkeypatch):
    sj, _ = s1
    vj, vt = precs[kind]
    monkeypatch.setattr(jmg, "jnp", _F64Dots())
    bj, bt = random_vec(sj.system, 7)
    zj, zt = vj(bj), vt(bt)
    for k in ("u", "p"):
        assert rel(zt[k].numpy(), np.asarray(zj[k])) <= 1e-10


def test_band_bicgstab_matches(precs, monkeypatch):
    """The port's fixed-sweep band BiCGStab (``ops.cuda_band.band_bicgstab``,
    RAS-preconditioned) on the JAX tables carried across, against the JAX
    one on JAX's own band operators with float64 dots: 1e-10; with the JAX
    package's own float32 dots the two differ only at float32 level."""
    from phifem_tpu_torch.mg import VCycle
    from phifem_tpu_torch.ops import cuda_band

    vj, _ = precs["schwarz"]
    vt = VCycle([], ())
    interface_tables_from_numpy(
        vt, vj._flat_meta, **{n: np.asarray(getattr(vj, n)) for n in SCHWARZ + ("schwarz_own",)},
        schwarz_sweeps=vj.schwarz_sweeps, device="cpu",
    )
    m = vt.band_ids.shape[0]
    rb = np.random.default_rng(9).standard_normal(m)
    # JAX's band_mv / band_ras: the closures its band correction hands to
    # _band_bicgstab
    ops = {}
    monkeypatch.setattr(jmg, "_band_bicgstab", lambda mv, M, b, it: ops.update(mv=mv, M=M) or jnp.zeros_like(b))
    n_flat = sum(vj._flat_meta[2])
    vj._band_correct_flat(jnp.zeros(n_flat), jnp.zeros(n_flat))
    monkeypatch.undo()

    def jax_band(dots64):
        monkeypatch.setattr(jmg, "jnp", _F64Dots() if dots64 else jnp)
        return np.asarray(jmg._band_bicgstab(ops["mv"], ops["M"], jnp.asarray(rb), vj.schwarz_sweeps))

    et = cuda_band.band_bicgstab(vt.band_tables, torch.as_tensor(rb), vt.schwarz_sweeps).numpy()
    assert rel(et, jax_band(True)) <= 1e-10
    assert rel(et, jax_band(False)) <= 1e-4
    # and the full band correction on the carried-across tables
    rf = np.random.default_rng(4).standard_normal(sum(vj._flat_meta[2]))
    monkeypatch.setattr(jmg, "jnp", _F64Dots())
    cj = vj._band_correct_flat(jnp.zeros_like(jnp.asarray(rf)), jnp.asarray(rf))
    ct = vt._band_correct_flat(torch.zeros(len(rf), dtype=torch.float64), torch.as_tensor(rf))
    for k in ("u", "p"):
        assert rel(ct[k].numpy(), np.asarray(cj[k])) <= 1e-10
