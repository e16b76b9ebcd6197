"""The band solve's RAS table and its fused BiCGStab steps
(``phifem_tpu_torch/ops/cuda_band.py``), without JAX.

The RAS apply reads a slot-major (K, m) table: each band DoF's row of its
owning block's inverse and that block's ids (``cuda_band.ras_table``).  On
synthetic bands with pad ids inside blocks, unowned DoFs and K in {6, 16,
27, 33}, its plain version is ``torch.equal`` (sign of zero included) to
the former form, which gathered the owner's row of the (nb, K, K) table in
every mode; the fused plain steps (RAS+P, RAS+S) equal the plain update
followed by the plain RAS apply; and the fused loop of ``band_bicgstab`` (8
steps a sweep) equals the unfused ``band_bicgstab_ref`` (10), bit for bit.
"""

import numpy as np
import pytest
import torch

from phifem_tpu_torch.ops import cuda_band as cb
from test_torch_band import synthetic
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

KS = (6, 16, 27, 33)


def former_ras(tab: cb.BandTables, x: torch.Tensor, mode: int = cb.RAS_APPLY, om: float = 1.0, c=None):
    """The former plain RAS apply: each DoF's owner row of the (nb, K, K)
    inverses against the owner block's entries of x, from the first product
    up in ascending order, 0 where a DoF has no owner."""
    K = tab.K
    valid = tab.owner < tab.nb * K
    s = torch.where(valid, tab.owner, 0).long()
    xv = torch.cat([x, x.new_zeros(1)])[tab.ids.long()[torch.div(s, K, rounding_mode="floor")]]
    prod = (tab.inv.reshape(-1, K)[s] * xv).T
    acc = prod[0]
    for row in prod[1:]:
        acc = acc + row
    y = torch.where(valid, acc, 0.0)
    return om * y if mode == cb.RAS_SCALE else c + om * y if mode == cb.RAS_ADD else y


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a, b) and torch.equal(torch.signbit(a), torch.signbit(b))


@pytest.fixture(scope="module")
def tables():
    """K -> a synthetic band: pad ids inside blocks (block 0 ends in one,
    and blocks shorter than K), three unowned DoFs at least."""
    return {K: synthetic(400 + 37 * K, 150 + K, K, 7, seed=K) for K in KS}


def vec(m: int, seed: int) -> torch.Tensor:
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(m))


@pytest.mark.parametrize("K", KS)
def test_table_holds_each_owned_row(tables, K):
    """Column i of the table is the ids and the inverse's row of DoF i's
    owner slot; an unowned DoF has K pads of value +0, and the RAS apply
    gives it +0."""
    tab = tables[K]
    m, nb = tab.m, tab.nb
    assert tab.ras_cols.shape == tab.ras_vals.shape == (K, m)
    assert tab.ras_cols.dtype == torch.int32 and tab.ras_vals.dtype == torch.float64
    owner = tab.owner.long()
    own = owner < nb * K
    assert int((~own).sum()) >= 3 and bool((tab.ids == m).any(dim=1)[1:].any())
    b, k = owner[own] // K, owner[own] % K
    assert torch.equal(tab.ras_cols[:, own].T, tab.ids[b])
    assert torch.equal(tab.ras_vals[:, own].T, tab.inv[b, k])
    assert bool((tab.ras_cols[:, ~own] == m).all())
    assert same_bits(tab.ras_vals[:, ~own], torch.zeros(K, int((~own).sum()), dtype=torch.float64))
    y = cb.band_ras_ref(tab, vec(m, 1))
    assert same_bits(y[~own], torch.zeros(int((~own).sum()), dtype=torch.float64))


@pytest.mark.parametrize("mode", [cb.RAS_APPLY, cb.RAS_SCALE, cb.RAS_ADD], ids=["apply", "scale", "add"])
@pytest.mark.parametrize("K", KS)
def test_plain_ras_equals_the_former_form(tables, K, mode):
    """The plain RAS apply on the new table against the former plain form,
    bit for bit, on a random x and on one with zeros of both signs."""
    tab = tables[K]
    c = vec(tab.m, 2)
    x = vec(tab.m, 3)
    z = x.clone()
    z[::3] = 0.0
    z[1::3] = -0.0
    for v in (x, z):
        assert same_bits(cb.band_ras_ref(tab, v, mode=mode, om=0.7, c=c), former_ras(tab, v, mode, 0.7, c))
    y = torch.empty_like(x)
    assert cb.band_ras_ref(tab, x, y) is y and same_bits(y, former_ras(tab, x))


def _state(m: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    st = {k: torch.as_tensor(rng.standard_normal(m)) for k in ("r", "p", "v", "x", "xb", "pout", "ph", "s", "sh")}
    st["sc"] = torch.as_tensor(0.5 + rng.random(cb.SLOTS))
    return st


@pytest.mark.parametrize("K", [6, 27])
def test_fused_plain_steps_equal_update_then_ras(tables, K):
    """RAS+P at sweeps 0-2 (the select taking x, keeping xb, and a NaN
    residual) and RAS+S against the plain update then the plain RAS apply
    on copies, bit for bit."""
    tab = tables[K]
    for sweep in (0, 1, 2):
        for rr, rrb0, rrb1 in ((0.5, 1.0, 0.25), (0.5, 0.25, 1.0), (float("nan"), 1.0, 1.0)):
            st = _state(tab.m, 10 * sweep + 1)
            st["sc"][cb.RR], st["sc"][cb.RRB0], st["sc"][cb.RRB1] = rr, rrb0, rrb1
            want = {k: t.clone() for k, t in st.items()}
            cb.band_ras_p(tab, sweep, st["sc"], st["r"], st["p"], st["v"], st["x"], st["xb"], st["pout"], st["ph"])
            p = want["p"].clone()  # RAS+P leaves p as it was
            cb.band_update_ref(cb.P, sweep, want["sc"], r=want["r"], p=p, v=want["v"], x=want["x"], xb=want["xb"])
            want["pout"] = p
            want["ph"] = cb.band_ras_ref(tab, p)
            for k in st:
                assert torch.equal(st[k].nan_to_num(7.0), want[k].nan_to_num(7.0)), (sweep, rr, k)
    st = _state(tab.m, 99)
    want = {k: t.clone() for k, t in st.items()}
    cb.band_ras_s(tab, st["sc"], st["r"], st["v"], st["s"], st["sh"])
    cb.band_update_ref(cb.S, 0, want["sc"], r=want["r"], v=want["v"], s=want["s"])
    want["sh"] = cb.band_ras_ref(tab, want["s"])
    assert all(torch.equal(st[k], want[k]) for k in st)


@pytest.mark.parametrize("K", KS)
def test_fused_loop_equals_the_unfused_plain_loop(tables, K):
    """``band_bicgstab`` on CPU tensors (the fused loop, 8 steps a sweep,
    through the wrappers' plain versions) against ``band_bicgstab_ref``
    (the unfused loop, 10), bit for bit, with no launch counted."""
    tab = tables[K]
    rb = vec(tab.m, 4)
    before = cb.launches
    for sweeps in (1, 2, 9):
        assert torch.equal(cb.band_bicgstab(tab, rb, sweeps), cb.band_bicgstab_ref(tab, rb, sweeps)), sweeps
    assert cb.launches == before


def test_fused_wrappers_check_their_vectors(tables):
    """The fused steps refuse an output that is an input, a negative
    sweep, and P or S as an update mode; a ``meta`` tensor raises."""
    tab = tables[6]
    st = _state(tab.m, 5)
    with pytest.raises(ValueError, match="another vector"):
        cb.band_ras_p(tab, 1, st["sc"], st["r"], st["p"], st["v"], st["x"], st["xb"], st["p"], st["ph"])
    with pytest.raises(ValueError, match="another vector"):
        cb.band_ras_s(tab, st["sc"], st["r"], st["v"], st["r"], st["sh"])
    with pytest.raises(ValueError, match="sweep"):
        cb.band_ras_p(tab, -1, st["sc"], st["r"], st["p"], st["v"], st["x"], st["xb"], st["pout"], st["ph"])
    for mode in (cb.P, cb.S):
        with pytest.raises(ValueError, match="mode"):
            cb.band_update(mode, 1, st["sc"], r=st["r"])
    meta = {k: t.to("meta") for k, t in st.items()}
    with pytest.raises(ValueError, match="no kernel for device meta"):
        cb.band_ras_s(tab, meta["sc"], meta["r"], meta["v"], meta["s"], meta["sh"])
    with pytest.raises(ValueError, match="no kernel for device meta"):
        cb.band_bicgstab(tab, meta["r"], 2)
