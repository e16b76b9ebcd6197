"""The band matrix's sliced ELL table and its product
(``phifem_tpu_torch/ops/cuda_band.py``: ``sliced_ell``, ``band_ell`` /
``band_ell_ref``, ``BandTables.ell_rows``) and the one-launch ordered dots.

No JAX here: the plain product is held to the former plain version, the
ascending sum over the padded slot-major table
(``cuda_amg.amg_ell_sweep_ref``), bit for bit with the sign of zero
(``torch.signbit``), on synthetic bands of widths 1 to 900 with row lengths
that vary within slices, empty rows (all pad, or the identity at slot 0 as
``mg.set_schwarz_tables`` makes them), m no multiple of the slice, a pad
inside a row, a trailing slot of value -0, and rows whose products are all
-0 (full width: the sum stays -0; shorter: the trailing pads make it +0).
``tests/test_torch_band.py`` checks the same on the four bands it holds
against JAX's.  On the card (marker ``cuda``): the ELL kernel ``torch.equal``
to its plain version in both modes on those bands (built by the port on
the host, then moved), and the dots in one launch ``torch.equal`` to
``band_dots_ref`` from 1 to 2^20 values, 100 calls in a row (the arrival
counter is back to 0 after each).
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import phifem_tpu_torch as pt
from phifem_tpu_torch.mg import VCycle, attach_interface_solve
from phifem_tpu_torch.ops import cuda_amg as ca
from phifem_tpu_torch.ops import cuda_band as cb
from phifem_tpu_torch.solvers import masked_operator
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

BOX3 = ((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0))
# (m, host width) of the synthetic bands
WIDE = {"w1_m1": (1, 1), "w2_m31": (31, 2), "w7_m33": (33, 7), "w40_m2049": (2049, 40), "w101_m1000": (1000, 101),
        "w900_m70": (70, 900)}


@contextlib.contextmanager
def sort_window(window: int):
    """``cuda_band.WINDOW`` set to ``window`` for the tables built inside."""
    saved = cb.WINDOW
    cb.WINDOW = window
    try:
        yield
    finally:
        cb.WINDOW = saved


def wide_band(m: int, w: int, seed: int = 0, device="cpu", window: int = cb.WINDOW):
    """(band tables, host cols, host vals) of a random band of m rows and
    host width w, one block per DoF: row lengths 0..w, half the slices
    drawing them from a narrow range and half from the whole one; every
    7th row the identity at slot 0 and row 1 all pad; with w >= 3 row 2 a
    pad inside it, row 3 a trailing slot of value -0; the last row full
    width and, with w >= 2, row 4 one slot, both of products -0 when x's
    last entry is 0 (column m - 1, value -1)."""
    rng = np.random.default_rng(seed)
    cols = np.full((m, w), m, np.int64)
    vals = np.zeros((m, w))
    for i in range(m):
        lo = 0 if (i // cb.SLICE) % 2 else max(0, w - 3)
        n = int(rng.integers(lo, w + 1))
        cols[i, :n] = rng.integers(0, m, n)
        vals[i, :n] = rng.standard_normal(n)
        if i % 7 == 0:
            cols[i], vals[i] = m, 0.0
            cols[i, 0], vals[i, 0] = i, 1.0
    special = {1: (np.array([], np.int64), np.array([]))}
    if w >= 3:
        special[2] = (np.array([0, m, m - 1]), np.array([0.5, 0.0, 2.0]))
        special[3] = (np.array([0, m]), np.array([1.5, -0.0]))
    if w >= 2:
        special[4] = (np.array([m - 1]), np.array([-1.0]))
    special[m - 1] = (np.full(w, m - 1), np.full(w, -1.0))
    for i, (c, v) in special.items():
        if i < m:
            cols[i], vals[i] = m, 0.0
            cols[i, : len(c)], vals[i, : len(v)] = c, v
    with sort_window(window):
        tab = cb.band_tables(np.arange(m)[:, None], np.ones((m, 1, 1)), np.arange(m), cols, vals, device)
    return tab, cols, vals


def x_for(m: int, seed: int = 1) -> torch.Tensor:
    """A random x with its last entry +0 (the -0 rows' column)."""
    x = torch.as_tensor(np.random.default_rng(seed).standard_normal(m))
    x[-1] = 0.0
    return x


def padded_product(cols, vals, x, b=None) -> torch.Tensor:
    """The former plain band product: the ascending sum over every slot of
    the padded table, slot-major (``cuda_amg.amg_ell_sweep_ref``)."""
    c = torch.as_tensor(np.ascontiguousarray(np.asarray(cols).T), dtype=torch.int32)
    v = torch.as_tensor(np.ascontiguousarray(np.asarray(vals).T), dtype=torch.float64)
    return ca.amg_ell_sweep_ref(ca.APPLY if b is None else ca.RESIDUAL, c, v, x, b)


def check_layout(tab: cb.BandTables, cols: np.ndarray, vals: np.ndarray, window: int = cb.WINDOW) -> None:
    """The sliced table holds each host row's slots in their order up to
    its last slot that is not a trailing pad (column m, value +0), the rows
    sorted by length (longest first, ties in row order) within each
    ``window``, each slice as wide as its longest row, and nothing else."""
    m, w = cols.shape
    assert tab.width == w and tab.m == m
    pad = (cols == m) & (vals == 0.0) & ~np.signbit(vals)
    n = np.array([max([k + 1 for k in range(w) if not pad[i, k]], default=0) for i in range(m)])
    perm = tab.row_perm.cpu().numpy()
    np.testing.assert_array_equal(np.sort(perm), np.arange(m))
    for w0 in range(0, m, window):
        rows = perm[w0 : w0 + window]
        assert set(rows) == set(range(w0, min(m, w0 + window)))
        assert all((n[a], -a) > (n[b], -b) for a, b in zip(rows[:-1], rows[1:]))
    np.testing.assert_array_equal(tab.row_len.cpu().numpy(), n[perm])
    ns = -(-m // cb.SLICE)
    off = tab.sell_off.cpu().numpy()
    widths = [int(n[perm[s * cb.SLICE : (s + 1) * cb.SLICE]].max()) for s in range(ns)]
    np.testing.assert_array_equal(np.diff(off), cb.SLICE * np.array(widths))
    assert off[0] == 0 and off[-1] == tab.sell_cols.numel() == tab.sell_vals.numel()
    sc, sv = tab.sell_cols.cpu().numpy(), tab.sell_vals.cpu().numpy()
    for p, i in enumerate(perm):
        at = off[p // cb.SLICE] + cb.SLICE * np.arange(n[i]) + p % cb.SLICE
        np.testing.assert_array_equal(sc[at], cols[i, : n[i]])
        np.testing.assert_array_equal(sv[at].view(np.int64), vals[i, : n[i]].view(np.int64))
    assert tab.sell_cols.dtype == tab.row_perm.dtype == torch.int32 and tab.sell_off.dtype == torch.int64


def assert_same_bits(a: torch.Tensor, b: torch.Tensor) -> None:
    assert torch.equal(a, b) and torch.equal(torch.signbit(a), torch.signbit(b))


# ------------------------------------------------- the CPU
@pytest.mark.parametrize("window", [1, 64, cb.WINDOW])
@pytest.mark.parametrize("case", list(WIDE))
def test_sliced_layout_holds_each_row(case, window):
    m, w = WIDE[case]
    tab, cols, vals = wide_band(m, w, window=window)
    check_layout(tab, cols, vals, window)
    assert int(tab.row_len.sum()) <= tab.sell_cols.numel() <= cb.SLICE * len(tab.sell_off) * w
    if window == 1:
        np.testing.assert_array_equal(tab.row_perm.numpy(), np.arange(m))
    elif m >= 1000:  # sorted rows: the slices pad less than unsorted ones
        assert tab.sell_cols.numel() < wide_band(m, w, window=1)[0].sell_cols.numel()


@pytest.mark.parametrize("window", [1, cb.WINDOW])
@pytest.mark.parametrize("case", list(WIDE))
def test_plain_product_equals_the_padded_sum(case, window):
    """Bit for bit, the sign of zero included, in both modes."""
    m, w = WIDE[case]
    tab, cols, vals = wide_band(m, w, window=window)
    x = x_for(m)
    b = torch.as_tensor(np.random.default_rng(2).standard_normal(m))
    y = cb.band_ell_ref(tab, x)
    assert_same_bits(y, padded_product(cols, vals, x))
    assert_same_bits(cb.band_ell_ref(tab, x, b=b), padded_product(cols, vals, x, b))
    assert bool(torch.signbit(y[-1])) == (w > 0) and float(y[-1]) == 0.0  # full width, products -0: -0
    if w >= 2 and m > 4:
        assert float(y[4]) == 0.0 and not bool(torch.signbit(y[4]))  # one slot of -0, then the pads: +0
    out = torch.empty(m, dtype=torch.float64)
    assert cb.band_ell(tab, x, out) is out
    assert_same_bits(out, y)


@pytest.mark.parametrize("case", list(WIDE))
def test_ell_rows_give_back_the_host_table(case):
    m, w = WIDE[case]
    tab, cols, vals = wide_band(m, w)
    c, v = tab.ell_rows()
    assert c.dtype == torch.int64 and v.dtype == torch.float64
    np.testing.assert_array_equal(c.numpy(), cols)
    np.testing.assert_array_equal(v.numpy().view(np.int64), vals.view(np.int64))


def test_dot_scratch_and_launch_counts():
    """One launch a dot call whatever n; the scratch: a counter word and
    the chunk sums, zeroed."""
    for n in (1, 1023, 1024, 1025, 48_642, 170_654, 2**20, 2**20 + 1):
        assert cb.dot_stages(n) == 1
        nc = -(-n // cb.CHUNK)
        assert cb.dot_work(n, 2) == (0 if nc == 1 else 1 + 2 * (nc + -(-nc // cb.CHUNK)))
    w = cb.dot_scratch(48_642, 2, "cpu")
    assert w.numel() == cb.dot_work(48_642, 2) and not bool(w.any())
    assert cb.dot_scratch(100, 3, "cpu").numel() == 1


# ------------------------------------------------- the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _on(tab: cb.BandTables, dev) -> cb.BandTables:
    fields = [f.name for f in dataclasses.fields(tab) if isinstance(getattr(tab, f.name), torch.Tensor)]
    return dataclasses.replace(tab, **{f: getattr(tab, f).to(dev) for f in fields})


def _s1_band():
    from phifem_tpu_torch.models import flower

    g = pt.Grid(40, 40, ((-4.5, -4.5), (4.5, 4.5)), pt.CellType.triangle, device="cpu")
    s = pt.WeakDirichletPoisson(g, mode="bg", detection_degree=1, single_layer_cut=True)
    s.setup(flower.levelset, flower.source_term, detection_levelset=flower.detection_levelset).assemble()
    return s.lattice_preconditioner(dtype=torch.float64, kind="schwarz").band_tables


def _neumann3_band():
    from phifem_tpu_torch.models import lattice_core

    u = lambda x: torch.cos(x[..., 0]) * torch.exp((x[..., 1] + x[..., 2]) / 2.0)
    st = pt.NeumannPoisson3(pt.Grid3(8, 8, 8, BOX3, device="cpu")).setup(
        lambda x: (x**2).sum(-1) - 0.49, lambda x: 1.5 * u(x), lambda x: 0.0 * u(x)).assemble()
    total, blocks = st._interface_blocks()
    sel = np.concatenate([st.active[k].numpy().reshape(-1) for k in ("u", "y", "p")])
    ids, A, ras = lattice_core.build_interface_block(blocks, total, sel)
    apply = lattice_core.make_interface_apply(ids, A, [r[r < len(ids)] for r in ras], dense_max=0, sweeps=1,
                                              device="cpu")
    return apply.band.band_tables


def _tet_band():
    m = pt.UMesh3.box(6, 6, 6, BOX3, device="cpu")
    u = lambda x: torch.cos(x[..., 0]) * torch.sin(x[..., 1]) * torch.cos(x[..., 2])
    s = pt.WeakDirichletPoissonU(m, mode="bg").setup(lambda x: (x**2).sum(-1) - 0.61**2, lambda x: 3 * u(x), u_D=u)
    s.assemble()
    return attach_interface_solve(VCycle([], ()), s.op, masked_operator(s.op)[2], kind="schwarz").band_tables


CARD_BANDS = {"s1_flower_n40": _s1_band, "neumann3_n8": _neumann3_band, "tet_n6": _tet_band,
              **{k: (lambda k=k: wide_band(*WIDE[k])[0]) for k in WIDE},
              "w101_m1000_unsorted": lambda: wide_band(*WIDE["w101_m1000"], window=1)[0]}


@pytest.mark.cuda
@pytest.mark.parametrize("band", list(CARD_BANDS))
def test_ell_kernel_equals_plain_version(cuda, band):
    tab = _on(CARD_BANDS[band](), cuda)
    x = x_for(tab.m).to(cuda)
    b = torch.as_tensor(np.random.default_rng(3).standard_normal(tab.m), device=cuda)
    for rhs in (None, b):
        before = cb.ell_launches
        y = cb.band_ell(tab, x, b=rhs)
        torch.cuda.synchronize()
        assert cb.ell_launches == before + 1
        assert_same_bits(y, cb.band_ell_ref(tab, x, b=rhs))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1023, 1024, 1025, 48_642, 170_654, 2**20])
def test_dots_in_one_launch(cuda, n):
    rng = np.random.default_rng(n)
    a, b, c = (torch.as_tensor(rng.standard_normal(n), device=cuda) for _ in range(3))
    work = cb.dot_scratch(n, 3, cuda)
    for q in (1, 2, 3):
        pairs = [(a, b), (c, c), (b, a)][:q]
        want = cb.band_dots_ref(pairs)
        out = torch.empty(q, dtype=torch.float64, device=cuda)
        before = cb.dot_launches
        for _ in range(100):
            out.zero_()
            cb.band_dots(pairs, out, work)
            assert torch.equal(out, want), q
        assert cb.dot_launches == before + 100
    if work.numel() > 1:
        assert float(work[0]) == 0.0  # the arrival counter is back to 0
