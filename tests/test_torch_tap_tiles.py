"""The tap kernel's tile table (``ops.cuda_taps.tile_table``) and the
support it is built from (``TapOperator.support``), on the CPU; and the
port's default device.  No JAX here.

* On S1 (n=24), S3 on quadrilaterals and S4 (n=20), built by the port,
  every nonzero weight lies in ``support``, also after ``reassemble`` and
  after a refresh from random element matrices.
* A plain traversal of the tile table that sums only each tile's active
  taps, in the kernel's order, equals the plain matvec to 1e-13 relative in
  float64 (the same products; the plain version sums them tap by tap over
  whole planes): on those schemes and on synthetic operators with empty
  tiles, whole empty rows of tiles, ragged edges and a target block
  without taps.
"""

import inspect

import numpy as np
import pytest
import torch

import phifem_tpu_torch as pt
from phifem_tpu_torch.ops import cuda_taps
from phifem_tpu_torch.ops.lattice import build_lattice_mg
from phifem_tpu_torch.utils.convert import interface_tables_from_numpy, lattice_mg_from_numpy
from torch_tap_cases import random_tap_operator, sparse_tap_operator
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

BOX = ((-1.0, -1.0), (1.0, 1.0))
SCHEMES = ["s1", "s3_quad", "s4"]


def _circle(x):
    return x[..., 0] ** 2 + x[..., 1] ** 2 - 0.49


def _diamond(x):
    return torch.abs(x[..., 0] + 0.13) + torch.abs(x[..., 1] - 0.02) - 0.71


def _ones(x):
    return torch.ones(x.shape[:-1], dtype=x.dtype)


def _zeros(x):
    return torch.zeros(x.shape[:-1], dtype=x.dtype)


def _build(name):
    if name == "s1":
        g = pt.Grid(24, 24, BOX, pt.CellType.triangle, device="cpu")
        return pt.WeakDirichletPoisson(g, mode="bg").setup(_circle, _ones).assemble()
    ct = "quadrilateral" if name == "s3_quad" else "triangle"
    g = pt.Grid(20, 20, BOX, pt.CellType(ct), device="cpu")
    T = pt.NeumannPoisson if name.startswith("s3") else pt.RobinPoisson
    return T(g, mode="bg").setup(_diamond, _ones, _zeros).assemble()


@pytest.fixture(scope="module")
def schemes():
    return {name: _build(name) for name in SCHEMES}


def _rel(a, b):
    """max|a - b| / max|b|; a field that is zero (a block without taps) must
    be exactly zero."""
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), np.finfo(float).tiny))


def _outside_support(top) -> int:
    nz = torch.nonzero(top.W).reshape(-1).numpy()
    return int((~np.isin(nz, top.support)).sum())


def tile_traversal(top, x):
    """``y`` by walking the tile table as the kernel does: per tile, only its
    active taps, ascending; a tile without one is zero.  Also checks the
    table's order and targets."""
    base, ptr, tile_taps = cuda_taps.tile_table(top)
    TR, TC = cuda_taps.TILE
    order = sorted(range(top.num_taps), key=lambda t: top.taps[t][0])
    P = top.pad
    blocks = [b.cpu().numpy() for b in top._decompose(x)]
    padded = [np.pad(b, ((P, P + TR), (P, P + TC), (0, 0))) for b in blocks]
    W = top.W.cpu().numpy()
    ys = []
    for b, (R, C) in enumerate(top.blk_shapes):
        vi, ntc = top.blk_ch[b], -(-C // TC)
        y = np.full((R, C, vi), np.nan)
        for i in range(base[b], base[b + 1]):
            r0, c0 = (i - base[b]) // ntc * TR, (i - base[b]) % ntc * TC
            r1, c1 = min(r0 + TR, R), min(c0 + TC, C)
            acc = np.zeros((r1 - r0, c1 - c0, vi))
            active = tile_taps[ptr[i] : ptr[i + 1]]
            assert np.all(np.diff(active) > 0)
            for k in active:
                t = order[k]
                bi, bj, dr, dc = top.taps[t]
                assert bi == b
                w = W[top.tap_offsets[t] : top.tap_offsets[t + 1]].reshape(R, C, vi, top.blk_ch[bj])
                src = padded[bj][P + r0 + dr : P + r1 + dr, P + c0 + dc : P + c1 + dc]
                acc += np.einsum("rcij,rcj->rci", w[r0:r1, c0:c1], src)
            y[r0:r1, c0:c1] = acc
        ys.append(torch.as_tensor(y))
    return top._recompose(ys)


def _random_x(top, seed):
    rng = np.random.default_rng(seed)
    return {sp.name: torch.as_tensor(rng.standard_normal((sp.shape[0] * sp.shape[1] * sp.nblocks,) + sp.vshape))
            for sp in top.specs}


@pytest.mark.parametrize("name", SCHEMES)
def test_support_holds_every_weight(schemes, name):
    s = schemes[name]
    top = s.op.lattice_form()
    support = top.support
    assert support is not None and np.all(np.diff(support) > 0)
    assert 0 < len(support) < top.num_weights
    assert _outside_support(top) == 0
    s.phi_h.data = s.phi_h.data * 1.3
    s.op.reassemble()
    assert s.op.lattice_form() is top and top.support is support
    assert _outside_support(top) == 0
    rng = np.random.default_rng(7)
    for i in s.op.dynamic_batch_ids():
        b = s.op.batches[i]
        b.matrices = torch.as_tensor(rng.standard_normal(tuple(b.matrices.shape)))
    top.refresh(s.op)
    assert torch.count_nonzero(top.W) > 0.9 * len(support) and _outside_support(top) == 0


@pytest.mark.parametrize("name", SCHEMES)
def test_tile_traversal_equals_plain_on_schemes(schemes, name):
    top = schemes[name].op.lattice_form()
    x = _random_x(top, 1)
    y = tile_traversal(top, x)
    ref = cuda_taps.tap_matvec_ref(top, top.W, x)
    for k in ref:
        assert _rel(y[k], ref[k]) <= 1e-13, k
    assert 0.0 < cuda_taps.active_tile_fraction(top) < 1.0


@pytest.mark.parametrize("ct", ["triangle", "quadrilateral"])
def test_tile_traversal_equals_plain_on_sparse_support(ct):
    top, x = sparse_tap_operator(37, 23, ct, torch.float64, "cpu")
    base, ptr, _ = cuda_taps.tile_table(top)
    counts = np.diff(ptr)
    last = len(top.blk_shapes) - 1
    assert not counts[base[last] :].any()  # the block without taps
    ntc = -(-top.blk_shapes[0][1] // cuda_taps.TILE[1])
    first = counts[base[0] : base[1]].reshape(-1, ntc)
    assert first[0].any() and not first[-1].any() and not first[:, -1].any()  # empty tiles, rows
    TR, TC = cuda_taps.TILE
    assert all(C % TC for _, C in top.blk_shapes) and any(R % TR for R, _ in top.blk_shapes)  # ragged
    y = tile_traversal(top, x)
    ref = cuda_taps.tap_matvec_ref(top, top.W, x)
    for k in ref:
        assert _rel(y[k], ref[k]) <= 1e-13, k
    assert cuda_taps.active_tile_fraction(top) < 0.5


@pytest.mark.parametrize("case", ["4x4", "4x2", "2x4", "mixed"])
def test_tile_traversal_equals_plain_four_channels(case):
    """The kernel's traversal on operators with 4-channel blocks (37 x 23:
    ragged tiles), against the plain matvec."""
    from torch_tap_cases import FOUR_CHANNEL_PAIRS

    _, fields, chans = next(c for c in FOUR_CHANNEL_PAIRS if c[0] == case)
    top, x = random_tap_operator(37, 23, "triangle", torch.float64, "cpu", fields=fields, chans=chans)
    y = tile_traversal(top, x)
    ref = cuda_taps.tap_matvec_ref(top, top.W, x)
    for k in ref:
        assert _rel(y[k], ref[k]) <= 1e-13, k


def test_tile_table_without_support_lists_every_tap():
    top, x = random_tap_operator(13, 9, "triangle", torch.float64, "cpu")
    base, ptr, tile_taps = cuda_taps.tile_table(top)
    per_block = np.bincount([t[0] for t in top.taps], minlength=len(top.blk_shapes))
    for b in range(len(top.blk_shapes)):
        assert np.all(np.diff(ptr)[base[b] : base[b + 1]] == per_block[b])
    assert cuda_taps.active_tile_fraction(top) == 1.0
    y = tile_traversal(top, x)
    ref = cuda_taps.tap_matvec_ref(top, top.W, x)
    for k in ref:
        assert _rel(y[k], ref[k]) <= 1e-13, k


def _cover_counts(top):
    """Per field, how often the kernel writes each element: once per zero
    run that holds it, once per active tile that holds it."""
    base, ptr, _ = cuda_taps.tile_table(top)
    runs, work = cuda_taps.zero_runs(top, base, ptr)
    assert work[0] == 0 and work[-1] == len(runs) and np.all(np.diff(work) > 0)
    assert np.all(np.diff(work) <= cuda_taps._STAGE) and np.all((runs[:, 2] > 0) & (runs[:, 2] <= cuda_taps._RUN))
    TR, TC = cuda_taps.TILE
    counts = {}
    for sp in top.specs:
        n = sp.shape[0] * sp.shape[1] * sp.nblocks * sp.vsz
        cnt = np.zeros(n, np.int64)
        for b, start, length in runs[runs[:, 0] == sp.base]:
            cnt[start : start + length] += 1
        R, C = sp.shape
        for o in range(sp.nblocks):
            b = sp.base + o
            ntc = -(-C // TC)
            for i in np.flatnonzero(np.diff(ptr)[base[b] : base[b + 1]]):
                r0, c0 = i // ntc * TR, i % ntc * TC
                for r in range(r0, min(r0 + TR, R)):
                    for c in range(c0, min(c0 + TC, C)):
                        el = (r * C + c) * sp.nblocks * sp.vsz + o * sp.vsz
                        cnt[el : el + sp.vsz] += 1
        counts[sp.name] = cnt
    return counts


@pytest.mark.parametrize("case", ["s1", "s4", "s4_short_runs", "sparse_tri", "sparse_quad", "dense"])
def test_every_output_written_once(schemes, case, monkeypatch):
    """The zero runs and the active tiles of the kernel's table cover every
    output of every field exactly once (one writer per output); also where
    runs are cut to a few elements and work items to a few runs."""
    if case == "s4_short_runs":
        monkeypatch.setattr(cuda_taps, "_RUN", 50)
        monkeypatch.setattr(cuda_taps, "_STAGE", 4)
        case = "s4"
    if case in schemes:
        top = schemes[case].op.lattice_form()
    elif case == "dense":
        top, _ = random_tap_operator(13, 9, "triangle", torch.float64, "cpu")
    else:
        top, _ = sparse_tap_operator(37, 23, case.split("_")[1].replace("tri", "triangle").replace(
            "quad", "quadrilateral"), torch.float64, "cpu")
    for name, cnt in _cover_counts(top).items():
        assert np.all(cnt == 1), name


@pytest.mark.parametrize("fn", [build_lattice_mg, lattice_mg_from_numpy, interface_tables_from_numpy])
def test_builders_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_grid_defaults_to_the_card():
    g = pt.Grid(4, 4)  # allocates nothing
    assert g.device.type == "cuda"
    assert pt.Grid(4, 4, device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert g.vertex_coords.device.type == "cuda"
    else:  # no fallback to the CPU
        with pytest.raises((RuntimeError, AssertionError)):
            g.vertex_coords
