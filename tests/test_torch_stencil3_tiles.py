"""The tilings of the two 3D kernels, walked on the CPU.

The CUDA kernels cannot run here, so a plain traversal of each kernel's
tiles, driven by the same tile constants that reach the kernels as -D
defines (``cuda_lattice3.TILE``, ``cuda_hex3.TILE``), does the work each
kernel does, in its order of sums, and must equal the plain version bit for
bit (``torch.equal``) and write every output exactly once:

* the 27-point lattice sweep: every thread of the launch owns one (x, y)
  column of the padded array and a run of planes, with its window of
  neighbours at clamped coordinates (an inner output never needs a clamp),
  the terms at their canonical positions in ascending order from -0, the
  shell written by the same threads;
* the masked hex-cell stencil at degree 1: a thread per node column and a run
  of nodes along z, each node adding its active cells in ascending local
  index; at degree 2 and 3: tiles of cells with a one-cell halo on the low
  side, tiles with no active cell writing zeros, work items of a block of
  rows by a block of cells that cover every (row, cell) once, the row dots
  kept only for the nodes the tile owns (in slots that start as NaN), and
  each owned node adding its slots in ascending local index;
* the 3-channel block forms: the block sweep by CTAs that tile the logical
  interior, each staging its three channels with a halo, each thread
  streaming its run's planes in ascending z through a one-plane window so
  that every node takes its 3 x 3 block parts in ascending position from
  -0, and the CTAs on the array's faces writing the shell; the block hex
  stencil by CTAs of node columns and runs (one or all three output
  channels each) that stage their cell masks first and read no x when none
  is active, each node summing every cell's row dot over ascending
  (channel, node) and adding the active cells' in ascending local index.

Shapes: ragged lattices, sides smaller than one tile and exact multiples of
one, a lattice of one CTA and one with no interior, the sphere mask, all-
empty and all-full masks, float32 and float64.
"""

import itertools
import re

import numpy as np
import pytest
import torch

from phifem_tpu_torch.ops import cuda_hex3, cuda_lattice3 as cl
from phifem_tpu_torch.ops.lattice3 import _terms3, hex_element_matrix, vertex_stencil_weights3
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

DTYPES = {"f32": torch.float32, "f64": torch.float64}
MODES = {"matvec": (cl.MATVEC, False), "residual": (cl.RESIDUAL, True), "jacobi_masked": (cl.JACOBI, True),
         "jacobi": (cl.JACOBI, False)}
# logical (D, R, C): ragged, smaller than a CTA, the padded array an exact
# multiple of the CTA's extent (16 x 8 x 64 with the default tile), and large
LATTICE_SHAPES = [(5, 7, 9), (3, 5, 4), (37, 37, 37), (129, 65, 33), (14, 6, 62)]


def _ids(shape):
    return "x".join(map(str, shape))


def _sweep_inputs(shape, dt, seed):
    rng = np.random.default_rng(seed)
    D, R, C = shape
    x = torch.zeros((D + 2, R + 2, C + 2), dtype=dt)
    b = torch.zeros_like(x)
    x[2:D, 2:R, 2:C] = torch.as_tensor(rng.standard_normal((D - 2, R - 2, C - 2)), dtype=dt)
    b[2:D, 2:R, 2:C] = torch.as_tensor(rng.standard_normal((D - 2, R - 2, C - 2)), dtype=dt)
    x[0], x[:, -1] = 1.5, -2.5  # a shell that the Jacobi sweep keeps
    mask = torch.as_tensor(rng.random(shape) < 0.7, dtype=dt)
    w = vertex_stencil_weights3(hex_element_matrix(0.3, 0.2, 0.25, stiffness=1.0, mass=2.0))
    return x, b, mask, cl.pack_terms(_terms3(w)), 0.8 / w[1, 1, 1]


def lattice_traversal(mode, x, terms, b, mask, scale, tile=cl.TILE):
    """The sweep by the kernel's threads, all at once: each thread of the
    launch's grid owns one (x, y) column of the padded array and a run of
    planes, loads its window of (run + 2) planes x 3 rows x 3 columns at
    clamped coordinates and sums the terms in ascending canonical position
    from -0.  Returns the output and how often each element was written."""
    dt = x.dtype
    PD, PR, PC = x.shape
    D, R, C = PD - 2, PR - 2, PC - 2
    nbx, nby, nbz, sh = cl.tile_grid(D, R, C, dt, tile)
    BX, BY, RZ = sh["BX"] * sh["RX"], sh["BY"], sh["RZ"]  # a CTA's columns, rows and planes
    assert nbx * BX >= PC and nby * BY >= PR and nbz * RZ >= PD  # the grid covers the array
    assert (nbx - 1) * BX < PC and (nby - 1) * BY < PR and (nbz - 1) * RZ < PD  # and no CTA is empty
    w = {(a * 3 + bb) * 3 + c: torch.tensor(wt, dtype=dt) for a, bb, c, wt in terms}  # rounded once to T
    s = torch.tensor(scale, dtype=dt)
    # one thread per (run, row, column) of the grid; threads off the array return
    pz0, py, px = torch.meshgrid(torch.arange(nbz) * RZ, torch.arange(nby * BY), torch.arange(nbx * BX), indexing="ij")
    live = (py < PR) & (px < PC)
    pz0, py, px = pz0[live], py[live], px[live]
    clz = lambda v, hi: v.clamp(0, hi - 1)
    win = [[[x[clz(pz0 - 1 + a, PD), clz(py - 1 + r, PR), clz(px - 1 + c, PC)] for c in range(3)] for r in range(3)]
           for a in range(RZ + 2)]
    out = torch.full_like(x, float("nan"))
    written = torch.zeros(x.shape, dtype=torch.int32)
    colin = (px >= 2) & (px <= C - 1) & (py >= 2) & (py <= R - 1)
    for k in range(RZ):
        pz = pz0 + k
        on = pz < PD
        acc = torch.full(px.shape, -0.0, dtype=dt)
        for p in range(27):
            if p in w:
                acc = acc + w[p] * win[k + p // 9][(p // 3) % 3][p % 3]
        inner = colin & (pz >= 2) & (pz <= D - 1)
        # an inner output's window needs no clamping
        assert bool(((pz[inner] - 1 >= 0) & (pz[inner] + 1 < PD)).all())
        xc = win[k + 1][1][1]
        if mode == cl.MATVEC:
            val = torch.where(inner, acc, torch.zeros_like(acc))
        else:
            pzc = clz(pz, PD)
            res = b[pzc, py, px] - acc
            if mode == cl.JACOBI:
                res = s * res
            if mask is not None:
                res = res * mask[clz(pzc - 1, D), clz(py - 1, R), clz(px - 1, C)]
            val = xc + res if mode == cl.JACOBI else res
            val = torch.where(inner, val, xc if mode == cl.JACOBI else torch.zeros_like(xc))
        out[pz[on], py[on], px[on]] = val[on]
        written.index_put_((pz[on], py[on], px[on]), torch.ones(int(on.sum()), dtype=torch.int32), accumulate=True)
    return out, written


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("shape", LATTICE_SHAPES, ids=_ids)
def test_lattice3_tiles_match_plain_version(shape, mode, dt):
    m_id, masked = MODES[mode]
    x, b, mask, terms, od = _sweep_inputs(shape, DTYPES[dt], seed=sum(shape))
    m = mask if masked else None
    out, written = lattice_traversal(m_id, x, terms, b, m, od)
    assert bool((written == 1).all())
    assert torch.equal(out, cl.lattice3_sweep_ref(m_id, x, terms, b, m, od))


def test_lattice3_terms_must_ascend():
    w = vertex_stencil_weights3(hex_element_matrix(0.3, 0.2, 0.25))
    terms = _terms3(w)
    with pytest.raises(ValueError):
        cl.pack_terms(terms[::-1])
    with pytest.raises(ValueError):
        cl.pack_terms(terms + terms[-1:])


# ------------------------------------------------------------------ hex3
def _hex_inputs(mask, degree, seed):
    rng = np.random.default_rng(seed)
    nz, ny, nx = mask.shape
    dt = mask.dtype
    nloc = (degree + 1) ** 3
    x = torch.as_tensor(rng.standard_normal((degree * nz + 1, degree * ny + 1, degree * nx + 1)), dtype=dt)
    return x, torch.as_tensor(rng.standard_normal((nloc, nloc)), dtype=dt)


def _axis_cells(v, d, tc):
    """(halo-indexed cell, local offset) along one axis of the owned node v,
    in ascending offset: the kernel's axis_cells."""
    c, r = divmod(v, d)
    if r:
        return [(c + 1, r)]
    return ([(c + 1, 0)] if c < tc else []) + [(c, d)]


def hex1_traversal(x, mask, A, tile=cuda_hex3.TILE):
    """The degree-1 kernel: every thread of the launch owns one (x, y) node
    column and a run of nodes along z; each node adds, in ascending local
    index i, the active cells around it (cell = node - offset_i), each as
    mask * (its row dot over ascending j), from 0.  Windows at clamped
    coordinates; a cell outside the grid has mask 0."""
    dt = x.dtype
    nz, ny, nx = mask.shape
    D, R, C = x.shape
    sfx = "_F64" if dt == torch.float64 else "_F32"
    BX, BY, RZ, ZR = tile["BX1"], tile["BY1"], tile["RZ1" + sfx], tile["RZ1" + sfx] * tile["ZCH1"]
    cdiv = lambda a, b: -(-a // b)
    nbx, nby, nbz = cdiv(C, BX), cdiv(R, BY), cdiv(D, ZR)  # a CTA marches over ZCH1 blocks of RZ nodes
    assert (nbx - 1) * BX < C and (nby - 1) * BY < R and (nbz - 1) * ZR < D
    runs = torch.arange(nbz * tile["ZCH1"]) * RZ
    z0, py, px = torch.meshgrid(runs[runs < D], torch.arange(nby * BY), torch.arange(nbx * BX), indexing="ij")
    live = (py < R) & (px < C)
    z0, py, px = z0[live], py[live], px[live]
    y = torch.full_like(x, float("nan"))
    written = torch.zeros(x.shape, dtype=torch.int32)
    offs = [(i >> 2, (i >> 1) & 1, i & 1) for i in range(8)]  # (oz, oy, ox) of local index i
    for k in range(RZ):
        pz = z0 + k
        on = pz < D
        acc = torch.zeros(px.shape, dtype=dt)
        for i, (oz, oy, ox) in enumerate(offs):
            cz, cy, cx = pz - oz, py - oy, px - ox
            inside = (cz >= 0) & (cz < nz) & (cy >= 0) & (cy < ny) & (cx >= 0) & (cx < nx)
            m = torch.where(inside, mask[cz.clamp(0, nz - 1), cy.clamp(0, ny - 1), cx.clamp(0, nx - 1)],
                            torch.zeros((), dtype=dt))
            s = None
            for j, (jz, jy, jx) in enumerate(offs):
                t = A[i, j] * x[(cz + jz).clamp(0, D - 1), (cy + jy).clamp(0, R - 1), (cx + jx).clamp(0, C - 1)]
                s = t if s is None else s + t
            acc = torch.where(m != 0, acc + m * s, acc)
        y[pz[on], py[on], px[on]] = acc[on]
        written.index_put_((pz[on], py[on], px[on]), torch.ones(int(on.sum()), dtype=torch.int32), accumulate=True)
    return y, written


def hex_traversal(x, mask, A, d, tile=cuda_hex3.TILE):
    """``y`` by the degree-2 / 3 kernel's tiles, and how often each node was
    written.  Also returns the number of tiles that skipped x (no active
    cell)."""
    dt = x.dtype
    nz, ny, nx = mask.shape
    P = d + 1
    nloc = P**3
    TC, KC, RB = tile[f"TC{d}"], tile["KC"], cuda_hex3.ROWS[d]
    HC = TC + 1
    assert nloc % RB == 0
    y = torch.full_like(x, float("nan"))
    written = torch.zeros(x.shape, dtype=torch.int32)
    offs = [(oz, oy, ox) for oz in range(P) for oy in range(P) for ox in range(P)]
    cdiv = lambda a, b: -(-a // b)
    skipped = 0
    for tz, ty, tx in itertools.product(range(cdiv(nz, TC)), range(cdiv(ny, TC)), range(cdiv(nx, TC))):
        t0 = (tz * TC, ty * TC, tx * TC)
        ncell = (nz, ny, nx)
        own = [d * (n - t) + 1 if t + TC >= n else d * TC for t, n in zip(t0, ncell)]
        # 1. the masks of the tile and its low halo, 0 outside the grid
        ms = torch.zeros((HC, HC, HC), dtype=dt)
        lo = [max(t - 1, 0) for t in t0]
        hi = [min(t + TC, n) for t, n in zip(t0, ncell)]
        ms[tuple(slice(l - t + 1, h - t + 1) for l, h, t in zip(lo, hi, t0))] = \
            mask[lo[0] : hi[0], lo[1] : hi[1], lo[2] : hi[2]]
        act = torch.nonzero(ms != 0)
        base = tuple(d * t for t in t0)
        onodes = tuple(slice(bb, bb + o) for bb, o in zip(base, own))
        if len(act) == 0:
            y[onodes] = 0
            written[onodes] += 1
            skipped += 1
            continue
        # the work items (row block, block of KC cells) cover every (row, cell) once
        na = len(act)
        items = [(it % (nloc // RB), it // (nloc // RB)) for it in range((nloc // RB) * cdiv(na, KC))]
        pairs = sorted((rb * RB + r, cb * KC + k) for rb, cb in items for r in range(RB) for k in range(KC)
                       if cb * KC + k < na)
        assert pairs == [(i, c) for i in range(nloc) for c in range(na)]
        # 2. x at the nodes [d (t0 - 1), d (t0 + TC)], 0 outside the lattice
        HN = d * HC + 1
        xs = torch.zeros((HN, HN, HN), dtype=dt)
        g0 = [d * (t - 1) for t in t0]
        gl = [max(g, 0) for g in g0]
        gh = [min(g + HN, s) for g, s in zip(g0, x.shape)]
        xs[tuple(slice(l - g, h - g) for l, h, g in zip(gl, gh, g0))] = x[gl[0] : gh[0], gl[1] : gh[1], gl[2] : gh[2]]
        # 3. row dots of the active cells, ascending j, kept for owned rows
        qz, qy, qx = act[:, 0], act[:, 1], act[:, 2]
        xc = torch.stack([xs[d * qz + jz, d * qy + jy, d * qx + jx] for jz, jy, jx in offs], 1)  # (na, nloc)
        s = A[None, :, 0] * xc[:, :1]
        for j in range(1, nloc):
            s = s + A[None, :, j] * xc[:, j : j + 1]
        slot = torch.full((HC, HC, HC, nloc), float("nan"), dtype=dt)
        for r, (oz, oy, ox) in enumerate(offs):
            v = [d * (q - 1) + o for q, o in zip((qz, qy, qx), (oz, oy, ox))]
            owned = (v[0] >= 0) & (v[0] < own[0]) & (v[1] >= 0) & (v[1] < own[1]) & (v[2] >= 0) & (v[2] < own[2])
            cz, cy, cx = qz[owned], qy[owned], qx[owned]
            slot[cz, cy, cx, r] = ms[cz, cy, cx] * s[owned, r]
        # 4. each owned node: its slots in ascending local index, from 0
        for lz, ly, lx in itertools.product(range(own[0]), range(own[1]), range(own[2])):
            acc = torch.zeros((), dtype=dt)
            for (cz, oz), (cy, oy), (cx, ox) in itertools.product(
                    _axis_cells(lz, d, TC), _axis_cells(ly, d, TC), _axis_cells(lx, d, TC)):
                if ms[cz, cy, cx] != 0:
                    acc = acc + slot[cz, cy, cx, (oz * P + oy) * P + ox]
            y[base[0] + lz, base[1] + ly, base[2] + lx] = acc
            written[base[0] + lz, base[1] + ly, base[2] + lx] += 1
    return y, written, skipped


def _sphere_mask(n: int, dt) -> torch.Tensor:
    import phifem_tpu_torch as pt
    from phifem_tpu_torch.tagging3 import compute_tags3

    g = pt.Grid3(n, n, n, ((-1.0,) * 3, (1.0,) * 3), device="cpu")
    tags = compute_tags3(g, lambda x: x[..., 0] ** 2 + x[..., 1] ** 2 + x[..., 2] ** 2 - 0.49)
    return torch.as_tensor(tags.region_mask((1, 2)), dtype=dt).contiguous()


# n: smaller than a tile (3, 5), ragged (13), an exact multiple of every
# degree's tile side with the default tiling (12), the sphere (n=10)
HEX_CASES = {"3": (3, 4, 3), "5": (5, 5, 5), "12": (12, 12, 12), "13": (13, 7, 9), "sphere10": None}


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("degree", [1, 2, 3])
@pytest.mark.parametrize("case", list(HEX_CASES))
def test_hex3_tiles_match_plain_version(case, degree, dt):
    tdt = DTYPES[dt]
    if HEX_CASES[case] is None:
        mask = _sphere_mask(10, tdt)
    else:
        rng = np.random.default_rng(len(case) + degree)
        mask = torch.as_tensor(rng.random(HEX_CASES[case]) < 0.4, dtype=tdt)
    x, A = _hex_inputs(mask, degree, seed=degree)
    y, written = hex1_traversal(x, mask, A) if degree == 1 else hex_traversal(x, mask, A, degree)[:2]
    assert bool((written == 1).all())
    assert torch.equal(y, cuda_hex3.hex_stencil3_ref(x, mask, A, degree))


def test_hex3_inactive_tiles_read_no_x():
    """Tiles whose cells and low halo are all inactive write zeros only."""
    tc = cuda_hex3.TILE["TC2"]
    rng = np.random.default_rng(4)
    mask = torch.as_tensor(rng.random((2 * tc, 2 * tc, 2 * tc)) < 0.5, dtype=torch.float64)
    mask[:tc] = 0  # the low half in z: the first layer of tiles has no active cell
    x, A = _hex_inputs(mask, 2, seed=0)
    y, written, skipped = hex_traversal(x, mask, A, 2)
    assert bool((written == 1).all()) and torch.equal(y, cuda_hex3.hex_stencil3_ref(x, mask, A, 2))
    assert skipped == 4


def test_tile_constants_reach_the_kernels():
    """The wrappers build their sources with their TILE and BLOCK_TILE as -D
    defines, so a change of a constant rebuilds the kernel that the tests
    describe."""
    assert cl.defines() == tuple(f"-DPHIFEM_L3_{k}={v}" for k, v in cl.TILE.items()) + tuple(
        f"-DPHIFEM_L3B_{k}={v}" for k, v in cl.BLOCK_TILE.items())
    assert cuda_hex3.defines() == tuple(f"-DPHIFEM_HEX3_{k}={v}" for k, v in cuda_hex3.TILE.items()) + tuple(
        f"-DPHIFEM_HEX3B_{k}={v}" for k, v in cuda_hex3.BLOCK_TILE.items())
    for mod, prefix, bprefix in ((cl, "PHIFEM_L3_", "PHIFEM_L3B_"), (cuda_hex3, "PHIFEM_HEX3_", "PHIFEM_HEX3B_")):
        src = mod.SOURCE.read_text()
        for k in mod.TILE:
            assert f"#ifndef {prefix}{k}" in src
        for k in mod.BLOCK_TILE:
            assert f"#ifndef {bprefix}{k}" in src
        # and every tiling macro the source reads is one the wrapper passes
        for k in re.findall(rf"#ifndef {bprefix}(\w+)", src):
            assert k in mod.BLOCK_TILE
        for k in re.findall(rf"#ifndef {prefix}(\w+)", src):
            assert k in mod.TILE


# ------------------------------------------------------ 3-channel blocks
def _block_sweep_inputs(shape, dt, seed):
    from phifem_tpu_torch.models.interface_elasticity import lame
    from phifem_tpu_torch.models.interface_elasticity3 import _elastic_element_matrix
    from phifem_tpu_torch.ops.lattice3 import _block_terms3, block_vertex_stencil_weights3

    rng = np.random.default_rng(seed)
    D, R, C = shape
    x = torch.zeros((3, D + 2, R + 2, C + 2), dtype=dt)
    b = torch.zeros_like(x)
    if min(shape) > 2:  # an interior
        x[:, 2:D, 2:R, 2:C] = torch.as_tensor(rng.standard_normal((3, D - 2, R - 2, C - 2)), dtype=dt)
        b[:, 2:D, 2:R, 2:C] = torch.as_tensor(rng.standard_normal((3, D - 2, R - 2, C - 2)), dtype=dt)
    x[:, 0], x[:, :, -1] = 1.5, -2.5
    mask = torch.as_tensor(rng.random(shape) < 0.7, dtype=dt)
    terms = _block_terms3(block_vertex_stencil_weights3(_elastic_element_matrix(0.3, 0.2, 0.25, *lame(1.0, 0.3)), 3))
    dinv = np.linalg.inv(next(W for a, bb, c, W in terms if (a, bb, c) == (1, 1, 1)))
    return x, b, mask, cl.pack_block_terms(terms, dinv)


def lattice_block_traversal(mode, x, packed, b, mask, omega, tile=cl.BLOCK_TILE):
    """The block sweep by the kernel's CTAs and threads.  The grid tiles the
    logical interior ([2, D-1] x [2, R-1] x [2, C-1] in padded
    coordinates) with ``BX`` x the dtype's ``BY`` x ``RZ``; each CTA stages
    its three channels with a one-node halo at clamped coordinates; each
    thread owns one column and a run of RZ planes and streams planes
    z0 - 1 .. z0 + RZ through a one-plane window of 3 channels x 3 rows x 3
    columns, plane a giving node k the terms at oz = a - k, in ascending
    canonical position from -0, per output channel the part
    ((w0 x0 + w1 x1) + w2 x2), every weight rounded once to T; the CTAs on
    the array's faces write the shell beyond their tiles by rows.  Returns
    the output and how often each node was written."""
    dt = x.dtype
    vsz, PD, PR, PC = x.shape
    D, R, C = PD - 2, PR - 2, PC - 2
    nbx, nby, nbz, sh = cl.block_tile_grid(D, R, C, dt, tile)
    BX, BY, RZ = sh["BX"], sh["BY"], sh["RZ"]
    NP = RZ + 2
    # the tiles cover the interior, and no tile lies beyond it but a lone one
    assert nbx * BX >= C - 2 and nby * BY >= R - 2 and nbz * RZ >= D - 2
    assert nbx == 1 or (nbx - 1) * BX < C - 2
    assert nby == 1 or (nby - 1) * BY < R - 2
    assert nbz == 1 or (nbz - 1) * RZ < D - 2
    w = {(a * 3 + bb) * 3 + c: torch.tensor(W, dtype=dt) for a, bb, c, W in packed}
    dinv, om = torch.tensor(packed.dinv, dtype=dt), torch.tensor(omega, dtype=dt)
    out = torch.full_like(x, float("nan"))
    written = torch.zeros((PD, PR, PC), dtype=torch.int64)
    cz, cy, cx = (v.reshape(-1) for v in torch.meshgrid(torch.arange(nbz), torch.arange(nby), torch.arange(nbx),
                                                         indexing="ij"))
    z0, y0, x0 = 2 + cz * RZ, 2 + cy * BY, 2 + cx * BX  # each CTA's first interior node
    # 1. each CTA's block, (3, RZ + 2, BY + 2, BX + 2) at clamped coordinates
    clamp = lambda v, n: v.clamp(0, n - 1)
    za = clamp(z0[:, None] - 1 + torch.arange(NP), PD)
    yr = clamp(y0[:, None] - 1 + torch.arange(BY + 2), PR)
    xq = clamp(x0[:, None] - 1 + torch.arange(BX + 2), PC)
    blk = x[:, za[:, :, None, None], yr[:, None, :, None], xq[:, None, None, :]].movedim(0, 1)  # (cta, c, a, r, q)
    # 2. every thread of every CTA: (cta, ty, tx), flattened
    ct, ty, tx = (v.reshape(-1) for v in torch.meshgrid(torch.arange(len(z0)), torch.arange(BY), torch.arange(BX),
                                                         indexing="ij"))
    px, py, pz0 = x0[ct] + tx, y0[ct] + ty, z0[ct]
    live = (py <= R - 1) & (px <= C - 1)
    acc = [[torch.full(ct.shape, -0.0, dtype=dt) for _ in range(vsz)] for _ in range(RZ)]
    for a in range(NP):  # planes in ascending z
        win = [[[blk[ct, c, a, ty + r, tx + q] for q in range(3)] for r in range(3)] for c in range(vsz)]
        for oz in range(3):
            k = a - oz
            if not 0 <= k < RZ:
                continue
            for q in range(9):
                p, oy, ox = oz * 9 + q, q // 3, q % 3
                if p not in w:
                    continue
                for i in range(vsz):
                    part = w[p][i, 0] * win[0][oy][ox]
                    for j in range(1, vsz):
                        part = part + w[p][i, j] * win[j][oy][ox]
                    acc[k][i] = acc[k][i] + part
    for k in range(RZ):
        pz = pz0 + k
        on = live & (pz <= D - 1)
        zi, yi, xi = pz[on], py[on], px[on]
        written.index_put_((zi, yi, xi), torch.ones(len(zi), dtype=torch.int64), accumulate=True)
        for i in range(vsz):
            if mode == cl.MATVEC:
                out[i, zi, yi, xi] = acc[k][i][on]
                continue
            res = [b[c, zi, yi, xi] - acc[k][c][on] for c in range(vsz)]
            m = None if mask is None else mask[zi - 1, yi - 1, xi - 1]
            if mode == cl.RESIDUAL:
                out[i, zi, yi, xi] = res[i] if m is None else res[i] * m
                continue
            d = dinv[i, 0] * res[0]
            for j in range(1, vsz):
                d = d + dinv[i, j] * res[j]
            upd = om * d
            if m is not None:
                upd = upd * m
            out[i, zi, yi, xi] = blk[ct[on], i, k + 1, ty[on] + 1, tx[on] + 1] + upd
    # 3. the shell: a CTA on a face extends its tile to the array's edge
    for c_z, c_y, c_x, zz0, yy0, xx0 in zip(cz.tolist(), cy.tolist(), cx.tolist(), z0.tolist(), y0.tolist(),
                                            x0.tolist()):
        ext = [(0 if cb == 0 else o, P if cb == nb - 1 else o + t) for cb, nb, o, t, P in
               ((c_z, nbz, zz0, RZ, PD), (c_y, nby, yy0, BY, PR), (c_x, nbx, xx0, BX, PC))]
        inner = torch.zeros((PD, PR, PC), dtype=torch.bool)
        inner[zz0:min(zz0 + RZ, D), yy0:min(yy0 + BY, R), xx0:min(xx0 + BX, C)] = True
        box = torch.zeros_like(inner)
        box[ext[0][0]:ext[0][1], ext[1][0]:ext[1][1], ext[2][0]:ext[2][1]] = True
        shell = box & ~inner
        written += shell
        out[:, shell] = x[:, shell] if mode == cl.JACOBI else 0.0
    return out, written


# logical (D, R, C): besides LATTICE_SHAPES' ragged ones, an interior that is
# an exact multiple of the default tiles (32 x 8 x 16), a lattice with no
# interior and one with a single interior node (one CTA each), and a ragged
# one
BLOCK_LATTICE_SHAPES = LATTICE_SHAPES[:3] + LATTICE_SHAPES[4:] + [(18, 10, 34), (1, 1, 1), (3, 3, 3), (9, 17, 11)]


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("shape", BLOCK_LATTICE_SHAPES, ids=_ids)
def test_lattice3_block_tiles_match_plain_version(shape, mode, dt):
    md, masked = MODES[mode]
    x, b, mask, packed = _block_sweep_inputs(shape, DTYPES[dt], seed=len(shape) + md)
    m = mask if masked else None
    y, written = lattice_block_traversal(md, x, packed, b, m, 0.6)
    assert bool((written == 1).all())
    assert torch.equal(y, cl.lattice3_block_sweep_ref(md, x, packed, b, m, 0.6))


# block term sets with positions (oz, oy, ox) dropped, the centre kept: the
# kernel's branch per absent term (every S5-3D stencil has all 27)
PARTIAL_TERMS = {"no_corners": lambda a, b, c: not {a, b, c} <= {0, 2},
                 "star": lambda a, b, c: sorted((a, b, c)) in ([1, 1, 1], [0, 1, 1], [1, 1, 2]),
                 "no_top_plane": lambda a, b, c: a != 2}


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("terms", list(PARTIAL_TERMS))
@pytest.mark.parametrize("shape", [(5, 6, 7), (18, 10, 34)], ids=_ids)
def test_lattice3_block_tiles_partial_terms_match_plain_version(shape, terms, mode, dt):
    md, masked = MODES[mode]
    x, b, mask, full = _block_sweep_inputs(shape, DTYPES[dt], seed=len(shape) + md)
    packed = cl.pack_block_terms([t for t in full if PARTIAL_TERMS[terms](*t[:3])], full.dinv)
    assert 0 < len(packed) < len(full)
    m = mask if masked else None
    y, written = lattice_block_traversal(md, x, packed, b, m, 0.6)
    assert bool((written == 1).all())
    assert torch.equal(y, cl.lattice3_block_sweep_ref(md, x, packed, b, m, 0.6))


@pytest.mark.parametrize("dt", list(DTYPES))
def test_lattice3_block_tiles_other_shapes(dt):
    """Tilings other than the shipped one (short runs, small CTAs, rolled
    or not) walk to the same bits."""
    tile = {"BX": 7, "BY_F32": 3, "RZ_F32": 3, "ROLL_F32": 0, "BY_F64": 5, "RZ_F64": 2, "ROLL_F64": 1}
    x, b, mask, packed = _block_sweep_inputs((13, 9, 22), DTYPES[dt], seed=7)
    for md, m in ((cl.MATVEC, None), (cl.JACOBI, mask)):
        y, written = lattice_block_traversal(md, x, packed, b, m, 0.6, tile)
        assert bool((written == 1).all())
        assert torch.equal(y, cl.lattice3_block_sweep_ref(md, x, packed, b, m, 0.6))


def hexblock_traversal(x, mask, K, tile=cuda_hex3.BLOCK_TILE):
    """The block hex stencil by the kernel's CTAs and threads: a CTA of the
    dtype's BX x BY threads, each a node column and a run of RZ nodes along
    z, for all three output channels or, with SPLIT, one (the channel the
    slowest part of the grid's z).  The CTA first stages the
    cell masks around its nodes (0 outside the grid); with none active it
    writes zeros and reads no x.  Otherwise it stages x's three channels
    with a one-node halo at clamped coordinates, and per node each input
    channel's 3 x 3 x 3 window adds every cell's products to the row sums
    s[c][i] in ascending (channel, node) from the first product; each output
    channel then adds m_i s[c][i] over the active cells in ascending i from
    +0.  Returns y, how often each output was written, the number of CTAs
    that read no x and the x values the others staged."""
    dt = x.dtype
    vsz, D, R, C = x.shape
    nz, ny, nx = mask.shape
    sfx = "_F64" if dt == torch.float64 else "_F32"
    BX, BY, RZ, split = tile["BX"], tile["BY"], tile["RZ"], tile["SPLIT" + sfx]
    cdiv = lambda a, q: -(-a // q)
    nbx, nby, nbz = cdiv(C, BX), cdiv(R, BY), cdiv(D, RZ)
    assert (nbx - 1) * BX < C and (nby - 1) * BY < R and (nbz - 1) * RZ < D  # no CTA is empty
    groups = [[c] for c in range(vsz)] if split else [list(range(vsz))]  # output channels of each CTA
    Kt = K.to(dt)
    y = torch.full_like(x, float("nan"))
    written = torch.zeros(x.shape, dtype=torch.int64)
    cg, cz, cy, cx = (v.reshape(-1) for v in torch.meshgrid(torch.arange(len(groups)), torch.arange(nbz),
                                                             torch.arange(nby), torch.arange(nbx), indexing="ij"))
    z0, y0, x0 = cz * RZ, cy * BY, cx * BX
    # 1. the masks around each CTA's nodes: cells z0-1 .. z0+RZ-1 (y, x alike), 0 outside the grid
    mp = torch.zeros((nz + 2, ny + 2, nx + 2), dtype=dt)
    mp[1:-1, 1:-1, 1:-1] = mask
    ia = lambda o, n, t: (o[:, None] + torch.arange(t + 1)).clamp(max=n + 1)  # index into mp: cell + 1
    sm = mp[ia(z0, nz, RZ)[:, :, None, None], ia(y0, ny, BY)[:, None, :, None], ia(x0, nx, BX)[:, None, None, :]]
    found = (sm != 0).flatten(1).any(1)
    # every (CTA, thread): node column px, row py
    ct, ty, tx = (v.reshape(-1) for v in torch.meshgrid(torch.arange(len(z0)), torch.arange(BY), torch.arange(BX),
                                                         indexing="ij"))
    px, py = x0[ct] + tx, y0[ct] + ty
    live = (px < C) & (py < R)

    def put(sel, pz, vals_of):
        for c in range(vsz):
            mine = sel & (cg[ct] == groups.index([c]) if split else sel)
            y[c, pz[mine], py[mine], px[mine]] = vals_of(c, mine)
            written[c].index_put_((pz[mine], py[mine], px[mine]), torch.ones(int(mine.sum()), dtype=torch.int64),
                                  accumulate=True)

    # CTAs with no active cell: zeros
    for k in range(RZ):
        pz = z0[ct] + k
        put(live & (pz < D) & ~found[ct], pz, lambda c, sel: 0.0)
    # 2. the others stage x at clamped coordinates
    cl_ = lambda o, n, t: (o[:, None] - 1 + torch.arange(t + 2)).clamp(0, n - 1)
    sx = x[:, cl_(z0, D, RZ)[:, :, None, None], cl_(y0, R, BY)[:, None, :, None], cl_(x0, C, BX)[:, None, None, :]]
    x_staged = int(found.sum()) * sx[0, 0].numel() * vsz
    # 3. each thread's run, node by node
    act = found[ct] & live
    for k in range(RZ):
        pz = z0[ct] + k
        m = [sm[ct, k + 1 - (i >> 2), ty + 1 - ((i >> 1) & 1), tx + 1 - (i & 1)] for i in range(8)]
        s = [[None] * 8 for _ in range(vsz)]
        for cj in range(vsz):
            w = [sx[cj, ct, k + d // 9, ty + (d // 3) % 3, tx + d % 3] for d in range(27)]
            for i in range(8):
                oz, oy, ox = i >> 2, (i >> 1) & 1, i & 1
                for ci in range(vsz):
                    for j in range(8):
                        jz, jy, jx = j >> 2, (j >> 1) & 1, j & 1
                        t = Kt[8 * ci + i, 8 * cj + j] * w[((1 - oz + jz) * 3 + 1 - oy + jy) * 3 + 1 - ox + jx]
                        s[ci][i] = t if s[ci][i] is None else s[ci][i] + t
        acc = []
        for ci in range(vsz):
            a = torch.zeros(ct.shape, dtype=dt)
            for i in range(8):
                a = torch.where(m[i] != 0, a + m[i] * s[ci][i], a)
            acc.append(a)
        put(act & (pz < D), pz, lambda c, sel: acc[c][sel])
    return y, written, int((~found).sum()), x_staged


# mask shapes (nz, ny, nx) and kinds: HEX_CASES's, a grid of one CTA, nodes an
# exact multiple of the default tiles (8 x 16 x 32), an all-active and an
# all-empty mask
BLOCK_HEX_CASES = {**{k: (v, "random") for k, v in HEX_CASES.items()}, "single": ((2, 2, 2), "random"),
                   "tiles": ((7, 15, 31), "random"), "full": ((9, 6, 20), "full"), "empty": ((9, 6, 20), "empty")}


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("case", list(BLOCK_HEX_CASES))
def test_hex_block_tiles_match_plain_version(case, dt):
    tdt = DTYPES[dt]
    rng = np.random.default_rng(len(case))
    shape, kind = BLOCK_HEX_CASES[case]
    if shape is None:
        mask = _sphere_mask(10, tdt)
    else:
        mask = torch.as_tensor({"random": lambda: rng.random(shape) < 0.4, "full": lambda: np.ones(shape),
                                "empty": lambda: np.zeros(shape)}[kind](), dtype=tdt)
    nz, ny, nx = mask.shape
    x = torch.as_tensor(rng.standard_normal((3, nz + 1, ny + 1, nx + 1)), dtype=tdt)
    K = torch.as_tensor(rng.standard_normal((24, 24)), dtype=tdt)
    y, written, _, _ = hexblock_traversal(x, mask, K)
    assert bool((written == 1).all())
    assert torch.equal(y, cuda_hex3.hex_block_stencil3_ref(x, mask, K))


@pytest.mark.parametrize("split", [0, 1])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_hex_block_tiles_other_shapes(dt, split):
    """Tilings other than the shipped one (ragged CTAs, one or three output
    channels per CTA) walk to the same bits."""
    tdt = DTYPES[dt]
    tile = {"BX": 5, "BY": 3, "RZ": 2, "SPLIT_F32": split, "SPLIT_F64": split}
    rng = np.random.default_rng(13)
    mask = torch.as_tensor(rng.random((6, 7, 12)) < 0.5, dtype=tdt)
    x = torch.as_tensor(rng.standard_normal((3, 7, 8, 13)), dtype=tdt)
    K = torch.as_tensor(rng.standard_normal((24, 24)), dtype=tdt)
    y, written, _, _ = hexblock_traversal(x, mask, K, tile)
    assert bool((written == 1).all())
    assert torch.equal(y, cuda_hex3.hex_block_stencil3_ref(x, mask, K))


@pytest.mark.parametrize("dt", list(DTYPES))
def test_hex_block_empty_ctas_read_no_x(dt):
    """CTAs whose cells (with the one-cell halo below) are all inactive
    write zeros and stage no x; a wholly empty mask stages none."""
    tdt = DTYPES[dt]
    sfx = "_F64" if tdt == torch.float64 else "_F32"
    rz = cuda_hex3.BLOCK_TILE["RZ"]
    rng = np.random.default_rng(11)
    shape = (3 * rz - 1, 9, 20)  # three layers of CTAs along z
    mask = torch.as_tensor(rng.random(shape) < 0.5, dtype=tdt)
    mask[:rz] = 0  # the cells around the first layer's nodes 0 .. rz - 1: none active
    x = torch.as_tensor(rng.standard_normal((3, shape[0] + 1, 10, 21)), dtype=tdt)
    K = torch.as_tensor(rng.standard_normal((24, 24)), dtype=tdt)
    y, written, skipped, staged = hexblock_traversal(x, mask, K)
    bt = cuda_hex3.BLOCK_TILE
    per_layer = -(-10 // bt["BY"]) * -(-21 // bt["BX"]) * (3 if bt["SPLIT" + sfx] else 1)
    assert skipped == per_layer and bool((written == 1).all())
    assert torch.equal(y, cuda_hex3.hex_block_stencil3_ref(x, mask, K))
    y, _, skipped, staged = hexblock_traversal(x, torch.zeros_like(mask), K)
    assert skipped == 3 * per_layer and staged == 0 and not y.any()
