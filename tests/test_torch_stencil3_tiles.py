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
* the 3-channel block forms: the block sweep by the same column-and-run
  threads, each node's 3 x 3 block parts added per term in ascending
  position from -0; the block hex stencil by a thread per node column and a
  run of nodes, each node adding, per output channel, its active cells in
  ascending local index, each cell's row dot in ascending (channel, node).

Shapes: ragged lattices, sides smaller than one tile and exact multiples of
one, the sphere mask, float32 and float64.
"""

import itertools

import numpy as np
import pytest
import torch

from phifem_tpu_torch.ops import cuda_hex3, cuda_lattice3 as cl
from phifem_tpu_torch.ops.lattice3 import _terms3, hex_element_matrix, vertex_stencil_weights3

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


# ------------------------------------------------------ 3-channel blocks
def _block_sweep_inputs(shape, dt, seed):
    from phifem_tpu_torch.models.interface_elasticity import lame
    from phifem_tpu_torch.models.interface_elasticity3 import _elastic_element_matrix
    from phifem_tpu_torch.ops.lattice3 import _block_terms3, block_vertex_stencil_weights3

    rng = np.random.default_rng(seed)
    D, R, C = shape
    x = torch.zeros((3, D + 2, R + 2, C + 2), dtype=dt)
    b = torch.zeros_like(x)
    x[:, 2:D, 2:R, 2:C] = torch.as_tensor(rng.standard_normal((3, D - 2, R - 2, C - 2)), dtype=dt)
    b[:, 2:D, 2:R, 2:C] = torch.as_tensor(rng.standard_normal((3, D - 2, R - 2, C - 2)), dtype=dt)
    x[:, 0], x[:, :, -1] = 1.5, -2.5
    mask = torch.as_tensor(rng.random(shape) < 0.7, dtype=dt)
    terms = _block_terms3(block_vertex_stencil_weights3(_elastic_element_matrix(0.3, 0.2, 0.25, *lame(1.0, 0.3)), 3))
    dinv = np.linalg.inv(next(W for a, bb, c, W in terms if (a, bb, c) == (1, 1, 1)))
    return x, b, mask, cl.pack_block_terms(terms, dinv)


def lattice_block_traversal(mode, x, packed, b, mask, omega, tile=cl.BLOCK_TILE):
    """The block sweep by the kernel's threads: a CTA of BX x BY threads,
    each one (x, y) column of the padded array and a run of RZ planes; per
    node, per term in ascending canonical position, per output channel the
    part ((w0 x0 + w1 x1) + w2 x2) added to the channel's sum from -0, every
    weight rounded once to T.  Returns the output and how often each node
    was written."""
    dt = x.dtype
    vsz, PD, PR, PC = x.shape
    D, R, C = PD - 2, PR - 2, PC - 2
    BX, BY, RZ = tile["BX"], tile["BY"], tile["RZ"]
    cdiv = lambda a, q: -(-a // q)
    nbx, nby, nbz = cdiv(PC, BX), cdiv(PR, BY), cdiv(PD, RZ)
    w = {(a * 3 + bb) * 3 + c: torch.tensor(W, dtype=dt) for a, bb, c, W in packed}
    dinv, om = torch.tensor(packed.dinv, dtype=dt), torch.tensor(omega, dtype=dt)
    out = torch.full_like(x, float("nan"))
    written = torch.zeros((PD, PR, PC), dtype=torch.int64)
    py, px = torch.meshgrid(torch.arange(nby * BY), torch.arange(nbx * BX), indexing="ij")
    live = (py < PR) & (px < PC)
    py, px = py[live], px[live]
    for bz in range(nbz):
        for k in range(RZ):
            pz = bz * RZ + k
            if pz >= PD:
                break
            written[pz, py, px] += 1
            inner = (py >= 2) & (py <= R - 1) & (px >= 2) & (px <= C - 1) & (2 <= pz <= D - 1)
            zi, yi, xi = pz, py[inner], px[inner]
            for c in range(vsz):  # the shell: zero, or x in Jacobi mode
                shell = x[c, pz, py[~inner], px[~inner]]
                out[c, pz, py[~inner], px[~inner]] = shell if mode == cl.JACOBI else torch.zeros_like(shell)
            if not inner.any():
                continue
            acc = [torch.full(yi.shape, -0.0, dtype=dt) for _ in range(vsz)]
            for p in sorted(w):
                xv = [x[c, zi + p // 9 - 1, yi + (p // 3) % 3 - 1, xi + p % 3 - 1] for c in range(vsz)]
                for i in range(vsz):
                    part = w[p][i, 0] * xv[0]
                    for j in range(1, vsz):
                        part = part + w[p][i, j] * xv[j]
                    acc[i] = acc[i] + part
            for i in range(vsz):
                if mode == cl.MATVEC:
                    out[i, zi, yi, xi] = acc[i]
                    continue
                res = [b[c, zi, yi, xi] - acc[c] for c in range(vsz)]
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
                out[i, zi, yi, xi] = x[i, zi, yi, xi] + upd
    return out, written


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("shape", LATTICE_SHAPES[:3] + LATTICE_SHAPES[4:], ids=_ids)
def test_lattice3_block_tiles_match_plain_version(shape, mode, dt):
    md, masked = MODES[mode]
    x, b, mask, packed = _block_sweep_inputs(shape, DTYPES[dt], seed=len(shape) + md)
    m = mask if masked else None
    y, written = lattice_block_traversal(md, x, packed, b, m, 0.6)
    assert bool((written == 1).all())
    assert torch.equal(y, cl.lattice3_block_sweep_ref(md, x, packed, b, m, 0.6))


def hexblock_traversal(x, mask, K, tile=cuda_hex3.BLOCK_TILE):
    """The block hex stencil by the kernel's threads: a CTA of BX x BY
    threads, each a node column and a run of RZ nodes; x staged at clamped
    coordinates, cell masks 0 outside the grid; per output channel and node
    the cells in ascending local index i, skipped where the mask is 0, each
    row dot summed in ascending (channel, node) from its first product, then
    acc + m s from +0."""
    dt = x.dtype
    vsz, D, R, C = x.shape
    nz, ny, nx = mask.shape
    BX, BY, RZ = tile["BX"], tile["BY"], tile["RZ"]
    cdiv = lambda a, q: -(-a // q)
    nbx, nby, nbz = cdiv(C, BX), cdiv(R, BY), cdiv(D, RZ)
    assert nbx * BX >= C and nby * BY >= R and nbz * RZ >= D
    Kt = K.to(dt)
    xp = torch.nn.functional.pad(x[None], (1, 1, 1, 1, 1, 1), mode="replicate")[0]  # clamped coordinates
    mp = torch.zeros((nz + 2, ny + 2, nx + 2), dtype=dt)
    mp[1:-1, 1:-1, 1:-1] = mask  # 0 outside the grid
    y = torch.full_like(x, float("nan"))
    written = torch.zeros((D, R, C), dtype=torch.int64)
    z, yy, xx = torch.meshgrid(torch.arange(D), torch.arange(R), torch.arange(C), indexing="ij")
    for bz in range(nbz):  # each (CTA, thread, k) writes its node once
        for k in range(RZ):
            if bz * RZ + k < D:
                written[bz * RZ + k] += 1
    for ci in range(vsz):
        acc = torch.zeros((D, R, C), dtype=dt)
        for i in range(8):
            oz, oy, ox = i >> 2, (i >> 1) & 1, i & 1
            m = mp[z - oz + 1, yy - oy + 1, xx - ox + 1]
            s = None
            for cj in range(vsz):
                for j in range(8):
                    jz, jy, jx = j >> 2, (j >> 1) & 1, j & 1
                    t = Kt[8 * ci + i, 8 * cj + j] * xp[cj, z - oz + jz + 1, yy - oy + jy + 1, xx - ox + jx + 1]
                    s = t if s is None else s + t
            acc = torch.where(m != 0, acc + m * s, acc)
        y[ci] = acc
    return y, written


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("case", list(HEX_CASES))
def test_hex_block_tiles_match_plain_version(case, dt):
    tdt = DTYPES[dt]
    rng = np.random.default_rng(len(case))
    mask = _sphere_mask(10, tdt) if HEX_CASES[case] is None else torch.as_tensor(
        rng.random(HEX_CASES[case]) < 0.4, dtype=tdt)
    nz, ny, nx = mask.shape
    x = torch.as_tensor(rng.standard_normal((3, nz + 1, ny + 1, nx + 1)), dtype=tdt)
    K = torch.as_tensor(rng.standard_normal((24, 24)), dtype=tdt)
    y, written = hexblock_traversal(x, mask, K)
    assert bool((written == 1).all())
    assert torch.equal(y, cuda_hex3.hex_block_stencil3_ref(x, mask, K))
