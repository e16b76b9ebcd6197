"""3D lattice-resident geometric multigrid (Q1 hexahedra), scalar part.

Counterpart of :mod:`phifem_tpu.ops.lattice3`: the scalar cycle
``Lattice3MG`` and the block cycle ``Lattice3BlockMG`` of a 3-vector field
(the S5-3D elasticity bulks).  The reduced operator of a
uniform trilinear cell term on a structured hex grid with Dirichlet
conditions on the box boundary is EXACTLY a constant 27-point vertex stencil
on the zero-extended interior, so matvec, Jacobi smoothing, residual,
full-weighting restriction and trilinear prolongation are shifted-slice
arithmetic on ``(depth, rows, cols)`` tensors.  The matvec, the residual and
the Jacobi sweep run the hand-written kernel of
:mod:`phifem_tpu_torch.ops.cuda_lattice3` on the card (its plain version on
the CPU); so do the block cycle's through the kernel's 3-channel block form
(:func:`~phifem_tpu_torch.ops.cuda_lattice3.lattice3_block_sweep`).  The
transfers and the dense coarse solves are plain PyTorch.

The 3D stiffness stencil is not refinement-invariant (it scales like h), so
each level carries its own stencil, re-assembled from one host 8x8 element
matrix per level.

Layout: ``(D+2, R+2, C+2)`` padded tensors for a ``D x R x C`` vertex
lattice (``D = nz+1, R = ny+1, C = nx+1``); logical node ``(d, r, c)``
lives at ``[1+d, 1+r, 1+c]``.  Reduced vectors keep the padding ring AND
the logical boundary shell identically zero; the active interior is
``[2:D, 2:R, 2:C]``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from .cuda_lattice3 import JACOBI, MATVEC, RESIDUAL, lattice3_block_sweep, lattice3_sweep, pack_block_terms, pack_terms

__all__ = [
    "hex_element_matrix",
    "vertex_stencil_weights3",
    "block_vertex_stencil_weights3",
    "Lattice3MG",
    "Lattice3BlockMG",
    "build_lattice3_mg",
    "build_lattice3_block_mg",
    "lattice3_cg",
]

# local-node lattice offsets (dx, dy, dz), x fastest, as the vertex raveling
_HEX_OFFS = tuple((dx, dy, dz) for dz in (0, 1) for dy in (0, 1) for dx in (0, 1))


def hex_element_matrix(hx: float, hy: float, hz: float, stiffness: float = 1.0, mass: float = 0.0) -> np.ndarray:
    """8x8 trilinear element matrix ``stiffness * ∫∇u·∇v + mass * ∫u v`` on
    an ``hx x hy x hz`` hex, by 2x2x2 Gauss quadrature (exact).  Host numpy."""
    gp = np.array([0.5 - 0.5 / np.sqrt(3.0), 0.5 + 0.5 / np.sqrt(3.0)])
    A = np.zeros((8, 8))
    hs = np.array([hx, hy, hz])

    def shape(xi):  # xi in [0,1]^3 -> (8,) values and (8, 3) reference gradients
        vals = np.empty(8)
        grads = np.empty((8, 3))
        for i, (dx, dy, dz) in enumerate(_HEX_OFFS):
            f = np.array([xi[0] if dx else 1.0 - xi[0], xi[1] if dy else 1.0 - xi[1], xi[2] if dz else 1.0 - xi[2]])
            df = np.array([1.0 if dx else -1.0, 1.0 if dy else -1.0, 1.0 if dz else -1.0])
            vals[i] = f.prod()
            for k in range(3):
                grads[i, k] = df[k] * np.prod(np.delete(f, k))
        return vals, grads

    vol = hx * hy * hz
    for gx in gp:
        for gy in gp:
            for gz in gp:
                vals, grads = shape(np.array([gx, gy, gz]))
                gphys = grads / hs[None, :]
                A += (vol / 8.0) * (stiffness * gphys @ gphys.T + mass * np.outer(vals, vals))
    return A


def vertex_stencil_weights3(A8: np.ndarray) -> np.ndarray:
    """Aggregate the 8x8 hex element matrix into the (3, 3, 3) vertex
    stencil ``w[1+dz, 1+dy, 1+dx]`` valid at every interior vertex."""
    w = np.zeros((3, 3, 3))
    A8 = np.asarray(A8, np.float64)
    for i, (dxi, dyi, dzi) in enumerate(_HEX_OFFS):
        for j, (dxj, dyj, dzj) in enumerate(_HEX_OFFS):
            w[1 + dzj - dzi, 1 + dyj - dyi, 1 + dxj - dxi] += A8[i, j]
    return w


def _terms3(w: np.ndarray) -> List[Tuple[int, int, int, float]]:
    """Nonzero ``(a, b, c, weight)`` terms in ascending (a, b, c) order."""
    out = []
    scale = max(1e-300, np.abs(w).max())
    for a in range(3):
        for b in range(3):
            for c in range(3):
                if abs(w[a, b, c]) > 1e-14 * scale:
                    out.append((a, b, c, float(w[a, b, c])))
    return out


@dataclasses.dataclass(frozen=True)
class _Level3:
    D: int  # nz + 1
    R: int  # ny + 1
    C: int  # nx + 1
    terms: Tuple[Tuple[int, int, int, float], ...]


def _conv_interior3(xp: torch.Tensor, terms, D: int, R: int, C: int) -> torch.Tensor:
    """(A x) at the logical-interior nodes: shape (D-2, R-2, C-2)."""
    acc = None
    for a, b, c, wt in terms:
        part = wt * xp[a + 1 : a + D - 1, b + 1 : b + R - 1, c + 1 : c + C - 1]
        acc = part if acc is None else acc + part
    return acc


def _embed3(v: torch.Tensor, D: int, R: int, C: int) -> torch.Tensor:
    out = torch.zeros((D + 2, R + 2, C + 2), dtype=v.dtype, device=v.device)
    out[2:D, 2:R, 2:C] = v
    return out


def _interleave_axis(A: torch.Tensor, H: torch.Tensor, axis: int) -> torch.Tensor:
    """[a0 h0 a1 h1 ... a_{m-1}] along ``axis`` from A (m) and H (m-1)."""
    A = torch.movedim(A, axis, 0)
    H = torch.movedim(H, axis, 0)
    m = A.shape[0]
    body = torch.stack([A[: m - 1], H], dim=1).reshape((2 * (m - 1),) + tuple(A.shape[1:]))
    return torch.movedim(torch.cat([body, A[m - 1 :]], dim=0), 0, axis)


def _prolong3(Ecp: torch.Tensor, Dc: int, Rc: int, Cc: int) -> torch.Tensor:
    """Trilinear prolongation, interleave form: the coarse padded
    (Dc+2, Rc+2, Cc+2) reduced vector to the fine logical
    (2Dc-1, 2Rc-1, 2Cc-1) correction lattice (boundary shell zero)."""
    E = Ecp[1 : 1 + Dc, 1 : 1 + Rc, 1 : 1 + Cc]
    for axis in (2, 1, 0):
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[axis] = slice(None, -1)
        hi[axis] = slice(1, None)
        H = 0.5 * (E[tuple(lo)] + E[tuple(hi)])
        E = _interleave_axis(E, H, axis)
    return E


def _restrict3(r_int: torch.Tensor, Dc: int, Rc: int, Cc: int) -> torch.Tensor:
    """Full weighting (transpose of trilinear prolongation, weight sum 8) of
    the fine logical-interior (D-2, R-2, C-2) residual; returns the coarse
    padded reduced vector."""
    out = None
    n_d, n_r, n_c = Dc - 2, Rc - 2, Cc - 2
    wts = ((-1, 0.5), (0, 1.0), (1, 0.5))
    for s, ws in wts:
        planes = r_int[1 + s :: 2][:n_d]
        for t, wt in wts:
            rows = planes[:, 1 + t :: 2][:, :n_r]
            for u, wu in wts:
                part = (ws * wt * wu) * rows[:, :, 1 + u :: 2][:, :, :n_c]
                out = part if out is None else out + part
    return _embed3(out.to(r_int.dtype), Dc, Rc, Cc)


def _dense_coarse_inv3(terms, D: int, R: int, C: int, mask: Optional[np.ndarray] = None) -> np.ndarray:
    """Exact inverse of the reduced operator on the coarsest interior."""
    nd, nr, nc = D - 2, R - 2, C - 2
    n = nd * nr * nc
    A = np.zeros((n, n))
    idx = np.arange(n).reshape(nd, nr, nc)
    for a, b, c, wt in terms:
        dz, dy, dx = a - 1, b - 1, c - 1
        src = idx[max(0, -dz) : nd - max(0, dz), max(0, -dy) : nr - max(0, dy), max(0, -dx) : nc - max(0, dx)]
        dst = idx[max(0, dz) : nd - max(0, -dz), max(0, dy) : nr - max(0, -dy), max(0, dx) : nc - max(0, -dx)]
        A[src.reshape(-1), dst.reshape(-1)] += wt
    if mask is not None:
        act = np.asarray(mask[1 : D - 1, 1 : R - 1, 1 : C - 1], bool).reshape(-1)
        A[~act, :] = 0.0
        A[:, ~act] = 0.0
        off = np.where(~act)[0]
        A[off, off] = 1.0
    return np.linalg.inv(A)


def _coarsen_mask3(m: np.ndarray) -> np.ndarray:
    """Coarse active mask: 3x3x3 trilinear-support pooling, then stride 2."""
    D, R, C = m.shape
    p = np.zeros((D + 2, R + 2, C + 2), bool)
    p[1 : 1 + D, 1 : 1 + R, 1 : 1 + C] = m
    pool = np.zeros_like(m)
    for s in (0, 1, 2):
        for t in (0, 1, 2):
            for u in (0, 1, 2):
                pool |= p[s : s + D, t : t + R, u : u + C]
    return pool[::2, ::2, ::2].copy()


@dataclasses.dataclass
class Lattice3MG:
    """V-cycle preconditioner on 3D padded lattices, one stencil per level.

    ``__call__(bp)`` treats ``bp`` (padded, reduced) as a right-hand side
    and returns an approximate ``A^{-1} bp`` computed in ``dtype`` (float32
    by default), cast back to the input dtype.  Each Jacobi sweep and each
    residual is one launch of the lattice sweep kernel on the card."""

    levels: List[_Level3]
    coarse_inv: torch.Tensor
    dtype: torch.dtype = torch.float32
    omega: float = 0.8
    pre_smooth: int = 2
    post_smooth: int = 2
    masks: Optional[List[torch.Tensor]] = None  # per-level logical (D, R, C)

    def __post_init__(self):
        # the kernel's form of each level's stencil, made once
        self._packed = [pack_terms(lvl.terms) for lvl in self.levels]

    @property
    def terms(self):
        return self.levels[0].terms

    def _dinv(self, k: int) -> float:
        return 1.0 / next(wt for a, b, c, wt in self.levels[k].terms if (a, b, c) == (1, 1, 1))

    def _smooth(self, xp, bp, k: int, sweeps: int):
        od = self.omega * self._dinv(k)
        m = None if self.masks is None else self.masks[k]
        for _ in range(sweeps):
            xp = lattice3_sweep(JACOBI, xp, self._packed[k], bp, m, od)
        return xp

    def _cycle(self, k: int, bp):
        lvl = self.levels[k]
        D, R, C = lvl.D, lvl.R, lvl.C
        if k == len(self.levels) - 1:
            v = self.coarse_inv @ bp[2:D, 2:R, 2:C].reshape(-1)
            return _embed3(v.reshape(D - 2, R - 2, C - 2), D, R, C)
        xp = self._smooth(torch.zeros_like(bp), bp, k, self.pre_smooth)
        m = None if self.masks is None else self.masks[k]
        r = lattice3_sweep(RESIDUAL, xp, self._packed[k], bp, m)
        nxt = self.levels[k + 1]
        bc = _restrict3(r[2:D, 2:R, 2:C], nxt.D, nxt.R, nxt.C)
        if self.masks is not None:
            bc = bc * _embed3(self.masks[k + 1][1:-1, 1:-1, 1:-1], nxt.D, nxt.R, nxt.C)
        ec = self._cycle(k + 1, bc)
        corr = _prolong3(ec, nxt.D, nxt.R, nxt.C)
        if self.masks is not None:
            corr = corr * self.masks[k]
        xp[2:D, 2:R, 2:C] += corr[1:-1, 1:-1, 1:-1]
        return self._smooth(xp, bp, k, self.post_smooth)

    def __call__(self, bp: torch.Tensor) -> torch.Tensor:
        return self._cycle(0, bp.to(self.dtype).contiguous()).to(bp.dtype)


def build_lattice3_mg(
    nx: int,
    ny: int,
    nz: int,
    spacing: Tuple[float, float, float],
    stiffness: float = 1.0,
    mass: float = 0.0,
    min_n: int = 8,
    dtype: torch.dtype = torch.float32,
    mask: Optional[np.ndarray] = None,
    device: Union[str, torch.device] = "cuda",
    **kw,
) -> Lattice3MG:
    """Build the 3D V-cycle for ``stiffness * (-Δ) + mass * I`` on an
    ``nx x ny x nz``-cell hex lattice.  Each level re-assembles its own 8x8
    element matrix at its spacing (host, closed form).  ``mask``: optional
    (nz+1, ny+1, nx+1) bool of active logical vertices; coarser levels pool
    it.  The tables go to ``device``, the card unless the caller asks for
    the CPU."""
    hx, hy, hz = spacing
    dims = [(nx, ny, nz)]
    while nx % 2 == 0 and ny % 2 == 0 and nz % 2 == 0 and min(nx, ny, nz) // 2 >= min_n:
        nx, ny, nz = nx // 2, ny // 2, nz // 2
        dims.append((nx, ny, nz))
    levels = []
    for k, (lx, ly, lz) in enumerate(dims):
        A8 = hex_element_matrix(hx * 2**k, hy * 2**k, hz * 2**k, stiffness=stiffness, mass=mass)
        levels.append(_Level3(lz + 1, ly + 1, lx + 1, tuple(_terms3(vertex_stencil_weights3(A8)))))
    lvl_masks = coarse_mask = None
    if mask is not None:
        m = np.asarray(mask, bool)
        masks_np = [m]
        for _ in levels[1:]:
            m = _coarsen_mask3(m)
            masks_np.append(m)
        coarse_mask = masks_np[-1]
        lvl_masks = [torch.as_tensor(mm, dtype=dtype, device=device).contiguous() for mm in masks_np]
    lvl = levels[-1]
    inv = _dense_coarse_inv3(lvl.terms, lvl.D, lvl.R, lvl.C, coarse_mask)
    return Lattice3MG(levels, torch.as_tensor(inv, dtype=dtype, device=device), dtype=dtype, masks=lvl_masks, **kw)


# ----------------------------------------------------------- block cycle
def block_vertex_stencil_weights3(K: np.ndarray, vsz: int) -> np.ndarray:
    """Aggregate an (8 vsz, 8 vsz) CHANNEL-MAJOR vector hex element matrix
    (local dof = 8 channel + node) into the (3, 3, 3, vsz, vsz) block vertex
    stencil."""
    w = np.zeros((3, 3, 3, vsz, vsz))
    K = np.asarray(K, np.float64)
    for i, (dxi, dyi, dzi) in enumerate(_HEX_OFFS):
        for j, (dxj, dyj, dzj) in enumerate(_HEX_OFFS):
            w[1 + dzj - dzi, 1 + dyj - dyi, 1 + dxj - dxi] += K[i::8, j::8][:vsz, :vsz]
    return w


def _block_terms3(w: np.ndarray) -> List[Tuple[int, int, int, np.ndarray]]:
    """Nonzero ``(a, b, c, block)`` terms in ascending (a, b, c) order."""
    out = []
    scale = max(1e-300, np.abs(w).max())
    for a in range(3):
        for b in range(3):
            for c in range(3):
                if np.abs(w[a, b, c]).max() > 1e-14 * scale:
                    out.append((a, b, c, w[a, b, c].copy()))
    return out


def _conv_interior3_block(xp: torch.Tensor, offs, W, D: int, R: int, C: int) -> torch.Tensor:
    """(A x) at the logical-interior nodes of a channels-first block lattice:
    ``xp`` (vsz, D+2, R+2, C+2) -> (vsz, D-2, R-2, C-2); ``offs`` the terms'
    ``(a, b, c, ...)`` positions and ``W`` their (nterms, vsz, vsz) blocks
    (read on the host).  Per term and output channel the part ``sum_j W[i, j]
    x_j`` in ascending j, added to the channel's sum in the order of the
    terms: the JAX package's einsum, in the order of the block sweep kernel."""
    Wl = (W.cpu().numpy() if torch.is_tensor(W) else np.asarray(W, np.float64)).tolist()
    vsz = xp.shape[0]
    acc = [None] * vsz
    for t, o in enumerate(offs):
        a, b, c = o[0], o[1], o[2]
        xs = [xp[j, a + 1 : a + D - 1, b + 1 : b + R - 1, c + 1 : c + C - 1] for j in range(vsz)]
        for i in range(vsz):
            part = Wl[t][i][0] * xs[0]
            for j in range(1, vsz):
                part = part + Wl[t][i][j] * xs[j]
            acc[i] = part if acc[i] is None else acc[i] + part
    return torch.stack(acc)


def _dense_coarse_inv3_block(terms, D: int, R: int, C: int, vsz: int, mask: Optional[np.ndarray] = None) -> np.ndarray:
    """Pseudo-inverse (rcond 1e-10) of the reduced block operator on the
    coarsest interior; flat index ``((i nr + j) nc + k) vsz + comp``.  A
    floating masked elasticity block is exactly singular along its rigid
    modes, hence the pseudo-inverse."""
    nd, nr, nc = D - 2, R - 2, C - 2
    n = nd * nr * nc
    A = np.zeros((n * vsz, n * vsz))
    idx = np.arange(n).reshape(nd, nr, nc)
    comp = np.arange(vsz)
    for a, b, c, Wb in terms:
        dz, dy, dx = a - 1, b - 1, c - 1
        src = idx[max(0, -dz) : nd - max(0, dz), max(0, -dy) : nr - max(0, dy), max(0, -dx) : nc - max(0, dx)]
        dst = idx[max(0, dz) : nd - max(0, -dz), max(0, dy) : nr - max(0, -dy), max(0, dx) : nc - max(0, -dx)]
        rows = (src.reshape(-1)[:, None, None] * vsz + comp[None, :, None])
        cols = (dst.reshape(-1)[:, None, None] * vsz + comp[None, None, :])
        A[rows, cols] += np.asarray(Wb)[None]
    if mask is not None:
        act = np.repeat(np.asarray(mask[1 : D - 1, 1 : R - 1, 1 : C - 1], bool).reshape(-1), vsz)
        A[~act, :] = 0.0
        A[:, ~act] = 0.0
        off = np.where(~act)[0]
        A[off, off] = 1.0
    return np.linalg.pinv(A, rcond=1e-10)


@dataclasses.dataclass
class Lattice3BlockMG:
    """Block (multi-channel) 3D V-cycle on channels-first padded lattices
    (vsz, D+2, R+2, C+2): one block stencil per level, block-Jacobi smoothing
    with the interior centre-block inverse, channelwise trilinear transfers.
    ``Ws`` / ``dinvs`` are per-level host float64 tables ((nterms, vsz, vsz)
    and (vsz, vsz)); each sweep and residual is one launch of the block sweep
    kernel on the card, the tables rounded to ``dtype`` there as in the plain
    version."""

    levels: List[_Level3]
    offs: Tuple[Tuple[int, int, int], ...]
    Ws: List[np.ndarray]
    dinvs: List[np.ndarray]
    coarse_inv: torch.Tensor
    vsz: int
    dtype: torch.dtype = torch.float32
    # block Jacobi on the Q1 elasticity stencil has lam_max(D^-1 A) ~ 2.64
    # (nu = 0.3): omega = 0.8 amplifies, 0.6 damps the upper spectrum
    omega: float = 0.6
    pre_smooth: int = 2
    post_smooth: int = 2
    masks: Optional[List[torch.Tensor]] = None  # per-level logical (D, R, C)

    def __post_init__(self):
        self._packed = [
            pack_block_terms([(a, b, c, W[t]) for t, (a, b, c) in enumerate(self.offs)], dinv)
            for W, dinv in zip(self.Ws, self.dinvs)
        ]

    def _smooth(self, xp, bp, k: int, sweeps: int):
        m = None if self.masks is None else self.masks[k]
        for _ in range(sweeps):
            xp = lattice3_block_sweep(JACOBI, xp, self._packed[k], bp, m, self.omega)
        return xp

    def _cycle(self, k: int, bp):
        lvl = self.levels[k]
        D, R, C = lvl.D, lvl.R, lvl.C
        if k == len(self.levels) - 1:
            flat = torch.movedim(bp[:, 2:D, 2:R, 2:C], 0, -1).reshape(-1)
            sol = self.coarse_inv @ flat
            out = torch.zeros_like(bp)
            out[:, 2:D, 2:R, 2:C] = torch.movedim(sol.reshape(D - 2, R - 2, C - 2, self.vsz), -1, 0)
            return out
        xp = self._smooth(torch.zeros_like(bp), bp, k, self.pre_smooth)
        m = None if self.masks is None else self.masks[k]
        r = lattice3_block_sweep(RESIDUAL, xp, self._packed[k], bp, m)
        nxt = self.levels[k + 1]
        bc = torch.stack([_restrict3(r[c, 2:D, 2:R, 2:C], nxt.D, nxt.R, nxt.C) for c in range(self.vsz)])
        if self.masks is not None:
            bc = bc * _embed3(self.masks[k + 1][1:-1, 1:-1, 1:-1], nxt.D, nxt.R, nxt.C)
        ec = self._cycle(k + 1, bc.contiguous())
        corr = torch.stack([_prolong3(ec[c], nxt.D, nxt.R, nxt.C) for c in range(self.vsz)])
        if self.masks is not None:
            corr = corr * self.masks[k]
        xp[:, 2:D, 2:R, 2:C] += corr[:, 1:-1, 1:-1, 1:-1]
        return self._smooth(xp, bp, k, self.post_smooth)

    def __call__(self, bp: torch.Tensor) -> torch.Tensor:
        return self._cycle(0, bp.to(self.dtype).contiguous()).to(bp.dtype)


def build_lattice3_block_mg(
    nx: int,
    ny: int,
    nz: int,
    spacing: Tuple[float, float, float],
    elem_fn,
    vsz: int,
    min_n: int = 4,
    dtype: torch.dtype = torch.float32,
    mask: Optional[np.ndarray] = None,
    device: Union[str, torch.device] = "cuda",
    **kw,
) -> Lattice3BlockMG:
    """Build the block 3D V-cycle for the uniform vector cell term whose
    channel-major element matrix at spacing (hx, hy, hz) is
    ``elem_fn(hx, hy, hz) -> (8 vsz, 8 vsz)`` (e.g. Q1 linear elasticity);
    each level re-assembles its own element matrix (host, closed form).
    ``mask``: optional (nz+1, ny+1, nx+1) bool of active logical vertices,
    pooled on coarser levels.  The tables go to ``device``, the card unless
    the caller asks for the CPU."""
    hx, hy, hz = spacing
    dims = [(nx, ny, nz)]
    while nx % 2 == 0 and ny % 2 == 0 and nz % 2 == 0 and min(nx, ny, nz) // 2 >= min_n:
        nx, ny, nz = nx // 2, ny // 2, nz // 2
        dims.append((nx, ny, nz))
    levels, terms_per_level = [], []
    for k, (lx, ly, lz) in enumerate(dims):
        K = elem_fn(hx * 2**k, hy * 2**k, hz * 2**k)
        terms_per_level.append(_block_terms3(block_vertex_stencil_weights3(K, vsz)))
        levels.append(_Level3(lz + 1, ly + 1, lx + 1, ()))
    offs = tuple((a, b, c) for a, b, c, _ in terms_per_level[0])
    Ws, dinvs = [], []
    for terms in terms_per_level:
        by_off = {(a, b, c): Wb for a, b, c, Wb in terms}
        Ws.append(np.stack([by_off[o] for o in offs]))
        dinvs.append(np.linalg.inv(by_off[(1, 1, 1)]))
    lvl_masks = coarse_mask = None
    if mask is not None:
        m = np.asarray(mask, bool)
        masks_np = [m]
        for _ in levels[1:]:
            m = _coarsen_mask3(m)
            masks_np.append(m)
        coarse_mask = masks_np[-1]
        lvl_masks = [torch.as_tensor(mm, dtype=dtype, device=device).contiguous() for mm in masks_np]
    lvl = levels[-1]
    inv = _dense_coarse_inv3_block(terms_per_level[-1], lvl.D, lvl.R, lvl.C, vsz, coarse_mask)
    return Lattice3BlockMG(levels, offs, Ws, dinvs, torch.as_tensor(inv, dtype=dtype, device=device), vsz,
                           dtype=dtype, masks=lvl_masks, **kw)


def lattice3_cg(
    mg: Lattice3MG,
    bp: torch.Tensor,
    tol: float = 1e-10,
    maxiter: int = 40,
    x0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, float, int]:
    """MG-preconditioned CG on 3D padded lattices (full precision of ``bp``,
    V-cycle in ``mg.dtype``), on the ||b||-normalized system.  Returns
    ``(xp, relres, iters)``.  A Python loop whose exit test reads one scalar
    per iteration; dots in the working dtype of ``bp`` (the JAX package
    rounds them to float32)."""
    terms = mg._packed[0]

    def matvec(xp):
        return lattice3_sweep(MATVEC, xp, terms)

    def dot(a, b):
        return torch.dot(a.reshape(-1), b.reshape(-1))

    bp = bp.contiguous()
    bscale = torch.clamp(torch.sqrt(dot(bp, bp)), min=torch.finfo(bp.dtype).tiny)
    bn = bp / bscale
    if x0 is None:
        x, r = torch.zeros_like(bn), bn
    else:
        x = x0 / bscale
        r = bn - matvec(x)
    tol2 = tol * tol
    z = mg(r)
    p, rz, it = z, dot(r, z), 0
    while it < maxiter and dot(r, r).item() > tol2:
        Ap = matvec(p)
        alpha = rz / dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = mg(r)
        rz_new = dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        it += 1
    relres = float(torch.sqrt(dot(r, r)))
    return x * bscale, relres, it
