"""2D lattice-resident geometric multigrid for uniform P1 box problems.

Counterpart of :mod:`phifem_tpu.ops.lattice`: the scalar cycle
(:class:`LatticeMG`), the constant block cycle of a vector P1 field with a
Dirichlet-masked bulk (:class:`LatticeBlockMG`) and the variable-stencil
block cycle of free-boundary vector fields (:class:`LatticeVarMG`, S5's
displacement bulks).  The reduced
operator of a uniform single-scalar P1 cell term with Dirichlet conditions
on the box boundary is EXACTLY a constant-coefficient 9-point vertex stencil
applied to the zero-extended interior; on the right-triangle split the P1
stiffness stencil is the classic 5-point Laplacian.  So the whole
MG-preconditioned CG solver is shifted-slice arithmetic on 2D
``(rows, cols)`` tensors: no gathers, scatters, masks or reshapes on the
hot path.  In this port these are plain PyTorch ops (hand-written kernels
for them are later work: ROADMAP queue 2, items 2 and 3).

Layout: ``(R+2, C+2)`` padded tensors for an ``R x C`` vertex lattice
(``R = ny+1``); logical node ``(r, c)`` lives at ``[1+r, 1+c]``.  For
*reduced* vectors (Krylov iterates, residuals) the padding ring AND the
logical boundary ring stay identically zero, so the active interior is
``[2:R, 2:C]``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

__all__ = [
    "vertex_stencil_weights",
    "block_vertex_stencil_weights",
    "LatticeMG",
    "LatticeBlockMG",
    "LatticeVarMG",
    "build_lattice_mg",
    "build_lattice_block_mg",
    "build_lattice_var_mg",
    "cell_stencil_maps",
    "galerkin_coarsen_stencil",
    "orientation_cell_masks",
    "lattice_cg",
]


def vertex_stencil_weights(mats, offs_per_orient) -> np.ndarray:
    """Aggregate per-orientation element matrices into the (3, 3) vertex
    stencil ``w[1+dy, 1+dx]`` valid at every interior lattice vertex."""
    w = np.zeros((3, 3))
    mats = np.asarray(mats, np.float64)
    for o, offs in enumerate(offs_per_orient):
        for i, (dxi, dyi) in enumerate(offs):
            for j, (dxj, dyj) in enumerate(offs):
                w[1 + dyj - dyi, 1 + dxj - dxi] += mats[o, i, j]
    return w


def _terms(w: np.ndarray) -> List[Tuple[int, int, float]]:
    """Nonzero (a, b, weight) triples (zero couplings, e.g. the diagonal
    terms of the triangle stiffness stencil, are dropped)."""
    out = []
    for a in range(3):
        for b in range(3):
            if abs(w[a, b]) > 1e-14 * max(1e-300, np.abs(w).max()):
                out.append((a, b, float(w[a, b])))
    return out


@dataclasses.dataclass(frozen=True)
class _Level:
    R: int  # logical lattice rows (ny + 1)
    C: int  # logical lattice cols (nx + 1)


def _conv_interior(xp: torch.Tensor, terms, R: int, C: int) -> torch.Tensor:
    """(A x) at the logical-interior nodes: shape (R-2, C-2).  Interior
    node ``r in [1, R-2]`` reads padded rows ``r + a``, ``a in {0,1,2}``."""
    acc = None
    for a, b, wt in terms:
        part = wt * xp[a + 1 : a + R - 1, b + 1 : b + C - 1]
        acc = part if acc is None else acc + part
    return acc


def _embed(v: torch.Tensor, R: int, C: int) -> torch.Tensor:
    """Zero-embed a logical-interior (R-2, C-2) block into padded (R+2, C+2)."""
    out = torch.zeros((R + 2, C + 2), dtype=v.dtype, device=v.device)
    out[2:R, 2:C] = v
    return out


def _interleave_cols(A: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """[a0 h0 a1 h1 ... a_{m-1}] from A (r, m) and H (r, m-1)."""
    r, m = A.shape
    body = torch.stack([A[:, : m - 1], H], dim=2).reshape(r, 2 * (m - 1))
    return torch.cat([body, A[:, m - 1 :]], dim=1)


def _interleave_rows(A: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    m, c = A.shape
    body = torch.stack([A[: m - 1], H], dim=1).reshape(2 * (m - 1), c)
    return torch.cat([body, A[m - 1 :]], dim=0)


def _prolong(Ecp: torch.Tensor, Rc: int, Cc: int) -> torch.Tensor:
    """Bilinear prolongation, interleave form.  Input: coarse padded
    (Rc+2, Cc+2) reduced vector.  Output: the fine logical (2Rc-1, 2Cc-1)
    lattice of corrections (zero boundary rows)."""
    E = Ecp[1 : 1 + Rc, 1 : 1 + Cc]
    Hc = 0.5 * (E[:, :-1] + E[:, 1:])
    W = _interleave_cols(E, Hc)  # (Rc, 2Cc-1)
    Hr = 0.5 * (W[:-1] + W[1:])
    return _interleave_rows(W, Hr)  # (2Rc-1, 2Cc-1)


def _restrict(r_int: torch.Tensor, Rc: int, Cc: int) -> torch.Tensor:
    """Full-weighting restriction (transpose of bilinear prolongation,
    weight sum 4).  ``r_int``: fine logical-interior (R-2, C-2) residual.
    Returns the coarse padded (Rc+2, Cc+2) reduced vector."""
    out = None
    # coarse interior i in [1, Rc-2] reads fine logical rows 2i+s,
    # s in {-1,0,1}; r_int index = logical - 1 -> start s+1, stride 2
    n_i, n_j = Rc - 2, Cc - 2
    for s, ws in ((-1, 0.5), (0, 1.0), (1, 0.5)):
        rows = r_int[1 + s :: 2][:n_i]
        for t, wt in ((-1, 0.5), (0, 1.0), (1, 0.5)):
            part = (ws * wt) * rows[:, 1 + t :: 2][:, :n_j]
            out = part if out is None else out + part
    return _embed(out, Rc, Cc)


def _dense_coarse_inv(
    terms, R: int, C: int, mask: Optional[np.ndarray] = None
) -> np.ndarray:
    """Exact inverse of the reduced operator on the coarsest interior.
    ``mask``: optional (R, C) bool of active logical nodes — inactive
    rows/cols become identity."""
    ni, nj = R - 2, C - 2
    n = ni * nj
    A = np.zeros((n, n))
    for a, b, wt in terms:
        dy, dx = a - 1, b - 1
        for i in range(ni):
            i2 = i + dy
            if not (0 <= i2 < ni):
                continue
            for j in range(nj):
                j2 = j + dx
                if 0 <= j2 < nj:
                    A[i * nj + j, i2 * nj + j2] += wt
    if mask is not None:
        act = np.asarray(mask[1 : R - 1, 1 : C - 1], bool).reshape(-1)
        A[~act, :] = 0.0
        A[:, ~act] = 0.0
        A[np.diag_indices(n)[0][~act], np.diag_indices(n)[1][~act]] = 1.0
    return np.linalg.inv(A)


def _coarsen_mask(m: np.ndarray) -> np.ndarray:
    """Coarse-level active mask: coarse vertex (i, j) is active when any
    fine vertex in the 3x3 bilinear support of (2i, 2j) is active."""
    R, C = m.shape
    p = np.zeros((R + 2, C + 2), bool)
    p[1 : 1 + R, 1 : 1 + C] = m
    pool = np.zeros_like(m)
    for s in (0, 1, 2):
        for t in (0, 1, 2):
            pool |= p[s : s + R, t : t + C]
    return pool[::2, ::2].copy()


@dataclasses.dataclass
class LatticeMG:
    """V-cycle preconditioner on 2D padded lattices.

    ``__call__(bp)`` treats ``bp`` (padded, reduced) as a right-hand side
    and returns an approximate ``A^{-1} bp`` computed in ``dtype`` (float32
    by default), cast back to the input dtype.
    """

    levels: List[_Level]
    terms: List[Tuple[int, int, float]]
    coarse_inv: torch.Tensor  # (n, n) dense inverse on the coarsest interior
    dtype: torch.dtype = torch.float32
    omega: float = 0.8
    pre_smooth: int = 2
    post_smooth: int = 2
    # optional per-level active masks, logical (R, C) in compute dtype
    masks: Optional[List[torch.Tensor]] = None

    def __post_init__(self):
        self._dinv = 1.0 / next(wt for a, b, wt in self.terms if a == 1 and b == 1)

    def _mask_int(self, k: int, R: int, C: int):
        if self.masks is None:
            return None
        return self.masks[k][1 : R - 1, 1 : C - 1]

    def _smooth(self, xp, bp, lvl: _Level, k: int, sweeps: int):
        """Damped Jacobi, ``x += omega * dinv * (b - A x)`` on the interior
        (updates ``xp`` in place)."""
        R, C = lvl.R, lvl.C
        od = self.omega * self._dinv
        m = self._mask_int(k, R, C)
        for _ in range(sweeps):
            r = bp[2:R, 2:C] - _conv_interior(xp, self.terms, R, C)
            xp[2:R, 2:C] += od * r if m is None else od * r * m
        return xp

    def _cycle(self, k: int, bp):
        lvl = self.levels[k]
        R, C = lvl.R, lvl.C
        if k == len(self.levels) - 1:
            v = self.coarse_inv @ bp[2:R, 2:C].reshape(-1)
            return _embed(v.reshape(R - 2, C - 2), R, C)
        xp = self._smooth(torch.zeros_like(bp), bp, lvl, k, self.pre_smooth)
        r_int = bp[2:R, 2:C] - _conv_interior(xp, self.terms, R, C)
        m = self._mask_int(k, R, C)
        if m is not None:
            r_int = r_int * m  # inactive-row residuals must not restrict
        nxt = self.levels[k + 1]
        bc = _restrict(r_int, nxt.R, nxt.C)
        if self.masks is not None:
            bc = bc * _embed(self.masks[k + 1][1:-1, 1:-1], nxt.R, nxt.C)
        ec = self._cycle(k + 1, bc)
        corr = _prolong(ec, nxt.R, nxt.C)  # fine logical (R, C)
        if self.masks is not None:
            corr = corr * self.masks[k]
        xp[2:R, 2:C] += corr[1:-1, 1:-1]
        return self._smooth(xp, bp, lvl, k, self.post_smooth)

    def __call__(self, bp: torch.Tensor) -> torch.Tensor:
        return self._cycle(0, bp.to(self.dtype)).to(bp.dtype)


def build_lattice_mg(
    nx: int,
    ny: int,
    w: np.ndarray,
    min_n: int = 16,
    dtype: torch.dtype = torch.float32,
    mask: Optional[np.ndarray] = None,
    device: Union[str, torch.device] = "cuda",
    **kw,
) -> LatticeMG:
    """Build the V-cycle for an ``nx x ny``-block lattice with vertex
    stencil ``w`` (refinement-invariant for the 2D P1 stiffness, so every
    level shares it).  ``mask``: optional (ny+1, nx+1) bool of active
    logical vertices; coarser levels pool it (``_coarsen_mask``).  The
    tables go to ``device``, the card unless the caller asks for the CPU."""
    levels = [_Level(ny + 1, nx + 1)]
    while nx % 2 == 0 and ny % 2 == 0 and nx // 2 >= min_n and ny // 2 >= min_n:
        nx //= 2
        ny //= 2
        levels.append(_Level(ny + 1, nx + 1))
    terms = _terms(np.asarray(w))
    lvl_masks = None
    coarse_mask = None
    if mask is not None:
        m = np.asarray(mask, bool)
        masks_np = [m]
        for _ in levels[1:]:
            m = _coarsen_mask(m)
            masks_np.append(m)
        coarse_mask = masks_np[-1]
        lvl_masks = [torch.as_tensor(mm, dtype=dtype, device=device) for mm in masks_np]
    inv = _dense_coarse_inv(terms, levels[-1].R, levels[-1].C, coarse_mask)
    return LatticeMG(
        levels,
        terms,
        torch.as_tensor(inv, dtype=dtype, device=device),
        dtype=dtype,
        masks=lvl_masks,
        **kw,
    )


def block_vertex_stencil_weights(mats, offs_per_orient, vsz: int) -> np.ndarray:
    """Aggregate per-orientation VECTOR element matrices (local layout
    node-major, component-minor, as the assembly gathers) into the
    (3, 3, vsz, vsz) block vertex stencil."""
    w = np.zeros((3, 3, vsz, vsz))
    mats = np.asarray(mats, np.float64)
    for o, offs in enumerate(offs_per_orient):
        for i, (dxi, dyi) in enumerate(offs):
            for j, (dxj, dyj) in enumerate(offs):
                w[1 + dyj - dyi, 1 + dxj - dxi] += mats[o, i * vsz : (i + 1) * vsz, j * vsz : (j + 1) * vsz]
    return w


def _block_terms(w: np.ndarray) -> List[Tuple[int, int, np.ndarray]]:
    """Nonzero (a, b, (vsz, vsz) block) triples of a block stencil."""
    out = []
    scale = max(1e-300, np.abs(w).max())
    for a in range(3):
        for b in range(3):
            if np.abs(w[a, b]).max() > 1e-14 * scale:
                out.append((a, b, w[a, b].copy()))
    return out


def _conv_interior_block(xp: torch.Tensor, terms, W: torch.Tensor, R: int, C: int) -> torch.Tensor:
    """(A x) at the logical-interior nodes of channels-first block lattices:
    ``xp`` (vsz, R+2, C+2) -> (vsz, R-2, C-2); ``W`` stacks the terms'
    (vsz, vsz) blocks in the compute dtype."""
    acc = None
    for t, (a, b, _) in enumerate(terms):
        part = torch.einsum("ij,jrc->irc", W[t], xp[:, a + 1 : a + R - 1, b + 1 : b + C - 1])
        acc = part if acc is None else acc + part
    return acc


def _dense_coarse_inv_block(terms, R: int, C: int, vsz: int, mask: Optional[np.ndarray] = None) -> np.ndarray:
    """Exact inverse of the reduced block operator on the coarsest
    interior; flat index ``(node_row nj + node_col) vsz + comp``."""
    ni, nj = R - 2, C - 2
    n = ni * nj
    A = np.zeros((n * vsz, n * vsz))
    idx = np.arange(n).reshape(ni, nj)
    comp = np.arange(vsz)
    for a, b, Wb in terms:
        dy, dx = a - 1, b - 1
        src = idx[max(0, -dy) : ni - max(0, dy), max(0, -dx) : nj - max(0, dx)].reshape(-1)
        dst = idx[max(0, dy) : ni - max(0, -dy), max(0, dx) : nj - max(0, -dx)].reshape(-1)
        A[src[:, None, None] * vsz + comp[None, :, None], dst[:, None, None] * vsz + comp[None, None, :]] += Wb[None]
    if mask is not None:
        act = np.repeat(np.asarray(mask[1 : R - 1, 1 : C - 1], bool).reshape(-1), vsz)
        A[~act, :] = 0.0
        A[:, ~act] = 0.0
        off = np.where(~act)[0]
        A[off, off] = 1.0
    return np.linalg.inv(A)


@dataclasses.dataclass
class LatticeBlockMG:
    """Block (multi-channel) V-cycle on channels-first padded lattices
    (vsz, R+2, C+2), the vector-field form of :class:`LatticeMG`: block
    Jacobi with the constant interior (vsz, vsz) centre-block inverse,
    channelwise bilinear transfers.  Plain PyTorch (no card path of the port
    reaches it: S5's bulks are free-boundary fields)."""

    levels: List[_Level]
    terms: List[Tuple[int, int, np.ndarray]]
    coarse_inv: torch.Tensor
    vsz: int
    dtype: torch.dtype = torch.float32
    omega: float = 0.8
    pre_smooth: int = 2
    post_smooth: int = 2
    masks: Optional[List[torch.Tensor]] = None  # per-level (R, C), channel-shared

    def __post_init__(self):
        dev = self.coarse_inv.device
        d = next(Wb for a, b, Wb in self.terms if a == 1 and b == 1)
        self._dinv = torch.as_tensor(np.linalg.inv(d), dtype=self.dtype, device=dev)
        self._W = torch.as_tensor(np.stack([Wb for _, _, Wb in self.terms]), dtype=self.dtype, device=dev)

    def _mask_int(self, k: int, R: int, C: int):
        if self.masks is None:
            return None
        return self.masks[k][1 : R - 1, 1 : C - 1]

    def _smooth(self, xp, bp, lvl: _Level, k: int, sweeps: int):
        R, C = lvl.R, lvl.C
        m = self._mask_int(k, R, C)
        for _ in range(sweeps):
            r = bp[:, 2:R, 2:C] - _conv_interior_block(xp, self.terms, self._W, R, C)
            upd = self.omega * torch.einsum("ij,jrc->irc", self._dinv, r)
            if m is not None:
                upd = upd * m
            xp[:, 2:R, 2:C] += upd
        return xp

    def _cycle(self, k: int, bp):
        lvl = self.levels[k]
        R, C = lvl.R, lvl.C
        if k == len(self.levels) - 1:
            flat = torch.movedim(bp[:, 2:R, 2:C], 0, -1).reshape(-1)
            out = torch.zeros_like(bp)
            out[:, 2:R, 2:C] = torch.movedim((self.coarse_inv @ flat).reshape(R - 2, C - 2, self.vsz), -1, 0)
            return out
        xp = self._smooth(torch.zeros_like(bp), bp, lvl, k, self.pre_smooth)
        r_int = bp[:, 2:R, 2:C] - _conv_interior_block(xp, self.terms, self._W, R, C)
        m = self._mask_int(k, R, C)
        if m is not None:
            r_int = r_int * m
        nxt = self.levels[k + 1]
        bc = torch.stack([_restrict(ri, nxt.R, nxt.C) for ri in r_int])
        if self.masks is not None:
            bc = bc * _embed_mask(self.masks[k + 1], nxt.R, nxt.C)
        ec = self._cycle(k + 1, bc)
        corr = torch.stack([_prolong(e, nxt.R, nxt.C) for e in ec])
        if self.masks is not None:
            corr = corr * self.masks[k]
        xp[:, 2:R, 2:C] += corr[:, 1:-1, 1:-1]
        return self._smooth(xp, bp, lvl, k, self.post_smooth)

    def __call__(self, bp: torch.Tensor) -> torch.Tensor:
        return self._cycle(0, bp.to(self.dtype)).to(bp.dtype)


def _embed_mask(m: torch.Tensor, R: int, C: int) -> torch.Tensor:
    """Logical (R, C) mask -> padded (R+2, C+2) with a zero ring and zero
    logical borders (the reduced-vector convention)."""
    out = torch.zeros((R + 2, C + 2), dtype=m.dtype, device=m.device)
    out[2:R, 2:C] = m[1:-1, 1:-1]
    return out


def build_lattice_block_mg(
    nx: int,
    ny: int,
    w: np.ndarray,
    min_n: int = 16,
    dtype: torch.dtype = torch.float32,
    mask: Optional[np.ndarray] = None,
    device: Union[str, torch.device] = "cuda",
    **kw,
) -> LatticeBlockMG:
    """Build the block V-cycle for an ``nx x ny``-block lattice with the
    (3, 3, vsz, vsz) block vertex stencil ``w`` (scale-free in 2D, so every
    level shares it); the tables go to ``device``, the card unless the
    caller asks for the CPU."""
    vsz = int(w.shape[-1])
    levels = [_Level(ny + 1, nx + 1)]
    while nx % 2 == 0 and ny % 2 == 0 and nx // 2 >= min_n and ny // 2 >= min_n:
        nx //= 2
        ny //= 2
        levels.append(_Level(ny + 1, nx + 1))
    terms = _block_terms(np.asarray(w))
    lvl_masks = coarse_mask = None
    if mask is not None:
        m = np.asarray(mask, bool)
        masks_np = [m]
        for _ in levels[1:]:
            m = _coarsen_mask(m)
            masks_np.append(m)
        coarse_mask = masks_np[-1]
        lvl_masks = [torch.as_tensor(mm, dtype=dtype, device=device) for mm in masks_np]
    inv = _dense_coarse_inv_block(terms, levels[-1].R, levels[-1].C, vsz, coarse_mask)
    return LatticeBlockMG(levels, terms, torch.as_tensor(inv, dtype=dtype, device=device), vsz, dtype=dtype,
                          masks=lvl_masks, **kw)


def orientation_cell_masks(grid, sel: np.ndarray) -> np.ndarray:
    """Per-orientation ``(norient, ny, nx)`` float cell indicators from a
    flat covered-cells bool ``sel`` (row-major boxes, the two triangles of
    a box interleaved, as in ``StencilCellBatch``)."""
    ny, nx = grid.ny, grid.nx
    if grid.is_simplex:
        return np.stack([sel[0::2].reshape(ny, nx), sel[1::2].reshape(ny, nx)]).astype(np.float64)
    return sel.reshape(1, ny, nx).astype(np.float64)


def cell_stencil_maps(contribs, offs_per_orient, vsz: int) -> np.ndarray:
    """Variable per-vertex block stencil maps ``(3, 3, vsz, vsz, R-2, C-2)``
    on the logical-interior vertices, assembled from per-orientation cell
    indicators: the exact reduced operator of the cell terms on the covered
    region, with a FREE (Neumann) boundary where coverage ends, which a
    floating or naturally bounded block needs from its bulk MG.

    ``contribs``: ``(mats, ind)`` pairs, element matrices (norient,
    nloc*vsz, nloc*vsz) and indicators (norient, ny, nx), summed."""
    norient, ny, nx = contribs[0][1].shape
    R, C = ny + 1, nx + 1
    W = np.zeros((3, 3, vsz, vsz, R, C))
    for mats, ind in contribs:
        mats = np.asarray(mats, np.float64)
        for o, offs in enumerate(offs_per_orient):
            io = ind[o]
            for i, (dxi, dyi) in enumerate(offs):
                for j, (dxj, dyj) in enumerate(offs):
                    blk = mats[o, i * vsz : (i + 1) * vsz, j * vsz : (j + 1) * vsz]
                    a, b = 1 + dyj - dyi, 1 + dxj - dxi
                    W[a, b, :, :, dyi : dyi + ny, dxi : dxi + nx] += blk[:, :, None, None] * io
    return W[:, :, :, :, 1 : R - 1, 1 : C - 1]


def galerkin_coarsen_stencil(Wf: np.ndarray, Rc: int, Cc: int) -> np.ndarray:
    """Galerkin (RAP) coarsening of a variable 9-point block stencil with
    full-weighting restriction and bilinear prolongation; the coarse
    operator stays 9-point.  (Re-discretizing coarse levels from pooled
    cell indicators diverges with depth on free-boundary blocks; RAP keeps
    the coarse correction A-optimal for SPD blocks.)

    ``Wf``: (3, 3, vsz, vsz, Rf-2, Cf-2) with ``Rf = 2 Rc - 1``.  Returns
    (3, 3, vsz, vsz, Rc-2, Cc-2)."""
    _, _, vsz, _, nif, njf = Wf.shape
    Rf, Cf = nif + 2, njf + 2
    # logical-full with a ring of zeros, plus 2 of padding for the gathers
    Wfull = np.zeros((3, 3, vsz, vsz, Rf + 4, Cf + 4))
    Wfull[:, :, :, :, 3 : 3 + nif, 3 : 3 + njf] = Wf
    wt = {-1: 0.5, 0: 1.0, 1: 0.5}
    Wc = np.zeros((3, 3, vsz, vsz, Rc, Cc))
    Iidx = 2 * np.arange(Rc)
    Jidx = 2 * np.arange(Cc)
    for dI in (-1, 0, 1):
        for dJ in (-1, 0, 1):
            acc = np.zeros((vsz, vsz, Rc, Cc))
            for s in (-1, 0, 1):
                for t in (-1, 0, 1):
                    for sp in (-1, 0, 1):
                        a = 2 * dI + sp - s
                        if abs(a) > 1:
                            continue
                        for tp in (-1, 0, 1):
                            b = 2 * dJ + tp - t
                            if abs(b) > 1:
                                continue
                            w = wt[s] * wt[t] * wt[sp] * wt[tp]
                            # fine row vertex (2I+s, 2J+t), offset (a, b)
                            acc += w * Wfull[1 + a, 1 + b][:, :, (Iidx + s + 2)[:, None], (Jidx + t + 2)[None, :]]
            Wc[1 + dI, 1 + dJ] = acc
    return Wc[:, :, :, :, 1 : Rc - 1, 1 : Cc - 1]


def _var_diag_inv(Wint: np.ndarray, mask: Optional[np.ndarray]) -> np.ndarray:
    """Per-vertex inverses of the center blocks ``Wint[1, 1]``, ``(vsz,
    vsz, R-2, C-2)``; identity where the block vanishes or the vertex is
    masked out."""
    vsz = Wint.shape[2]
    D = np.moveaxis(Wint[1, 1], (0, 1), (-2, -1)).copy()  # (R-2, C-2, v, v)
    dead = np.abs(D).max(axis=(-2, -1)) < 1e-300
    if mask is not None:
        dead |= ~np.asarray(mask[1:-1, 1:-1], bool)
    D[dead] = np.eye(vsz)
    return np.moveaxis(np.linalg.inv(D), (-2, -1), (0, 1))


def _dense_var_coarse_pinv(Wint: np.ndarray, mask: Optional[np.ndarray]) -> np.ndarray:
    """Masked dense pseudo-inverse of the coarsest variable operator (a
    floating block's coarsest operator is exactly singular: pinv gives the
    zero-gauge solve); flat index (node_row * nj + node_col) * vsz + comp."""
    vsz, ni, nj = Wint.shape[2], Wint.shape[-2], Wint.shape[-1]
    n = ni * nj * vsz
    A = np.zeros((n, n))
    idx = np.arange(ni)[:, None] * nj + np.arange(nj)[None, :]
    for a in range(3):
        for b in range(3):
            dy, dx = a - 1, b - 1
            i0, i1 = max(0, -dy), min(ni, ni - dy)
            j0, j1 = max(0, -dx), min(nj, nj - dx)
            if i0 >= i1 or j0 >= j1:
                continue
            rows = idx[i0:i1, j0:j1].reshape(-1)
            cols = idx[i0 + dy : i1 + dy, j0 + dx : j1 + dx].reshape(-1)
            blks = np.moveaxis(Wint[a, b, :, :, i0:i1, j0:j1], (0, 1), (-2, -1)).reshape(-1, vsz, vsz)
            np.add.at(
                A,
                (rows[:, None, None] * vsz + np.arange(vsz)[None, :, None],
                 cols[:, None, None] * vsz + np.arange(vsz)[None, None, :]),
                blks,
            )
    if mask is not None:
        act = np.repeat(np.asarray(mask[1:-1, 1:-1], bool).reshape(-1), vsz)
        A[~act, :] = 0.0
        A[:, ~act] = 0.0
        dd = np.where(~act)[0]
        A[dd, dd] = 1.0
    return np.linalg.pinv(A, rcond=1e-10)


def _mask_rows_cols(Wint: np.ndarray, m: np.ndarray) -> np.ndarray:
    """The stencil restricted to the active vertices ``m`` (logical (R, C)
    bool): rows and columns of inactive vertices zeroed."""
    ni, nj = Wint.shape[-2:]
    mi = m[1:-1, 1:-1].astype(np.float64)
    mp = np.pad(mi, 1)
    Wint = Wint * mi  # rows
    for a in range(3):
        for b in range(3):
            Wint[a, b] *= mp[a : a + ni, b : b + nj]  # columns
    return Wint


@dataclasses.dataclass
class LatticeVarMG:
    """Variable-stencil block V-cycle on channels-first padded lattices
    ``(vsz, R+2, C+2)``: every level's operator is the exact reduced
    cell-term operator of the covered region (free boundary where coverage
    ends) or its Galerkin coarsening, smoothed by damped block Jacobi with
    per-vertex (vsz, vsz) inverses.  For floating or naturally bounded
    blocks (S5's two displacement fields).

    Plain PyTorch: ``_conv`` is one stacked ``einsum`` over the 9 taps."""

    levels: List[_Level]
    Ws: List[torch.Tensor]  # per level (3, 3, vsz, vsz, R-2, C-2)
    Dinvs: List[torch.Tensor]  # per level (vsz, vsz, R-2, C-2)
    coarse_inv: torch.Tensor  # dense pinv on the coarsest interior
    vsz: int
    dtype: torch.dtype = torch.float32
    omega: float = 0.8
    pre_smooth: int = 2
    post_smooth: int = 2
    masks: Optional[List[torch.Tensor]] = None  # per level (R, C), shared by the channels

    def _conv(self, xp: torch.Tensor, k: int, R: int, C: int) -> torch.Tensor:
        W = self.Ws[k]
        xs = torch.stack([xp[:, a + 1 : a + R - 1, b + 1 : b + C - 1] for a in range(3) for b in range(3)])
        return torch.einsum("tijrc,tjrc->irc", W.reshape((9,) + W.shape[2:]), xs)

    def _mask_int(self, k: int, R: int, C: int):
        if self.masks is None:
            return None
        return self.masks[k][1 : R - 1, 1 : C - 1]

    def _smooth(self, xp, bp, lvl: _Level, k: int, sweeps: int):
        """Damped block Jacobi on the interior (updates ``xp`` in place)."""
        R, C = lvl.R, lvl.C
        m = self._mask_int(k, R, C)
        for _ in range(sweeps):
            r = bp[:, 2:R, 2:C] - self._conv(xp, k, R, C)
            upd = self.omega * torch.einsum("ijrc,jrc->irc", self.Dinvs[k], r)
            xp[:, 2:R, 2:C] += upd if m is None else upd * m
        return xp

    def _cycle(self, k: int, bp):
        lvl = self.levels[k]
        R, C = lvl.R, lvl.C
        if k == len(self.levels) - 1:
            flat = torch.movedim(bp[:, 2:R, 2:C], 0, -1).reshape(-1)
            sol = self.coarse_inv @ flat
            out = torch.zeros_like(bp)
            out[:, 2:R, 2:C] = torch.movedim(sol.reshape(R - 2, C - 2, self.vsz), -1, 0)
            return out
        xp = self._smooth(torch.zeros_like(bp), bp, lvl, k, self.pre_smooth)
        r_int = bp[:, 2:R, 2:C] - self._conv(xp, k, R, C)
        m = self._mask_int(k, R, C)
        if m is not None:
            r_int = r_int * m
        nxt = self.levels[k + 1]
        bc = torch.stack([_restrict(ri, nxt.R, nxt.C) for ri in r_int])
        if self.masks is not None:
            bc = bc * _embed(self.masks[k + 1][1:-1, 1:-1], nxt.R, nxt.C)
        ec = self._cycle(k + 1, bc)
        corr = torch.stack([_prolong(e, nxt.R, nxt.C) for e in ec])
        if self.masks is not None:
            corr = corr * self.masks[k]
        xp[:, 2:R, 2:C] += corr[:, 1:-1, 1:-1]
        return self._smooth(xp, bp, lvl, k, self.post_smooth)

    def __call__(self, bp: torch.Tensor) -> torch.Tensor:
        return self._cycle(0, bp.to(self.dtype)).to(bp.dtype)


def build_lattice_var_mg(
    grid,
    contribs,
    vsz: int,
    min_n: int = 16,
    dtype: torch.dtype = torch.float32,
    mask: Optional[np.ndarray] = None,
    device: Union[str, torch.device] = "cuda",
    **kw,
) -> LatticeVarMG:
    """Build the variable-stencil V-cycle for the cell terms ``contribs``:
    ``(mats, covered)`` pairs, element matrices (norient, nloc*vsz,
    nloc*vsz) and a covered-cells bool (num_cells,) or a (norient, ny, nx)
    indicator.  ``mask``: (ny+1, nx+1) active-vertex bool.  The fine
    operator is the row- and column-masked stencil (the bulk block); the
    coarse ones are its Galerkin coarsenings, each masked where its center
    block falls below 1e-12 of the fine scale.  The tables go to
    ``device``, the card unless the caller asks for the CPU."""
    from .stencil import orientation_offsets

    nx, ny = grid.nx, grid.ny
    levels = [_Level(ny + 1, nx + 1)]
    while nx % 2 == 0 and ny % 2 == 0 and nx // 2 >= min_n and ny // 2 >= min_n:
        nx //= 2
        ny //= 2
        levels.append(_Level(ny + 1, nx + 1))
    fine = []
    for mats, covered in contribs:
        covered = np.asarray(covered)
        ind = orientation_cell_masks(grid, covered.astype(bool)) if covered.ndim == 1 else covered.astype(np.float64)
        fine.append((np.asarray(mats), ind))
    Wint = cell_stencil_maps(fine, orientation_offsets(grid), vsz)
    if mask is not None:
        m0 = np.asarray(mask, bool)
    else:
        m0 = np.zeros((levels[0].R, levels[0].C), bool)
        m0[1:-1, 1:-1] = np.abs(Wint[1, 1]).max(axis=(0, 1)) > 0.0
    Wint = _mask_rows_cols(Wint, m0)
    masks_np: List[np.ndarray] = [m0]
    Ws, Dinvs = [], []
    scale = max(1e-300, np.abs(Wint[1, 1]).max())
    tens = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    for k, lv in enumerate(levels):
        if k > 0:
            Wint = galerkin_coarsen_stencil(Wint, lv.R, lv.C)
            mk = np.zeros((lv.R, lv.C), bool)
            mk[1:-1, 1:-1] = np.abs(Wint[1, 1]).max(axis=(0, 1)) > 1e-12 * scale
            masks_np.append(mk)
            Wint = _mask_rows_cols(Wint, mk)
        Ws.append(tens(Wint))
        Dinvs.append(tens(_var_diag_inv(Wint, masks_np[k])))
    inv = _dense_var_coarse_pinv(Wint, masks_np[-1])
    return LatticeVarMG(levels, Ws, Dinvs, tens(inv), vsz, dtype=dtype, masks=[tens(m) for m in masks_np], **kw)


def lattice_cg(
    mg: LatticeMG,
    bp: torch.Tensor,
    tol: float = 1e-10,
    maxiter: int = 40,
    x0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, float, int]:
    """MG-preconditioned CG on padded lattices (full precision of ``bp``,
    V-cycle in ``mg.dtype``).  Returns ``(xp, relres, iters)``.

    A Python loop; its exit test reads one scalar from the device per
    iteration.  Dots run in the working dtype of ``bp``."""
    lvl = mg.levels[0]
    R, C = lvl.R, lvl.C
    terms = mg.terms

    def matvec(xp):
        return _embed(_conv_interior(xp, terms, R, C), R, C)

    def dot(a, b):
        return torch.dot(a.reshape(-1), b.reshape(-1))

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
