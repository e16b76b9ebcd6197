"""Shared machinery of the hand-built 3D lattice schemes.

Counterpart of :mod:`phifem_tpu.models.lattice_core`.  The 3D schemes bypass the generic assembly layer: their operators are
masked uniform stencils (:func:`~phifem_tpu_torch.ops.cuda_hex3.hex_stencil3`,
a hand-written kernel on the card), static per-orientation face matrices and
batched cut-cell blocks.  This module holds:

* the numpy quadrature and shape tables of Q1 and Q_d hexahedra and the
  closed-form cell -> node gather lists;
* :func:`make_equilibrated_runner` / :func:`cached_equilibrated_solve`: the
  symmetric-diagonally-equilibrated Krylov solve on dict vectors (the port's
  ``solvers._pbicgstab`` / ``_pcg`` / ``_pfgmres``; penalty rows scale like
  h^-3, so equilibration is needed);
* :func:`build_interface_block` / :func:`lattice_sparse_solve`: the sparse
  data-dependent DoF block (its per-entity RAS blocks built vectorized) and
  the host SuperLU direct solve;
* :func:`make_interface_apply`: the correction ``A_II^{-1} r_I`` on that
  block, a dense inverse or the band solve of :class:`~phifem_tpu_torch.mg.
  VCycle` (fixed-sweep BiCGStab or damped RAS-Richardson);
* :func:`lattice_l2_h1_errors` / :func:`lattice_l2_h1_errors_d` /
  :func:`lattice_l2_h1_errors_vec`: relative L2 / H10 errors against a
  callable, its derivatives by ``torch.func``.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..mg import TABLE_DTYPE, VCycle, entity_blocks, set_schwarz_tables
from ..ops import cuda_band
from ..ops.cuda_hex3 import hex_offsets
from ..ops.scatter import scatter_plan

Vec = Dict[str, torch.Tensor]

HEX_OFFS = tuple((dx, dy, dz) for dz in (0, 1) for dy in (0, 1) for dx in (0, 1))

__all__ = [
    "HEX_OFFS",
    "gauss01",
    "hex_shape",
    "hex_quadrature",
    "hex_quadrature_points",
    "face_quadrature",
    "face_quadrature_points",
    "cell_dofs_of",
    "lagrange1d_coeffs",
    "hexd_shape",
    "hexd_quadrature",
    "faced_quadrature",
    "cell_nodes_of",
    "cut_cell_points",
    "levelset_and_grad",
    "touched_vertices",
    "OrderedScatter",
    "lattice_l2_h1_errors_d",
    "lattice_l2_h1_errors",
    "lattice_l2_h1_errors_vec",
    "make_equilibrated_runner",
    "cached_equilibrated_solve",
    "build_interface_block",
    "lattice_sparse_solve",
    "make_interface_apply",
]


# ------------------------------------------------------ numpy tables (host)
def gauss01(n: int):
    """n-point Gauss nodes / weights on [0, 1] (weights sum to 1)."""
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


def hex_shape(xi: np.ndarray):
    """Trilinear values (8,) and reference gradients (8, 3) at xi in
    [0,1]^3 (node order HEX_OFFS)."""
    vals = np.empty(8)
    grads = np.empty((8, 3))
    for i, (dx, dy, dz) in enumerate(HEX_OFFS):
        f = np.array([xi[0] if dx else 1.0 - xi[0], xi[1] if dy else 1.0 - xi[1], xi[2] if dz else 1.0 - xi[2]])
        df = np.array([1.0 if dx else -1.0, 1.0 if dy else -1.0, 1.0 if dz else -1.0])
        vals[i] = f.prod()
        for k in range(3):
            grads[i, k] = df[k] * np.prod(np.delete(f, k))
    return vals, grads


def _tensor_points(g):
    """npd^3 tensor points (x fastest) of the 1D nodes ``g``."""
    return [(gx, gy, gz) for gz in g for gy in g for gx in g]


def hex_quadrature(npd: int):
    """(nq,) weights, (nq, 8) values, (nq, 8, 3) reference gradients of
    the npd^3 tensor Gauss rule on [0,1]^3."""
    g, w = gauss01(npd)
    W, V, G = [], [], []
    for (gx, gy, gz), (wx, wy, wz) in zip(_tensor_points(g), _tensor_points(w)):
        vals, grads = hex_shape(np.array([gx, gy, gz]))
        W.append(wx * wy * wz)
        V.append(vals)
        G.append(grads)
    return np.asarray(W), np.asarray(V), np.asarray(G)


def hex_quadrature_points(npd: int) -> np.ndarray:
    """(nq, 3) reference coordinates of the npd^3 tensor Gauss rule, in
    the order of :func:`hex_quadrature`."""
    g, _ = gauss01(npd)
    return np.asarray(_tensor_points(g))


def _face_points(ax_lat: int, at_upper: bool, g):
    k_phys = {0: 2, 1: 1, 2: 0}[ax_lat]
    t = [i for i in range(3) if i != k_phys]
    out = []
    for ga in g:
        for gb in g:
            xi = np.empty(3)
            xi[k_phys] = 1.0 if at_upper else 0.0
            xi[t[0]], xi[t[1]] = ga, gb
            out.append(xi)
    return out, k_phys


def face_quadrature(ax_lat: int, at_upper: bool, npd: int = 2):
    """Quadrature on the hex face normal to lattice axis ``ax_lat`` (0=z,
    1=y, 2=x): (nq,) weights, (nq, 8) values, (nq, 8, 3) reference
    gradients, and the physical coordinate index the face is normal to."""
    g, w = gauss01(npd)
    pts, k_phys = _face_points(ax_lat, at_upper, g)
    W = np.asarray([wa * wb for wa in w for wb in w])
    VG = [hex_shape(xi) for xi in pts]
    return W, np.asarray([v for v, _ in VG]), np.asarray([gr for _, gr in VG]), k_phys


def face_quadrature_points(ax_lat: int, at_upper: bool, npd: int = 2) -> np.ndarray:
    """(nqf, 3) reference coordinates of the face rule, in the order of
    :func:`face_quadrature`."""
    g, _ = gauss01(npd)
    pts, _ = _face_points(ax_lat, at_upper, g)
    return np.asarray(pts)


def cell_dofs_of(lattice_shape: Tuple[int, int, int], cells: np.ndarray) -> np.ndarray:
    """(ne, 8) int flat vertex ids of hex cells (ne, 3) = (iz, iy, ix),
    node order HEX_OFFS."""
    _, R, C = lattice_shape
    out = np.empty((cells.shape[0], 8), np.int64)
    for i, (dx, dy, dz) in enumerate(HEX_OFFS):
        out[:, i] = ((cells[:, 0] + dz) * R + cells[:, 1] + dy) * C + cells[:, 2] + dx
    return out


def lagrange1d_coeffs(degree: int) -> np.ndarray:
    """(degree+1, degree+1) ascending polynomial coefficients of the 1D
    Lagrange basis at the equispaced nodes k/degree on [0, 1] (row i = L_i)."""
    nodes = np.arange(degree + 1) / max(degree, 1)
    V = np.vander(nodes, degree + 1, increasing=True)
    return np.linalg.inv(V).T


def hexd_shape(xi: np.ndarray, degree: int):
    """Values (nloc,), gradients (nloc, 3) and PURE second derivatives
    (nloc, 3) of the Q_degree basis at xi in [0,1]^3, node order
    :func:`hex_offsets`."""
    Cf = lagrange1d_coeffs(degree)

    def ev(t):
        vals = np.array([np.polyval(Cf[i][::-1], t) for i in range(degree + 1)])
        d1 = np.array([np.polyval(np.polyder(Cf[i][::-1]), t) for i in range(degree + 1)])
        if degree >= 2:
            d2 = np.array([np.polyval(np.polyder(Cf[i][::-1], 2), t) for i in range(degree + 1)])
        else:
            d2 = np.zeros(degree + 1)
        return vals, d1, d2

    fx, dfx, ddx = ev(xi[0])
    fy, dfy, ddy = ev(xi[1])
    fz, dfz, ddz = ev(xi[2])
    offs = hex_offsets(degree)
    nloc = len(offs)
    vals = np.empty(nloc)
    grads = np.empty((nloc, 3))
    sec = np.empty((nloc, 3))
    for i, (ox, oy, oz) in enumerate(offs):
        vals[i] = fx[ox] * fy[oy] * fz[oz]
        grads[i] = (dfx[ox] * fy[oy] * fz[oz], fx[ox] * dfy[oy] * fz[oz], fx[ox] * fy[oy] * dfz[oz])
        sec[i] = (ddx[ox] * fy[oy] * fz[oz], fx[ox] * ddy[oy] * fz[oz], fx[ox] * fy[oy] * ddz[oz])
    return vals, grads, sec


def hexd_quadrature(npd: int, degree: int):
    """npd^3 tensor Gauss rule on the Q_degree basis: (nq,) weights,
    (nq, nloc) values, (nq, nloc, 3) reference gradients, (nq, nloc, 3)
    pure reference second derivatives."""
    g, w = gauss01(npd)
    W, V, G, S = [], [], [], []
    for (gx, gy, gz), (wx, wy, wz) in zip(_tensor_points(g), _tensor_points(w)):
        vals, grads, sec = hexd_shape(np.array([gx, gy, gz]), degree)
        W.append(wx * wy * wz)
        V.append(vals)
        G.append(grads)
        S.append(sec)
    return np.asarray(W), np.asarray(V), np.asarray(G), np.asarray(S)


def faced_quadrature(ax_lat: int, at_upper: bool, npd: int, degree: int):
    """Q_degree version of :func:`face_quadrature`."""
    g, w = gauss01(npd)
    pts, k_phys = _face_points(ax_lat, at_upper, g)
    W = np.asarray([wa * wb for wa in w for wb in w])
    VG = [hexd_shape(xi, degree)[:2] for xi in pts]
    return W, np.asarray([v for v, _ in VG]), np.asarray([gr for _, gr in VG]), k_phys


def cell_nodes_of(node_shape: Tuple[int, int, int], cells: np.ndarray, degree: int) -> np.ndarray:
    """(ne, (degree+1)^3) int flat NODE ids of hex cells (ne, 3) =
    (iz, iy, ix) on the degree-refined node lattice; :func:`cell_dofs_of`
    at degree 1."""
    _, Rn, Cn = node_shape
    offs = hex_offsets(degree)
    out = np.empty((cells.shape[0], len(offs)), np.int64)
    for i, (ox, oy, oz) in enumerate(offs):
        out[:, i] = ((degree * cells[:, 0] + oz) * Rn + degree * cells[:, 1] + oy) * Cn + degree * cells[:, 2] + ox
    return out


def levelset_and_grad(levelset: Callable, pts: torch.Tensor):
    """phi and grad phi (``torch.func``) at points (..., 3)."""
    from torch.func import grad, vmap

    g = vmap(grad(lambda p: levelset(p[None])[0]))(pts.reshape(-1, 3))
    return levelset(pts), g.reshape(pts.shape)


def cut_cell_points(grid, cells: np.ndarray, Pq: np.ndarray) -> torch.Tensor:
    """(ne, nq, 3) physical quadrature points of the cells (ne, 3) =
    (iz, iy, ix), from the reference points ``Pq`` (nq, 3)."""
    hs = np.array(grid.spacing)
    (x0, y0, z0), _ = grid.bbox
    orig = np.stack([x0 + hs[0] * cells[:, 2], y0 + hs[1] * cells[:, 1], z0 + hs[2] * cells[:, 0]], axis=-1)
    return torch.as_tensor(orig[:, None, :] + (Pq * hs[None, :])[None, :, :], dtype=grid.dtype, device=grid.device)


def touched_vertices(ct: np.ndarray, tag: int, DRC) -> np.ndarray:
    """(D, R, C) bool: the vertices of the cells tagged ``tag``."""
    nz, ny, nx = ct.shape
    m = np.zeros(DRC, bool)
    sel = ct == tag
    for (dx, dy, dz) in HEX_OFFS:
        m[dz : dz + nz, dy : dy + ny, dx : dx + nx] |= sel
    return m


# -------------------------------------------------------- ordered scatter
class OrderedScatter:
    """``y[dofs] += values`` with repeated ids summed in entity order
    (:func:`~phifem_tpu_torch.ops.scatter.scatter_plan`), so that a sum on
    the card never depends on the order of atomics.  ``dofs``: the flat
    target ids of all families, in the order their values will be
    concatenated."""

    def __init__(self, dofs: torch.Tensor):
        self.uniq, self.pos = scatter_plan(dofs.reshape(-1))
        self.n = dofs.numel()

    def add_(self, y: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
        v = torch.cat([values.reshape(-1), values.new_zeros(1)])
        return y.index_add_(0, self.uniq, v[self.pos].sum(dim=1))


# ------------------------------------------------------------------ errors
def _exact_and_grad(exact: Callable, pe: torch.Tensor):
    """``exact`` and its gradient (``torch.func``) at points (..., 3)."""
    from torch.func import grad, vmap

    flat = pe.reshape(-1, 3)
    ge = vmap(grad(lambda p: exact(p[None])[0]))(flat)
    return exact(pe), ge.reshape(pe.shape)


def _error_sums(mask, nodes_q, grads_q, pts_q, wq, exact):
    """Accumulate the four masked quadrature sums over the points."""
    num_l2 = den_l2 = num_h1 = den_h1 = 0.0
    for uq, gq, pe, w in zip(nodes_q, grads_q, pts_q, wq):
        ue, ge = _exact_and_grad(exact, pe)
        num_l2 = num_l2 + w * torch.sum(mask * (uq - ue) ** 2)
        den_l2 = den_l2 + w * torch.sum(mask * ue**2)
        for k in range(3):
            num_h1 = num_h1 + w * torch.sum(mask * (gq[k] - ge[..., k]) ** 2)
            den_h1 = den_h1 + w * torch.sum(mask * ge[..., k] ** 2)
    return {"l2": float(torch.sqrt(num_l2 / den_l2)), "h10": float(torch.sqrt(num_h1 / den_h1))}


def _corner_origins(grid, shape, dt, dev):
    nz, ny, nx = shape
    hx, hy, hz = grid.spacing
    (x0, y0, z0), _ = grid.bbox
    kw = dict(dtype=dt, device=dev)
    z = (z0 + hz * torch.arange(nz, **kw)[:, None, None]).expand(shape)
    y = (y0 + hy * torch.arange(ny, **kw)[None, :, None]).expand(shape)
    x = (x0 + hx * torch.arange(nx, **kw)[None, None, :]).expand(shape)
    return x, y, z


def lattice_l2_h1_errors_d(
    grid, region_mask: np.ndarray, u_nodes: torch.Tensor, exact: Callable, degree: int, npd: Optional[int] = None
) -> Dict[str, float]:
    """Relative L2 / H10 errors of a degree-d lattice field against a
    callable, by cellwise Gauss quadrature over the masked cells (dense
    masked lattice sums, stride-d slices of the node lattice)."""
    dt, dev = u_nodes.dtype, u_nodes.device
    hx, hy, hz = grid.spacing
    d = degree
    npd = npd if npd is not None else d + 1
    W, V, G, _ = hexd_quadrature(npd, d)
    Pq = hex_quadrature_points(npd)
    offs = hex_offsets(d)
    mask = torch.as_tensor(region_mask.astype(np.float64), dtype=dt, device=dev)
    nz, ny, nx = mask.shape
    x0, y0, z0 = _corner_origins(grid, mask.shape, dt, dev)
    nodes = [u_nodes[oz : oz + d * nz : d, oy : oy + d * ny : d, ox : ox + d * nx : d] for (ox, oy, oz) in offs]
    Gd = G / np.array([hx, hy, hz])[None, None, :]
    uqs, gqs, pts = [], [], []
    for q in range(W.shape[0]):
        uqs.append(sum(float(V[q, i]) * nodes[i] for i in range(len(offs))))
        gqs.append([sum(float(Gd[q, i, k]) * nodes[i] for i in range(len(offs))) for k in range(3)])
        pts.append(torch.stack([x0 + float(Pq[q, 0]) * hx, y0 + float(Pq[q, 1]) * hy, z0 + float(Pq[q, 2]) * hz], -1))
    return _error_sums(mask, uqs, gqs, pts, [float(w) for w in W], exact)


def lattice_l2_h1_errors(grid, region_mask: np.ndarray, u_lat: torch.Tensor, exact: Callable) -> Dict[str, float]:
    """Relative L2 / H10 errors of a scalar Q1 lattice field against a
    callable, by 2x2x2 cellwise Gauss quadrature over the masked cells."""
    dt, dev = u_lat.dtype, u_lat.device
    hx, hy, hz = grid.spacing
    W, V, G = hex_quadrature(2)
    Pq = hex_quadrature_points(2)
    mask = torch.as_tensor(region_mask.astype(np.float64), dtype=dt, device=dev)
    nz, ny, nx = mask.shape
    x0, y0, z0 = _corner_origins(grid, mask.shape, dt, dev)
    corners = [u_lat[dz : dz + nz, dy : dy + ny, dx : dx + nx] for (dx, dy, dz) in HEX_OFFS]
    Gd = G / np.array([hx, hy, hz])[None, None, :]
    uqs, gqs, pts = [], [], []
    for q in range(W.shape[0]):
        uqs.append(sum(float(V[q, i]) * corners[i] for i in range(8)))
        gqs.append([sum(float(Gd[q, i, k]) * corners[i] for i in range(8)) for k in range(3)])
        pts.append(torch.stack([x0 + float(Pq[q, 0]) * hx, y0 + float(Pq[q, 1]) * hy, z0 + float(Pq[q, 2]) * hz], -1))
    return _error_sums(mask, uqs, gqs, pts, [float(w) for w in W], exact)


def lattice_l2_h1_errors_vec(grid, region_mask: np.ndarray, u_lat: torch.Tensor, exact: Callable) -> Dict[str, float]:
    """Relative L2 / H10 errors of a channels-first vector Q1 lattice field
    ``u_lat`` (ncf, D, R, C) against ``exact((..., 3)) -> (..., ncf)``, by
    2x2x2 cellwise Gauss quadrature over the masked cells; the norms sum over
    the channels, the Jacobian of ``exact`` by ``torch.func``."""
    from torch.func import jacfwd, vmap

    dt, dev = u_lat.dtype, u_lat.device
    hx, hy, hz = grid.spacing
    ncf = u_lat.shape[0]
    W, V, G = hex_quadrature(2)
    Pq = hex_quadrature_points(2)
    mask = torch.as_tensor(region_mask.astype(np.float64), dtype=dt, device=dev)
    nz, ny, nx = mask.shape
    x0, y0, z0 = _corner_origins(grid, mask.shape, dt, dev)
    corners = [[u_lat[c, dz : dz + nz, dy : dy + ny, dx : dx + nx] for (dx, dy, dz) in HEX_OFFS] for c in range(ncf)]
    Gd = G / np.array([hx, hy, hz])[None, None, :]
    jac = vmap(jacfwd(lambda p: exact(p[None])[0]))
    num_l2 = den_l2 = num_h1 = den_h1 = 0.0
    for q in range(W.shape[0]):
        w = float(W[q])
        pe = torch.stack([x0 + float(Pq[q, 0]) * hx, y0 + float(Pq[q, 1]) * hy, z0 + float(Pq[q, 2]) * hz], -1)
        ue = exact(pe)  # (..., ncf)
        ge = jac(pe.reshape(-1, 3)).reshape(pe.shape[:-1] + (ncf, 3))
        for c in range(ncf):
            uq = sum(float(V[q, i]) * corners[c][i] for i in range(8))
            num_l2 = num_l2 + w * torch.sum(mask * (uq - ue[..., c]) ** 2)
            den_l2 = den_l2 + w * torch.sum(mask * ue[..., c] ** 2)
            for k in range(3):
                gk = sum(float(Gd[q, i, k]) * corners[c][i] for i in range(8))
                num_h1 = num_h1 + w * torch.sum(mask * (gk - ge[..., c, k]) ** 2)
                den_h1 = den_h1 + w * torch.sum(mask * ge[..., c, k] ** 2)
    return {"l2": float(torch.sqrt(num_l2 / den_l2)), "h10": float(torch.sqrt(num_h1 / den_h1))}


# ----------------------------------------------------- equilibrated solve
def make_equilibrated_runner(
    matvec: Callable[[Vec], Vec],
    diag: Vec,
    active: Dict[str, torch.Tensor],
    method: str = "bicgstab",
    tol: float = 1e-10,
    maxiter: int = 4000,
    precond: Optional[Callable] = None,
    deflate: Optional[Sequence[Vec]] = None,
    restart: int = 20,
):
    """``run(b) -> (x, rel_residual, iterations)``: symmetric diagonal
    equilibration, identity on inactive DoFs, then the port's BiCGStab, CG
    or flexible GMRES (cycles of ``restart`` steps) on dict vectors.
    ``deflate``: vectors spanning a (near-)null space; the iteration then
    runs on ``P A P + Q Q^T``, as :func:`phifem_tpu_torch.solvers.solve`
    does.  The relative residual is that of the equilibrated system,
    recomputed after the loop."""
    from ..solvers import _pbicgstab, _pcg, _pfgmres, tree_axpy, tree_dot

    runners = {"cg": _pcg, "fgmres": functools.partial(_pfgmres, restart=restart), "bicgstab": _pbicgstab}
    if method not in runners:
        raise ValueError(f"unknown method {method!r}: expected 'bicgstab', 'cg' or 'fgmres'")
    runner = runners[method]
    dsqrt = {k: torch.sqrt(torch.abs(d)) for k, d in diag.items()}
    dinv = {k: 1.0 / d for k, d in dsqrt.items()}

    def mv(y: Vec) -> Vec:
        z = matvec({k: torch.where(active[k], y[k] * dinv[k], 0.0) for k in y})
        return {k: torch.where(active[k], z[k] * dinv[k], y[k]) for k in y}

    if precond is not None:
        def M(r: Vec) -> Vec:
            z = precond({k: v * dsqrt[k] for k, v in r.items()})
            return {k: v * dsqrt[k] for k, v in z.items()}
    else:
        M = lambda r: r

    ortho = []
    for v in deflate or ():
        q = {k: torch.where(active[k], v[k], 0.0) * dsqrt[k] for k in v}
        for o in ortho:
            q = tree_axpy(-tree_dot(o, q), o, q)
        nrm = torch.clamp(torch.sqrt(tree_dot(q, q)), min=1e-300)
        ortho.append({k: t / nrm for k, t in q.items()})
    if ortho:
        def proj(v: Vec) -> Vec:
            for o in ortho:
                v = tree_axpy(-tree_dot(o, v), o, v)
            return v

        mv_plain, M_plain = mv, M

        def mv(y: Vec) -> Vec:
            z = proj(mv_plain(proj(y)))
            for o in ortho:  # identity on the deflated span
                z = tree_axpy(tree_dot(o, y), o, z)
            return z

        M = lambda r: proj(M_plain(proj(r)))

    def run(b: Vec):
        b_eq = {k: torch.where(active[k], b[k] * dinv[k], 0.0) for k in b}
        if ortho:
            b_eq = proj(b_eq)
        x0 = {k: torch.zeros_like(v) for k, v in b_eq.items()}
        x, it, _ = runner(mv, b_eq, x0, tol=tol, atol=0.0, maxiter=maxiter, M=M)
        r = {k: b_eq[k] - v for k, v in mv(x).items()}
        rn = float(torch.sqrt(tree_dot(r, r)))
        bn = float(torch.sqrt(tree_dot(b_eq, b_eq)))
        for o in ortho:  # the zero-null-component gauge
            x = tree_axpy(-tree_dot(o, x), o, x)
        return {k: v * dinv[k] for k, v in x.items()}, rn / max(bn, 1e-300), int(it)

    return run


def cached_equilibrated_solve(
    scheme, method: str, tol: float, maxiter: int, precond: Optional[Callable], deflate=None
) -> Tuple[Vec, float, int]:
    """Solve with a runner memoized on ``scheme`` (which exposes ``matvec``,
    ``diag``, ``active`` and ``b``): returns (x, rel_residual, iterations)."""
    key = (method, float(tol), int(maxiter), id(precond), len(deflate) if deflate else 0, id(deflate))
    cache = getattr(scheme, "_solve_cache", None)
    if cache is None:
        cache = scheme._solve_cache = {}
    run = cache.get(key)
    if run is None:
        run = cache[key] = make_equilibrated_runner(
            scheme.matvec, scheme.diag, scheme.active, method=method, tol=tol, maxiter=maxiter,
            precond=precond, deflate=deflate,
        )
    return run(scheme.b)


# ------------------------------------------------ sparse interface block
def _coo_block(blocks, idx_of: np.ndarray, m: int):
    import scipy.sparse as sp

    rows, cols, vals = [], [], []
    for row_dofs, col_dofs, mats in blocks:
        row_dofs, col_dofs = np.asarray(row_dofs), np.asarray(col_dofs)
        ne, r = row_dofs.shape
        c = col_dofs.shape[1]
        mm = np.broadcast_to(np.asarray(mats), (ne, r, c))
        rl = idx_of[np.broadcast_to(row_dofs[:, :, None], mm.shape)].reshape(-1)
        cl = idx_of[np.broadcast_to(col_dofs[:, None, :], mm.shape)].reshape(-1)
        keep = (rl >= 0) & (cl >= 0)
        rows.append(rl[keep])
        cols.append(cl[keep])
        vals.append(mm.reshape(-1)[keep])
    return sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))), shape=(m, m)
    ).tocsr()


def build_interface_block(blocks, total: int, selectable: np.ndarray):
    """The sparse data-dependent DoF block of a lattice scheme.

    ``blocks``: ``(row_dofs (ne, r), col_dofs (ne, c), mats (ne, r, c) or
    (r, c))`` in GLOBAL flat ids; ``selectable`` (total,) bool marks the
    DoFs eligible.  Returns ``(ids, A_csr, entity_blocks)``: the selected
    global ids, the CSR matrix restricted to them, and the (nb, K)
    per-entity overlapping blocks in compact ids padded with ``m``."""
    sel = np.zeros(total, bool)
    for row_dofs, col_dofs, _ in blocks:
        sel[np.asarray(row_dofs).reshape(-1)] = True
        sel[np.asarray(col_dofs).reshape(-1)] = True
    sel &= selectable
    ids = np.where(sel)[0]
    m = ids.shape[0]
    idx_of = -np.ones(total, np.int64)
    idx_of[ids] = np.arange(m)
    A = _coo_block(blocks, idx_of, m)
    ents = entity_blocks([np.concatenate([np.asarray(r), np.asarray(c)], axis=1) for r, c, _ in blocks], idx_of, m)
    return ids, A, ents


def lattice_sparse_solve(blocks, b_concat: np.ndarray, active: np.ndarray) -> np.ndarray:
    """Host SuperLU direct solve of a lattice scheme's active-restricted
    system (``blocks``: the FULL operator's entity batches in global flat
    ids); inactive DoFs get x = 0."""
    from scipy.sparse.linalg import splu

    total = active.shape[0]
    ids, A, _ = build_interface_block(blocks, total, active)
    x = np.zeros(total)
    x[ids] = splu(A.tocsc()).solve(b_concat[ids])
    return x


def make_interface_apply(
    ids: np.ndarray,
    A_csr,
    ras_blocks,
    dense_max: int = 4000,
    sweeps: Optional[int] = None,
    inner: str = "krylov",
    inner_omega: float = 1.0,
    device="cuda",
):
    """The interface-block correction ``apply(rf) -> (ids, corr)``, ``corr ~
    A_II^{-1} rf[ids]`` for the flat residual ``rf``: a dense inverse when
    ``m <= dense_max``, else an inner solve on the ELL band matrix with RAS
    block preconditioning (the tables of :class:`~phifem_tpu_torch.mg.VCycle`,
    float64, filled by :func:`~phifem_tpu_torch.mg.set_schwarz_tables`; each
    band DoF is corrected from the first block that holds it).

    ``ras_blocks``: the overlapping blocks in compact ids, a padded (nb, K)
    array (pad ``m``) or a list of id arrays.  ``inner="krylov"`` runs
    ``sweeps`` fixed BiCGStab steps (by default ``max(10, 0.3 sqrt(m))``),
    fast but nonlinear in ``rf`` when it stops on the sweep count;
    ``inner="richardson"`` runs ``sweeps`` damped RAS-Richardson steps
    ``z += inner_omega RAS(r - A z)`` from ``inner_omega RAS(r)``, a fixed
    linear operator.  ``corr`` comes back in ``rf``'s dtype; the tables go to
    ``device``, the card unless the caller asks for the CPU.  Both inner
    solves run the band kernels of :mod:`phifem_tpu_torch.ops.cuda_band` on
    the card."""
    if inner not in ("krylov", "richardson"):
        raise ValueError(f"unknown inner solve {inner!r}: expected 'krylov' or 'richardson'")
    m = ids.shape[0]
    ids_t = torch.as_tensor(ids, dtype=torch.int64, device=device)
    if m <= dense_max:
        inv = torch.as_tensor(np.linalg.inv(A_csr.toarray()), dtype=TABLE_DTYPE, device=device)

        def apply_dense(rf: torch.Tensor):
            return ids_t, (inv @ rf[ids_t].to(TABLE_DTYPE)).to(rf.dtype)

        apply_dense.m = m
        return apply_dense

    if not isinstance(ras_blocks, np.ndarray):
        K = max(len(bl) for bl in ras_blocks)
        padded = np.full((len(ras_blocks), K), m, np.int64)
        for i, bl in enumerate(ras_blocks):
            padded[i, : len(bl)] = bl
        ras_blocks = padded
    n_sweeps = sweeps if sweeps is not None else max(10, int(0.3 * m**0.5))
    band = set_schwarz_tables(VCycle([], ()), A_csr, ids, ras_blocks, n_sweeps, device)
    tab = band.band_tables

    def apply(rf: torch.Tensor):
        rb = rf[ids_t].to(TABLE_DTYPE)
        if inner == "richardson":
            corr = cuda_band.band_richardson(tab, rb, n_sweeps, inner_omega)
        else:
            corr = cuda_band.band_bicgstab(tab, rb, n_sweeps)
        return ids_t, corr.to(rf.dtype)

    apply.band, apply.m = band, m
    return apply
