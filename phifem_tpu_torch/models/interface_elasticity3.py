"""S5 in 3D: two-material interface elasticity on the hex lattice.

Counterpart of :mod:`phifem_tpu.models.interface_elasticity3`, the z-axis
extension of the 2D S5: div sigma_i(u_i) = f on each side of the immersed
interface {phi = 0} with E_in / E_out contrast, continuity of displacement
and traction imposed by phi-weighted penalties on the cut cells, exact
Dirichlet conditions on the outer box faces.

Fields (Q1 vertex lattices, stored channels-flat ``c N + vertex``):

  ui, uo : displacement per side, 3 channels
  yi, yo : tensor flux ~ -sigma per side, 9 channels (row-major (a, b))
  p      : vector auxiliary, 3 channels

Bilinear form:

  a = int_{dx(1,2)} sigma_in(ui) : eps(vi) + int_{dx(2,3)} sigma_out(uo) : eps(vo)
    + pen int_{dx(2)} [ coef_out |yi + sigma_in(grad ui)|^2-form
                      + coef_in  |yo + sigma_out(grad uo)|^2-form
                      + h^-2 |(yi - yo) . grad phi|^2-form
                      + h^-2 |ui - uo + h^-1 p phi|^2-form ]
    + stab int_{dx(2)} h^2 (div yi . div zi + div yo . div zo)
    + stab int_{dS(1|2)} h [sigma_in(grad ui) n][...]   (in-side ghost)
    + stab int_{dS(2|3)} h [sigma_out(grad uo) n][...]  (out-side ghost)
    + int_{ds(100)} (yi . n) . vi + int_{ds(101)} (yo . n) . vo

Structure, as :mod:`neumann3`: each side's bulk stiffness is a cell-masked
uniform (24, 24) block vertex stencil, one launch of the 3-channel block
hex-cell stencil kernel (:func:`~phifem_tpu_torch.ops.cuda_hex3.
hex_block_stencil3`) on the card; ghost faces are static (48, 48) per-axis
jump matrices; the one-sided flux terms are static (8, 8) face masses from
a y channel into a u channel; the cut-cell penalty block over
[ui(24) | uo(24) | yi(72) | yo(72) | p(24)] is a shared static (216, 216)
part and a per-cell phi part.  The bulk cycles of
:meth:`InterfaceElasticity3.lattice_preconditioner` run the 3-channel
block lattice sweep (:class:`~phifem_tpu_torch.ops.lattice3.
Lattice3BlockMG`).  Every scatter of entity contributions sums in a fixed
order (:class:`~phifem_tpu_torch.models.lattice_core.OrderedScatter`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..grid3 import Grid3
from ..ops.cuda_hex3 import hex_block_stencil3, hex_stencil3
from ..ops.lattice3 import build_lattice3_block_mg, hex_element_matrix
from ..solvers import SolveResult
from ..tagging3 import Tags3, compute_tags3
from .interface_elasticity import lame
from .lattice_core import (
    OrderedScatter,
    build_interface_block,
    cached_equilibrated_solve,
    cell_dofs_of,
    cut_cell_points,
    face_quadrature,
    hex_quadrature,
    hex_quadrature_points,
    lattice_l2_h1_errors_vec,
    levelset_and_grad,
    make_interface_apply,
    touched_vertices,
)

Vec = Dict[str, torch.Tensor]

__all__ = ["InterfaceElasticity3"]

# local dof layout inside a cut cell: 3 ui channels, 3 uo, 9 yi, 9 yo, 3 p,
# each channel's 8 vertex values, channel-major
_OFF_UI, _OFF_UO, _OFF_YI, _OFF_YO, _OFF_P = 0, 24, 48, 120, 192
_NLOC = 216
#: the fields in the flat layout: ui [0, 3N), uo [3N, 6N), yi [6N, 15N),
#: yo [15N, 24N), p [24N, 27N)
FIELDS = (("ui", 3), ("uo", 3), ("yi", 9), ("yo", 9), ("p", 3))


def _sigma_factor(Gp: np.ndarray, lmbda: float, mu: float) -> np.ndarray:
    """(nq, 3, 3, 24) table: sigma(grad u)[a, b] as a linear functional of
    the 24 local displacement dofs (channel c, node i -> column 8c + i),
    from physical basis gradients ``Gp`` (nq, 8, 3)."""
    nq = Gp.shape[0]
    S = np.zeros((nq, 3, 3, 24))
    for a in range(3):
        for b in range(3):
            for c in range(3):
                sl = slice(8 * c, 8 * c + 8)
                if a == b:
                    S[:, a, b, sl] += lmbda * Gp[:, :, c]
                if c == a:
                    S[:, a, b, sl] += mu * Gp[:, :, b]
                if c == b:
                    S[:, a, b, sl] += mu * Gp[:, :, a]
    return S


def _eps_factor(Gp: np.ndarray) -> np.ndarray:
    """(nq, 3, 3, 24) strain table eps(grad u)[a, b]."""
    return _sigma_factor(Gp, 0.0, 0.5)


def _div_factor(Gp: np.ndarray) -> np.ndarray:
    """(nq, 3, 72) table: div y[a] = sum_b d_b y[a, b] over the 72 local
    tensor dofs (channel (a, b) = 3a + b, node i -> column 8 (3a+b) + i)."""
    D = np.zeros((Gp.shape[0], 3, 72))
    for a in range(3):
        for b in range(3):
            D[:, a, 8 * (3 * a + b) : 8 * (3 * a + b) + 8] = Gp[:, :, b]
    return D


def _elastic_element_matrix(hx: float, hy: float, hz: float, lmbda: float, mu: float) -> np.ndarray:
    """(24, 24) channel-major Q1-hex linear-elasticity element matrix
    int sigma(u) : eps(v)."""
    W, _, G = hex_quadrature(2)
    Gp = G / np.array([hx, hy, hz])[None, None, :]
    return hx * hy * hz * np.einsum("q,qabi,qabj->ij", W, _sigma_factor(Gp, lmbda, mu), _eps_factor(Gp))


def _masked_block_stencil_apply(X: torch.Tensor, K: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``y[c, v_i] += mask * sum_{c', j} K[8c+i, 8c'+j] x[c', v_j]`` over all
    cells (the block hex-cell stencil kernel on the card)."""
    return hex_block_stencil3(X, mask, K)


def _masked_block_stencil_diag(K: torch.Tensor, mask: torch.Tensor, DRC) -> torch.Tensor:
    """The diagonal of the masked block stencil: its stencil of diag(K) on
    ones."""
    ones = torch.ones((3,) + tuple(DRC), dtype=mask.dtype, device=mask.device)
    return hex_block_stencil3(ones, mask, torch.diag(torch.diagonal(K)).contiguous())


def vertex_blocks(ids: np.ndarray, N: int) -> np.ndarray:
    """The RAS blocks of the interface block regrouped per lattice vertex:
    the compact ids whose global id has the same vertex (``id mod N``, the 27
    DoFs of the five fields at a vertex), ascending within a block, the
    blocks in the order of their vertex's first appearance in ``ids``;
    padded (nb, K) with ``m``.  The vectorized form of the JAX package's
    dict regrouping, with the same blocks in the same order."""
    m = ids.shape[0]
    v = ids % N
    uniq, first, inv = np.unique(v, return_index=True, return_inverse=True)
    rank = np.empty(uniq.shape[0], np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(uniq.shape[0])
    blk = rank[inv.reshape(-1)]
    order = np.argsort(blk, kind="stable")
    counts = np.bincount(blk, minlength=uniq.shape[0])
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(m) - start[blk[order]]
    out = np.full((uniq.shape[0], int(counts.max()) if m else 1), m, np.int64)
    out[blk[order], pos] = order
    return out


@dataclasses.dataclass
class InterfaceElasticity3:
    """3D phi-FEM two-material interface elasticity on a hex box grid."""

    grid: Grid3
    pen_coef: float = 1.0
    stab_coef: float = 1.0
    E_in: float = 1.0
    nu_in: float = 0.3
    E_out: float = 0.001
    nu_out: float = 0.3

    # ------------------------------------------------------------ setup
    def setup(self, levelset: Callable, f: Callable, u_dbc: Callable):
        self.tags: Tags3 = compute_tags3(self.grid, levelset)
        self._levelset, self._f, self._u_dbc = levelset, f, u_dbc
        self.lmbda_in, self.mu_in = lame(self.E_in, self.nu_in)
        self.lmbda_out, self.mu_out = lame(self.E_out, self.nu_out)
        return self

    def _t(self, a, dtype=None) -> torch.Tensor:
        g = self.grid
        return torch.as_tensor(np.asarray(a), dtype=g.dtype if dtype is None else dtype, device=g.device)

    # ------------------------------------------------------------ assembly
    def assemble(self):
        g = self.grid
        dt, dev = g.dtype, g.device
        hx, hy, hz = g.spacing
        h = float(np.sqrt(hx * hx + hy * hy + hz * hz))
        self.h = h
        vol = hx * hy * hz
        pen, stab = self.pen_coef, self.stab_coef
        D, R, C = g.lattice_shape
        self._DRC = (D, R, C)
        N = self._N = D * R * C
        hs = np.array([hx, hy, hz])
        li, mi, lo, mo = self.lmbda_in, self.mu_in, self.lmbda_out, self.mu_out
        coef_in = (self.E_in / (self.E_in + self.E_out)) ** 2
        coef_out = (self.E_out / (self.E_in + self.E_out)) ** 2

        # ---- per-side bulk stiffness: uniform (24, 24) block stencils
        self.K_in = self._t(_elastic_element_matrix(hx, hy, hz, li, mi)).contiguous()
        self.K_out = self._t(_elastic_element_matrix(hx, hy, hz, lo, mo)).contiguous()
        self.mask_in = self._t(self.tags.region_mask((1, 2)).astype(np.float64)).contiguous()
        self.mask_out = self._t(self.tags.region_mask((2, 3)).astype(np.float64)).contiguous()

        # ---- cut-cell penalty block over [ui | uo | yi | yo | p]
        cells = self.tags.cut_cells()
        cut_np = cell_dofs_of((D, R, C), cells)
        ne = cut_np.shape[0]
        self.idxU = self._t(np.concatenate([c * N + cut_np for c in range(3)], axis=1), torch.int64)  # (ne, 24)
        self.idxY = self._t(np.concatenate([c * N + cut_np for c in range(9)], axis=1), torch.int64)  # (ne, 72)
        W, V, G = hex_quadrature(3)
        nq = W.shape[0]
        Gp = G / hs[None, None, :]
        Dv = _div_factor(Gp)
        F1 = np.zeros((nq, 3, 3, _NLOC))
        F2 = np.zeros((nq, 3, 3, _NLOC))
        for a in range(3):
            for b in range(3):
                ch = 3 * a + b
                F1[:, a, b, _OFF_YI + 8 * ch : _OFF_YI + 8 * ch + 8] = V
                F2[:, a, b, _OFF_YO + 8 * ch : _OFF_YO + 8 * ch + 8] = V
        F1[:, :, :, _OFF_UI : _OFF_UI + 24] += _sigma_factor(Gp, li, mi)
        F2[:, :, :, _OFF_UO : _OFF_UO + 24] += _sigma_factor(Gp, lo, mo)
        D1 = np.zeros((nq, 3, _NLOC))
        D2 = np.zeros((nq, 3, _NLOC))
        D1[:, :, _OFF_YI : _OFF_YI + 72] = Dv
        D2[:, :, _OFF_YO : _OFF_YO + 72] = Dv
        E_stat = pen * vol * (coef_out * np.einsum("q,qabi,qabj->ij", W, F1, F1)
                              + coef_in * np.einsum("q,qabi,qabj->ij", W, F2, F2))
        E_stat += stab * h**2 * vol * (np.einsum("q,qai,qaj->ij", W, D1, D1) + np.einsum("q,qai,qaj->ij", W, D2, D2))
        self.E_stat = self._t(E_stat)

        # phi-dependent factors (phi analytic at the quadrature points):
        # t3[a] = (yi - yo)[a, :] . grad phi, t4[a] = ui_a - uo_a + h^-1 p_a phi
        pts = cut_cell_points(g, cells, hex_quadrature_points(3))
        self._cut_pts = pts
        phi_q, gphi = levelset_and_grad(self._levelset, pts)
        Vt, Wt = self._t(V), self._t(W)
        F34 = torch.zeros((ne, nq, 6, _NLOC), dtype=dt, device=dev)
        for a in range(3):
            for b in range(3):
                ch = 3 * a + b
                blk = gphi[:, :, b, None] * Vt[None, :, :]
                F34[:, :, a, _OFF_YI + 8 * ch : _OFF_YI + 8 * ch + 8] = blk
                F34[:, :, a, _OFF_YO + 8 * ch : _OFF_YO + 8 * ch + 8] = -blk
            F34[:, :, 3 + a, _OFF_UI + 8 * a : _OFF_UI + 8 * a + 8] = Vt[None]
            F34[:, :, 3 + a, _OFF_UO + 8 * a : _OFF_UO + 8 * a + 8] = -Vt[None]
            F34[:, :, 3 + a, _OFF_P + 8 * a : _OFF_P + 8 * a + 8] = (phi_q / h)[:, :, None] * Vt[None, :, :]
        self.E_phi = (pen / h**2) * vol * torch.einsum("nqki,q,nqkj->nij", F34, Wt, F34)

        # ---- per-side ghost faces: static (48, 48) jump matrices, in-side
        # dS(1|2) and out-side dS(2|3)
        self.ghost = []  # (dofs (nf, 48), Eg (48, 48), field)
        fams = (("ui", self.tags.jump_faces_between((1,), (2,)), (li, mi)),
                ("uo", self.tags.jump_faces_between((2,), (3,)), (lo, mo)))
        for field, fam, (lm, mm) in fams:
            for ax in range(3):
                faces = fam[ax]
                if faces.shape[0] == 0:
                    continue
                Wf, _, G0, k = face_quadrature(ax, at_upper=True)
                _, _, G1, _ = face_quadrature(ax, at_upper=False)
                S0 = _sigma_factor(G0 / hs[None, None, :], lm, mm)
                S1 = _sigma_factor(G1 / hs[None, None, :], lm, mm)
                J = np.concatenate([S0[:, :, k, :], -S1[:, :, k, :]], axis=2)  # jump of (sigma n)[a], n = +e_k
                Eg = stab * h * (vol / hs[k]) * np.einsum("q,qai,qaj->ij", Wf, J, J)
                upper = faces.copy()
                upper[:, ax] += 1
                lo8, hi8 = cell_dofs_of((D, R, C), faces), cell_dofs_of((D, R, C), upper)
                dofs = np.concatenate([c * N + lo8 for c in range(3)] + [c * N + hi8 for c in range(3)], axis=1)
                self.ghost.append((self._t(dofs, torch.int64), self._t(Eg), field))

        # ---- one-sided interface flux terms (ds(100) + ds(101)): u[a] rows
        # from y[3a + k] columns through a signed face mass
        self.flux = []  # (cell dofs (nf, 8), Eb (8, 8), k, u field)
        for ufield, fam in (("ui", self.tags.faces_between((1, 2), (3,))),
                            ("uo", self.tags.faces_between((2, 3), (1,)))):
            for ax in range(3):
                for sign, faces in zip((+1, -1), fam[ax]):
                    if faces.shape[0] == 0:
                        continue
                    Wf, Vf, _, k = face_quadrature(ax, at_upper=(sign > 0))
                    Eb = sign * (vol / hs[k]) * np.einsum("q,qi,qj->ij", Wf, Vf, Vf)
                    self.flux.append((self._t(cell_dofs_of((D, R, C), faces), torch.int64), self._t(Eb), k, ufield))
        self._make_scatters()

        # ---- RHS: f . v per side + stab h^2 f . (div z) on the cut cells
        M8 = self._t(hex_element_matrix(hx, hy, hz, stiffness=0.0, mass=1.0))
        f_lat = g.eval_at_vertices(self._f)  # (D, R, C, 3)
        b_ui = torch.stack([hex_stencil3(f_lat[..., c].contiguous(), self.mask_in, M8, 1) for c in range(3)])
        b_uo = torch.stack([hex_stencil3(f_lat[..., c].contiguous(), self.mask_out, M8, 1) for c in range(3)])
        r_loc = stab * h**2 * vol * torch.einsum("nqa,q,qai->ni", self._f(pts), Wt, self._t(D1 + D2))
        zeros = lambda k: torch.zeros(k * N, dtype=dt, device=dev)
        b = {
            "ui": b_ui.reshape(-1),
            "uo": b_uo.reshape(-1),
            "yi": self._scatter_Y.add_(zeros(9), r_loc[:, _OFF_YI : _OFF_YI + 72]),
            "yo": self._scatter_Y.add_(zeros(9), r_loc[:, _OFF_YO : _OFF_YO + 72]),
            "p": zeros(3),
        }

        # ---- diagonal / active masks
        E_diag = torch.diag(self.E_stat)[None, :] + torch.diagonal(self.E_phi, dim1=1, dim2=2)
        diag = {}
        for side, K, mask, off in (("ui", self.K_in, self.mask_in, _OFF_UI), ("uo", self.K_out, self.mask_out, _OFF_UO)):
            d0 = _masked_block_stencil_diag(K, mask, (D, R, C)).reshape(-1)
            parts = [E_diag[:, off : off + 24].reshape(-1)]
            parts += [torch.diag(Eg).expand(d.shape).reshape(-1) for d, Eg, f in self.ghost if f == side]
            parts += [torch.zeros(3 * d.numel(), dtype=dt, device=dev) for d, _, _, f in self.flux if f == side]
            diag[side] = self._scatter_u[side].add_(d0, torch.cat(parts))
        diag["yi"] = self._scatter_Y.add_(zeros(9), E_diag[:, _OFF_YI : _OFF_YI + 72])
        diag["yo"] = self._scatter_Y.add_(zeros(9), E_diag[:, _OFF_YO : _OFF_YO + 72])
        diag["p"] = self._scatter_U.add_(zeros(3), E_diag[:, _OFF_P : _OFF_P + 24])

        # Dirichlet conditions on ui over the outer box faces with lifting:
        # identity rows through the active mask, b <- b - A x_bc, and
        # x <- w + x_bc after the solve
        bshell = torch.as_tensor(np.broadcast_to(g.boundary_mask_lattice().reshape(-1), (3, N)).reshape(-1),
                                 device=dev)
        ubc = g.eval_at_vertices(self._u_dbc)  # (D, R, C, 3)
        x_bc = torch.where(bshell, torch.movedim(ubc, -1, 0).reshape(-1), 0.0)
        self.x_bc = {k: (x_bc if k == "ui" else zeros(nc)) for k, nc in FIELDS}
        self.active = {k: diag[k] != 0.0 for k, _ in FIELDS}
        self.active["ui"] = self.active["ui"] & ~bshell
        self.diag = {k: torch.where(self.active[k], diag[k], 1.0) for k, _ in FIELDS}
        Axbc = self.matvec(self.x_bc)
        self.b = {k: b[k] - Axbc[k] for k, _ in FIELDS}
        self._solve_cache = {}
        return self

    def _make_scatters(self) -> None:
        """Ordered scatters: per displacement side, its penalty rows, ghost
        faces and flux rows (in that order); the (ne, 72) flux-tensor and
        the (ne, 24) 3-channel cut-cell families."""
        N = self._N
        self._scatter_u = {}
        for side in ("ui", "uo"):
            fams = [self.idxU.reshape(-1)] + [d.reshape(-1) for d, _, f in self.ghost if f == side]
            fams += [(a * N + d).reshape(-1) for d, _, _, f in self.flux if f == side for a in range(3)]
            self._scatter_u[side] = OrderedScatter(torch.cat(fams))
        self._scatter_Y = OrderedScatter(self.idxY)
        self._scatter_U = OrderedScatter(self.idxU)

    # ------------------------------------------------------------- matvec
    def matvec(self, x: Vec) -> Vec:
        D, R, C = self._DRC
        N = self._N
        loc = torch.cat([x["ui"][self.idxU], x["uo"][self.idxU], x["yi"][self.idxY], x["yo"][self.idxY],
                         x["p"][self.idxU]], dim=1)  # (ne, 216)
        out = loc @ self.E_stat.T + torch.einsum("nij,nj->ni", self.E_phi, loc)
        y = {}
        for side, K, mask, off, yf in (("ui", self.K_in, self.mask_in, _OFF_UI, "yi"),
                                       ("uo", self.K_out, self.mask_out, _OFF_UO, "yo")):
            yb = _masked_block_stencil_apply(x[side].reshape(3, D, R, C), K, mask).reshape(-1)
            parts = [out[:, off : off + 24].reshape(-1)]
            parts += [(x[side][d] @ Eg.T).reshape(-1) for d, Eg, f in self.ghost if f == side]
            parts += [(x[yf][(3 * a + k) * N + d] @ Eb.T).reshape(-1)
                      for d, Eb, k, f in self.flux if f == side for a in range(3)]
            y[side] = self._scatter_u[side].add_(yb, torch.cat(parts))
        for k, off in (("yi", _OFF_YI), ("yo", _OFF_YO)):
            y[k] = self._scatter_Y.add_(torch.zeros_like(x[k]), out[:, off : off + 72])
        y["p"] = self._scatter_U.add_(torch.zeros_like(x["p"]), out[:, _OFF_P : _OFF_P + 24])
        return y

    # ------------------------------------------------------------ helpers
    def rigid_modes(self) -> tuple:
        """Collective rigid-body motions of (ui, uo): 3 translations and 3
        rotations, the near-null directions of the penalized system."""
        g = self.grid
        N = self._N
        x, y, z = (v.expand(self._DRC).reshape(-1) for v in g.vertex_coords_lattice())
        one, zero = torch.ones_like(x), torch.zeros_like(x)
        fields = [(one, zero, zero), (zero, one, zero), (zero, zero, one), (-y, x, zero), (-z, zero, x), (zero, -z, y)]
        out = []
        for fx, fy, fz in fields:
            w = torch.cat([fx, fy, fz])
            out.append({"ui": w, "uo": w, "yi": x.new_zeros(9 * N), "yo": x.new_zeros(9 * N), "p": x.new_zeros(3 * N)})
        return tuple(out)

    def _flat(self, x: Vec) -> torch.Tensor:
        return torch.cat([x[k] for k, _ in FIELDS])

    def _split(self, xf: torch.Tensor) -> Vec:
        out, cur = {}, 0
        for k, nc in FIELDS:
            out[k] = xf[cur : cur + nc * self._N]
            cur += nc * self._N
        return out

    # ------------------------------------------------------ preconditioner
    def _interface_blocks(self):
        """The interface block's entity batches ``(row_dofs, col_dofs,
        mats)`` in global flat ids: penalty, ghost, flux, then each side's
        bulk cells that touch its selected displacement DoFs."""
        D, R, C = self._DRC
        N = self._N
        host = lambda t: t.cpu().numpy()
        idxU, idxY = host(self.idxU), host(self.idxY)
        pen_dofs = np.concatenate([idxU, 3 * N + idxU, 6 * N + idxY, 15 * N + idxY, 24 * N + idxU], axis=1)
        blocks = [(pen_dofs, pen_dofs, host(self.E_stat)[None] + host(self.E_phi))]
        for d, Eg, f in self.ghost:
            dd = host(d) + (0 if f == "ui" else 3 * N)
            blocks.append((dd, dd, host(Eg)))
        for d, Eb, k, f in self.flux:
            d8 = host(d)
            urow, ycol = (0, 6 * N) if f == "ui" else (3 * N, 15 * N)
            for a in range(3):
                blocks.append((urow + a * N + d8, ycol + (3 * a + k) * N + d8, host(Eb)))
        sel = {"ui": np.zeros(3 * N, bool), "uo": np.zeros(3 * N, bool)}
        sel["ui"][idxU.reshape(-1)] = True
        sel["uo"][idxU.reshape(-1)] = True
        for d, _, f in self.ghost:
            sel[f][host(d).reshape(-1)] = True
        for side, tags, K, off in (("ui", (1, 2), self.K_in, 0), ("uo", (2, 3), self.K_out, 3 * N)):
            cd = cell_dofs_of((D, R, C), np.argwhere(self.tags.region_mask(tags)).astype(np.int32))
            cd24 = np.concatenate([c * N + cd for c in range(3)], axis=1)
            t = sel[side][cd24].any(axis=1)
            if t.any():
                blocks.append((off + cd24[t], off + cd24[t], host(K)))
        return blocks

    def _coarse_basis(self, bulk_in: np.ndarray, touch_cut: np.ndarray, harmonic_degree: int, poly_degree: int):
        """The raw rank-k coarse basis (k, 27 N) on the device: the floating
        side's rigid modes (ui zeroed), per-side solid harmonics about the
        cut band's centroid (r/a)^l Y_lm inside and (a/r)^(l+1) Y_lm outside
        (angular factors by ``scipy.special.lpmv`` on the host, radial ones
        and the rows on the device), then Cartesian monomials per side and
        component up to ``poly_degree``; in the JAX package's order."""
        g = self.grid
        N = self._N
        dev, dt = g.device, g.dtype
        off = {"ui": 0, "uo": 3 * N}
        rows = []  # (field, component, values (N,)) of each non-rigid mode
        if harmonic_degree > 0:
            from scipy.special import lpmv

            x3, y3, z3 = (v.expand(self._DRC).reshape(-1).cpu().numpy()
                          for v in g.vertex_coords_lattice(torch.float64))
            pos = np.stack([x3, y3, z3], axis=1)
            cut_v = touch_cut.reshape(-1)
            dp = pos - pos[cut_v].mean(axis=0)
            r3n = np.sqrt((dp * dp).sum(axis=1))
            a3 = max(float(r3n[cut_v].mean()), 1e-12)
            rin_mean = float(r3n[bulk_in.reshape(-1)].mean()) if bulk_in.any() else np.inf
            f_int, f_ext = ("ui", "uo") if rin_mean < a3 else ("uo", "ui")
            ct3 = dp[:, 2] / np.maximum(r3n, 1e-30)
            ph3 = np.arctan2(dp[:, 1], dp[:, 0])
            rho = torch.as_tensor(r3n / a3, dtype=torch.float64, device=dev)
            angs = []  # (l, angular factor) in the JAX package's order
            for l in range(harmonic_degree + 1):
                for m in range(l + 1):
                    P = lpmv(m, l, ct3)
                    angs.append((l, P * np.cos(m * ph3)))
                    if m > 0:
                        angs.append((l, P * np.sin(m * ph3)))
            ang_t = torch.as_tensor(np.stack([a for _, a in angs]), dtype=torch.float64, device=dev)
            for i, (l, _) in enumerate(angs):
                wi = torch.clamp(rho, max=1.5) ** l
                we = torch.clamp(rho, min=0.2) ** (-(l + 1))
                for comp in range(3):
                    rows.append((f_int, comp, wi * ang_t[i]))
                    rows.append((f_ext, comp, we * ang_t[i]))
        if poly_degree > 0:
            xs, ys, zs = (v.expand(self._DRC).reshape(-1).to(torch.float64) for v in g.vertex_coords_lattice())
            polys = [xs**a * ys**b * zs**c for a in range(poly_degree + 1) for b in range(poly_degree + 1 - a)
                     for c in range(poly_degree + 1 - a - b)]
            rows += [(side, comp, p3) for side in ("ui", "uo") for comp in range(3) for p3 in polys]
        rigid = [self._flat({**m, "ui": torch.zeros_like(m["ui"])}).to(torch.float64) for m in self.rigid_modes()]
        Z = torch.zeros((len(rigid) + len(rows), 27 * N), dtype=torch.float64, device=dev)
        Z[: len(rigid)] = torch.stack(rigid)
        for i, (field, comp, vals) in enumerate(rows):
            s0 = off[field] + comp * N
            Z[len(rigid) + i, s0 : s0 + N] = vals
        return Z if dt == torch.float64 else Z.to(dt)

    def lattice_preconditioner(
        self,
        min_n: int = 4,
        dtype: torch.dtype = torch.float32,
        dense_max: int = 4000,
        sweeps: Optional[int] = None,
        use_mg: bool = True,
        use_iface: bool = True,
        use_coarse: bool = True,
        coarse_poly_degree: int = 0,
        coarse_harmonic_degree: Optional[int] = None,
        inner: str = "krylov",
        inner_omega: float = 1.0,
    ):
        """Per-side masked block V-cycles (:class:`~phifem_tpu_torch.ops.
        lattice3.Lattice3BlockMG`) on the non-cut elasticity bulks (ui: the
        Dirichlet box shell; uo: the floating sphere interior), damped Jacobi
        on the other active DoFs, a multiplicative solve on the cut / ghost /
        flux DoF block (:func:`~phifem_tpu_torch.models.lattice_core.
        make_interface_apply` with RAS blocks regrouped per lattice vertex,
        ``max(40, 0.8 sqrt(m))`` inner sweeps by default), then a
        multiplicative rank-k Galerkin step over the floating side's rigid
        modes and per-side solid harmonics of degree
        ``coarse_harmonic_degree`` (default ``clip(n // 4, 2, 10)``).  The
        basis Z and A Z^T are built on the device with the scheme's matvec;
        the (k, k) pseudo-inverse of Z A Z^T (rcond 1e-10) on the host.
        Pass ``deflate=self.rigid_modes()`` to :meth:`solve` with it (the
        collective rigid modes are exactly null)."""
        g = self.grid
        dev = g.device
        D, R, C = self._DRC
        N = self._N
        ct = self.tags.cell_tags
        touch = {t: touched_vertices(ct, t, (D, R, C)) for t in (1, 2, 3)}
        bulk_in, bulk_out = touch[1] & ~touch[2], touch[3] & ~touch[2]
        li, mi, lo, mo = self.lmbda_in, self.mu_in, self.lmbda_out, self.mu_out
        mgs = {}
        if use_mg:
            for side, bulk, (lm, mm) in (("ui", bulk_in, (li, mi)), ("uo", bulk_out, (lo, mo))):
                mgs[side] = build_lattice3_block_mg(
                    g.nx, g.ny, g.nz, g.spacing,
                    lambda hx, hy, hz, lm=lm, mm=mm: _elastic_element_matrix(hx, hy, hz, lm, mm),
                    vsz=3, min_n=min_n, dtype=dtype, mask=bulk, device=dev,
                )
        bulk_t = {"ui": torch.as_tensor(bulk_in.reshape(-1), device=dev),
                  "uo": torch.as_tensor(bulk_out.reshape(-1), device=dev)}
        inv_diag = {k: 1.0 / v for k, v in self.diag.items()}
        active = self.active
        omega = 0.67

        iface = None
        if use_iface:
            selectable = np.concatenate([active[k].cpu().numpy() for k, _ in FIELDS])
            ids, A_csr, _ = build_interface_block(self._interface_blocks(), 27 * N, selectable)
            # RAS blocks per lattice vertex (the 27 DoFs of all fields there):
            # the penalty's strong couplings are same-vertex cross-field ones,
            # and 27^2 block applies are far cheaper than 216^2 per-cell ones
            if sweeps is None:
                sweeps = max(40, int(0.8 * len(ids) ** 0.5))
            iface = make_interface_apply(ids, A_csr, vertex_blocks(ids, N), dense_max=dense_max, sweeps=sweeps,
                                         inner=inner, inner_omega=inner_omega, device=dev)

        Z = Ginv = None
        if use_coarse:
            # the rank-k step: without it a relative rigid motion of the
            # floating side, whose energy sits in the O(h)-thin penalty
            # band, is reduced at 1 - O(h) and outer iterations grow like
            # 1/h; the solid harmonics do the same for interface modes
            # varying like Y_lm (the 3D form of 2D S5's Fourier space)
            if coarse_harmonic_degree is None:
                coarse_harmonic_degree = int(np.clip(g.nx // 4, 2, 10))
            act = self._flat(active)
            Z = torch.where(act[None, :], self._coarse_basis(bulk_in, touch[2], coarse_harmonic_degree,
                                                              coarse_poly_degree), 0.0)
            nrm = torch.clamp(torch.sqrt(torch.sum(Z * Z, dim=1, keepdim=True)), min=1e-300)
            AZ = torch.empty_like(Z)
            for i in range(Z.shape[0]):
                AZ[i] = self._flat(self.matvec(self._split(Z[i])))
            Z, AZ = Z / nrm, AZ / nrm
            self._coarse_G = (Z @ AZ.T).cpu().numpy()
            Ginv = torch.as_tensor(np.linalg.pinv(self._coarse_G, rcond=1e-10), dtype=Z.dtype, device=dev)
            self._coarse_Z = Z
            del AZ

        def bulk_cycle(r_u: torch.Tensor, mg, bulk_flat: torch.Tensor) -> torch.Tensor:
            r3 = torch.where(bulk_flat[None], r_u.reshape(3, -1), 0.0).reshape(3, D, R, C)
            rp = torch.zeros((3, D + 2, R + 2, C + 2), dtype=r3.dtype, device=r3.device)
            rp[:, 1 : 1 + D, 1 : 1 + R, 1 : 1 + C] = r3
            return mg(rp)[:, 1 : 1 + D, 1 : 1 + R, 1 : 1 + C].reshape(3, -1)

        def residual(r: Vec, x: Vec) -> torch.Tensor:
            Ax = self.matvec({k: torch.where(active[k], v, 0.0) for k, v in x.items()})
            return self._flat({k: torch.where(active[k], r[k] - Ax[k], 0.0) for k in r})

        def precond(r: Vec) -> Vec:
            jac = {k: torch.where(active[k], omega * r[k] * inv_diag[k], 0.0) for k in r}
            x = dict(jac)
            for side in mgs:
                z = bulk_cycle(r[side], mgs[side], bulk_t[side])
                z = torch.where(bulk_t[side][None], z, jac[side].reshape(3, -1)).reshape(-1)
                x[side] = torch.where(active[side], z, 0.0)
            if iface is not None:
                xf = self._flat(x)
                ids_t, corr = iface(residual(r, x))
                xf.index_add_(0, ids_t, corr)
                x = self._split(xf)
            if Z is None:
                return x
            rf = residual(r, x)
            alpha = Ginv.to(rf.dtype) @ (Z.to(rf.dtype) @ rf)
            return self._split(self._flat(x) + Z.to(rf.dtype).T @ alpha)

        precond.mgs = mgs
        precond.iface = iface
        return precond

    # -------------------------------------------------------------- solve
    def solve(self, method: str = "bicgstab", tol: float = 1e-10, maxiter: int = 20000, precond=None,
              deflate=None) -> SolveResult:
        """Equilibrated Krylov with identity on inactive DoFs (``deflate``:
        e.g. :meth:`rigid_modes`), then the Dirichlet lifting undone and the
        two sides recombined into ``u_lat`` (3, D, R, C): halved on
        cut-touched vertices, zero on strictly opposite-side vertices."""
        x, rel, it = cached_equilibrated_solve(self, method, tol, maxiter, precond, deflate=deflate)
        x = dict(x)
        x["ui"] = x["ui"] + self.x_bc["ui"]
        self.result = SolveResult(x=x, residual=rel, iterations=it, converged=rel <= 10 * tol, recurrence=rel)
        ct = self.tags.cell_tags
        dev = self.grid.device
        touch = {t: torch.as_tensor(touched_vertices(ct, t, self._DRC).reshape(-1), device=dev) for t in (1, 2, 3)}
        u_in, u_out = x["ui"].reshape(3, -1), x["uo"].reshape(3, -1)
        u_in = torch.where(touch[2][None], u_in / 2.0, u_in)
        u_out = torch.where(touch[2][None], u_out / 2.0, u_out)
        u_in = torch.where((touch[3] & ~touch[2])[None], 0.0, u_in)
        u_out = torch.where((touch[1] & ~touch[2])[None], 0.0, u_out)
        self.u_lat = (u_in + u_out).reshape((3,) + tuple(self._DRC))
        return self.result

    # ------------------------------------------------------------- errors
    def l2_h1_errors(self, exact: Callable, region=(1, 2, 3)) -> Dict[str, float]:
        """Relative L2 / H10 errors of the recombined displacement against
        ``exact((..., 3)) -> (..., 3)``."""
        return lattice_l2_h1_errors_vec(self.grid, self.tags.region_mask(region), self.u_lat, exact)
