"""S2 in 3D: strong Dirichlet phi-FEM (u = phi * w) on the hex lattice.

Counterpart of :mod:`phifem_tpu.models.strong_dirichlet3`.  The homogeneous
Dirichlet condition holds by construction since u_h = phi w_h vanishes on
{phi = 0}.  Single Q1 field w:

  a(w; v) = int_{dx(1,2)} grad(phi w) . grad(phi v)
          - int_{Gamma_h} (grad(phi w) . n)(phi v)          (one-sided faces)
          + stab h^2 int_{dx(2)} Δ(phi w) Δ(phi v)
          + stab int_{ghost faces} h [grad(phi w) . n][grad(phi v) . n]

  L(v)    = int_{dx(1,2)} f (phi v) - stab h^2 int_{dx(2)} f Δ(phi v)

phi and its gradient and Laplacian are evaluated analytically at the
quadrature points (``torch.func``); for trilinear w, Δ(phi w) = 2 grad phi .
grad w + w Δphi pointwise.  phi weights every term, so there is no uniform
bulk stencil: all four term families are batched (8, 8) / (16, 16)
per-entity matrices applied as gather -> batched product -> one ordered
scatter (:class:`~phifem_tpu_torch.models.lattice_core.OrderedScatter`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np
import torch

from ..grid3 import Grid3
from ..solvers import SolveResult
from ..tagging3 import Tags3, compute_tags3
from .lattice_core import (
    OrderedScatter,
    cached_equilibrated_solve,
    cell_dofs_of,
    face_quadrature,
    face_quadrature_points,
    hex_quadrature,
    hex_quadrature_points,
    lattice_l2_h1_errors,
)

Vec = Dict[str, torch.Tensor]

__all__ = ["StrongDirichletPoisson3"]


@dataclasses.dataclass
class StrongDirichletPoisson3:
    """3D phi-FEM strong-Dirichlet Poisson: -Δu = f in {phi < 0}, u = 0 on
    {phi = 0}, with the ansatz u = phi w."""

    grid: Grid3
    stab_coef: float = 1.0

    def setup(self, levelset: Callable, f: Callable):
        g = self.grid
        self.tags: Tags3 = compute_tags3(g, levelset)
        self._levelset, self._f = levelset, f
        self.phi_lat = g.eval_at_vertices(levelset)
        return self

    def _phi_eval(self, pts: torch.Tensor):
        """phi, grad phi and Δphi at physical points (..., 3)."""
        from torch.func import grad, hessian, vmap

        ls = self._levelset
        scalar = lambda p: ls(p[None])[0]
        flat = pts.reshape(-1, 3)
        gr = vmap(grad(scalar))(flat).reshape(pts.shape)
        lap = vmap(lambda p: torch.trace(hessian(scalar)(p)))(flat).reshape(pts.shape[:-1])
        return ls(pts), gr, lap

    def _cell_points(self, cells: np.ndarray, Pq: np.ndarray) -> torch.Tensor:
        """(ne, nq, 3) physical quadrature points of cells (iz, iy, ix)."""
        g = self.grid
        hx, hy, hz = g.spacing
        (x0, y0, z0), _ = g.bbox
        orig = np.stack([x0 + hx * cells[:, 2], y0 + hy * cells[:, 1], z0 + hz * cells[:, 0]], axis=-1)
        hs = np.array([hx, hy, hz])
        return self._t(orig[:, None, :] + (Pq * hs[None, :])[None, :, :])

    def _t(self, a, dtype=None) -> torch.Tensor:
        g = self.grid
        return torch.as_tensor(np.asarray(a), dtype=g.dtype if dtype is None else dtype, device=g.device)

    def assemble(self):
        g = self.grid
        hx, hy, hz = g.spacing
        h = float(np.sqrt(hx * hx + hy * hy + hz * hz))
        self.h = h
        vol = hx * hy * hz
        stab = self.stab_coef
        D, R, C = g.lattice_shape
        self._DRC = (D, R, C)
        N = D * R * C
        hs = np.array([hx, hy, hz])
        idx = lambda a: self._t(a, torch.int64)

        W, V, G = hex_quadrature(3)
        Pq = hex_quadrature_points(3)
        Wt, Vt, Gpt = self._t(W), self._t(V), self._t(G / hs[None, None, :])

        # ---- bulk stiffness over every Omega_h cell (phi-weighted)
        cells_h = np.argwhere(self.tags.region_mask((1, 2))).astype(np.int32)
        self.bulk_dofs = idx(cell_dofs_of((D, R, C), cells_h))
        pts = self._cell_points(cells_h, Pq)
        phi, gphi, _ = self._phi_eval(pts)  # (ne, nq), (ne, nq, 3)
        # grad(phi w) coefficients: phi dN_i/dc + N_i dphi/dc
        Gc = phi[:, :, None, None] * Gpt[None] + gphi[:, :, None, :] * Vt[None, :, :, None]
        self.E_bulk = vol * torch.einsum("q,nqic,nqjc->nij", Wt, Gc, Gc)

        # ---- cut-cell Laplacian stabilization
        cut = self.tags.cut_cells()
        self.cut_dofs = idx(cell_dofs_of((D, R, C), cut))
        pts_c = self._cell_points(cut, Pq)
        _, gphi_c, lphi_c = self._phi_eval(pts_c)
        # Δ(phi w) coefficients: 2 grad phi . grad N_i + N_i Δphi
        Lc = 2.0 * torch.einsum("nqc,qic->nqi", gphi_c, Gpt) + lphi_c[:, :, None] * Vt[None]
        self.E_stab = (stab * h * h * vol) * torch.einsum("q,nqi,nqj->nij", Wt, Lc, Lc)

        # ---- ghost faces: batched (16, 16) phi-weighted jump matrices
        self.ghost = []
        for ax in range(3):
            faces = self.tags.ghost_faces[ax]
            if faces.shape[0] == 0:
                continue
            Wf, V0, G0, k = face_quadrature(ax, at_upper=True)
            _, V1, G1, _ = face_quadrature(ax, at_upper=False)
            Pf = face_quadrature_points(ax, at_upper=True)
            area = vol / hs[k]
            J = self._t(np.concatenate([G0[:, :, k] / hs[k], -G1[:, :, k] / hs[k]], axis=1))  # (nqf, 16)
            phi_f = self._levelset(self._cell_points(faces, Pf))  # the face at xi_k = 1
            Eg = (stab * h * area) * torch.einsum("q,nq,qi,qj->nij", self._t(Wf), phi_f * phi_f, J, J)
            upper = faces.copy()
            upper[:, ax] += 1
            dofs = np.concatenate([cell_dofs_of((D, R, C), faces), cell_dofs_of((D, R, C), upper)], axis=1)
            self.ghost.append((idx(dofs), Eg))

        # ---- Gamma_h one-sided boundary flux: -(grad(phi w) . n)(phi v)
        self.bdry = []
        for ax in range(3):
            for sign, faces in zip((+1, -1), self.tags.boundary_faces[ax]):
                if faces.shape[0] == 0:
                    continue
                Wf, Vf, Gf, k = face_quadrature(ax, at_upper=(sign > 0))
                Pf = face_quadrature_points(ax, at_upper=(sign > 0))
                area = vol / hs[k]
                dn = self._t(sign * Gf[:, :, k] / hs[k])  # outward-normal dN_i
                phi_f, gphi_f, _ = self._phi_eval(self._cell_points(faces, Pf))
                dnphi = sign * gphi_f[:, :, k]  # outward n . grad phi
                Vft = self._t(Vf)
                # trial: phi dn_i + N_i (n . grad phi); test: phi N_j
                A = phi_f[:, :, None] * dn[None] + dnphi[:, :, None] * Vft[None]
                B = phi_f[:, :, None] * Vft[None]
                Eb = -area * torch.einsum("q,nqj,nqi->nij", self._t(Wf), A, B)  # rows: test
                self.bdry.append((idx(cell_dofs_of((D, R, C), faces)), Eb))

        self._families = [(self.bulk_dofs, self.E_bulk), (self.cut_dofs, self.E_stab), *self.ghost, *self.bdry]
        self._scatter = OrderedScatter(torch.cat([dofs.reshape(-1) for dofs, _ in self._families]))

        # ---- RHS: f (phi v) over Omega_h - stab h^2 f Δ(phi v) on the cut cells
        r_bulk = vol * torch.einsum("q,nq,nq,qi->ni", Wt, self._f(pts), phi, Vt)
        r_stab = -(stab * h * h * vol) * torch.einsum("q,nq,nqi->ni", Wt, self._f(pts_c), Lc)
        zero = torch.zeros(N, dtype=g.dtype, device=g.device)
        b_w = OrderedScatter(torch.cat([self.bulk_dofs.reshape(-1), self.cut_dofs.reshape(-1)])).add_(
            zero.clone(), torch.cat([r_bulk.reshape(-1), r_stab.reshape(-1)])
        )
        self.b = {"w": b_w}

        # ---- diagonal / active
        diag = self._scatter.add_(
            zero.clone(), torch.cat([torch.diagonal(E, dim1=1, dim2=2).reshape(-1) for _, E in self._families])
        )
        self.active = {"w": diag != 0.0}
        self.diag = {"w": torch.where(self.active["w"], diag, 1.0)}
        self._solve_cache = {}
        return self

    def matvec(self, x: Vec) -> Vec:
        w = x["w"]
        parts = [torch.einsum("nij,nj->ni", E, w[dofs]).reshape(-1) for dofs, E in self._families]
        return {"w": self._scatter.add_(torch.zeros_like(w), torch.cat(parts))}

    def solve(self, method: str = "bicgstab", tol: float = 1e-10, maxiter: int = 8000, precond=None) -> SolveResult:
        x, rel, it = cached_equilibrated_solve(self, method, tol, maxiter, precond)
        self.w_lat = x["w"].reshape(self._DRC)
        # nodal product u_h = phi_h w_h
        self.u_lat = self.phi_lat * self.w_lat
        self.result = SolveResult(x=x, residual=rel, iterations=it, converged=rel <= 10 * tol, recurrence=rel)
        return self.result

    def l2_h1_errors(self, exact: Callable, region=(1,)) -> Dict[str, float]:
        """Errors of u_h = phi w against the exact u, over the INTERIOR
        cells by default (on cut cells phi_h w_h extends past Gamma)."""
        return lattice_l2_h1_errors(self.grid, self.tags.region_mask(region), self.u_lat, exact)
