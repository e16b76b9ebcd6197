"""S3 in 3D: Neumann phi-FEM (mixed flux formulation) on the hex lattice.

Counterpart of :mod:`phifem_tpu.models.neumann3`, the z-axis extension of
the 2D S3:

  -Delta u + u = f in Omega,  du/dn = u_N on Gamma

Fields: u (Q1), y ~ -grad u (Q1 3-vector, stored (3, N)), p (DG0 on the
cut cells):

  a = int_{dx(1,2)} (grad u . grad v + u v)
    + int_{Gamma_h} (y . n) v                               (one-sided faces)
    + pen int_{dx(2)} [ (y + grad u).(z + grad v)
                      + (div y + u)(div z + v)
                      + h^-2 (y.grad phi + h^-1 p phi)(z.grad phi + h^-1 q phi) ]
    + stab int_{ghost faces} h [grad u . n][grad v . n]

  L = int_{dx(1,2)} f v
    + pen int_{dx(2)} [ -h^-2 u_N |grad phi| (z.grad phi + h^-1 q phi)
                      + f (div z + v) ]

Structure, as :mod:`weak_dirichlet3`: the bulk (grad-grad + mass) is a
cell-masked uniform 8-node stencil, one launch of the masked hex-cell
stencil kernel (:func:`~phifem_tpu_torch.ops.cuda_hex3.hex_stencil3`) on the
card; the one-sided Gamma_h flux couples u rows to one y channel through a
static (8, 8) face mass matrix per (axis, side); ghost faces are static
(16, 16) jump matrices; only the cut-cell penalty block depends on phi: its
local (33, 33) matrices over [u(8) | y_x(8) | y_y(8) | y_z(8) | p(1)] are a
shared static part ``E_stat`` and a per-cell part ``E_phi``, both batched
products.  phi, grad phi, f and u_N are evaluated analytically at the
cut-cell quadrature points.  Every scatter of entity contributions sums in
a fixed order (:class:`~phifem_tpu_torch.models.lattice_core.OrderedScatter`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..grid3 import Grid3
from ..ops.cuda_hex3 import hex_stencil3
from ..ops.lattice3 import build_lattice3_mg, hex_element_matrix
from ..solvers import SolveResult
from ..tagging3 import Tags3, compute_tags3
from .lattice_core import (
    OrderedScatter,
    build_interface_block,
    cached_equilibrated_solve,
    cell_dofs_of,
    cut_cell_points,
    face_quadrature,
    hex_quadrature,
    hex_quadrature_points,
    lattice_l2_h1_errors,
    levelset_and_grad,
    make_interface_apply,
    touched_vertices,
)

Vec = Dict[str, torch.Tensor]

__all__ = ["NeumannPoisson3"]

# local dof layout inside a cut cell: u vertices, then each y channel's
# vertices, then the cell's single DG0 p value
_NLOC = 8 + 24 + 1


@dataclasses.dataclass
class NeumannPoisson3:
    """3D phi-FEM Neumann Poisson (mixed flux scheme) on a hex box grid."""

    grid: Grid3
    pen_coef: float = 1.0
    stab_coef: float = 1.0

    # ------------------------------------------------------------ setup
    def setup(self, levelset: Callable, f: Callable, u_N: Callable):
        g = self.grid
        self.tags: Tags3 = compute_tags3(g, levelset)
        # phi, grad phi, u_N and f are evaluated ANALYTICALLY at the cut-cell
        # quadrature points in assemble (a P1 phi_h's piecewise-constant
        # gradient costs an order of L2 convergence in the flux term)
        self._levelset, self._f, self._uN = levelset, f, u_N
        self.f_lat = g.eval_at_vertices(f)
        return self

    def _t(self, a, dtype=None) -> torch.Tensor:
        g = self.grid
        return torch.as_tensor(np.asarray(a), dtype=g.dtype if dtype is None else dtype, device=g.device)

    # ------------------------------------------------------------ assembly
    def assemble(self):
        g = self.grid
        dt, dev = g.dtype, g.device
        hx, hy, hz = g.spacing
        h = float(np.sqrt(hx * hx + hy * hy + hz * hz))  # CellDiameter
        self.h = h
        vol = hx * hy * hz
        pen, stab = self.pen_coef, self.stab_coef
        D, R, C = g.lattice_shape
        self._DRC = (D, R, C)
        N = D * R * C
        hs = np.array([hx, hy, hz])

        # bulk grad-grad + mass stencil, masked to Omega_h cells {1, 2}
        self.A8 = self._t(hex_element_matrix(hx, hy, hz, 1.0, 1.0))
        self.bulk_mask = self._t(self.tags.region_mask((1, 2)).astype(np.float64)).contiguous()

        # ---- cut-cell penalty block over [u | y_x | y_y | y_z | p]
        cells = self.tags.cut_cells()
        cut_np = cell_dofs_of((D, R, C), cells)
        self.cut_dofs = self._t(cut_np, torch.int64)
        self.cut_cells_flat = self._t((cells[:, 0] * g.ny + cells[:, 1]) * g.nx + cells[:, 2], torch.int64)
        W, V, G = hex_quadrature(3)
        nq = W.shape[0]
        Gp = G / hs[None, None, :]
        F1 = np.zeros((3, nq, _NLOC))  # (y + grad u)_c
        F2 = np.zeros((nq, _NLOC))  # div y + u
        F2[:, :8] = V
        for c in range(3):
            F1[c, :, :8] = Gp[:, :, c]
            F1[c, :, 8 + 8 * c : 16 + 8 * c] = V
            F2[:, 8 + 8 * c : 16 + 8 * c] = Gp[:, :, c]
        E_stat = vol * np.einsum("q,cqi,cqj->ij", W, F1, F1) + vol * np.einsum("q,qi,qj->ij", W, F2, F2)
        self.E_stat = pen * self._t(E_stat)

        Vt, Wt = self._t(V), self._t(W)
        pts = cut_cell_points(g, cells, hex_quadrature_points(3))  # (ne, nq, 3)
        phi_q, gphi = levelset_and_grad(self._levelset, pts)
        F3 = self._build_flux_factor(Vt, phi_q, gphi, h, cut_np.shape[0], nq, dt)
        self.E_phi = (pen / h**2) * vol * torch.einsum("nqi,q,nqj->nij", F3, Wt, F3)

        # ---- ghost faces: static (16, 16) jump matrices per lattice axis
        self.ghost = []
        for ax, faces in enumerate(self._ghost_face_lists()):
            if faces.shape[0] == 0:
                continue
            Wf, _, G0, k = face_quadrature(ax, at_upper=True)
            _, _, G1, _ = face_quadrature(ax, at_upper=False)
            area = vol / hs[k]
            J = np.concatenate([G0[:, :, k] / hs[k], -G1[:, :, k] / hs[k]], axis=1)  # (nqf, 16)
            Eg = stab * h * area * np.einsum("q,qi,qj->ij", Wf, J, J)
            upper = faces.copy()
            upper[:, ax] += 1
            dofs = np.concatenate([cell_dofs_of((D, R, C), faces), cell_dofs_of((D, R, C), upper)], axis=1)
            self.ghost.append((self._t(dofs, torch.int64), self._t(Eg)))

        # ---- Gamma_h one-sided flux (y . n) v: a static (8, 8) face mass per
        # (axis, sign) from the y channel normal to the face into the u rows
        self.flux = []  # (dofs (nf, 8), Eb (8, 8), channel k)
        for ax in range(3):
            for sign, faces in zip((+1, -1), self.tags.boundary_faces[ax]):
                if faces.shape[0] == 0:
                    continue
                Wf, Vf, _, k = face_quadrature(ax, at_upper=(sign > 0))
                Eb = sign * (vol / hs[k]) * np.einsum("q,qi,qj->ij", Wf, Vf, Vf)
                self.flux.append((self._t(cell_dofs_of((D, R, C), faces), torch.int64), self._t(Eb), k))
        self._make_scatters()

        # ---- RHS
        M8 = self._t(hex_element_matrix(hx, hy, hz, stiffness=0.0, mass=1.0))
        b_u = hex_stencil3(self.f_lat.contiguous(), self.bulk_mask, M8, 1).reshape(-1)
        ngphi = torch.sqrt(torch.sum(gphi * gphi, dim=-1))  # (ne, nq)
        r_loc = pen * vol * (
            torch.einsum("nq,q,qi->ni", self._f(pts), Wt, self._t(F2))
            - torch.einsum("nq,q,nqi->ni", self._uN(pts) * ngphi, Wt, F3) / h**2
        )
        b_u = self._scatter_cut.add_(b_u, r_loc[:, :8])
        b_y = self._scatter_y.add_(torch.zeros(3 * N, dtype=dt, device=dev), r_loc[:, 8:32]).reshape(3, N)
        b_p = torch.zeros(g.num_cells, dtype=dt, device=dev).index_add_(0, self.cut_cells_flat, r_loc[:, 32])
        self.b = {"u": b_u, "y": b_y, "p": b_p}

        # ---- diagonal / active masks
        E_diag = torch.diag(self.E_stat)[None, :] + torch.diagonal(self.E_phi, dim1=1, dim2=2)
        diag_u = self._masked_stencil_diag(self.A8, self.bulk_mask).reshape(-1)
        parts = [E_diag[:, :8].reshape(-1)] + [torch.diag(Eg).expand(d.shape).reshape(-1) for d, Eg in self.ghost]
        parts += [torch.zeros(d.numel(), dtype=dt, device=dev) for d, _, _ in self.flux]
        diag_u = self._scatter_u.add_(diag_u, torch.cat(parts))
        diag_y = self._scatter_y.add_(torch.zeros(3 * N, dtype=dt, device=dev), E_diag[:, 8:32]).reshape(3, N)
        diag_p = torch.zeros(g.num_cells, dtype=dt, device=dev).index_add_(0, self.cut_cells_flat, E_diag[:, 32])
        active = {"u": diag_u != 0.0, "y": diag_y != 0.0, "p": diag_p != 0.0}
        self.diag = {k: torch.where(active[k], d, 1.0) for k, d in (("u", diag_u), ("y", diag_y), ("p", diag_p))}
        self.active = active
        self._solve_cache = {}
        return self

    def _make_scatters(self) -> None:
        """The ordered scatters of the entity terms: u (cut cells, ghost
        faces, flux faces, in that order), the cut cells alone, and the
        flat (3 N) y channels of the cut cells (channel-major)."""
        N = int(np.prod(self._DRC))
        self._scatter_u = OrderedScatter(
            torch.cat([self.cut_dofs.reshape(-1)] + [d.reshape(-1) for d, _ in self.ghost]
                      + [d.reshape(-1) for d, _, _ in self.flux])
        )
        self._scatter_cut = OrderedScatter(self.cut_dofs)
        self._scatter_y = OrderedScatter(torch.cat([c * N + self.cut_dofs for c in range(3)], dim=1))

    # --------------------------------------------------------- overridables
    def _build_flux_factor(self, Vt, phi_q, gphi, h, ne, nq, dt) -> torch.Tensor:
        """(ne, nq, 33) coefficients of the penalized flux factor
        ``y . grad phi + h^-1 p phi`` (S4 adds the Robin slot)."""
        F3 = torch.zeros((ne, nq, _NLOC), dtype=dt, device=Vt.device)
        for c in range(3):
            F3[:, :, 8 + 8 * c : 16 + 8 * c] = gphi[:, :, c : c + 1] * Vt[None, :, :]
        F3[:, :, 32] = phi_q / h
        return F3

    def _ghost_face_lists(self):
        """Per-axis ghost-face lists: S3 stabilizes every Omega_h face
        touching a cut cell (the 2D dS(3) analogue)."""
        return self.tags.ghost_faces

    def _masked_stencil_diag(self, A8: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Diagonal of the masked stencil: the stencil of diag(A8) on ones."""
        ones = torch.ones(self._DRC, dtype=mask.dtype, device=mask.device)
        return hex_stencil3(ones, mask, torch.diag(torch.diagonal(A8)).contiguous(), 1)

    # ------------------------------------------------------------- matvec
    def matvec(self, x: Vec) -> Vec:
        u, y, p = x["u"], x["y"], x["p"]
        y_u = hex_stencil3(u.reshape(self._DRC), self.bulk_mask, self.A8, 1).reshape(-1)
        loc = torch.cat([u[self.cut_dofs]] + [y[c][self.cut_dofs] for c in range(3)]
                        + [p[self.cut_cells_flat][:, None]], dim=1)  # (ne, 33)
        out = loc @ self.E_stat.T + torch.einsum("nij,nj->ni", self.E_phi, loc)
        parts = [out[:, :8].reshape(-1)] + [(u[d] @ Eg.T).reshape(-1) for d, Eg in self.ghost]
        parts += [(y[k][d] @ Eb.T).reshape(-1) for d, Eb, k in self.flux]
        y_u = self._scatter_u.add_(y_u, torch.cat(parts))
        y_y = self._scatter_y.add_(torch.zeros(y.numel(), dtype=y.dtype, device=y.device), out[:, 8:32])
        y_p = torch.zeros_like(p).index_add_(0, self.cut_cells_flat, out[:, 32])
        return {"u": y_u, "y": y_y.reshape(y.shape), "p": y_p}

    # -------------------------------------------------------------- solve
    def solve(self, method: str = "bicgstab", tol: float = 1e-10, maxiter: int = 8000, precond=None) -> SolveResult:
        """Equilibrated Krylov (``"bicgstab"``, ``"cg"``, ``"fgmres"``) with
        identity on inactive DoFs."""
        x, rel, it = cached_equilibrated_solve(self, method, tol, maxiter, precond)
        self.u_lat = x["u"].reshape(self._DRC)
        self.result = SolveResult(x=x, residual=rel, iterations=it, converged=rel <= 10 * tol, recurrence=rel)
        return self.result

    # ------------------------------------------------------ preconditioner
    def _interface_blocks(self):
        """The flat layout's total size and the interface block's entity
        batches ``(row_dofs, col_dofs, mats)`` in global flat ids (u [0, N),
        y_c [(1+c) N, (2+c) N), p [4 N, 4 N + nc)): penalty, ghost, flux, then
        the bulk cells that touch the selected u DoFs."""
        D, R, C = self._DRC
        N = D * R * C
        host = lambda t: t.cpu().numpy()
        cut, cells_flat = host(self.cut_dofs), host(self.cut_cells_flat)
        pen_dofs = np.concatenate([cut] + [(1 + c) * N + cut for c in range(3)] + [4 * N + cells_flat[:, None]], axis=1)
        blocks = [(pen_dofs, pen_dofs, host(self.E_stat)[None] + host(self.E_phi))]
        blocks += [(host(d), host(d), host(Eg)) for d, Eg in self.ghost]
        blocks += [(host(d), (1 + k) * N + host(d), host(Eb)) for d, Eb, k in self.flux]
        sel_u = np.zeros(N, bool)
        sel_u[cut.reshape(-1)] = True
        for d in [d for d, _ in self.ghost] + [d for d, _, _ in self.flux]:
            sel_u[host(d).reshape(-1)] = True
        cdofs = cell_dofs_of((D, R, C), np.argwhere(self.tags.region_mask((1, 2))).astype(np.int32))
        touch = sel_u[cdofs].any(axis=1)
        blocks.append((cdofs[touch], cdofs[touch], host(self.A8)))
        return 4 * N + self.grid.num_cells, blocks

    def lattice_preconditioner(
        self,
        min_n: int = 4,
        dtype: torch.dtype = torch.float32,
        dense_max: int = 4000,
        sweeps: Optional[int] = None,
    ):
        """Masked 3D lattice V-cycle on the u bulk (Omega_h vertices touched
        by no cut cell; the grad-grad + mass operator), damped Jacobi on the
        other active DoFs, then a multiplicative solve on the cut / ghost /
        flux DoF block (:func:`~phifem_tpu_torch.models.lattice_core.
        make_interface_apply`: a dense inverse up to ``dense_max`` DoFs, else
        the band BiCGStab with ``max(40, 0.8 sqrt(m))`` inner sweeps: the
        mixed 33-DoF block needs more than S1's scalar one)."""
        g = self.grid
        dev = g.device
        D, R, C = self._DRC
        N = D * R * C
        ct = self.tags.cell_tags
        bulk = touched_vertices(ct, 1, (D, R, C)) & ~touched_vertices(ct, 2, (D, R, C))
        mg = build_lattice3_mg(g.nx, g.ny, g.nz, g.spacing, stiffness=1.0, mass=1.0, min_n=min_n, dtype=dtype,
                               mask=bulk, device=dev)
        bulk_t = torch.as_tensor(bulk, device=dev)
        inv_diag = {k: 1.0 / v for k, v in self.diag.items()}
        active = self.active
        omega = 0.67

        total, blocks = self._interface_blocks()
        selectable = np.concatenate([active[k].cpu().numpy().reshape(-1) for k in ("u", "y", "p")])
        ids, A_csr, ras = build_interface_block(blocks, total, selectable)
        if sweeps is None:
            sweeps = max(40, int(0.8 * len(ids) ** 0.5))
        iface = make_interface_apply(ids, A_csr, ras, dense_max=dense_max, sweeps=sweeps, device=dev)

        def precond(r: Vec) -> Vec:
            r3 = torch.where(bulk_t, r["u"].reshape(D, R, C), 0.0)
            rp = torch.zeros((D + 2, R + 2, C + 2), dtype=r3.dtype, device=r3.device)
            rp[1 : 1 + D, 1 : 1 + R, 1 : 1 + C] = r3
            z3 = mg(rp)[1 : 1 + D, 1 : 1 + R, 1 : 1 + C]
            z_u = torch.where(bulk_t.reshape(-1), z3.reshape(-1),
                              torch.where(active["u"], omega * r["u"] * inv_diag["u"], 0.0))
            x = {"u": z_u}
            for k in ("y", "p"):
                x[k] = torch.where(active[k], omega * r[k] * inv_diag[k], 0.0)
            # multiplicative interface-block correction on the residual
            Ax = self.matvec({k: torch.where(active[k], v, 0.0) for k, v in x.items()})
            res = torch.cat([torch.where(active[k], r[k] - Ax[k], 0.0).reshape(-1) for k in ("u", "y", "p")])
            xf = torch.cat([x[k].reshape(-1) for k in ("u", "y", "p")])
            ids_t, corr = iface(res)
            xf.index_add_(0, ids_t, corr)
            return {"u": xf[:N], "y": xf[N : 4 * N].reshape(3, N), "p": xf[4 * N :]}

        precond.mg = mg
        precond.iface = iface
        return precond

    # ------------------------------------------------------------- errors
    def l2_h1_errors(self, exact: Callable, region=(1, 2)) -> Dict[str, float]:
        """Relative L2 / H10 errors of u_h against a callable, by cellwise
        Gauss quadrature over the region cells."""
        return lattice_l2_h1_errors(self.grid, self.tags.region_mask(region), self.u_lat, exact)
