"""3D weak (dual-penalty) Dirichlet phi-FEM Poisson on the hex lattice.

Counterpart of :mod:`phifem_tpu.models.weak_dirichlet3`: the z-axis
extension of S1 on Q_degree tensor-Lagrange hexahedra (degree 1-3):

  a(u,p; v,q) = int_{dx(1,2)} grad u . grad v
              - int_{Gamma_h} (grad u . n) v            (one-sided faces)
              + pen/h^2 int_{dx(2)} (u - phi p / h)(v - phi q / h)
              + stab int_{ghost faces} h [grad u . n][grad v . n]
              (+ stab h^2 int_{dx(2)} (Δu)(Δv) for degree >= 2)

  L(v,q)      = int_{dx(1,2)} f v + pen/h^2 int_{dx(2)} u_D (v - phi q / h)
              (- stab h^2 int_{dx(2)} f Δv for degree >= 2)

Structure (no generic FEM assembly in 3D): the bulk stiffness is a
cell-masked uniform nloc-node stencil, one launch of the hand-written
masked hex-cell stencil kernel (:mod:`phifem_tpu_torch.ops.cuda_hex3`) on
the card; ghost and Gamma_h face matrices are static per axis orientation
(one host matrix each, applied as batched products over face lists); only
the penalty's u-p / p-p blocks and its right-hand side depend on phi,
computed as batched quadrature einsums over the cut cells.  Every
scatter-add of entity contributions sums in a fixed order
(:class:`~phifem_tpu_torch.models.lattice_core.OrderedScatter`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..grid3 import Grid3
from ..mg import TABLE_DTYPE, VCycle, entity_blocks, set_schwarz_tables
from ..ops.cuda_hex3 import hex_offsets, hex_stencil3
from ..ops.lattice3 import build_lattice3_mg, hex_element_matrix
from ..solvers import SolveResult
from ..tagging3 import Tags3, compute_tags3
from .lattice_core import (
    OrderedScatter,
    _coo_block,
    cached_equilibrated_solve,
    cell_dofs_of,
    cell_nodes_of,
    face_quadrature,
    faced_quadrature,
    hex_quadrature,
    hexd_quadrature,
    lattice_l2_h1_errors,
    lattice_l2_h1_errors_d,
    lattice_sparse_solve,
)

Vec = Dict[str, torch.Tensor]

__all__ = ["WeakDirichletPoisson3"]


@dataclasses.dataclass
class WeakDirichletPoisson3:
    """3D phi-FEM weak-Dirichlet Poisson: -Δu = f in {phi < 0}, u = u_D on
    {phi = 0}, immersed in a structured hex box grid."""

    grid: Grid3
    pen_coef: float = 1.0
    stab_coef: float = 1.0
    degree: int = 1  # Q_degree tensor-Lagrange hexes (1, 2 or 3)

    # ------------------------------------------------------------ setup
    def setup(self, levelset: Callable, f: Callable, u_D: Optional[Callable] = None):
        g = self.grid
        self.tags: Tags3 = compute_tags3(g, levelset)
        # the DoF nodes of Q_d are the vertices of the d-refined grid; phi,
        # f and u_D are interpolated at the nodes
        d = self.degree
        ng = g if d == 1 else dataclasses.replace(g, nx=d * g.nx, ny=d * g.ny, nz=d * g.nz)
        self._node_grid = ng
        self.phi_lat = ng.eval_at_vertices(levelset)
        self.f_lat = ng.eval_at_vertices(f)
        if u_D is None:
            self.uD_lat = torch.zeros(ng.lattice_shape, dtype=g.dtype, device=g.device)
        else:
            self.uD_lat = ng.eval_at_vertices(u_D)
        return self

    def _t(self, a, dtype=None) -> torch.Tensor:
        g = self.grid
        return torch.as_tensor(np.asarray(a), dtype=g.dtype if dtype is None else dtype, device=g.device)

    def _cell_dofs(self, cells: np.ndarray) -> np.ndarray:
        """(ne, nloc) flat NODE ids of cells (ne, 3) on the node lattice."""
        if self.degree == 1:
            return cell_dofs_of(self.grid.lattice_shape, cells)
        return cell_nodes_of(self._node_grid.lattice_shape, cells, self.degree)

    # ------------------------------------------------------------ assembly
    def assemble(self):
        g = self.grid
        dt, dev = g.dtype, g.device
        hx, hy, hz = g.spacing
        h = float(np.sqrt(hx * hx + hy * hy + hz * hz))  # CellDiameter
        self.h = h
        vol = hx * hy * hz
        pen, stab = self.pen_coef, self.stab_coef
        d = self.degree
        D, R, C = self._node_grid.lattice_shape
        self._DRC = (D, R, C)
        N = D * R * C
        hs = np.array([hx, hy, hz])

        # bulk stiffness stencil + region mask (cells 1, 2)
        if d == 1:
            Abulk = hex_element_matrix(hx, hy, hz)
        else:
            W1, V1, G1, _ = hexd_quadrature(d + 1, d)
            Gs = G1 / hs[None, None, :]
            Abulk = vol * np.einsum("q,qik,qjk->ij", W1, Gs, Gs)
        self.A8 = self._t(Abulk)  # (nloc, nloc); the name is Q1's
        self.bulk_mask = self._t(self.tags.region_mask((1, 2)).astype(np.float64)).contiguous()

        # ---- cut-cell penalty: data-dependent blocks
        cells = self.tags.cut_cells()
        self.cut_dofs = self._t(self._cell_dofs(cells), torch.int64)
        if d == 1:
            W, V, _ = hex_quadrature(3)
            Lap = None
        else:
            W, V, _G, S = hexd_quadrature(2 * d + 1, d)
            Lap = S[:, :, 0] / hx**2 + S[:, :, 1] / hy**2 + S[:, :, 2] / hz**2
        Vt, Wt = self._t(V), self._t(W)
        phi_n = self.phi_lat.reshape(-1)[self.cut_dofs]  # (ne, nloc)
        phi_q = phi_n @ Vt.T  # (ne, nq)
        # E_uu is uniform: pen/h^2 mass (+ the h^2 (Δu)(Δv) cell
        # stabilization for d >= 2, identically zero for Q1)
        self.E_uu = (pen / h**2) * vol * torch.einsum("q,qi,qj->ij", Wt, Vt, Vt)
        if Lap is not None:
            Lt = self._t(Lap)
            self.E_uu = self.E_uu + stab * h**2 * vol * torch.einsum("q,qi,qj->ij", Wt, Lt, Lt)
        self.E_up = (-pen / h**3) * vol * torch.einsum("nq,q,qi,qj->nij", phi_q, Wt, Vt, Vt)
        self.E_pp = (pen / h**4) * vol * torch.einsum("nq,q,qi,qj->nij", phi_q * phi_q, Wt, Vt, Vt)

        # ---- ghost faces: static (2 nloc, 2 nloc) per lattice axis
        self.ghost = []
        for ax in range(3):
            faces = self.tags.ghost_faces[ax]
            if faces.shape[0] == 0:
                continue
            if d == 1:
                Wf, V0, G0, k = face_quadrature(ax, at_upper=True)
                _, V1f, G1f, _ = face_quadrature(ax, at_upper=False)
            else:
                Wf, V0, G0, k = faced_quadrature(ax, True, d + 1, d)
                _, V1f, G1f, _ = faced_quadrature(ax, False, d + 1, d)
            area = vol / hs[k]
            dn0 = G0[:, :, k] / hs[k]  # d/dx_k from the lower cell
            dn1 = G1f[:, :, k] / hs[k]
            J = np.concatenate([dn0, -dn1], axis=1)  # (nq, 2 nloc) jump basis
            Eg = stab * h * area * np.einsum("q,qi,qj->ij", Wf, J, J)
            upper = faces.copy()
            upper[:, ax] += 1
            dofs = np.concatenate([self._cell_dofs(faces), self._cell_dofs(upper)], axis=1)
            self.ghost.append((self._t(dofs, torch.int64), self._t(Eg)))

        # ---- Gamma_h one-sided boundary flux: static (nloc, nloc) per (axis, sign)
        self.bdry = []
        self.bdry_meta = []  # (inside cells, axis, sign, area) for measures
        for ax in range(3):
            for sign, faces in zip((+1, -1), self.tags.boundary_faces[ax]):
                if faces.shape[0] == 0:
                    continue
                if d == 1:
                    Wf, Vf, Gf, k = face_quadrature(ax, at_upper=(sign > 0))
                else:
                    Wf, Vf, Gf, k = faced_quadrature(ax, sign > 0, d + 1, d)
                area = vol / hs[k]
                dn = sign * Gf[:, :, k] / hs[k]  # outward-normal derivative
                Eb = -area * np.einsum("q,qi,qj->ij", Wf, Vf, dn)
                self.bdry.append((self._t(self._cell_dofs(faces), torch.int64), self._t(Eb)))
                self.bdry_meta.append((faces, ax, sign, area))

        self._make_scatters()

        # ---- RHS: masked bulk mass stencil + penalty terms on cut cells
        if d == 1:
            M8 = hex_element_matrix(hx, hy, hz, stiffness=0.0, mass=1.0)
        else:
            M8 = vol * np.einsum("q,qi,qj->ij", W1, V1, V1)
        b_u = hex_stencil3(self.f_lat.contiguous(), self.bulk_mask, self._t(M8), d).reshape(-1)
        uD_q = self.uD_lat.reshape(-1)[self.cut_dofs] @ Vt.T  # (ne, nq)
        r_u = (pen / h**2) * vol * torch.einsum("nq,q,qi->ni", uD_q, Wt, Vt)
        if Lap is not None:
            # -stab h^2 (f, Δv) dx(2), the cell-stabilization consistency term
            f_q = self.f_lat.reshape(-1)[self.cut_dofs] @ Vt.T
            r_u = r_u - stab * h**2 * vol * torch.einsum("nq,q,qi->ni", f_q, Wt, Lt)
        r_p = (-pen / h**3) * vol * torch.einsum("nq,q,qi->ni", uD_q * phi_q, Wt, Vt)
        b_u = self._scatter_p.add_(b_u, r_u)
        b_p = self._scatter_p.add_(torch.zeros(N, dtype=dt, device=dev), r_p)
        self.b = {"u": b_u, "p": b_p}

        # ---- diagonal / active masks
        diag_u = self._masked_stencil_diag(self.A8, self.bulk_mask).reshape(-1)
        parts = [torch.diag(self.E_uu).expand(self.cut_dofs.shape)]
        parts += [torch.diag(E).expand(dofs.shape) for dofs, E in self.ghost + self.bdry]
        diag_u = self._scatter_u.add_(diag_u, torch.cat([p.reshape(-1) for p in parts]))
        diag_p = self._scatter_p.add_(torch.zeros(N, dtype=dt, device=dev), torch.diagonal(self.E_pp, dim1=1, dim2=2))
        active = {"u": diag_u != 0.0, "p": diag_p != 0.0}
        self.diag = {"u": torch.where(active["u"], diag_u, 1.0), "p": torch.where(active["p"], diag_p, 1.0)}
        self.active = active
        self._solve_cache = {}
        return self

    def _masked_stencil_diag(self, A8: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Diagonal of the masked stencil: the stencil of diag(A8) on ones."""
        ones = torch.ones(self._DRC, dtype=mask.dtype, device=mask.device)
        return hex_stencil3(ones, mask, torch.diag(torch.diagonal(A8)).contiguous(), self.degree)

    # ------------------------------------------------------------- matvec
    def _make_scatters(self) -> None:
        """One ordered scatter for all u contributions of the entity terms
        (cut cells, ghost faces, boundary faces, in that order), one for p."""
        self._scatter_u = OrderedScatter(
            torch.cat([self.cut_dofs.reshape(-1)] + [dofs.reshape(-1) for dofs, _ in self.ghost + self.bdry])
        )
        self._scatter_p = OrderedScatter(self.cut_dofs)

    def matvec(self, x: Vec) -> Vec:
        u, p = x["u"], x["p"]
        y_u = hex_stencil3(u.reshape(self._DRC), self.bulk_mask, self.A8, self.degree).reshape(-1)
        ug, pg = u[self.cut_dofs], p[self.cut_dofs]  # (ne, nloc)
        yu = ug @ self.E_uu.T + torch.einsum("nij,nj->ni", self.E_up, pg)
        yp = torch.einsum("nji,nj->ni", self.E_up, ug) + torch.einsum("nij,nj->ni", self.E_pp, pg)
        parts = [yu.reshape(-1)] + [(u[dofs] @ E.T).reshape(-1) for dofs, E in self.ghost + self.bdry]
        y_u = self._scatter_u.add_(y_u, torch.cat(parts))
        y_p = self._scatter_p.add_(torch.zeros_like(p), yp)
        return {"u": y_u, "p": y_p}

    def _penalty_block(self) -> np.ndarray:
        nloc = self.cut_dofs.shape[1]
        Eup = self.E_up.cpu().numpy()
        blk = np.zeros((Eup.shape[0], 2 * nloc, 2 * nloc))
        blk[:, :nloc, :nloc] = self.E_uu.cpu().numpy()[None]
        blk[:, :nloc, nloc:] = Eup
        blk[:, nloc:, :nloc] = np.swapaxes(Eup, 1, 2)
        blk[:, nloc:, nloc:] = self.E_pp.cpu().numpy()
        return blk

    def _entity_term_blocks(self):
        """The data-dependent terms as ``(dofs, mats)`` entity batches in
        global flat ids (u in [0, N), p in [N, 2N)): penalty, ghost, boundary."""
        N = int(np.prod(self._DRC))
        cut = self.cut_dofs.cpu().numpy()
        out = [(np.concatenate([cut, N + cut], axis=1), self._penalty_block())]
        out += [(dofs.cpu().numpy(), E.cpu().numpy()) for dofs, E in self.ghost + self.bdry]
        return out

    def _all_term_blocks(self):
        """Every operator term as (row_dofs, col_dofs, mats) entity batches
        in global flat ids: the FULL system, for the sparse direct path."""
        blocks = [(dofs, dofs, mats) for dofs, mats in self._entity_term_blocks()]
        cells = np.argwhere(self.tags.region_mask((1, 2))).astype(np.int32)
        cdofs = self._cell_dofs(cells)
        blocks.append((cdofs, cdofs, self.A8.cpu().numpy()))
        return blocks

    # -------------------------------------------------------------- solve
    def solve(self, method: str = "bicgstab", tol: float = 1e-10, maxiter: int = 4000, precond=None) -> SolveResult:
        """Equilibrated Krylov (``"bicgstab"``, ``"cg"``, ``"fgmres"``) with
        identity on inactive DoFs, or ``method="sparse"``: a host SuperLU
        direct solve of the active-restricted system."""
        if method == "sparse":
            N = int(np.prod(self._DRC))
            act = np.concatenate([self.active["u"].cpu().numpy(), self.active["p"].cpu().numpy()])
            bf = np.concatenate([self.b["u"].cpu().numpy(), self.b["p"].cpu().numpy()])
            xf = lattice_sparse_solve(self._all_term_blocks(), bf, act)
            x = {"u": self._t(xf[:N]), "p": self._t(xf[N:])}
            Ax = self.matvec(x)
            r = np.concatenate([Ax["u"].cpu().numpy(), Ax["p"].cpu().numpy()]) - bf
            r[~act] = 0.0
            rel = float(np.linalg.norm(r)) / max(float(np.linalg.norm(bf[act])), 1e-300)
            self.u_lat = x["u"].reshape(self._DRC)
            self.result = SolveResult(x=x, residual=rel, iterations=0, converged=rel <= 1e-8, recurrence=rel)
            return self.result
        x, rel, it = cached_equilibrated_solve(self, method, tol, maxiter, precond)
        self.u_lat = x["u"].reshape(self._DRC)
        self.result = SolveResult(x=x, residual=rel, iterations=it, converged=rel <= 10 * tol, recurrence=rel)
        return self.result

    # ------------------------------------------------------ preconditioner
    def _interface_csr(self):
        """Host sparse interface matrix: the global flat ids (u in [0, N),
        p in [N, 2N)) of the data-dependent DoF block, the CSR A_II
        restricted to it, and the (nb, K) per-entity overlapping RAS blocks
        in compact ids, padded with m (families: penalty, ghost, boundary,
        then the bulk cells that touch the block)."""
        N = int(np.prod(self._DRC))
        terms = self._entity_term_blocks()
        sel = np.zeros(2 * N, bool)
        for dofs, _ in terms:
            sel[dofs.reshape(-1)] = True
        sel[:N] &= self.active["u"].cpu().numpy()
        sel[N:] &= self.active["p"].cpu().numpy()
        # bulk stiffness entries among the selected u DoFs
        cells = np.argwhere(self.tags.region_mask((1, 2))).astype(np.int32)
        cdofs = self._cell_dofs(cells)
        terms.append((cdofs[sel[cdofs].any(axis=1)], self.A8.cpu().numpy()))
        ids = np.where(sel)[0]
        m = ids.shape[0]
        idx_of = -np.ones(2 * N, np.int64)
        idx_of[ids] = np.arange(m)
        A = _coo_block([(dofs, dofs, mats) for dofs, mats in terms], idx_of, m)
        return ids, A, entity_blocks([dofs for dofs, _ in terms], idx_of, m)

    def lattice_preconditioner(
        self,
        min_n: int = 4,
        dtype: torch.dtype = torch.float32,
        interface: bool = True,
        dense_max: int = 4000,
        sweeps: Optional[int] = None,
    ):
        """Masked 3D lattice V-cycle on the u bulk (Omega_h nodes touched by
        no cut cell) + damped Jacobi elsewhere + a multiplicative solve on
        the cut / ghost / boundary DoF block: a dense inverse up to
        ``dense_max`` DoFs, else the port's fixed-sweep band BiCGStab on the
        ELL band matrix with RAS block preconditioning.  For degree >= 2 the
        bulk cycle is low-order-refined: the Q1 lattice MG on the node grid.
        The interface tables are float64."""
        ng = self._node_grid
        d = self.degree
        D, R, C = self._DRC
        N = D * R * C
        dev = self.grid.device
        in1 = self.tags.cell_tags == 1
        cut = self.tags.cell_tags == 2
        touch1 = np.zeros((D, R, C), bool)
        touch_cut = np.zeros((D, R, C), bool)
        nz, ny, nx = in1.shape
        for (ox, oy, oz) in hex_offsets(d):
            touch1[oz : oz + d * nz : d, oy : oy + d * ny : d, ox : ox + d * nx : d] |= in1
            touch_cut[oz : oz + d * nz : d, oy : oy + d * ny : d, ox : ox + d * nx : d] |= cut
        bulk = touch1 & ~touch_cut
        mg = build_lattice3_mg(ng.nx, ng.ny, ng.nz, ng.spacing, min_n=min_n, dtype=dtype, mask=bulk, device=dev)
        bulk_t = torch.as_tensor(bulk, device=dev)
        bulk_flat = bulk_t.reshape(-1)
        inv_diag = {k: 1.0 / v for k, v in self.diag.items()}
        active = self.active
        omega = 0.67

        # the multiplicative band solve: VCycle's interface tables and apply
        band = None
        if interface:
            ids, A_csr, bids = self._interface_csr()
            m = ids.shape[0]
            band = VCycle([], ())
            band._flat_meta = (["u", "p"], [(N,), (N,)], [N, N])
            if m <= dense_max:
                band.interface_ids = torch.as_tensor(ids, dtype=torch.int64, device=dev)
                band.interface_inv = torch.as_tensor(np.linalg.inv(A_csr.toarray()), dtype=TABLE_DTYPE, device=dev)
            else:
                n_sweeps = sweeps if sweeps is not None else max(10, int(0.3 * m**0.5))
                set_schwarz_tables(band, A_csr, ids, bids, n_sweeps, dev)
        self._band = band

        def precond(r: Vec) -> Vec:
            r3 = torch.where(bulk_t, r["u"].reshape(D, R, C), 0.0)
            rp = torch.zeros((D + 2, R + 2, C + 2), dtype=r3.dtype, device=r3.device)
            rp[1 : 1 + D, 1 : 1 + R, 1 : 1 + C] = r3
            z3 = mg(rp)[1 : 1 + D, 1 : 1 + R, 1 : 1 + C]
            jac_u = omega * r["u"] * inv_diag["u"]
            z_u = torch.where(bulk_flat, z3.reshape(-1), torch.where(active["u"], jac_u, 0.0))
            z_p = torch.where(active["p"], omega * r["p"] * inv_diag["p"], 0.0)
            x = {"u": z_u, "p": z_p}
            if band is None:
                return x
            # multiplicative block correction on the residual
            Ax = self.matvec({k: torch.where(active[k], v, 0.0) for k, v in x.items()})
            res = {k: torch.where(active[k], r[k] - Ax[k], 0.0) for k in x}
            return band._band_correct_flat(band._flatten(x), band._flatten(res))

        precond.mg = mg
        return precond

    # ------------------------------------------------------------- errors
    def l2_h1_errors(self, exact: Callable, region=(1, 2)) -> Dict[str, float]:
        """Relative L2 / H10 errors of u_h against a callable, by cellwise
        Gauss quadrature over the region cells."""
        if self.degree == 1:
            return lattice_l2_h1_errors(self.grid, self.tags.region_mask(region), self.u_lat, exact)
        return lattice_l2_h1_errors_d(self.grid, self.tags.region_mask(region), self.u_lat, exact, self.degree)
