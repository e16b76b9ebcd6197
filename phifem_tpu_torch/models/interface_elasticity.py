"""S5 -- two-material linear elasticity with an immersed interface.

Counterpart of :mod:`phifem_tpu.models.interface_elasticity`:
  div sigma_i(u_i) = f on each side of the interface {phi = 0}, with an
  E_in / E_out contrast; continuity of displacement and traction imposed by
  phi-weighted penalties on cut cells; exact Dirichlet BC on the outer box
  edges.  Five fields: u_in, u_out (vector P1), y_in, y_out (tensor P1
  fluxes, value shape (2, 2)), p (vector P1 auxiliary).

* contrast-weighted flux penalties, coef_in/out = (E_i / (E_in + E_out))^2;
* two one-sided boundary terms, ds(100) and ds(101);
* a Dirichlet BC on the u_in block with lifting;
* the solution recombined on cut cells (average of the in/out halves).

The operator's tap form has five block lattices of 2 / 2 / 4 / 4 / 2
channels, so every matvec on the card runs the tap kernel at 4 channels.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import numpy as np
import torch

from ..assembly import (
    BoundaryTerm,
    CellTerm,
    FacetTerm,
    System,
    assemble_operator,
    assemble_vector,
)
from ..solvers import DirichletBC, SolveResult, solve
from ..spaces import Function, Space, boundary_dof_mask, interpolate
from .base import LevelSetLike, SchemeBase

__all__ = [
    "lame",
    "s5_forms",
    "dof_mask_from_cells",
    "s5_rigid_modes",
    "s5_fourier_modes",
    "s5_fourier_builder",
    "s5_recombine",
    "InterfaceElasticity",
]


def lame(E: float, nu: float):
    """(lambda, mu) from Young's modulus and Poisson's ratio."""
    lmbda = E * nu / (1.0 + nu) / (1.0 - 2.0 * nu)
    mu = E / 2.0 / (1.0 + nu)
    return lmbda, mu


def _eps(G):
    return 0.5 * (G + G.T)


def _sigma(G, lmbda, mu):
    """Stress from a displacement gradient G (2, 2)."""
    return lmbda * torch.trace(G) * torch.eye(2, dtype=G.dtype, device=G.device) + 2.0 * mu * _eps(G)


def _div_tensor(t):
    """div of a tensor FieldEval: (div y)_i = d_j y_ij."""
    return torch.einsum("ijj->i", t.grad)


def dof_mask_from_cells(space, cells: np.ndarray) -> np.ndarray:
    """Host boolean mask of the scalar DoFs touched by ``cells`` (of a
    :class:`Space` or a ``USpace``: both have ``cell_dofs_np``)."""
    mask = np.zeros(space.num_scalar_dofs, bool)
    mask[space.cell_dofs_np[np.asarray(cells, np.int64)].reshape(-1)] = True
    return mask


def s5_forms(pen, stab, E_in, nu_in, E_out, nu_out, primal_degree, flux_degree, levelset_degree,
             phi_h, f, ds_in, ds_out):
    """The S5 term lists ``(cell_terms, facet_terms, boundary_terms,
    rhs_cell_terms)``; ``ds_in`` / ``ds_out`` are the one-sided boundary
    measures 100 / 101."""
    li, mi = lame(E_in, nu_in)
    lo, mo = lame(E_out, nu_out)
    coef_in = (E_in / (E_in + E_out)) ** 2
    coef_out = (E_out / (E_in + E_out)) ** 2
    qdeg = 2 * (flux_degree + levelset_degree) + 2

    def stiff_in(u, v, d, x, ctx):
        return torch.sum(_sigma(u["u_in"].grad, li, mi) * _eps(v["u_in"].grad))

    def stiff_out(u, v, d, x, ctx):
        return torch.sum(_sigma(u["u_out"].grad, lo, mo) * _eps(v["u_out"].grad))

    def penalty(u, v, d, x, ctx):
        h = ctx.h
        gphi = d["phi"].grad
        t1 = coef_out * torch.sum(
            (u["y_in"].val + _sigma(u["u_in"].grad, li, mi))
            * (v["y_in"].val + _sigma(v["u_in"].grad, li, mi))
        )
        t2 = coef_in * torch.sum(
            (u["y_out"].val + _sigma(u["u_out"].grad, lo, mo))
            * (v["y_out"].val + _sigma(v["u_out"].grad, lo, mo))
        )
        ju = (u["y_in"].val - u["y_out"].val) @ gphi
        jv = (v["y_in"].val - v["y_out"].val) @ gphi
        t3 = torch.dot(ju, jv) / h**2
        su = u["u_in"].val - u["u_out"].val + u["p"].val * d["phi"].val / h
        sv = v["u_in"].val - v["u_out"].val + v["p"].val * d["phi"].val / h
        t4 = torch.dot(su, sv) / h**2
        return pen * (t1 + t2 + t3 + t4)

    def cell_stab(u, v, d, x, ctx):
        return stab * ctx.h**2 * (
            torch.dot(_div_tensor(u["y_in"]), _div_tensor(v["y_in"]))
            + torch.dot(_div_tensor(u["y_out"]), _div_tensor(v["y_out"]))
        )

    def ghost_in(u0, u1, v0, v1, d0, d1, x, n, ctx):
        ju = (_sigma(u0["u_in"].grad, li, mi) - _sigma(u1["u_in"].grad, li, mi)) @ n
        jv = (_sigma(v0["u_in"].grad, li, mi) - _sigma(v1["u_in"].grad, li, mi)) @ n
        return stab * ctx.h * torch.dot(ju, jv)

    def ghost_out(u0, u1, v0, v1, d0, d1, x, n, ctx):
        ju = (_sigma(u0["u_out"].grad, lo, mo) - _sigma(u1["u_out"].grad, lo, mo)) @ n
        jv = (_sigma(v0["u_out"].grad, lo, mo) - _sigma(v1["u_out"].grad, lo, mo)) @ n
        return stab * ctx.h * torch.dot(ju, jv)

    def bdry_in(u, v, d, x, n, ctx):
        return torch.dot(u["y_in"].val @ n, v["u_in"].val)

    def bdry_out(u, v, d, x, n, ctx):
        return torch.dot(u["y_out"].val @ n, v["u_out"].val)

    def rhs_in(v, d, x, ctx):
        return torch.dot(d["f"].val, v["u_in"].val)

    def rhs_out(v, d, x, ctx):
        return torch.dot(d["f"].val, v["u_out"].val)

    def rhs_stab(v, d, x, ctx):
        return stab * ctx.h**2 * (
            torch.dot(d["f"].val, _div_tensor(v["y_in"])) + torch.dot(d["f"].val, _div_tensor(v["y_out"]))
        )

    data = {"phi": phi_h}
    fdata = {"f": f}
    cell_terms = [
        (CellTerm(stiff_in, (1, 2), degree=2 * primal_degree, uniform=True), {}),
        (CellTerm(stiff_out, (2, 3), degree=2 * primal_degree, uniform=True), {}),
        (CellTerm(penalty, (2,), degree=qdeg), data),
        (CellTerm(cell_stab, (2,), degree=2 * flux_degree, uniform=True), {}),
    ]
    facet_terms = [
        (FacetTerm(ghost_in, region=(3,), npts=2), {}),
        (FacetTerm(ghost_out, region=(4,), npts=2), {}),
    ]
    boundary_terms = [
        (BoundaryTerm(bdry_in, ds_in, npts=2), {}),
        (BoundaryTerm(bdry_out, ds_out, npts=2), {}),
    ]
    rhs_cell_terms = [
        (CellTerm(rhs_in, (1, 2), degree=qdeg), fdata),
        (CellTerm(rhs_out, (2, 3), degree=qdeg), fdata),
        (CellTerm(rhs_stab, (2,), degree=qdeg), fdata),
    ]
    return cell_terms, facet_terms, boundary_terms, rhs_cell_terms


def _zero_fields(system: System):
    return {n: torch.zeros(sp.dof_shape, dtype=sp.grid.dtype, device=sp.grid.device)
            for n, sp in system.fields.items()}


def s5_rigid_modes(system: System, U) -> tuple:
    """Collective rigid-body motions of (u_in, u_out): the S5 system's exact
    null space (see :meth:`InterfaceElasticity.rigid_modes`).  ``U`` is a
    structured :class:`Space` or an imported mesh's ``USpace``; each
    interpolates by its own backend."""
    from ..uassembly import USpace, interpolate as interpolate_u

    interp = interpolate_u if isinstance(U, USpace) else interpolate
    modes = []
    for fn in (
        lambda x: torch.stack([torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device),
                               torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)], dim=-1),
        lambda x: torch.stack([torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device),
                               torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)], dim=-1),
        lambda x: torch.stack([-x[..., 1], x[..., 0]], dim=-1),
    ):
        w = interp(fn, U).data
        m = _zero_fields(system)
        m["u_in"] = w
        m["u_out"] = w
        modes.append(m)
    return tuple(modes)


def _interface_frame(coords: np.ndarray, cut_mask: np.ndarray):
    """Centroid and mean radius of the cut DoFs."""
    pts = coords[np.asarray(cut_mask)]
    c = pts.mean(axis=0)
    R = max(float(np.hypot(pts[:, 0] - c[0], pts[:, 1] - c[1]).mean()), 1e-12)
    return c, R


def s5_fourier_modes(system: System, coords: np.ndarray, cut_mask: np.ndarray, in_mask: np.ndarray,
                     K: int, fields=("u_in", "u_out")) -> tuple:
    """Interface-harmonic Fourier coarse modes of the S5 transmission
    system, built on the host: ``4 (2K + 1)`` mode dicts, {1, cos k theta,
    sin k theta} x {x, y component} x {``(r/R)^k`` on the field of the
    interface's interior side, ``(R/r)^k`` on the other}, about the cut
    band's centroid and mean radius R (``rho = r/R`` clipped below at 0.2,
    the interior profile above at 1.5).  ``in_mask`` (DoFs of u_in's region)
    decides which side is the interior.  :func:`s5_fourier_builder` builds
    the same span on the device."""
    c, R = _interface_frame(coords, cut_mask)
    d = coords - c
    r = np.hypot(d[:, 0], d[:, 1])
    theta = np.arctan2(d[:, 1], d[:, 0])
    rho = np.clip(r / R, 0.2, None)
    f_in, f_out = fields
    rin = float(r[np.asarray(in_mask)].mean()) if in_mask.any() else 0.0
    f_int, f_ext = (f_in, f_out) if rin < R else (f_out, f_in)
    g = system.fields[f_in].grid
    modes = []
    n = coords.shape[0]
    for k in range(K + 1):
        angs = [np.cos(k * theta)] if k == 0 else [np.cos(k * theta), np.sin(k * theta)]
        for a in angs:
            for comp in (0, 1):
                for fname, w in ((f_int, np.minimum(rho, 1.5) ** k), (f_ext, rho ** (-k))):
                    vals = np.zeros((n, 2))
                    vals[:, comp] = w * a
                    m = _zero_fields(system)
                    m[fname] = g._tensor(vals)
                    modes.append(m)
    return tuple(modes)


def s5_fourier_builder(system: System, grid, cut_pts: np.ndarray, rin: float, K: int):
    """Device-side construction of the S5 Fourier coarse basis: ``(z_builder,
    nmodes)`` for :func:`phifem_tpu_torch.mg.attach_coarse_correction_device`.
    The same closed-form modes as :func:`s5_fourier_modes`, built on the
    grid's device from its vertex lattice; only three scalars (centroid,
    radius, side) come from the host.  Only the two displacement fields are
    filled (the flux and auxiliary fields live on the cut band, which the
    band solve owns)."""
    c = cut_pts.mean(axis=0)
    R = max(float(np.hypot(cut_pts[:, 0] - c[0], cut_pts[:, 1] - c[1]).mean()), 1e-12)
    in_is_interior = rin < R
    names = list(system.fields)
    sizes = [int(np.prod(system.fields[n].dof_shape)) for n in names]
    N = system.fields["u_in"].dof_shape[0]
    nmodes = 4 * (2 * K + 1)

    def z_builder():
        xy = grid.vertex_coords.to(torch.float64)  # (N, 2)
        kw = dict(dtype=xy.dtype, device=xy.device)
        d = xy - torch.as_tensor(c, **kw)
        r = torch.sqrt(d[:, 0] ** 2 + d[:, 1] ** 2)
        theta = torch.arctan2(d[:, 1], d[:, 0])
        rho = torch.clamp(r / R, min=0.2)
        ks = torch.arange(K + 1, **kw)
        ang = torch.cat([torch.cos(ks[:, None] * theta[None, :]), torch.sin(ks[1:, None] * theta[None, :])])
        k_of = torch.cat([ks, ks[1:]])  # (A,), A = 2K + 1
        w_int = torch.clamp(rho, max=1.5)[None, :] ** k_of[:, None]
        w_ext = rho[None, :] ** (-k_of[:, None])
        A = ang.shape[0]
        # mode axis order: (angular a, side in {int, ext}, component)
        blk = torch.stack([ang * w_int, ang * w_ext], dim=1)  # (A, side, N)
        eye = torch.eye(2, **kw)
        vec5 = blk[:, :, None, :, None] * eye[None, None, :, None, :]  # (A, side, comp, N, 2)
        int_field = "u_in" if in_is_interior else "u_out"
        rows = []
        for n, sz in zip(names, sizes):
            full = torch.zeros((A, 2, 2, sz), **kw)
            if n in ("u_in", "u_out"):
                side = 0 if n == int_field else 1
                full[:, side] = vec5[:, side].reshape(A, 2, N * 2)
            rows.append(full.reshape(nmodes, sz))
        return torch.cat(rows, dim=1)

    return z_builder, nmodes


def s5_recombine(U, cell_tags: np.ndarray, u_in: torch.Tensor, u_out: torch.Tensor) -> torch.Tensor:
    """One displacement over the whole box: both halves halved on cut
    cells, each half's strictly-opposite-side DoFs zeroed, then added.
    ``U`` is a structured :class:`Space` or a ``USpace``."""
    ct = np.asarray(cell_tags)
    m_cut = dof_mask_from_cells(U, np.where(ct == 2)[0])
    m_int = dof_mask_from_cells(U, np.where(ct == 1)[0])
    m_ext = dof_mask_from_cells(U, np.where(ct == 3)[0])
    dev = u_in.device
    t = lambda a: torch.as_tensor(a, device=dev)[:, None]
    cut, rm_in, rm_out = t(m_cut), t(m_ext & ~m_cut), t(m_int & ~m_cut)
    u_in = torch.where(cut, u_in / 2.0, u_in)
    u_out = torch.where(cut, u_out / 2.0, u_out)
    u_in = torch.where(rm_in, 0.0, u_in)
    u_out = torch.where(rm_out, 0.0, u_out)
    return u_in + u_out


@dataclasses.dataclass
class InterfaceElasticity(SchemeBase):
    """phi-FEM two-material interface elasticity (S5)."""

    # the 5-field contrast-weighted cut block needs more inner band-solve
    # iterations than S1's scalar one (see mg.attach_interface_solve)
    _iface_sweeps_coef = 0.6

    primal_degree: int = 1
    flux_degree: int = 1
    auxiliary_degree: int = 1
    levelset_degree: int = 1
    E_in: float = 1.0
    nu_in: float = 0.3
    E_out: float = 0.001
    nu_out: float = 0.3
    # interface Fourier frequencies in the preconditioner's coarse space
    # (s5_fourier_modes); None: clip(n/4, 8, 64); 0: the rank-3 rigid space
    coarse_fourier_k: Optional[int] = None

    def setup(self, levelset: LevelSetLike, f: Union[Callable, Function], u_dbc: Union[Callable, Function]):
        g = self.grid
        self.tag(levelset)
        U = Space.lagrange(g, self.primal_degree, (2,))
        T = Space.lagrange(g, self.flux_degree, (2, 2))
        P = Space.lagrange(g, self.auxiliary_degree, (2,))
        Vphi = Space.lagrange(g, self.levelset_degree)
        self.U, self.T, self.P = U, T, P
        self.system = System({"u_in": U, "u_out": U, "y_in": T, "y_out": T, "p": P})
        self.phi_h = levelset if isinstance(levelset, Function) else interpolate(levelset, Vphi)
        self.f = f
        self.lmbda_in, self.mu_in = lame(self.E_in, self.nu_in)
        self.lmbda_out, self.mu_out = lame(self.E_out, self.nu_out)
        # Dirichlet BC on the u_in block over the outer box edges
        self.u_dbc = u_dbc if isinstance(u_dbc, Function) else interpolate(u_dbc, U)
        self.bcs = (DirichletBC("u_in", boundary_dof_mask(U)[:, None], self.u_dbc.data),)
        self._setup_args = (levelset, f, u_dbc)
        return self

    def assemble(self, rhs: bool = True):
        g = self.grid
        cell_terms, facet_terms, boundary_terms, rhs_cell_terms = s5_forms(
            self.pen_coef, self.stab_coef, self.E_in, self.nu_in, self.E_out, self.nu_out,
            self.primal_degree, self.flux_degree, self.levelset_degree, self.phi_h, self.f,
            self.tags.boundaries_measure(100), self.tags.boundaries_measure(101),
        )
        self.op = assemble_operator(
            self.system, g, cell_terms=cell_terms, facet_terms=facet_terms,
            boundary_terms=boundary_terms, cell_tags=self.cell_tags, facet_tags=self.facet_tags,
        )
        if rhs:
            self.b = assemble_vector(self.system, g, cell_terms=rhs_cell_terms, cell_tags=self.cell_tags)
        return self

    def rigid_modes(self) -> tuple:
        """The system's exact null space: collective rigid-body motions of
        (u_in, u_out).  Neither displacement block carries a grounding BC
        (the Dirichlet rows of u_in lie outside every active term's
        support), and an equal rigid motion of both blocks has no strain, no
        penalty jump and no flux."""
        return s5_rigid_modes(self.system, self.U)

    def lattice_preconditioner(self, min_n: int = 16, dtype: torch.dtype = torch.float32,
                               interface: bool = True, refresh: bool = False, coupled: bool = True,
                               **interface_kw):
        """S5's default is the multilevel coupled hierarchy
        (:meth:`~SchemeBase.coupled_preconditioner`): the flat bulk / band
        splitting is h-dependent for interface transmission.  ``coupled=
        False`` gives the flat single-level preconditioner."""
        if coupled and interface:
            return self.coupled_preconditioner(min_n=min_n, dtype=dtype, refresh=refresh, **interface_kw)
        return super().lattice_preconditioner(
            min_n=min_n, dtype=dtype, interface=interface, refresh=refresh, **interface_kw
        )

    def _bulk_neumann_fields(self) -> tuple:
        """Both displacement bulks end at the interface with a natural
        (traction-transfer) condition: their bulk MG takes the
        free-boundary variable stencil."""
        return ("u_in", "u_out")

    def _resolved_fourier_k(self) -> int:
        K = self.coarse_fourier_k
        if K is None:
            K = int(np.clip(max(self.grid.nx, self.grid.ny) // 4, 8, 64))
        return K

    def _tag_masks(self):
        ct = np.asarray(self.cell_tags)
        return (dof_mask_from_cells(self.U, np.where(ct == 2)[0]),
                dof_mask_from_cells(self.U, np.where(ct == 1)[0]))

    def _coarse_matrix_builder(self):
        """Device-side builder of the Fourier coarse basis
        (:func:`s5_fourier_builder`), or None (K = 0, or no cut cell)."""
        K = self._resolved_fourier_k()
        if K <= 0:
            return None
        cut, inner = self._tag_masks()
        coords = self.U.dof_coords_np
        cut_pts = coords[cut]
        if cut_pts.shape[0] == 0:
            return None
        in_pts = coords[inner]
        c = cut_pts.mean(axis=0)
        rin = float(np.hypot(in_pts[:, 0] - c[0], in_pts[:, 1] - c[1]).mean()) if len(in_pts) else 0.0
        return s5_fourier_builder(self.system, self.grid, cut_pts, rin, K)

    def _coarse_modes(self) -> tuple:
        """Host coarse space: the Fourier modes for K > 0
        (:func:`s5_fourier_modes`), else the rigid motions of u_in alone
        (the collective ones are deflated by the outer solve)."""
        K = self._resolved_fourier_k()
        if K > 0:
            cut, inner = self._tag_masks()
            return s5_fourier_modes(self.system, self.U.dof_coords_np, cut, inner, K)
        modes = []
        for m in self.rigid_modes():
            mm = dict(m)
            mm["u_out"] = torch.zeros_like(m["u_out"])
            modes.append(mm)
        return tuple(modes)

    def solve(self, method: str = "bicgstab", tol: float = 1e-10, **kw) -> SolveResult:
        # the collective rigid modes are deflated for the ITERATIVE methods
        # only: they are near-null directions that stall Krylov, but a direct
        # LU handles them, and the bordered constraint would distort its
        # solution
        if method not in ("dense", "sparse") and "deflate" not in kw:
            kw["deflate"] = self.rigid_modes()
        res = solve(self.op, self.b, bcs=self.bcs, method=method, tol=tol, **kw)
        self.result = res
        self.u_in_h = Function(self.U, res.x["u_in"])
        self.u_out_h = Function(self.U, res.x["u_out"])
        self.u_h = Function(self.U, s5_recombine(self.U, self.cell_tags, res.x["u_in"], res.x["u_out"]))
        return res
