"""phi-FEM schemes on imported meshes (triangles, quadrilaterals, tetrahedra).

Counterpart of :mod:`phifem_tpu.models.unstructured`: S1 weak Dirichlet,
S2 strong Dirichlet, S3 Neumann and S4 Robin in 2D and 3D, and S5
two-material interface elasticity in 2D (:class:`InterfaceElasticityU`).
The forms are the structured schemes' own (``s1_forms`` ... ``s5_forms``),
assembled through :mod:`phifem_tpu_torch.uassembly` and solved by the same
equilibrated Krylov stack; on a ``UMesh.from_grid`` copy of a structured
grid the two discretize identically.  Preconditioners: the default
Jacobi-equilibrated solve, :meth:`USchemeBase.amg_preconditioner`
(smoothed-aggregation AMG on the bulk + the cut-band solve, degree 1) and
:meth:`USchemeBase.p_multigrid_preconditioner` (degree >= 2).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import numpy as np
import torch
from torch.func import grad

from ..assembly import CellTerm, System
from ..solvers import DirichletBC, SolveResult, solve
from ..tagging import compute_tags_measures
from ..uassembly import (
    UFunction,
    USpace,
    assemble_operator,
    assemble_scalar,
    assemble_vector,
    boundary_dof_mask,
    interpolate,
)
from ..umesh import UMesh, _u_build_submesh
from .weak_dirichlet import s1_forms

LevelSetLike = Union[Callable, UFunction]

__all__ = [
    "USchemeBase",
    "WeakDirichletPoissonU",
    "StrongDirichletPoissonU",
    "NeumannPoissonU",
    "RobinPoissonU",
    "InterfaceElasticityU",
]


def _grad_of(f: Callable) -> Callable:
    """Batched gradient of a pointwise scalar callable ``f((n, d)) -> (n,)``
    (rows decouple, so ``grad(sum(f))`` is the per-row gradient)."""
    return grad(lambda pts: torch.sum(f(pts)))


@dataclasses.dataclass
class USchemeBase:
    """Tagging, measures, solve and errors shared by the imported-mesh
    schemes: the :class:`~phifem_tpu_torch.models.base.SchemeBase` of a
    ``UMesh`` or ``UMesh3``."""

    mesh: UMesh
    mode: str = "bg"
    detection_degree: int = 1
    single_layer_cut: bool = False
    pen_coef: float = 1.0
    stab_coef: float = 1.0

    @property
    def grid(self) -> UMesh:
        """The mesh, under the name the port's shared layers read."""
        return self.mesh

    def tag(self, detection_levelset: LevelSetLike):
        res = compute_tags_measures(
            self.mesh,
            detection_levelset,
            self.detection_degree,
            box_mode=True,
            single_layer_cut=self.single_layer_cut,
        )
        self.tags = res
        self.cell_tags = res.cells_tags.as_numpy()
        self.facet_tags = res.facets_tags.as_numpy()
        self.submesh = _u_build_submesh(self.mesh, self.cell_tags, self.facet_tags) if self.mode == "sub" else None
        return res

    def boundary_measure(self):
        if self.mode == "bg":
            return self.tags.boundaries_measure(100)
        return self.submesh.exterior

    def _assemble_forms(self, forms, rhs: bool):
        cell_terms, facet_terms, boundary_terms, rhs_cell_terms = forms
        self.op = assemble_operator(
            self.system,
            self.mesh,
            cell_terms=cell_terms,
            facet_terms=facet_terms,
            boundary_terms=boundary_terms,
            cell_tags=self.cell_tags,
            facet_tags=self.facet_tags,
        )
        if rhs:
            self.b = assemble_vector(self.system, self.mesh, cell_terms=rhs_cell_terms, cell_tags=self.cell_tags)
        return self

    def solve(self, method: str = "bicgstab", tol: float = 1e-10, **kw) -> SolveResult:
        res = solve(self.op, self.b, method=method, tol=tol, **kw)
        self.result = res
        return res

    def _cached(self, key, build):
        cache = getattr(self, "_mg_cache", None)
        if cache is None:
            cache = self._mg_cache = {}
        if key not in cache:
            cache[key] = build()
        return cache[key]

    def amg_preconditioner(self, refresh: bool = False, theta: float = 0.08, **kw):
        """Smoothed-aggregation AMG on each scalar field's bulk block + the
        multiplicative cut-band solve (:mod:`phifem_tpu_torch.amg`), the
        degree-1 imported-mesh counterpart of ``lattice_preconditioner``.
        Memoized on the operator's data version."""
        from ..amg import amg_preconditioner

        key = ("amg", float(theta), repr(sorted(kw.items())), self.op.data_version)
        if refresh:
            getattr(self, "_mg_cache", {}).pop(key, None)
        return self._cached(key, lambda: amg_preconditioner(self.op, getattr(self, "bcs", ()), theta=theta, **kw))

    def _p1_twin(self):
        """Degree-1 twin on the same mesh (the p-multigrid coarse
        problem); the level-set and detection degrees are untouched."""
        degree_fields = {"primal_degree", "flux_degree", "auxiliary_degree"}
        repl = {fld.name: 1 for fld in dataclasses.fields(self) if fld.name in degree_fields}
        return dataclasses.replace(self, **repl)

    def p_multigrid_preconditioner(self, low_iters: int = 30, refresh: bool = False, **interface_kw):
        """p-multigrid for degree >= 2 (:mod:`phifem_tpu_torch.pmg`): its
        degree-1 correction is an inner BiCGStab preconditioned by the
        equilibration alone (an imported mesh has no lattice).
        Nonstationary: pair it with ``method="fgmres"``."""
        from ..pmg import build_p_preconditioner

        key = ("pmg", low_iters, repr(sorted(interface_kw.items())), self.op.data_version)
        if refresh:
            getattr(self, "_mg_cache", {}).pop(key, None)
        return self._cached(key, lambda: build_p_preconditioner(self, low_iters=low_iters, **interface_kw))

    def l2_h1_errors(
        self,
        uh: UFunction,
        exact: Callable,
        exact_grad: Optional[Callable] = None,
        region=(1, 2),
        ref_degree: Optional[int] = None,
    ):
        """Relative L2 / H10 / H1 errors against an analytic solution, by
        high-order quadrature of ``u_h - u`` over the region's cells
        (``exact_grad`` defaults to autodiff of ``exact``)."""
        deg = 2 * (ref_degree or uh.space.degree + 2)
        guex = exact_grad or _grad_of(exact)

        def _scalar(integrand):
            return float(
                assemble_scalar(
                    self.mesh,
                    cell_terms=[(CellTerm(integrand, tuple(region), degree=deg), {"u": uh, "uex": exact, "guex": guex})],
                    cell_tags=self.cell_tags,
                )
            )

        l2_num = _scalar(lambda d, x, ctx: torch.sum((d["u"].val - d["uex"].val) ** 2))
        l2_den = _scalar(lambda d, x, ctx: torch.sum(d["uex"].val ** 2))
        h1_num = _scalar(lambda d, x, ctx: torch.sum((d["u"].grad - d["guex"].val) ** 2))
        h1_den = _scalar(lambda d, x, ctx: torch.sum(d["guex"].val ** 2))
        return {
            "l2": float(np.sqrt(l2_num / l2_den)),
            "h10": float(np.sqrt(h1_num / h1_den)),
            "h1": float(np.sqrt((l2_num + h1_num) / (l2_den + h1_den))),
        }


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)


@dataclasses.dataclass
class WeakDirichletPoissonU(USchemeBase):
    """S1 weak-Dirichlet phi-FEM Poisson on an imported mesh."""

    primal_degree: int = 1
    levelset_degree: int = 1

    def setup(
        self,
        levelset: LevelSetLike,
        f: Union[Callable, UFunction],
        u_D: Union[Callable, UFunction, None] = None,
        detection_levelset: Optional[LevelSetLike] = None,
    ):
        self.tag(detection_levelset if detection_levelset is not None else levelset)
        V = USpace.lagrange(self.mesh, self.primal_degree)
        Vphi = USpace.lagrange(self.mesh, self.levelset_degree)
        self.V, self.Vphi = V, Vphi
        self.system = System({"u": V, "p": V})
        self.phi_h = levelset if isinstance(levelset, UFunction) else interpolate(levelset, Vphi)
        self.f_h = f if isinstance(f, UFunction) else interpolate(f, V)
        if u_D is None:
            u_D = _zero
        self.u_D = u_D if isinstance(u_D, UFunction) else interpolate(u_D, V)
        self._setup_args = (levelset, f, u_D, detection_levelset)
        return self

    def assemble(self, rhs: bool = True):
        return self._assemble_forms(
            s1_forms(self.pen_coef, self.stab_coef, self.primal_degree, self.levelset_degree, self.phi_h,
                     self.f_h, self.u_D, self.boundary_measure()),
            rhs,
        )

    def solve(self, method: str = "bicgstab", tol: float = 1e-10, **kw) -> SolveResult:
        res = super().solve(method=method, tol=tol, **kw)
        self.u_h = UFunction(self.V, res.x["u"])
        self.p_h = UFunction(self.V, res.x["p"])
        return res


@dataclasses.dataclass
class StrongDirichletPoissonU(USchemeBase):
    """S2 strong-Dirichlet phi-FEM Poisson (u = phi w) on an imported mesh."""

    primal_degree: int = 1
    levelset_degree: int = 1

    def setup(
        self,
        levelset: Callable,
        f: Union[Callable, UFunction],
        detection_levelset: Optional[Callable] = None,
    ):
        self.tag(detection_levelset if detection_levelset is not None else levelset)
        V = USpace.lagrange(self.mesh, self.primal_degree)
        Vphi = USpace.lagrange(self.mesh, self.levelset_degree)
        self.V, self.Vphi = V, Vphi
        self.system = System({"w": V})
        self.phi_h = levelset if isinstance(levelset, UFunction) else interpolate(levelset, Vphi)
        self.f_h = f if isinstance(f, UFunction) else interpolate(f, V)
        self._levelset = levelset
        self._setup_args = (levelset, f, detection_levelset)
        return self

    def assemble(self, rhs: bool = True):
        from .strong_dirichlet import s2_forms

        return self._assemble_forms(
            s2_forms(self.stab_coef, self.primal_degree, self.levelset_degree, self.phi_h, self.f_h,
                     self.boundary_measure()),
            rhs,
        )

    def solve(self, method: str = "bicgstab", tol: float = 1e-10, **kw) -> SolveResult:
        res = super().solve(method=method, tol=tol, **kw)
        self.w_h = UFunction(self.V, res.x["w"])
        # the nodal product u = w phi in the primal space, phi
        # re-interpolated into V when the level-set space differs
        phi_V = self.phi_h if self.phi_h.space.degree == self.V.degree else interpolate(self._levelset, self.V)
        self.u_h = UFunction(self.V, self.w_h.data * phi_V.data)
        return res


@dataclasses.dataclass
class NeumannPoissonU(USchemeBase):
    """S3 Neumann mixed-flux phi-FEM on an imported mesh."""

    primal_degree: int = 1
    vector_degree: int = 1
    levelset_degree: int = 2

    def setup(
        self,
        levelset: Callable,
        f: Union[Callable, UFunction],
        u_N: Union[Callable, UFunction],
        detection_levelset: Optional[Callable] = None,
    ):
        self.tag(detection_levelset if detection_levelset is not None else levelset)
        V = USpace.lagrange(self.mesh, self.primal_degree)
        Y = USpace.lagrange(self.mesh, self.vector_degree, (self.mesh.dim,))
        Q = USpace.dg0(self.mesh)
        Vphi = USpace.lagrange(self.mesh, self.levelset_degree)
        self.V, self.Y, self.Q, self.Vphi = V, Y, Q, Vphi
        self.system = System({"u": V, "y": Y, "p": Q})
        self.phi_h = levelset if isinstance(levelset, UFunction) else interpolate(levelset, Vphi)
        self.f_h = f if isinstance(f, UFunction) else interpolate(f, V)
        self.u_N = u_N if isinstance(u_N, UFunction) else interpolate(u_N, V)
        self._setup_args = (levelset, f, u_N, detection_levelset)
        return self

    def _forms(self):
        from .neumann import s3_forms

        return s3_forms(self.pen_coef, self.stab_coef, self.primal_degree, self.vector_degree,
                        self.levelset_degree, self.phi_h, self.f_h, self.u_N, self.boundary_measure())

    def assemble(self, rhs: bool = True):
        return self._assemble_forms(self._forms(), rhs)

    def solve(self, method: str = "bicgstab", tol: float = 1e-10, **kw) -> SolveResult:
        res = super().solve(method=method, tol=tol, **kw)
        self.u_h = UFunction(self.V, res.x["u"])
        self.y_h = UFunction(self.Y, res.x["y"])
        return res


@dataclasses.dataclass
class RobinPoissonU(NeumannPoissonU):
    """S4 Robin mixed-flux phi-FEM on an imported mesh."""

    robin_coef: float = 1.0

    def _forms(self):
        from .robin import s4_forms

        return s4_forms(self.pen_coef, self.stab_coef, self.robin_coef, self.primal_degree, self.vector_degree,
                        self.levelset_degree, self.phi_h, self.f_h, self.u_N, self.boundary_measure())


@dataclasses.dataclass
class InterfaceElasticityU(USchemeBase):
    """S5 two-material interface elasticity on an imported 2D mesh: the
    structured :class:`~phifem_tpu_torch.models.interface_elasticity.
    InterfaceElasticity`'s five fields, forms (``s5_forms``: contrast-weighted
    penalties, the one-sided ds(100) / ds(101) terms), Dirichlet lifting of
    u_in on the outer boundary, rigid-mode deflation and cut-cell
    recombination, in bg mode.  ``amg_preconditioner()`` gives Jacobi plus
    the band solve here: every field is a vector, and AMG takes scalar
    blocks only."""

    primal_degree: int = 1
    flux_degree: int = 1
    auxiliary_degree: int = 1
    levelset_degree: int = 1
    E_in: float = 1.0
    nu_in: float = 0.3
    E_out: float = 0.001
    nu_out: float = 0.3

    def setup(self, levelset: LevelSetLike, f: Union[Callable, UFunction], u_dbc: Union[Callable, UFunction]):
        if self.mode != "bg":
            raise ValueError("S5 runs on the background mesh (bg mode)")
        if self.mesh.dim != 2:
            raise NotImplementedError(
                "S5-U is 2D (plane strain); the structured InterfaceElasticity3 covers 3D interface elasticity"
            )
        self.tag(levelset)
        m = self.mesh
        U = USpace.lagrange(m, self.primal_degree, (2,))
        T = USpace.lagrange(m, self.flux_degree, (2, 2))
        P = USpace.lagrange(m, self.auxiliary_degree, (2,))
        Vphi = USpace.lagrange(m, self.levelset_degree)
        self.U, self.T, self.P = U, T, P
        self.system = System({"u_in": U, "u_out": U, "y_in": T, "y_out": T, "p": P})
        self.phi_h = levelset if isinstance(levelset, UFunction) else interpolate(levelset, Vphi)
        self.f = f
        self.u_dbc = u_dbc if isinstance(u_dbc, UFunction) else interpolate(u_dbc, U)
        self.bcs = (DirichletBC("u_in", boundary_dof_mask(U)[:, None], self.u_dbc.data),)
        self._setup_args = (levelset, f, u_dbc)
        return self

    def assemble(self, rhs: bool = True):
        from .interface_elasticity import s5_forms

        return self._assemble_forms(
            s5_forms(self.pen_coef, self.stab_coef, self.E_in, self.nu_in, self.E_out, self.nu_out,
                     self.primal_degree, self.flux_degree, self.levelset_degree, self.phi_h, self.f,
                     self.tags.boundaries_measure(100), self.tags.boundaries_measure(101)),
            rhs,
        )

    def rigid_modes(self) -> tuple:
        from .interface_elasticity import s5_rigid_modes

        return s5_rigid_modes(self.system, self.U)

    def solve(self, method: str = "bicgstab", tol: float = 1e-10, **kw) -> SolveResult:
        """Solve with the Dirichlet rows; iterative methods deflate the
        collective rigid modes unless ``deflate`` is given, ``"dense"``
        takes the system as it is."""
        from .interface_elasticity import s5_recombine

        if method != "dense" and "deflate" not in kw:
            kw["deflate"] = self.rigid_modes()
        res = solve(self.op, self.b, bcs=self.bcs, method=method, tol=tol, **kw)
        self.result = res
        self.u_in_h = UFunction(self.U, res.x["u_in"])
        self.u_out_h = UFunction(self.U, res.x["u_out"])
        self.u_h = UFunction(self.U, s5_recombine(self.U, self.cell_tags, res.x["u_in"], res.x["u_out"]))
        return res
