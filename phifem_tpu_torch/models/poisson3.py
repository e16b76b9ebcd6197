"""3D box Poisson / Helmholtz on the hex lattice: the pure-multigrid path.

Counterpart of :mod:`phifem_tpu.models.poisson3`: ``alpha * (-Δu) + beta *
u = f`` on the box, ``u = u_D`` on its boundary, Q1 hexahedra, solved by the
lattice-resident MG-preconditioned CG of :mod:`phifem_tpu_torch.ops.lattice3`.
The load vector (mass-stencil convolution), the Dirichlet lift and every
matvec, residual and Jacobi sweep of the solve are launches of the 27-point
lattice sweep kernel on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..grid3 import Grid3
from ..ops.cuda_lattice3 import MATVEC, lattice3_sweep
from ..ops.lattice3 import Lattice3MG, _embed3, _terms3, build_lattice3_mg, hex_element_matrix, lattice3_cg
from ..ops.lattice3 import vertex_stencil_weights3
from ..solvers import SolveResult

__all__ = ["BoxPoisson3"]


def _pad(v: torch.Tensor) -> torch.Tensor:
    """(D, R, C) -> padded (D+2, R+2, C+2), the ring zero."""
    D, R, C = v.shape
    out = torch.zeros((D + 2, R + 2, C + 2), dtype=v.dtype, device=v.device)
    out[1 : 1 + D, 1 : 1 + R, 1 : 1 + C] = v
    return out


@dataclasses.dataclass
class BoxPoisson3:
    """``alpha * (-Δu) + beta * u = f`` on the box, u = u_D on ∂box, Q1."""

    grid: Grid3
    alpha: float = 1.0
    beta: float = 0.0

    def setup(self, f: Callable, u_D: Optional[Callable] = None):
        g = self.grid
        self.f_lat = g.eval_at_vertices(f)
        if u_D is None:
            self.uD_lat = torch.zeros(g.lattice_shape, dtype=g.dtype, device=g.device)
        else:
            self.uD_lat = g.eval_at_vertices(u_D)
        return self

    def assemble(self):
        """Load vector b = M f_h, the 27-point mass-stencil convolution on
        the interior rows (the boundary rows are overwritten by the
        Dirichlet lift)."""
        g = self.grid
        hx, hy, hz = g.spacing
        mass_terms = _terms3(vertex_stencil_weights3(hex_element_matrix(hx, hy, hz, stiffness=0.0, mass=1.0)))
        conv = lattice3_sweep(MATVEC, _pad(self.f_lat), mass_terms)
        D, R, C = g.lattice_shape
        b = torch.zeros((D, R, C), dtype=conv.dtype, device=conv.device)
        b[1:-1, 1:-1, 1:-1] = conv[2:D, 2:R, 2:C]
        self.b_lat = b
        return self

    def lattice_solver(self, min_n: int = 8, dtype: torch.dtype = torch.float32, **kw) -> Lattice3MG:
        g = self.grid
        return build_lattice3_mg(
            g.nx, g.ny, g.nz, g.spacing, stiffness=self.alpha, mass=self.beta,
            min_n=min_n, dtype=dtype, device=g.device, **kw,
        )

    def solve_lattice(self, tol: float = 1e-10, maxiter: int = 60, mg: Optional[Lattice3MG] = None) -> SolveResult:
        """CG in the grid's dtype preconditioned by the lattice V-cycle
        (float32 by default), the boundary values lifted into the RHS."""
        if mg is None:
            mg = getattr(self, "_lattice_mg", None) or self.lattice_solver()
            self._lattice_mg = mg
        g = self.grid
        D, R, C = g.lattice_shape
        border = torch.as_tensor(g.boundary_mask_lattice(), device=g.device)
        xD = torch.where(border, self.uD_lat, 0.0)
        lift = lattice3_sweep(MATVEC, _pad(xD), mg._packed[0])
        bp = _embed3(self.b_lat[1:-1, 1:-1, 1:-1] - lift[2:D, 2:R, 2:C], D, R, C)
        xp, rel, it = lattice3_cg(mg, bp, tol=tol, maxiter=maxiter)
        u3 = xp[1 : 1 + D, 1 : 1 + R, 1 : 1 + C] + xD
        self.u_lat = u3
        self.result = SolveResult(
            x={"u": u3.reshape(-1)}, residual=rel, iterations=it, converged=rel <= tol, recurrence=rel
        )
        return self.result
