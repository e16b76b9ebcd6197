"""S4 in 3D: Robin phi-FEM (mixed flux formulation) on the hex lattice.

Counterpart of :mod:`phifem_tpu.models.robin3`:

  -Delta u + u = f in Omega,  du/dn + alpha u = u_R on Gamma

The machinery of :class:`~phifem_tpu_torch.models.neumann3.NeumannPoisson3`
with the two deltas of the 2D S3 -> S4 step:

* the penalized flux factor takes the Robin term:
  ``y . grad phi  -  |grad phi| alpha u  +  h^-1 p phi``;
* ghost stabilization acts on the cut-cut faces only (the 2D dS(2) region)
  instead of every Omega_h face touching a cut cell.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .neumann3 import _NLOC, NeumannPoisson3

__all__ = ["RobinPoisson3"]


@dataclasses.dataclass
class RobinPoisson3(NeumannPoisson3):
    """3D phi-FEM Robin Poisson (mixed flux scheme) on a hex box grid."""

    robin_coef: float = 1.0

    def _build_flux_factor(self, Vt, phi_q, gphi, h, ne, nq, dt) -> torch.Tensor:
        ngphi = torch.sqrt(torch.sum(gphi * gphi, dim=-1))  # (ne, nq)
        F3 = torch.zeros((ne, nq, _NLOC), dtype=dt, device=Vt.device)
        F3[:, :, :8] = -self.robin_coef * ngphi[:, :, None] * Vt[None, :, :]
        for c in range(3):
            F3[:, :, 8 + 8 * c : 16 + 8 * c] = gphi[:, :, c : c + 1] * Vt[None, :, :]
        F3[:, :, 32] = phi_q / h
        return F3

    def _ghost_face_lists(self):
        """Cut-cut faces only (the 2D S4 stabilizes dS(2))."""
        cut = self.tags.cell_tags == 2
        out = []
        for ax in range(3):
            lo = [slice(None)] * 3
            hi = [slice(None)] * 3
            lo[ax] = slice(None, -1)
            hi[ax] = slice(1, None)
            out.append(np.argwhere(cut[tuple(lo)] & cut[tuple(hi)]).astype(np.int32))
        return tuple(out)
