"""Tilted-square data of the S4 Robin demo, on torch tensors.

The same arithmetic, in the same order, as ``demo/robin/square/data.py``:
the geometry and exact solution of the S3 demo
(:mod:`phifem_tpu_torch.models.neumann_square`) with Robin data
du/dn + alpha u, alpha = ``robin_coef``.
"""

import torch

from .neumann_square import (  # noqa: F401  (re-exported demo data)
    TILT,
    _side_derivatives,
    detection_levelset,
    exact_solution,
    levelset,
    source_term,
)

robin_coef = 1.0

__all__ = ["TILT", "robin_coef", "levelset", "detection_levelset", "exact_solution", "source_term", "robin_data"]


def robin_data(x):
    """du/dn + alpha u with the demo's piecewise side selection (note the
    leading -dy and -dx branches)."""
    rx, ry, dx, dy = _side_derivatives(x)
    vals = -dy
    vals = torch.where(torch.abs(ry) < rx, dx, vals)
    vals = torch.where(torch.abs(rx) < ry, dy, vals)
    vals = torch.where(torch.abs(ry) < -rx, -dx, vals)
    return vals + robin_coef * exact_solution(x)
