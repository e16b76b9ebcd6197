"""Tilted-square data of the S3 Neumann demo, on torch tensors.

The same arithmetic, in the same order, as ``demo/neumann/square/data.py``,
with the ``x: (n, 2)`` convention.  The exact solution is
cos(2 pi r_x) cos(2 pi r_y) in coordinates rotated by pi/6; the level set
vanishes on the rotated unit square, the detection level set is its
non-smooth |.|_1 form.
"""

import numpy as np
import torch

TILT = np.pi / 6.0

__all__ = ["TILT", "levelset", "detection_levelset", "exact_solution", "source_term", "neumann_data"]


def _rot(angle, x):
    c, s = np.cos(angle), np.sin(angle)
    return torch.stack([c * x[..., 0] + s * x[..., 1], -s * x[..., 0] + c * x[..., 1]], dim=-1)


def detection_levelset(x):
    y = _rot(TILT - np.pi / 4.0, x)
    return torch.abs(y[..., 0]) + torch.abs(y[..., 1]) - np.sqrt(2.0) / 2.0


def levelset(x):
    vect = torch.full_like(x, 0.5)
    shift = x - _rot(-TILT, vect)
    r = _rot(TILT, shift)
    return -torch.sin(np.pi * r[..., 0]) * torch.sin(np.pi * r[..., 1])


def exact_solution(x):
    r = _rot(TILT, x)
    return torch.cos(2 * np.pi * r[..., 0]) * torch.cos(2 * np.pi * r[..., 1])


def source_term(x):
    return 8.0 * np.pi**2 * exact_solution(x) + exact_solution(x)


def _side_derivatives(x):
    r = _rot(TILT, x)
    rx, ry = r[..., 0], r[..., 1]
    dx = -2 * np.pi * torch.sin(2 * np.pi * rx) * torch.cos(2 * np.pi * ry)
    dy = -2 * np.pi * torch.cos(2 * np.pi * rx) * torch.sin(2 * np.pi * ry)
    return rx, ry, dx, dy


def neumann_data(x):
    """Piecewise normal derivative of the exact solution on the rotated
    square's four sides."""
    rx, ry, dx, dy = _side_derivatives(x)
    vals = dy
    vals = torch.where(torch.abs(ry) < rx, dx, vals)
    vals = torch.where(torch.abs(rx) < ry, dy, vals)
    vals = torch.where(torch.abs(ry) < -rx, dx, vals)
    return vals
