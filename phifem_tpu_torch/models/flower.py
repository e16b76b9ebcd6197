"""Flower level-set data of the S1 weak-Dirichlet demo, on torch tensors.

The same arithmetic, in the same order, as
``demo/weak-dirichlet/flower/data.py``, with the ``x: (n, 2)`` convention.
The smooth level set (graded smooth-min of a disk and 8 petal disks) feeds
the formulation; the non-smooth min-composition is for tagging only.
"""

import numpy as np
import torch

_C = 2.0 * (np.cos(np.pi / 8.0) + np.sin(np.pi / 8.0))
_R = np.sqrt(2.0) * 2.0 * (np.sin(np.pi / 8.0) + np.cos(np.pi / 8.0)) * np.sin(np.pi / 8.0)

__all__ = ["levelset", "detection_levelset", "source_term", "dirichlet_data"]


def _petal_centers():
    i = np.arange(1, 9)
    return _C * np.cos(i * np.pi / 4.0), _C * np.sin(i * np.pi / 4.0)


def _atan_r(x, radius=1.0, slope=1.0):
    r = torch.sqrt(x[..., 0] ** 2 + x[..., 1] ** 2)
    return torch.arctan(slope * (r - radius))


def _smin(x, y1, y2, kmin=0.0, kmax=1.0):
    k = kmax * ((np.pi / 2.0 - _atan_r(x, radius=2.0, slope=50.0)) / np.pi / 2.0) + kmin
    m = torch.maximum(k, torch.minimum(y1, y2))
    q = torch.sqrt(torch.clamp(k - y1, min=0.0) ** 2 + torch.clamp(k - y2, min=0.0) ** 2)
    return m - q


def levelset(x):
    """Smooth flower level set (formulation only)."""
    val = x[..., 0] ** 2 + x[..., 1] ** 2 - 4.0
    xs, ys = _petal_centers()
    for xi, yi in zip(xs, ys):
        pet = (x[..., 0] - xi) ** 2 + (x[..., 1] - yi) ** 2 - _R**2
        val = _smin(x, val, pet)
    return val


def detection_levelset(x):
    """Non-smooth min-composition (tagging only)."""
    val = x[..., 0] ** 2 + x[..., 1] ** 2 - 4.0
    xs, ys = _petal_centers()
    for xi, yi in zip(xs, ys):
        pet = (x[..., 0] - xi) ** 2 + (x[..., 1] - yi) ** 2 - _R**2
        val = torch.minimum(val, pet)
    return val


def source_term(x):
    """10 inside the disk of radius r1/sqrt(2) around the first petal."""
    d2 = (x[..., 0] - _C) ** 2 + x[..., 1] ** 2
    return torch.where(d2 <= _R**2 / 2.0, 10.0, 0.0).to(x.dtype)


def dirichlet_data(x):
    return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
