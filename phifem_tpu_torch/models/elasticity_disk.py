"""Two-material disk data of the S5 interface-elasticity demo, on torch
tensors.

The same arithmetic, in the same order, as
``demo/interface-elasticity/data.py``, with the ``x: (n, 2)`` convention:
the "in" material (E = 1) lies OUTSIDE the unit circle (``levelset = 1 -
r^2 < 0`` there), the soft one (E = 0.001) inside, and the source term is
``f = -div sigma_in(cos r, cos r) / E_in``, derived by ``torch.func.jacfwd``
as the demo derives it by ``jax.jacfwd``.
"""

import torch
from torch.func import jacfwd, vmap

from .interface_elasticity import lame

__all__ = ["E_in", "nu_in", "E_out", "nu_out", "levelset", "exact_solution", "source_term"]

E_in, nu_in = 1.0, 0.3
E_out, nu_out = 0.001, 0.3
lmbda_in, mu_in = lame(E_in, nu_in)
lmbda_out, mu_out = lame(E_out, nu_out)


def levelset(x):
    return 1.0 - (x[..., 0] ** 2 + x[..., 1] ** 2)


def exact_solution(x):
    r = torch.sqrt(x[..., 0] ** 2 + x[..., 1] ** 2)
    val = (torch.cos(r) - torch.cos(torch.ones((), dtype=x.dtype, device=x.device))) / E_in
    val = torch.where(r < 1.0, val * (E_in / E_out), val)
    return torch.stack([val, val], dim=-1)


def _cos_vec(p):
    r = torch.sqrt(p[0] ** 2 + p[1] ** 2)
    return torch.stack([torch.cos(r), torch.cos(r)])


def _sigma_in(p):
    G = jacfwd(_cos_vec)(p)
    eps = 0.5 * (G + G.T)
    return lmbda_in * torch.trace(G) * torch.eye(2, dtype=p.dtype, device=p.device) + 2.0 * mu_in * eps


def source_term(x):
    """f = -div sigma_in(cos_vec) / E_in."""
    D = vmap(jacfwd(_sigma_in))(x)  # (n, 2, 2, 2) = d_k sigma_ij
    return -torch.einsum("nijj->ni", D) / E_in
