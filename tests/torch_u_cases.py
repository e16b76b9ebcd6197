"""Shared cases of the imported-mesh parity tests: the same triangle or
quadrilateral mesh, made from a seed with numpy, in both packages.

The mesh is ``demo/unstructured/main.py``'s fallback: a structured grid of
[-1, 1]^2 copied into a ``UMesh`` with its interior vertices moved by
``amp * h * (U[0, 1) - 1/2)`` (``np.random.default_rng(seed)``).  The level
sets are written once for numpy, JAX and torch inputs alike.
"""

import numpy as np
import torch

import jax.numpy as jnp

import phifem_tpu as pf
import phifem_tpu_torch as pt

BOX = ((-1.0, -1.0), (1.0, 1.0))
R2 = 0.49  # the demo's circle, r^2


def mesh_arrays(n, amp=0.25, seed=0, quad=False):
    """(verts, cells) of the perturbed mesh (JAX's ``UMesh.from_grid`` of
    the n x n grid, then the demo's perturbation)."""
    ct = pf.CellType.quadrilateral if quad else pf.CellType.triangle
    um, _ = pf.UMesh.from_grid(pf.Grid(n, n, BOX, ct))
    verts = um.verts.copy()
    h = 2.0 / n
    rng = np.random.default_rng(seed)
    interior = (np.abs(np.abs(verts[:, 0]) - 1.0) > 1e-12) & (np.abs(np.abs(verts[:, 1]) - 1.0) > 1e-12)
    verts[interior] += amp * h * (rng.random((int(interior.sum()), 2)) - 0.5)
    return verts, um.cells


def meshes(n, amp=0.25, seed=0, quad=False):
    """(JAX UMesh, port UMesh on the CPU) of the same arrays."""
    verts, cells = mesh_arrays(n, amp, seed, quad)
    return pf.UMesh(verts, cells), pt.UMesh(verts, cells, device="cpu")


def circle(x):
    return x[..., 0] ** 2 + x[..., 1] ** 2 - R2


def ellipse(x):
    return (x[..., 0] - 0.1) ** 2 + 2.0 * (x[..., 1] + 0.05) ** 2 - 0.4


def u_j(x):
    return jnp.cos(x[..., 0]) * jnp.sin(x[..., 1])


def u_t(x):
    return torch.cos(x[..., 0]) * torch.sin(x[..., 1])


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def np_t(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _s2_exact(lib):
    def uex(x):
        return lib.sin(x[..., 0] ** 2 + x[..., 1] ** 2 - R2)

    def f(x):
        r2x = x[..., 0] ** 2 + x[..., 1] ** 2
        return 4.0 * r2x * lib.sin(r2x - R2) - 4.0 * lib.cos(r2x - R2)

    return uex, f


def _nderiv(lib, u):
    """The outward normal derivative of u on the circles phi = const
    (analytic gradient, the same formula in both packages)."""

    def nd(x):
        gx = -lib.sin(x[..., 0]) * lib.sin(x[..., 1])
        gy = lib.cos(x[..., 0]) * lib.cos(x[..., 1])
        norm = lib.sqrt((2.0 * x[..., 0]) ** 2 + (2.0 * x[..., 1]) ** 2)
        norm = lib.maximum(norm, 1e-12 + 0.0 * norm)
        return (gx * 2.0 * x[..., 0] + gy * 2.0 * x[..., 1]) / norm

    return nd


def scheme_args(name: str, pkg: str):
    """(class name, constructor kwargs, setup args, exact solution) of the
    demo's scheme ``name`` (s1-s4) for ``pkg`` ("jax" or "torch")."""
    lib = jnp if pkg == "jax" else torch
    u = u_j if pkg == "jax" else u_t
    if name == "s1":
        return "WeakDirichletPoissonU", {}, (circle, lambda x: 2.0 * u(x), u), u
    if name == "s2":
        uex, f = _s2_exact(lib)
        return "StrongDirichletPoissonU", {}, (circle, f), uex
    nd = _nderiv(lib, u)
    if name == "s3":
        return "NeumannPoissonU", {}, (circle, lambda x: 3.0 * u(x), nd), u
    return "RobinPoissonU", {"robin_coef": 1.0}, (circle, lambda x: 3.0 * u(x), lambda x: nd(x) + u(x)), u


def schemes(name: str, n: int, mode: str = "bg", assemble: bool = True, amp: float = 0.25, quad: bool = False,
            **kw):
    """The scheme ``name`` set up (and assembled) on the same perturbed
    mesh in both packages: ``(jax_scheme, port_scheme, exact_j, exact_t)``."""
    import phifem_tpu.models as jmod
    import phifem_tpu_torch.models as tmod

    jm, tm = meshes(n, amp, quad=quad)
    out = []
    for pkg, mod, mesh in (("jax", jmod, jm), ("torch", tmod, tm)):
        cls, ckw, args, uex = scheme_args(name, pkg)
        s = getattr(mod, cls)(mesh, mode=mode, **ckw, **kw)
        s.setup(*args)
        if assemble:
            s.assemble()
        out.append((s, uex))
    return out[0][0], out[1][0], out[0][1], out[1][1]
