"""Shared problems of the sharded-solve parity tests
(``tests/test_torch_parallel_*.py``): the problems of
``tests/test_parallel.py`` built the same way in the JAX package and in the
port, and the two packages' meshes of k shards (JAX on the first k virtual
CPU devices, the port on ``["cpu"] * k``).  Importing this module imports
JAX."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import phifem_tpu as pf
import phifem_tpu.models as jm
import phifem_tpu.parallel as jpar
import phifem_tpu_torch as pt
import phifem_tpu_torch.parallel as tpar

BOX = ((-1.0, -1.0), (1.0, 1.0))


def meshes(k: int):
    """(JAX mesh over the first k CPU devices, port mesh of k CPU shards)."""
    assert len(jax.devices()) >= k, "the suite forces 8 virtual CPU devices"
    return jpar.make_mesh(k), tpar.make_mesh(devices=["cpu"] * k)


def _circle(x):
    return x[..., 0] ** 2 + x[..., 1] ** 2 - 0.49


def _data(lib):
    uex = lambda x: lib.cos(x[..., 0]) * lib.sin(x[..., 1])
    return uex, lambda x: 2.0 * uex(x)


def _s1(pkg, n: int, degree: int):
    kw = {} if degree == 1 else {"primal_degree": degree, "levelset_degree": degree}
    dev = {} if pkg is pf else {"device": "cpu"}
    g = pkg.Grid(n, n, BOX, "triangle", **dev)
    s = (jm if pkg is pf else pt).WeakDirichletPoisson(g, mode="bg", **kw)
    uex, f = _data(jnp if pkg is pf else torch)
    s.setup(_circle, f, u_D=uex)
    s.assemble()
    return s


@functools.lru_cache(maxsize=None)
def s1_circle_port(n: int, degree: int = 1):
    """``tests/test_parallel.py``'s S1 problem (bg mode, the circle r = 0.7
    on [-1, 1]^2) at ``degree`` in the port, on the CPU."""
    return _s1(pt, n, degree)


@functools.lru_cache(maxsize=None)
def s1_circle(n: int, degree: int = 1):
    """The same S1 problem in both packages: ``(jax, port)``."""
    return _s1(pf, n, degree), s1_circle_port(n, degree)


def _umesh_arrays(n: int, amp: float = 0.25):
    """``tests/test_parallel.py::_umesh_problem``'s perturbed triangle mesh:
    (verts, cells) from the JAX package's ``UMesh.from_grid``."""
    um, _ = pf.UMesh.from_grid(pf.Grid(n, n, BOX, "triangle"))
    verts = um.verts.copy()
    rng = np.random.default_rng(3)
    h = 2.0 / n
    interior = (np.abs(np.abs(verts[:, 0]) - 1.0) > 1e-12) & (np.abs(np.abs(verts[:, 1]) - 1.0) > 1e-12)
    verts[interior] += amp * h * (rng.random((int(interior.sum()), 2)) - 0.5)
    return verts, um.cells


def _s1u(pkg, n: int):
    verts, cells = _umesh_arrays(n)
    mesh = pf.UMesh(verts, cells) if pkg is pf else pt.UMesh(verts, cells, device="cpu")
    uex, f = _data(jnp if pkg is pf else torch)
    s = (jm if pkg is pf else pt).WeakDirichletPoissonU(mesh, mode="bg")
    s.setup(_circle, f, u_D=uex)
    s.assemble()
    return s


@functools.lru_cache(maxsize=None)
def s1_umesh_port(n: int):
    """S1 on the perturbed imported mesh, in the port on the CPU."""
    return _s1u(pt, n)


@functools.lru_cache(maxsize=None)
def s1_umesh(n: int):
    """The same S1-U problem in both packages: ``(jax, port)``."""
    return _s1u(pf, n), s1_umesh_port(n)


def _s5u(pkg, n: int):
    dev = {} if pkg is pf else {"device": "cpu"}
    um, _ = pkg.UMesh.from_grid(pkg.Grid(n, n, BOX, "triangle", **dev))
    if pkg is pt:
        uv = lambda x: torch.stack([torch.cos(x[..., 0]), torch.sin(x[..., 1])], dim=-1)
    else:
        uv = lambda x: jnp.stack([jnp.cos(x[..., 0]), jnp.sin(x[..., 1])], axis=-1)
    s = (jm if pkg is pf else pt).InterfaceElasticityU(um, mode="bg", E_in=1.0, E_out=0.1)
    s.setup(_circle, uv, uv)
    s.assemble()
    return s


@functools.lru_cache(maxsize=None)
def s5_umesh_port(n: int):
    """``tests/test_parallel.py::test_partitioned_solve_s5_deflated``'s S5-U
    problem in the port on the CPU."""
    return _s5u(pt, n)


@functools.lru_cache(maxsize=None)
def s5_umesh(n: int):
    """The same S5-U problem in both packages: ``(jax, port)``."""
    return _s5u(pf, n), s5_umesh_port(n)


def random_x(b: dict, seed: int = 0):
    """The same seeded vector in both layouts: ``(jax dict, torch dict)``."""
    rng = np.random.default_rng(seed)
    x = {k: rng.normal(size=np.shape(v)) for k, v in b.items()}
    return {k: jnp.asarray(v) for k, v in x.items()}, {k: torch.as_tensor(v) for k, v in x.items()}


def np_of(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def rel_to_max(a, b) -> float:
    """max |a - b| / max |b|."""
    a, b = np_of(a), np_of(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))
