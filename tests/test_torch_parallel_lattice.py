"""Parity of the port's distributed lattice MG-CG solves
(``phifem_tpu_torch.parallel.lattice`` / ``lattice3``) with the JAX
package's, on meshes of 2-4 shards (JAX on the suite's virtual CPU devices,
the port on ``["cpu"] * k``) at lattices whose rows / planes do not divide
the shard count, with distributed coarse levels and an agglomerated tail.
Each JAX solve runs once per module.  The port's dots are float64 where
JAX's are float32: the counts agree within the 2 ROADMAP allows Poisson."""

import numpy as np
import pytest
import torch

import phifem_tpu_torch as pt
import phifem_tpu_torch.parallel as tpar
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

N2 = 48  # 49 vertex rows
N3 = 16  # 17 planes
# (shards, replicate_rows): 3 shards keep levels 0-1 distributed (m = 18, 9)
# and agglomerate the 13-row level; 4 shards keep all three (m = 16, 8, 4)
# and end in the dense inverse
CASES2 = [(3, 8), (4, 4)]
# (shards, replicate_planes): 2 shards keep all four levels distributed (m =
# 16, 8, 4, 2) and end in the dense inverse; 3 shards keep levels 0-1 (m =
# 6, 3) and agglomerate the 9-plane level's hierarchy
CASES3 = [(2, 2), (3, 3)]


def _box_poisson(n):
    """The box Poisson problem of tests/test_parallel.py in both packages."""
    import jax.numpy as jnp

    import phifem_tpu as pf
    from phifem_tpu.models import BoxPoisson

    out = []
    for pkg, lib, cls, dev in ((pf, jnp, BoxPoisson, {}), (pt, torch, pt.BoxPoisson, {"device": "cpu"})):
        g = pkg.Grid(n, n, ((0.0, 0.0), (1.0, 1.0)), "triangle", **dev)
        uex = lambda x, lib=lib: lib.sin(np.pi * x[..., 0]) * lib.sin(np.pi * x[..., 1])
        s = cls(g).setup(lambda x, u=uex: 2.0 * np.pi**2 * u(x))
        s.assemble()
        out.append(s)
    return out


def _box3(n):
    import jax.numpy as jnp

    from phifem_tpu.grid3 import Grid3
    from phifem_tpu.models import BoxPoisson3

    out = []
    for G, cls, lib, dev in ((Grid3, BoxPoisson3, jnp, {}), (pt.Grid3, pt.BoxPoisson3, torch, {"device": "cpu"})):
        g = G(n, n, n, ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)), **dev)
        uex = lambda x, lib=lib: lib.sin(np.pi * x[..., 0]) * lib.sin(np.pi * x[..., 1]) * lib.sin(np.pi * x[..., 2])
        s = cls(g).setup(lambda x, u=uex: 3.0 * np.pi**2 * u(x))
        s.assemble()
        out.append(s)
    return out


@pytest.fixture(scope="module")
def lattice2():
    """The problem, its stencil weights and JAX's sharded solve per case."""
    pytest.importorskip("jax")
    from torch_parallel_cases import meshes

    from phifem_tpu.ops.lattice import vertex_stencil_weights
    from phifem_tpu.ops.stencil import _TRI_OFFS
    from phifem_tpu.parallel import build_sharded_lattice_mg, sharded_lattice_solve

    sj, st = _box_poisson(N2)
    w = vertex_stencil_weights(np.asarray(sj.op.batches[0].matrices), _TRI_OFFS)
    b2d = sj.b["u"].reshape(N2 + 1, N2 + 1)
    out = {"st": st, "w": w}
    for k, rr in CASES2:
        jmesh = meshes(k)[0]
        mg = build_sharded_lattice_mg(N2, N2, w, jmesh, min_n=12, replicate_rows=rr)
        u2d, rel, it = sharded_lattice_solve(mg, jmesh, b2d, tol=1e-11, maxiter=60)
        out[k] = (np.asarray(u2d), rel, it, [(l.R, l.C, l.m) for l in mg.levels], mg.tail is not None)
    return out


@pytest.mark.parametrize("k,rr", CASES2)
def test_sharded_lattice_solve_matches_jax(lattice2, k, rr):
    """The same distributed levels and tail as JAX's plan; the solution
    within 1e-8 of max |u| of JAX's and of the port's single-device
    ``solve_lattice``; relres below 1e-10; the count within 2 of JAX's."""
    from torch_parallel_cases import rel_to_max

    uj, relj, itj, levels, has_tail = lattice2[k]
    st = lattice2["st"]
    mesh = tpar.make_mesh(devices=["cpu"] * k)
    mg = tpar.build_sharded_lattice_mg(N2, N2, lattice2["w"], mesh, min_n=12, replicate_rows=rr)
    assert [(l.R, l.C, l.m) for l in mg.levels] == levels and (mg.tail is not None) == has_tail
    stats = {}
    u2d, rel, it = tpar.sharded_lattice_solve(mg, mesh, st.b["u"].reshape(N2 + 1, N2 + 1), tol=1e-11, maxiter=60,
                                              stats=stats)
    assert rel < 1e-10 and relj < 1e-10, (rel, relj)
    assert abs(it - itj) <= 2, (it, itj)
    assert rel_to_max(u2d, uj) <= 1e-8
    r_ref = st.solve_lattice(tol=1e-11, maxiter=60)
    assert rel_to_max(u2d.reshape(-1), r_ref.x["u"]) <= 1e-8
    assert stats["bytes_moved"] > 0


@pytest.fixture(scope="module")
def lattice3():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from torch_parallel_cases import meshes

    from phifem_tpu.parallel import build_sharded_lattice3_mg, sharded_lattice3_solve

    sj, st = _box3(N3)
    sj.solve_lattice(tol=1e-11, maxiter=40)
    out = {"st": st}
    for k, rp in CASES3:
        jmesh = meshes(k)[0]
        mg = build_sharded_lattice3_mg(N3, N3, N3, sj.grid.spacing, jmesh, min_n=2, replicate_planes=rp,
                                       dtype=jnp.float64)
        u3, rel, it = sharded_lattice3_solve(mg, jmesh, sj.b_lat, tol=1e-11, maxiter=40)
        out[k] = (np.asarray(u3), rel, it, [(l.D, l.m) for l in mg.levels], mg.tail is not None)
    return out


@pytest.mark.parametrize("k,rp", CASES3)
def test_sharded_lattice3_solve_matches_jax(lattice3, k, rp):
    """z-plane slabs with the 27-point sweep on each slab (the kernel's
    plain version here): JAX's plan, the solution within 1e-8 of max |u| of
    JAX's and of the port's single-device ``solve_lattice``, relres below
    1e-10, the count within 2 of JAX's."""
    from torch_parallel_cases import rel_to_max

    uj, relj, itj, levels, has_tail = lattice3[k]
    st = lattice3["st"]
    mesh = tpar.make_mesh(devices=["cpu"] * k)
    mg = tpar.build_sharded_lattice3_mg(N3, N3, N3, st.grid.spacing, mesh, min_n=2, replicate_planes=rp,
                                        dtype=torch.float64)
    assert [(l.D, l.m) for l in mg.levels] == levels and (mg.tail is not None) == has_tail
    u3, rel, it = tpar.sharded_lattice3_solve(mg, mesh, st.b_lat, tol=1e-11, maxiter=40)
    assert rel < 1e-10 and relj < 1e-10, (rel, relj)
    assert abs(it - itj) <= 2, (it, itj)
    assert rel_to_max(u3, uj) <= 1e-8
    st.solve_lattice(tol=1e-11, maxiter=40)
    assert rel_to_max(u3, st.u_lat) <= 1e-8


@pytest.mark.cuda
def test_sharded_lattice3_runs_the_sweep_kernel():
    """Three shards on one card: each slab's stencil is one launch of the
    lattice sweep kernel, and one distributed matvec equals the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from phifem_tpu_torch.ops import cuda_lattice3

    n = 20
    m = -(-(n + 1) // 3)
    x = np.random.default_rng(0).normal(size=(3, m, n + 3, n + 3))
    out = []
    for dev in ("cpu", "cuda"):
        mesh = tpar.make_mesh(devices=[dev] * 3)
        mg = tpar.build_sharded_lattice3_mg(n, n, n, (0.05,) * 3, mesh, min_n=5, replicate_planes=100,
                                            dtype=torch.float64)
        assert mg.levels[0].m == m
        n0 = cuda_lattice3.launches
        out.append(torch.cat(mg._conv(list(torch.as_tensor(x, device=dev)), 0)).cpu())
        if dev == "cuda":
            torch.cuda.synchronize()
            assert cuda_lattice3.launches - n0 == 3
    assert torch.equal(out[0], out[1])
