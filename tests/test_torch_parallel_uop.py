"""Parity of the port's element-sharded and partitioned operators and solves
on imported meshes (``phifem_tpu_torch.parallel.uop``) with the JAX
package's, on meshes of 2-4 shards (JAX on the suite's virtual CPU devices,
the port on ``["cpu"] * k``): S1 on ``tests/test_parallel.py``'s perturbed
n=13 triangle mesh (entity and DoF counts that divide no shard count) and
S5 on the n=10 mesh with rigid-mode deflation.  Each JAX result is computed
once per module."""

import numpy as np
import pytest
import torch

import phifem_tpu_torch.parallel as tpar
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

K_MV = (2, 3, 4)  # shards of the matvec cases
K_JAX = 3  # the matvec case also held to JAX, and the shards of the S1 solves
K_S5 = 4


@pytest.fixture(scope="module")
def jax_uop():
    """JAX's element-sharded and partitioned matvecs of a seeded vector on
    3 shards (jitted), its two solves of S1 and its element-sharded
    deflated solve of S5 on 4 shards (``tests/test_parallel.py`` holds
    JAX's partitioned S5 solve to this one)."""
    pytest.importorskip("jax")
    import jax
    from torch_parallel_cases import meshes, random_x, s1_umesh, s5_umesh

    import phifem_tpu.parallel as jpar

    sj, _ = s1_umesh(13)
    xj, _ = random_x(sj.b)
    jm = meshes(K_JAX)[0]
    E = jpar.ElementShardedOperator(sj.op, jm)
    P = jpar.PartitionedUOperator(sj.op, jm)
    out = {"mv": ({f: np.asarray(v) for f, v in jax.jit(E.matvec)(xj).items()},
                  {f: np.asarray(v) for f, v in P.unpartition(jax.jit(P.matvec)(P.partition(xj))).items()},
                  dict(P.chunk), dict(P.nghost), dict(P.S))}
    for name, fn in (("element", jpar.element_sharded_solve), ("partitioned", jpar.partitioned_solve)):
        x, rel, it = fn(sj.op, sj.b, jm, method="bicgstab", tol=1e-12, maxiter=4000)
        out[name] = ({f: np.asarray(v) for f, v in x.items()}, rel, it)
    s5, _ = s5_umesh(10)
    x, rel, it = jpar.element_sharded_solve(s5.op, s5.b, mesh=meshes(K_S5)[0], bcs=s5.bcs, method="bicgstab",
                                            tol=1e-9, maxiter=2000, deflate=s5.rigid_modes())
    out["s5"] = ({f: np.asarray(v) for f, v in x.items()}, rel, it)
    return out


@pytest.mark.parametrize("k", K_MV)
def test_uop_matvecs_match_jax_and_masked_operator(request, k):
    """The element-sharded matvec (one ordered psum) and the partitioned one
    (ghost all_to_all there and back) equal the port's masked operator to
    1e-12 of max |y|, each partitioned vector part being an owner block; on
    3 shards also JAX's matvecs, ownership blocks, ghost counts and exchange
    widths."""
    pytest.importorskip("jax")
    from torch_parallel_cases import random_x, rel_to_max, s1_umesh_port

    from phifem_tpu_torch.solvers import masked_operator

    st = s1_umesh_port(13)
    _, xt = random_x(st.b)
    mesh = tpar.make_mesh(devices=["cpu"] * k)
    E = tpar.ElementShardedOperator(st.op, mesh)
    P = tpar.PartitionedUOperator(st.op, mesh)
    xp = P.partition(xt)
    assert all(len(xp[f]) == k and all(t.shape[0] == P.chunk[f] for t in xp[f]) for f in xp)
    ye, yp = E.matvec(xt), P.unpartition(P.matvec(xp))
    y_ref = masked_operator(st.op)[0](xt)
    for f in y_ref:
        assert rel_to_max(ye[f], y_ref[f]) <= 1e-12 and rel_to_max(yp[f], y_ref[f]) <= 1e-12, f
    if k == K_JAX:
        ye_j, yp_j, chunk, nghost, S = request.getfixturevalue("jax_uop")["mv"]
        assert (P.chunk, P.nghost, P.S) == (chunk, nghost, S)
        for f in y_ref:
            assert rel_to_max(ye[f], ye_j[f]) <= 1e-12 and rel_to_max(yp[f], yp_j[f]) <= 1e-12, f


@pytest.mark.parametrize("name", ["element", "partitioned"])
def test_uop_solves_match_jax(jax_uop, name):
    """S1-U by BiCGStab through both decompositions (3 shards): x within
    1e-8 of max |x| of JAX's, both at their tolerance."""
    from torch_parallel_cases import rel_to_max, s1_umesh_port

    st = s1_umesh_port(13)
    fn = {"element": tpar.element_sharded_solve, "partitioned": tpar.partitioned_solve}[name]
    stats = {}
    x, rel, it = fn(st.op, st.b, tpar.make_mesh(devices=["cpu"] * K_JAX), method="bicgstab", tol=1e-12,
                    maxiter=4000, stats=stats)
    xj, relj, itj = jax_uop[name]
    assert rel < 1e-11 and relj < 1e-11 and it > 0 and stats["matvecs"] > it, (rel, relj)
    for f in x:
        assert rel_to_max(x[f], xj[f]) <= 1e-8, f


@pytest.mark.parametrize("name", ["element", "partitioned"])
def test_uop_s5_deflated_matches_jax(jax_uop, name):
    """S5-U (singular system, rigid-mode deflation, Dirichlet lifting) on 4
    shards to 1e-9 (``tests/test_parallel.py``'s solves): relres below 1e-8
    and x within 1e-6 of max(|x|, 1) of JAX's element-sharded solve (that
    test's bar is 1e-5)."""
    from torch_parallel_cases import s5_umesh_port

    st = s5_umesh_port(10)
    fn = tpar.element_sharded_solve if name == "element" else tpar.partitioned_solve
    x, rel, it = fn(st.op, st.b, mesh=tpar.make_mesh(devices=["cpu"] * K_S5), bcs=st.bcs, method="bicgstab",
                    tol=1e-9, maxiter=2000, deflate=st.rigid_modes())
    xj, relj, _ = jax_uop["s5"]
    assert rel < 1e-8 and relj < 1e-8, (rel, relj)
    for f in x:
        scale = max(float(np.abs(xj[f]).max()), 1.0)
        assert float(np.abs(x[f].numpy() - xj[f]).max()) <= 1e-6 * scale, f


def test_uop_refresh_after_reassemble():
    """After ``op.reassemble()`` with a new level set, ``refresh()`` re-splits
    the rebuilt element matrices: both distributed matvecs track the
    single-device masked operator to 1e-12."""
    pytest.importorskip("jax")
    from torch_parallel_cases import _umesh_arrays, random_x

    import phifem_tpu_torch as pt
    from phifem_tpu_torch.solvers import masked_operator

    verts, cells = _umesh_arrays(11)
    uex = lambda x: torch.cos(x[..., 0]) * torch.sin(x[..., 1])
    s = pt.WeakDirichletPoissonU(pt.UMesh(verts, cells, device="cpu"), mode="bg")
    s.setup(lambda x: x[..., 0] ** 2 + x[..., 1] ** 2 - 0.49, lambda x: 2.0 * uex(x), u_D=uex)
    s.assemble()
    mesh = tpar.make_mesh(devices=["cpu"] * 3)
    E, P = tpar.ElementShardedOperator(s.op, mesh), tpar.PartitionedUOperator(s.op, mesh)
    s.phi_h.data = 1.7 * s.phi_h.data
    s.op.reassemble()
    E.refresh()
    P.refresh()
    _, x = random_x(s.b, seed=1)
    y_ref = masked_operator(s.op)[0](x)
    for y in (E.matvec(x), P.unpartition(P.matvec(P.partition(x)))):
        for f in y:
            scale = float(y_ref[f].abs().max())
            assert float((y[f] - y_ref[f]).abs().max()) <= 1e-12 * max(scale, 1.0), f
