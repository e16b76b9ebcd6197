"""Parity of the port's row-slab halo decomposition
(``phifem_tpu_torch.parallel.halo``) and of ``sharded_solve``'s
whole-vector branch with the JAX package's, on meshes of 2-4 shards (JAX
on the suite's virtual CPU devices, the port on ``["cpu"] * k``) at sizes
whose rows do not divide the shard count; and the collectives of
``phifem_tpu_torch.parallel.sharding``, which need no JAX.  Each JAX result
is computed once per module."""

import numpy as np
import pytest
import torch

import phifem_tpu_torch.parallel as tpar
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)
from phifem_tpu_torch.parallel import sharding


# ------------------------------------------------------------ collectives
@pytest.mark.parametrize("k", [2, 3, 4])
def test_collectives(k):
    """``ppermute`` zeroes the slots that receive nothing, ``psum`` puts the
    same bits on every shard and repeats them call after call, ``all_gather``
    stacks the parts everywhere, and ``all_to_all`` there and back is the
    identity; ``bytes_moved`` counts only copies between two shards."""
    rng = np.random.default_rng(k)
    parts = [torch.as_tensor(rng.normal(size=(5, 3))) for _ in range(k)]
    before = sharding.bytes_moved
    out = sharding.ppermute(parts, [(i, i + 1) for i in range(k - 1)])
    assert torch.equal(out[0], torch.zeros(5, 3))
    for i in range(1, k):
        assert torch.equal(out[i], parts[i - 1]) and out[i].data_ptr() != parts[i - 1].data_ptr()
    assert sharding.bytes_moved - before == (k - 1) * 5 * 3 * 8
    s1, s2 = sharding.psum(parts), sharding.psum(parts)
    want = parts[0].clone()
    for p in parts[1:]:
        want = want + p
    for a, b in zip(s1, s2):
        assert torch.equal(a, want) and torch.equal(b, want)
    g = sharding.all_gather(parts)
    assert all(torch.equal(t, torch.stack(parts)) for t in g)
    blocks = [torch.as_tensor(rng.normal(size=(k, 2, 4))) for _ in range(k)]
    there = sharding.all_to_all(blocks)
    for q in range(k):
        for p in range(k):
            assert torch.equal(there[q][p], blocks[p][q])
    back = sharding.all_to_all(there)
    assert all(torch.equal(a, b) for a, b in zip(back, blocks))


def test_shard_mesh_of_repeated_devices():
    mesh = tpar.make_mesh(devices=["cpu"] * 3)
    assert mesh.shape == {"shard": 3} and mesh.size == 3 and mesh.devices == (torch.device("cpu"),) * 3
    x = {"u": torch.arange(10.0), "v": torch.ones(7, 2)}
    blocks = tpar.shard_vector(x, mesh)
    assert [b.shape[0] for b in blocks["u"]] == [4, 4, 4] and blocks["u"][2][2:].abs().sum() == 0
    assert torch.equal(torch.cat(blocks["u"])[:10], x["u"]) and blocks["v"][0].shape == (3, 2)
    with pytest.raises(ValueError):
        tpar.make_mesh(2, devices=["cpu"] * 3)


# -------------------------------------------------------------- halo (JAX)
# 16 and 34 vertex rows: neither divides the shards; the first case is also
# held to JAX's HaloOperator
HALO_CASES = [(15, 3), (33, 4)]
JAX_HALO_CASE = (15, 3)


@pytest.fixture(scope="module")
def jax_halo():
    """JAX's halo matvec of a seeded vector (S1, n=15, 3 shards, jitted) and
    its slab shape."""
    pytest.importorskip("jax")
    import jax
    from torch_parallel_cases import meshes, random_x, s1_circle

    import phifem_tpu.parallel as jpar

    n, k = JAX_HALO_CASE
    sj, _ = s1_circle(n)
    Hj = jpar.HaloOperator(sj.op, sj.grid, meshes(k)[0])
    xj, _ = random_x(sj.b)
    y = Hj.unpad(jax.jit(Hj.matvec)(Hj.pad(xj)))
    return {f: np.asarray(v) for f, v in y.items()}, Hj.H, Hj.m


@pytest.mark.parametrize("n,k", HALO_CASES)
def test_halo_matvec_matches_jax_and_masked_operator(request, n, k):
    """One halo matvec (stencil term per slab, generic batches per shard,
    one pull and one push of H rows) equals the port's single-device masked
    operator and, at n=15 on 3 shards, JAX's ``HaloOperator.matvec``, to
    1e-12 of max |y|, with JAX's halo width and slab height."""
    pytest.importorskip("jax")
    from torch_parallel_cases import random_x, rel_to_max, s1_circle_port

    from phifem_tpu_torch.solvers import masked_operator

    st = s1_circle_port(n)
    _, xt = random_x(st.b)
    H = tpar.HaloOperator(st.op, st.grid, tpar.make_mesh(devices=["cpu"] * k))
    assert len(H.diag["u"]) == k and H.m == -(-(n + 1) // k)
    y = H.unpad(H.matvec(H.pad(xt)))
    y_ref = masked_operator(st.op)[0](xt)
    for f in y:
        assert rel_to_max(y[f], y_ref[f]) <= 1e-12, f
    if (n, k) == JAX_HALO_CASE:
        yj, Hw, m = request.getfixturevalue("jax_halo")
        assert (H.H, H.m) == (Hw, m)
        for f in y:
            assert rel_to_max(y[f], yj[f]) <= 1e-12, f


@pytest.fixture(scope="module")
def halo_solves():
    """JAX's ``halo_solve`` (S1, n=15, 3 shards) and ``sharded_solve`` of S1
    at degree 2 (the GSPMD branch, n=9, 2 shards), each run once."""
    pytest.importorskip("jax")
    from torch_parallel_cases import meshes, s1_circle

    import phifem_tpu.parallel as jpar

    sj, _ = s1_circle(15)
    xh, relh = jpar.halo_solve(sj.op, sj.grid, sj.b, meshes(3)[0], method="bicgstab", tol=1e-12, maxiter=4000)
    sj2, _ = s1_circle(9, degree=2)
    x2, rel2 = jpar.sharded_solve(sj2.op, sj2.b, meshes(2)[0], method="bicgstab", tol=1e-12, maxiter=4000)
    return {"halo": ({f: np.asarray(v) for f, v in xh.items()}, relh),
            "p2": ({f: np.asarray(v) for f, v in x2.items()}, rel2)}


def test_halo_solve_matches_jax(halo_solves):
    """``halo_solve`` (BiCGStab on the equilibrated system, dots summed over
    the shards) against JAX's: x within 1e-8 of max |x|, and both solves at
    their tolerance."""
    from torch_parallel_cases import meshes, rel_to_max, s1_circle_port

    st = s1_circle_port(15)
    stats = {}
    x, rel = tpar.halo_solve(st.op, st.grid, st.b, meshes(3)[1], method="bicgstab", tol=1e-12, maxiter=4000,
                             stats=stats)
    xj, relj = halo_solves["halo"]
    assert rel < 1e-11 and relj < 1e-11, (rel, relj)
    assert stats["path"] == "halo" and 0 < stats["iterations"] < 4000 and stats["bytes_moved"] > 0
    for f in x:
        assert rel_to_max(x[f], xj[f]) <= 1e-8, f


def test_sharded_solve_degree2_branch_matches_jax(halo_solves):
    """Degree 2 is no slab layout: ``sharded_solve`` takes the whole-vector
    branch (the masked operator on the first shard's device, split into row
    blocks, Jacobi BiCGStab on the blocks), as JAX takes GSPMD's; x within
    1e-8 of max |x| of JAX's."""
    from torch_parallel_cases import meshes, rel_to_max, s1_circle_port

    st = s1_circle_port(9, degree=2)
    with pytest.raises(tpar.UnsupportedFieldError):
        tpar.HaloOperator(st.op, st.grid, meshes(2)[1])
    stats = {}
    x, rel = tpar.sharded_solve(st.op, st.b, meshes(2)[1], method="bicgstab", tol=1e-12, maxiter=4000, stats=stats)
    xj, relj = halo_solves["p2"]
    assert stats["path"] == "whole-vector" and rel < 1e-11 and relj < 1e-11, (rel, relj)
    for f in x:
        assert rel_to_max(x[f], xj[f]) <= 1e-8, f


def test_halo_wider_than_a_slab_raises():
    """JAX's rule: a halo wider than the slab height raises
    UnsupportedFieldError (here 10 shards of one row for a halo of 2 on a
    9 x 9 grid)."""
    pytest.importorskip("jax")
    from torch_parallel_cases import s1_circle_port

    st = s1_circle_port(9)
    assert tpar.HaloOperator(st.op, st.grid, tpar.make_mesh(devices=["cpu"] * 5)).H == 2
    with pytest.raises(tpar.UnsupportedFieldError, match="halo width"):
        tpar.HaloOperator(st.op, st.grid, tpar.make_mesh(devices=["cpu"] * 10))


# ------------------------------------------------------------------- card
@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
def test_halo_matvec_runs_the_stencil_kernel_on_each_slab(dt):
    """Four shards on one card: the halo matvec launches the stencil kernel
    once per slab and equals the same matvec on the CPU (the kernel's plain
    version) to 1e-13 (f64) / 1e-5 (f32) of max |y|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import phifem_tpu_torch as pt
    from phifem_tpu_torch.models import flower
    from phifem_tpu_torch.ops import cuda_stencil

    ops = []
    for dev in ("cpu", "cuda"):
        g = pt.Grid(64, 64, ((-4.5, -4.5), (4.5, 4.5)), device=dev, dtype=dt)
        s = pt.WeakDirichletPoisson(g, mode="bg", detection_degree=1, single_layer_cut=True)
        s.setup(flower.levelset, flower.source_term, detection_levelset=flower.detection_levelset)
        s.assemble()
        ops.append((s, tpar.HaloOperator(s.op, g, tpar.make_mesh(devices=[dev] * 4))))
    rng = np.random.default_rng(0)
    x = {k: torch.as_tensor(rng.normal(size=v.shape), dtype=dt) for k, v in ops[0][0].b.items()}
    y_cpu = ops[0][1].unpad(ops[0][1].matvec(ops[0][1].pad(x)))
    n0 = cuda_stencil.launches
    Hc = ops[1][1]
    y = Hc.unpad(Hc.matvec(Hc.pad({k: v.cuda() for k, v in x.items()})))
    torch.cuda.synchronize()
    assert cuda_stencil.launches - n0 == 4
    tol = 1e-13 if dt == torch.float64 else 1e-5
    for f in y:
        ref = y_cpu[f].double()
        assert float((y[f].cpu().double() - ref).abs().max()) <= tol * float(ref.abs().max()), f
