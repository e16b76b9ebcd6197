"""Port parity of S5 on imported meshes (``InterfaceElasticityU``,
``phifem_tpu_torch/models/unstructured.py``) against
``phifem_tpu.models.unstructured``, float64 on the CPU.

``tests/test_usolve.py``'s problem: the perturbed triangle mesh of
[-1, 1]^2 (amplitude 0.25 h, seed 0; ``tests/torch_u_cases.py``) at n = 8,
the circle R = 0.7, E_in / E_out = 1.0 / 0.1, ``u_vec`` / ``f_vec``:

* the Dirichlet rows of u_in (mask and values) equal JAX's;
* every batch's element matrices, b and one operator matvec to 1e-12;
* the three collective rigid modes and ``s5_recombine`` of seeded halves,
  against JAX's;
* rigid-mode deflated BiCGStab to 1e-9 (``maxiter`` 400, JAX's own test
  path): the counts within max(3, 0.25 it), the displacements to 1e-6 of
  max|u| (the port's Krylov dots are float64, JAX's float32: ROADMAP);
* ``amg_preconditioner()`` builds no AMG (every field is a vector) and
  gives Jacobi plus the band solve;
* bg mode only, and 2D only (a ``UMesh3`` raises as in JAX).

No dense solve: JAX's is in ``tests/slow_tests.txt``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import phifem_tpu as pf
import phifem_tpu_torch as pt
from phifem_tpu.models import InterfaceElasticityU as JS5
from phifem_tpu.models.interface_elasticity import s5_recombine as j_recombine
from phifem_tpu.uassembly import interpolate as j_interp
from phifem_tpu_torch.models import InterfaceElasticityU as TS5
from phifem_tpu_torch.models.interface_elasticity import s5_recombine as t_recombine
from torch_u_cases import mesh_arrays, np_t, rel
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

N = 8
TOL = 1e-12
E_IN, E_OUT = 1.0, 0.1


def phi(x):
    return x[..., 0] ** 2 + x[..., 1] ** 2 - 0.49


def vec(lib):
    def u_vec(x):
        return lib.stack([lib.sin(x[..., 0]) * lib.cos(x[..., 1]), x[..., 0] * x[..., 1]], -1)

    def f_vec(x):
        return lib.stack([lib.cos(x[..., 0]) + x[..., 1], lib.sin(x[..., 1]) - x[..., 0]], -1)

    return u_vec, f_vec


@pytest.fixture(scope="module")
def pair():
    v, c = mesh_arrays(N)
    uj, fj = vec(jnp)
    ut, ft = vec(torch)
    sj = JS5(pf.UMesh(v, c), mode="bg", E_in=E_IN, E_out=E_OUT).setup(phi, fj, uj)
    sj.assemble()
    st = TS5(pt.UMesh(v, c, device="cpu"), mode="bg", E_in=E_IN, E_out=E_OUT).setup(phi, ft, ut).assemble()
    return sj, st


def test_s5u_dirichlet_rows(pair):
    sj, st = pair
    (bj,), (bt,) = sj.bcs, st.bcs
    assert bt.field == bj.field == "u_in"
    assert np.array_equal(np_t(bt.mask), np.asarray(bj.mask))
    assert rel(np_t(bt.values), bj.values) <= 1e-15
    assert np.array_equal(st.cell_tags, sj.cell_tags) and np.array_equal(st.facet_tags, sj.facet_tags)
    assert list(st.system.fields) == ["u_in", "u_out", "y_in", "y_out", "p"]


def test_s5u_element_matrices_matvec_rhs(pair):
    sj, st = pair
    assert len(st.op.batches) == len(sj.op.batches)
    for bj, bt in zip(sj.op.batches, st.op.batches):
        assert [(n, vs) for n, _, vs in bt.segments] == [(n, vs) for n, _, vs in bj.segments]
        assert rel(np_t(bt.matrices), bj.matrices) <= TOL
    rng = np.random.default_rng(4)
    x = {n: rng.standard_normal(s.dof_shape) for n, s in st.system.fields.items()}
    yj = sj.op.matvec({k: jnp.asarray(v) for k, v in x.items()})
    yt = st.op.matvec({k: torch.as_tensor(v) for k, v in x.items()})
    for k in x:
        assert rel(np_t(yt[k]), yj[k]) <= TOL, k
        assert rel(np_t(st.b[k]), sj.b[k]) <= TOL, k


def test_s5u_rigid_modes_and_recombine(pair):
    sj, st = pair
    mj, mt = sj.rigid_modes(), st.rigid_modes()
    assert len(mt) == len(mj) == 3
    for a, b in zip(mt, mj):
        for k in b:
            assert np.abs(np_t(a[k]) - np.asarray(b[k])).max() <= 1e-15, k
    # the modes are the operator's null space (Dirichlet rows aside)
    for m in mt:
        y = st.op.matvec(m)
        assert max(float(v.abs().max()) for v in y.values()) <= 1e-10 * max(float(v.abs().max()) for v in m.values())
    rng = np.random.default_rng(6)
    a, b = rng.standard_normal(st.U.dof_shape), rng.standard_normal(st.U.dof_shape)
    want = np.asarray(j_recombine(sj.U, sj.cell_tags, jnp.asarray(a), jnp.asarray(b)))
    got = np_t(t_recombine(st.U, st.cell_tags, torch.as_tensor(a), torch.as_tensor(b)))
    assert np.array_equal(got, want)
    # and interpolate on the vector space, JAX's backend against the port's
    uj, _ = vec(jnp)
    ut, _ = vec(torch)
    assert rel(np_t(pt.interpolate_u(ut, st.U).data), j_interp(uj, sj.U).data) <= 1e-15


def test_s5u_deflated_bicgstab(pair):
    sj, st = pair
    rj = sj.solve(method="bicgstab", tol=1e-9, maxiter=400)
    rt = st.solve(method="bicgstab", tol=1e-9, maxiter=400)
    assert rj.converged and rt.converged, (rj.residual, rt.residual)
    assert abs(rt.iterations - rj.iterations) <= max(3, 0.25 * rj.iterations), (rt.iterations, rj.iterations)
    for k in ("u_in", "u_out"):
        xj = np.asarray(rj.x[k])
        assert np.abs(np_t(rt.x[k]) - xj).max() <= 1e-6 * np.abs(xj).max(), k
    uj = np.asarray(sj.u_h.data)
    assert np.abs(np_t(st.u_h.data) - uj).max() <= 1e-6 * np.abs(uj).max()


def test_s5u_amg_preconditioner_is_jacobi_and_band(pair):
    _, st = pair
    vc = st.amg_preconditioner()
    assert vc.amgs == {} and vc.amg_levels == {}
    assert vc.interface_inv is not None or vc.band_ids is not None
    r = st.solve(method="bicgstab", tol=1e-9, maxiter=400, precond=vc)
    assert r.converged
    assert r.iterations < st.solve(method="bicgstab", tol=1e-9, maxiter=400).iterations


def test_s5u_rules_follow_jax():
    v, c = mesh_arrays(4)
    ut, ft = vec(torch)
    with pytest.raises(ValueError, match="bg"):
        TS5(pt.UMesh(v, c, device="cpu"), mode="sub").setup(phi, ft, ut)
    tets = pt.UMesh3.box(2, 2, 2, ((-1.0,) * 3, (1.0,) * 3), device="cpu")
    with pytest.raises(NotImplementedError, match="2D"):
        TS5(tets).setup(lambda x: (x**2).sum(-1) - 0.3, ft, ut)
