"""Port parity of imported-mesh assembly (``phifem_tpu_torch/uassembly.py``)
against ``phifem_tpu.uassembly``, float64 on the CPU.

The perturbed triangle mesh of ``tests/torch_u_cases.py`` (n = 12) in both
packages; schemes built once per module:

* spaces: cell -> DoF maps, DoF coordinates and boundary masks of Lagrange
  degrees 1-3 and DG0, bit for bit; ``interpolate`` to 1e-15;
* S1 at degree 1 (bg and sub mode), 2 and 3 (bg), and S3 (a vector P1 flux and
  DG0): every batch's element matrices, the operator applied to a seeded
  vector, and b, to 1e-12 relative (the same sums in another order); the
  same batches rebuildable; ``reassemble`` after a new level set;
* ``assemble_scalar`` through ``l2_h1_errors`` on an interpolant, to 1e-12.

Quadrilateral meshes: ``tests/test_torch_uquad.py``; tetrahedra:
``tests/test_torch_utet.py``.
"""

import numpy as np
import pytest
import torch

import phifem_tpu.uassembly as ju
import phifem_tpu_torch.uassembly as tu
from torch_u_cases import meshes, np_t, rel, schemes
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

N = 12
TOL = 1e-12


@pytest.fixture(scope="module")
def pair():
    return meshes(N)


@pytest.mark.parametrize("degree", [1, 2, 3, 0], ids=["P1", "P2", "P3", "DG0"])
def test_space_tables_bit_for_bit(pair, degree):
    jm, tm = pair
    if degree == 0:
        js, ts = ju.USpace.dg0(jm), tu.USpace.dg0(tm)
    else:
        js, ts = ju.USpace.lagrange(jm, degree, (2,)), tu.USpace.lagrange(tm, degree, (2,))
    assert (ts.num_dofs, ts.dof_shape) == (js.num_dofs, js.dof_shape)
    assert np.array_equal(ts.cell_dofs_np, js.cell_dofs_np)
    assert np.array_equal(ts.dof_coords_np, js.dof_coords_np)
    if degree:
        assert np.array_equal(np_t(tu.boundary_dof_mask(ts)), np.asarray(ju.boundary_dof_mask(js)))
        f = lambda x: x[..., 0] ** 3 - 2.0 * x[..., 1]
        assert rel(np_t(tu.interpolate(f, tu.USpace.lagrange(tm, degree)).data),
                   ju.interpolate(f, ju.USpace.lagrange(jm, degree)).data) <= 1e-15


CASES = {"s1-P1-bg": ("s1", "bg", 1), "s1-P1-sub": ("s1", "sub", 1), "s1-P2-bg": ("s1", "bg", 2),
         "s1-P3-bg": ("s1", "bg", 3), "s3-bg": ("s3", "bg", None)}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    name, mode, degree = CASES[request.param]
    kw = {} if degree is None else {"primal_degree": degree}
    return schemes(name, N, mode, **kw)


def _seeded(system, seed=3):
    rng = np.random.default_rng(seed)
    return {n: rng.standard_normal(s.dof_shape) for n, s in system.fields.items()}


def test_element_matrices(case):
    sj, st, _, _ = case
    assert len(st.op.batches) == len(sj.op.batches)
    for bj, bt in zip(sj.op.batches, st.op.batches):
        assert [(n, vs) for n, _, vs in bt.segments] == [(n, vs) for n, _, vs in bj.segments]
        for (_, dj, _), (_, dt, _) in zip(bj.segments, bt.segments):
            assert np.array_equal(np_t(dt), np.asarray(dj))
        assert rel(np_t(bt.matrices), bj.matrices) <= TOL
        assert bt.dynamic == (getattr(bj, "rebuild", None) is not None)


def test_matvec_and_rhs(case):
    sj, st, _, _ = case
    x = _seeded(st.system)
    yj = sj.op.matvec({k: np.asarray(v) for k, v in x.items()})
    yt = st.op.matvec({k: torch.as_tensor(v) for k, v in x.items()})
    for k in x:
        assert rel(np_t(yt[k]), yj[k]) <= TOL, k
        assert rel(np_t(st.b[k]), sj.b[k]) <= TOL, k
    assert set(np.unique(st.cell_tags)) == {1, 2, 3}


def test_reassemble_after_new_levelset(case):
    sj, st, _, _ = case
    shift = np.linspace(0.0, 0.01, st.phi_h.data.shape[0])
    sj.phi_h.data = sj.phi_h.data + shift
    st.phi_h.data = st.phi_h.data + torch.as_tensor(shift)
    sj.op.reassemble()
    st.op.reassemble()
    assert st.op.data_version == 1
    for bj, bt in zip(sj.op.batches, st.op.batches):
        assert rel(np_t(bt.matrices), bj.matrices) <= TOL


def test_assemble_scalar_errors(case):
    sj, st, uj, ut = case
    ej = sj.l2_h1_errors(ju.interpolate(uj, sj.V), uj)
    et = st.l2_h1_errors(tu.interpolate(ut, st.V), ut)
    for k in ("l2", "h10", "h1"):
        assert abs(et[k] - ej[k]) <= TOL * abs(ej[k]) + 1e-15, (k, et, ej)

