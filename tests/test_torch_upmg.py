"""Port parity of p-multigrid on an imported mesh
(``USchemeBase.p_multigrid_preconditioner`` in
``phifem_tpu_torch/models/unstructured.py``) against
``phifem_tpu.models.unstructured``, float64 on the CPU.

S1-U at degree 2 (P2 primal and level set) on the perturbed triangle mesh
of ``tests/torch_u_cases.py`` at n = 12, bg mode, solved by flexible GMRES
to 1e-10 with the default p-multigrid preconditioner in both packages (its
degree-1 correction: the P1 twin's equilibrated inner BiCGStab; an imported
mesh has no lattice):

* ``_p1_twin`` lowers the primal degree only, and the preconditioner is
  memoized;
* the counts within max(3, 0.25 it) (JAX's inner BiCGStab takes float32
  recurrence dots, the port's float64: a deliberate deviation, ROADMAP);
* the solution to 1e-9 of JAX's, relative to max|x| per field;
* the relative L2 / H10 errors to 1e-8 of JAX's.
"""

import numpy as np
import pytest

from torch_u_cases import np_t, rel, schemes
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

N = 12
KW = dict(primal_degree=2, levelset_degree=2)


@pytest.fixture(scope="module")
def solved():
    sj, st, uj, ut = schemes("s1", N, **KW)
    vt = st.p_multigrid_preconditioner()
    rj = sj.solve(method="fgmres", tol=1e-10, maxiter=200, precond=sj.p_multigrid_preconditioner())
    rt = st.solve(method="fgmres", tol=1e-10, maxiter=200, precond=vt)
    ej = sj.l2_h1_errors(sj.u_h, uj)
    et = st.l2_h1_errors(st.u_h, ut)
    return st, vt, rj, rt, ej, et


def test_p1_twin_and_memo(solved):
    st, vt, _, _, _, _ = solved
    twin = st._p1_twin()
    assert (twin.primal_degree, twin.levelset_degree) == (1, KW["levelset_degree"])
    assert twin.mesh is st.mesh
    assert st.p_multigrid_preconditioner() is vt


def test_counts(solved):
    _, _, rj, rt, _, _ = solved
    assert rt.converged and rj.converged, (rt.residual, rj.residual)
    jit = int(rj.iterations)
    assert abs(rt.iterations - jit) <= max(3, 0.25 * jit), (rt.iterations, jit)


def test_solution(solved):
    _, _, rj, rt, _, _ = solved
    assert set(rt.x) == set(rj.x)
    for k, xj in rj.x.items():
        assert rel(np_t(rt.x[k]), np.asarray(xj)) <= 1e-9, k


def test_errors(solved):
    _, _, _, _, ej, et = solved
    for k in ("l2", "h10"):
        assert abs(et[k] - ej[k]) <= 1e-8 * ej[k], (k, et, ej)
