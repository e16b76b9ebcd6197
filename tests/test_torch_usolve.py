"""Port parity of the imported-mesh schemes S1-S4
(``phifem_tpu_torch/models/unstructured.py``) against
``phifem_tpu.models.unstructured``: whole solves, float64 on the CPU.

``demo/unstructured/main.py``'s four schemes (the circle r^2 = 0.49,
u = cos x sin y; S2 with u = sin(phi)) on the perturbed triangle mesh of
``tests/torch_u_cases.py`` at n = 12, bg mode, and S1 in sub mode, solved
by Jacobi-equilibrated BiCGStab to 1e-10 in both packages:

* the solution to 1e-6 of JAX's, relative to max|x| per field;
* the counts within max(3, 0.25 it): the port's Krylov dots are float64,
  JAX's float32 (a deliberate deviation, ROADMAP);
* the relative L2 / H10 errors to 1e-6 of JAX's.
"""

import numpy as np
import pytest

from torch_u_cases import np_t, schemes
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

N = 12
CASES = {"s1": ("s1", "bg"), "s2": ("s2", "bg"), "s3": ("s3", "bg"), "s4": ("s4", "bg"), "s1-sub": ("s1", "sub")}


@pytest.fixture(scope="module", params=list(CASES))
def solved(request):
    name, mode = CASES[request.param]
    sj, st, uj, ut = schemes(name, N, mode)
    rj = sj.solve(method="bicgstab", tol=1e-10)
    rt = st.solve(method="bicgstab", tol=1e-10)
    region = (1,) if name in ("s3", "s4") else (1, 2)
    ej = sj.l2_h1_errors(sj.u_h, uj, region=region)
    et = st.l2_h1_errors(st.u_h, ut, region=region)
    return request.param, rj, rt, ej, et


def test_solution(solved):
    name, rj, rt, _, _ = solved
    assert rt.converged and rj.converged, (rt.residual, rj.residual)
    for k, xj in rj.x.items():
        xj = np.asarray(xj)
        assert np.abs(np_t(rt.x[k]) - xj).max() <= 1e-6 * np.abs(xj).max(), (name, k)


def test_counts(solved):
    name, rj, rt, _, _ = solved
    assert abs(rt.iterations - rj.iterations) <= max(3, 0.25 * rj.iterations), (name, rt.iterations, rj.iterations)


def test_errors(solved):
    name, _, _, ej, et = solved
    for k in ("l2", "h10"):
        assert abs(et[k] - ej[k]) <= 1e-6 * ej[k], (name, k, et, ej)
