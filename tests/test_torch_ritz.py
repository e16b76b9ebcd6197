"""``lattice_preconditioner(ritz_modes=k)`` of the port
(``phifem_tpu_torch.mg.attach_ritz_modes``) against the JAX package's, on
S1 (the flower, n=24, 2 modes) and on S5 (the demo's disk, n=16, the flat
preconditioner, 4 modes, rigid modes deflated).

Both start the Arnoldi iteration from the same vector
(``default_rng(0).standard_normal`` on the active DoFs); what differs is the
float32 cycle inside ``E = I - M A`` (summation orders, and the port's
float64 band tables), which the iteration amplifies.  Measured differences
(on a CPU): kept |lambda| 8e-8 (S1) and 2e-6 (S5); largest principal angle
between the two coarse spans 8e-7 rad (S1) and 1.5e-4 rad (S5).  The
tolerances are 1e-5 for |lambda| and 1e-4 / 1e-3 rad for the angles: ten
times the largest reading or more, and far below what a different harvest
would give (the next Ritz values lie 0.01-0.07 away)."""

import numpy as np
import pytest
import scipy.linalg as sl
import torch

pytest.importorskip("jax")

from torch_s1_cases import flower  # noqa: E402
from torch_s5_cases import s5  # noqa: E402

LAM_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Under the suite's parallel workers torch's intra-op threads only
    contend for the cores: one thread a worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_with_lambdas(build, monkeypatch):
    """Build the JAX preconditioner, recording the eigenvalues of its
    Hessenberg matrix (the JAX cycle keeps no Ritz values)."""
    seen = []
    real_eig = np.linalg.eig

    def spy(H):
        lam, Y = real_eig(H)
        seen.append(lam)
        return lam, Y

    with monkeypatch.context() as m:
        m.setattr(np.linalg, "eig", spy)
        vc = build()
    assert len(seen) == 1
    return vc, seen[0]


def _kept(lam, n_keep, tol_lam=0.5):
    a = np.sort(np.abs(lam))[::-1][:n_keep]
    return a[a >= tol_lam]


@pytest.fixture(scope="module")
def s1_pair():
    mp = pytest.MonkeyPatch()
    sj, st = flower(24)
    vj, lam = _jax_with_lambdas(lambda: sj.lattice_preconditioner(ritz_modes=2), mp)
    vt = st.lattice_preconditioner(ritz_modes=2)
    return sj, st, vj, vt, lam


@pytest.fixture(scope="module")
def s5_pair():
    mp = pytest.MonkeyPatch()
    sj, st = s5(16)
    vj, lam = _jax_with_lambdas(lambda: sj.lattice_preconditioner(coupled=False, ritz_modes=4), mp)
    vt = st.lattice_preconditioner(coupled=False, ritz_modes=4)
    return sj, st, vj, vt, lam


def test_s1_kept_lambdas_match_jax(s1_pair):
    _, _, _, vt, lam = s1_pair
    kj = _kept(lam, 2)
    assert len(kj) == 2 and vt.ritz_lambdas.shape == (2,)
    assert np.abs(vt.ritz_lambdas - kj).max() <= LAM_TOL


def test_s1_coarse_span_matches_jax(s1_pair):
    _, _, vj, vt, _ = s1_pair
    Zj, Zt = np.asarray(vj.coarse_Z), vt.coarse_Z.numpy()
    assert Zj.shape == Zt.shape == (2, Zj.shape[1])
    assert sl.subspace_angles(Zj.T, Zt.T).max() <= 1e-4


def test_s1_outer_count_matches_jax(s1_pair):
    sj, st, vj, vt, _ = s1_pair
    rj = sj.solve(tol=1e-8, precond=vj)
    rt = st.solve(tol=1e-8, precond=vt)
    assert rt.converged and rj.converged
    assert abs(rt.iterations - rj.iterations) <= max(3, 0.25 * rj.iterations), (rt.iterations, rj.iterations)


def test_ritz_modes_are_in_the_memo_key(s1_pair):
    _, st, _, vt, _ = s1_pair
    assert st.lattice_preconditioner(ritz_modes=2) is vt
    plain = st.lattice_preconditioner()
    assert plain is not vt and plain.coarse_Z is None and plain.ritz_lambdas is None
    assert st.lattice_preconditioner(ritz_modes=2, ritz_arnoldi=10) is not vt


def test_s5_kept_lambdas_match_jax(s5_pair):
    _, _, _, vt, lam = s5_pair
    kj = _kept(lam, 4)
    assert len(kj) == 4 and vt.ritz_lambdas.shape == (4,)
    assert np.abs(vt.ritz_lambdas - kj).max() <= LAM_TOL


def test_s5_coarse_span_matches_jax_after_the_fourier_modes(s5_pair):
    """The Ritz modes come after S5's closed-form coarse space, as in JAX,
    and are orthogonal to the collective rigid modes they were kept from."""
    _, st, vj, vt, _ = s5_pair
    Zj, Zt = np.asarray(vj.coarse_Z), vt.coarse_Z.numpy()
    assert Zj.shape == Zt.shape
    assert sl.subspace_angles(Zj.T, Zt.T).max() <= 1e-3
    assert sl.subspace_angles(Zj[-4:].T, Zt[-4:].T).max() <= 1e-3
    plain = st.lattice_preconditioner(coupled=False)
    assert np.array_equal(Zt[:-4], plain.coarse_Z.numpy())
    names = list(st.op.system.fields)
    for mode in st.rigid_modes():
        q = torch.cat([torch.broadcast_to(mode[n], st.op.system.fields[n].dof_shape).reshape(-1) for n in names])
        assert np.abs(Zt[-4:] @ q.numpy()).max() <= 1e-8 * float(torch.linalg.vector_norm(q))


def test_s5_deflated_outer_count_matches_jax(s5_pair):
    sj, st, vj, vt, _ = s5_pair
    rj = sj.solve(tol=1e-8, precond=vj)
    rt = st.solve(tol=1e-8, precond=vt)
    assert rt.converged and rj.converged
    assert abs(rt.iterations - rj.iterations) <= max(3, 0.25 * rj.iterations), (rt.iterations, rj.iterations)
