"""Port parity and accuracy of the schemes S2 (strong Dirichlet), S3
(Neumann) and S4 (Robin).

Against the JAX package, on the demos' configurations at small n (S2: the
flower on triangles, n=24; S3: the tilted square on quadrilaterals, n=20;
S4: the tilted square on triangles, n=20; float64, CPU):

* tags bit for bit; the load vector and one operator matvec to 1e-12
  relative (the same float64 sums in another order);
* dense solves to 1e-10 relative (host least squares on the same matrix);
* BiCGStab to 1e-10, iterations within max(3, 25%) of JAX's (the port takes
  float64 Krylov dots and interface tables, JAX float32 ones), solutions
  to 1e-6; S2 with the default (Jacobi) preconditioner, S3/S4 with
  ``lattice_preconditioner()``;
* relative L2/H1 errors of the same u_h to 1e-8.

Port only, the convergence checks of tests/test_schemes.py:105-160 at their
sizes (n=10, 20, dense solves, the circle of radius 0.7).
"""

import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import phifem_tpu as pf  # noqa: E402
import phifem_tpu.models as jm  # noqa: E402
import phifem_tpu_torch as pt  # noqa: E402
from phifem_tpu_torch.models import flower as tflower  # noqa: E402
from phifem_tpu_torch.models import neumann_square as tnsq  # noqa: E402
from phifem_tpu_torch.models import robin_square as trsq  # noqa: E402
from torch_s1_cases import FLOWER_BOX, jflower, random_vec, rel  # noqa: E402

BOX = ((-1.0, -1.0), (1.0, 1.0))
CASES = ["s2", "s3", "s4"]


def _demo_data(*parts):
    path = Path(__file__).resolve().parents[1].joinpath("demo", *parts, "data.py")
    spec = importlib.util.spec_from_file_location("_".join(parts) + "_data", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jnsq = _demo_data("neumann", "square")
jrsq = _demo_data("robin", "square")


def _build(name):
    if name == "s2":
        gj = pf.Grid(24, 24, FLOWER_BOX, pf.CellType.triangle)
        gt = pt.Grid(24, 24, FLOWER_BOX, pt.CellType.triangle)
        sj = jm.StrongDirichletPoisson(gj, mode="bg", detection_degree=1)
        sj.setup(jflower.levelset, jflower.source_term, detection_levelset=jflower.detection_levelset)
        st = pt.StrongDirichletPoisson(gt, mode="bg", detection_degree=1)
        st.setup(tflower.levelset, tflower.source_term, detection_levelset=tflower.detection_levelset)
    elif name == "s3":
        gj = pf.Grid(20, 20, BOX, pf.CellType.quadrilateral)
        gt = pt.Grid(20, 20, BOX, pt.CellType.quadrilateral)
        sj = jm.NeumannPoisson(gj, mode="bg", detection_degree=1, levelset_degree=2)
        sj.setup(jnsq.levelset, jnsq.source_term, jnsq.neumann_data, detection_levelset=jnsq.detection_levelset)
        st = pt.NeumannPoisson(gt, mode="bg", detection_degree=1, levelset_degree=2)
        st.setup(tnsq.levelset, tnsq.source_term, tnsq.neumann_data, detection_levelset=tnsq.detection_levelset)
    else:
        gj = pf.Grid(20, 20, BOX, pf.CellType.triangle)
        gt = pt.Grid(20, 20, BOX, pt.CellType.triangle)
        sj = jm.RobinPoisson(gj, mode="bg", detection_degree=1, levelset_degree=2, robin_coef=jrsq.robin_coef)
        sj.setup(jrsq.levelset, jrsq.source_term, jrsq.robin_data, detection_levelset=jrsq.detection_levelset)
        st = pt.RobinPoisson(gt, mode="bg", detection_degree=1, levelset_degree=2, robin_coef=trsq.robin_coef)
        st.setup(trsq.levelset, trsq.source_term, trsq.robin_data, detection_levelset=trsq.detection_levelset)
    sj.assemble()
    st.assemble()
    return sj, st


@pytest.fixture(scope="module")
def schemes():
    return {name: _build(name) for name in CASES}


@pytest.fixture(scope="module")
def dense(schemes):
    """Dense (least-squares) solves of each case in both packages, once."""
    return {
        name: (pf.solvers.solve(sj.op, sj.b, method="dense"), st.solve(method="dense"))
        for name, (sj, st) in schemes.items()
    }


@pytest.mark.parametrize("name", CASES)
def test_tags_load_and_operator_match_jax(schemes, name):
    sj, st = schemes[name]
    np.testing.assert_array_equal(st.cell_tags, np.asarray(sj.cell_tags))
    np.testing.assert_array_equal(st.facet_tags, np.asarray(sj.facet_tags))
    assert rel(st.phi_h.data, np.asarray(sj.phi_h.data)) <= 1e-14
    for k in sj.b:
        assert rel(st.b[k], np.asarray(sj.b[k])) <= 1e-12, k
    xj, xt = random_vec(sj.system, 0)
    yj, yt = sj.op.matvec(xj), st.op.matvec(xt)
    for k in yj:
        assert rel(yt[k], yj[k]) <= 1e-12, k


def test_assembly_from_jax_data(schemes):
    """The port's S3 assembled from JAX's interpolated data (phi_h, f_h,
    u_N carried over as numpy) gives JAX's load vector and operator."""
    from phifem_tpu_torch.utils.convert import scheme_data_from_numpy

    sj, _ = schemes["s3"]
    st = pt.NeumannPoisson(pt.Grid(20, 20, BOX, pt.CellType.quadrilateral), mode="bg", levelset_degree=2)
    st.setup(tnsq.levelset, tnsq.source_term, tnsq.neumann_data, detection_levelset=tnsq.detection_levelset)
    scheme_data_from_numpy(
        st, phi_h=np.asarray(sj.phi_h.data), f_h=np.asarray(sj.f_h.data), u_N=np.asarray(sj.u_N.data)
    )
    assert torch.equal(st.phi_h.data, torch.tensor(np.asarray(sj.phi_h.data)))
    st.assemble()
    for k in sj.b:
        assert rel(st.b[k], np.asarray(sj.b[k])) <= 1e-12, k
    xj, xt = random_vec(sj.system, 5)
    yj, yt = sj.op.matvec(xj), st.op.matvec(xt)
    for k in yj:
        assert rel(yt[k], yj[k]) <= 1e-12, k


@pytest.mark.parametrize("name", CASES)
def test_dense_solve_matches_jax(dense, name):
    rj, rt = dense[name]
    for k in rj.x:
        assert rel(rt.x[k], np.asarray(rj.x[k])) <= 1e-10, k


@pytest.mark.parametrize("name", CASES)
def test_bicgstab_matches_jax(schemes, name):
    sj, st = schemes[name]
    kw = dict(tol=1e-10, maxiter=2000)
    if name == "s2":  # the demo's solve: the default (Jacobi) preconditioner
        rj, rt = sj.solve(**kw), st.solve(**kw)
    else:
        rj = sj.solve(precond=sj.lattice_preconditioner(), **kw)
        rt = st.solve(precond=st.lattice_preconditioner(), **kw)
    assert rt.converged and rt.recurrence <= 1e-10, (rt.residual, rt.recurrence)
    assert abs(rt.iterations - rj.iterations) <= max(3, 0.25 * rj.iterations), (rt.iterations, rj.iterations)
    key = "w" if name == "s2" else "u"
    assert rel(rt.x[key], np.asarray(rj.x[key])) <= 1e-6


@pytest.mark.parametrize("name", ["s3", "s4"])
def test_errors_match_jax(schemes, dense, name):
    sj, st = schemes[name]
    uh = pt.Function(st.V, dense[name][1].x["u"])
    uj = pf.Function(sj.V, jnp.asarray(uh.data.numpy()))
    jdata, tdata = (jnsq, tnsq) if name == "s3" else (jrsq, trsq)
    ej = sj.l2_h1_errors(uj, jdata.exact_solution)
    et = st.l2_h1_errors(uh, tdata.exact_solution)
    for k in ("l2", "h10", "h1"):
        assert abs(et[k] - ej[k]) <= 1e-8 * ej[k], (k, et[k], ej[k])
    assert et["h1"] < 0.5


# ------------------------------------------------ convergence (port only)
R = 0.7


def phi_circle(x):
    return x[..., 0] ** 2 + x[..., 1] ** 2 - R**2


def u_ex(x):
    return torch.sin(math.pi * x[..., 0]) * torch.cos(math.pi * x[..., 1])


def f_helmholtz(x):
    return 2.0 * math.pi**2 * u_ex(x) + u_ex(x)


def normal_derivative(x):
    """du/dn with n = grad(phi)/|grad(phi)|."""
    gx = math.pi * torch.cos(math.pi * x[..., 0]) * torch.cos(math.pi * x[..., 1])
    gy = -math.pi * torch.sin(math.pi * x[..., 0]) * torch.sin(math.pi * x[..., 1])
    norm = torch.clamp(2.0 * torch.linalg.norm(x, dim=-1), min=1e-12)
    return (gx * 2.0 * x[..., 0] + gy * 2.0 * x[..., 1]) / norm


def test_strong_dirichlet_convergence():
    def w_ex(x):
        return torch.cos(x[..., 0] + 0.5 * x[..., 1])

    def u_exact(x):
        return phi_circle(x) * w_ex(x)

    def f(x):
        # -Laplacian(phi w) = -(4 w + 2 grad phi . grad w + phi Laplacian w)
        s = x[..., 0] + 0.5 * x[..., 1]
        grad_dot = -2.0 * x[..., 0] * torch.sin(s) - x[..., 1] * torch.sin(s)
        return -(4.0 * torch.cos(s) + 2.0 * grad_dot - 1.25 * phi_circle(x) * torch.cos(s))

    errs = []
    for n in (10, 20):
        s = pt.StrongDirichletPoisson(pt.Grid(n, n, BOX, "triangle"), mode="bg")
        s.setup(phi_circle, f).assemble()
        s.solve(method="dense")
        errs.append(s.l2_h1_errors(s.u_h, u_exact))
    rate = math.log2(errs[0]["l2"] / errs[1]["l2"])
    assert errs[1]["l2"] < 0.05, errs
    assert rate > 1.5, errs


@pytest.mark.parametrize("cell_type", ["quadrilateral", "triangle"])
def test_neumann_convergence(cell_type):
    errs = []
    for n in (10, 20):
        s = pt.NeumannPoisson(pt.Grid(n, n, BOX, cell_type), mode="bg")
        s.setup(phi_circle, f_helmholtz, normal_derivative).assemble()
        s.solve(method="dense")
        errs.append(s.l2_h1_errors(s.u_h, u_ex))
    assert errs[1]["h1"] < 0.2, errs
    assert math.log2(errs[0]["l2"] / errs[1]["l2"]) > 1.3, errs


def test_robin_convergence():
    alpha = 1.0

    def robin_data(x):
        return normal_derivative(x) + alpha * u_ex(x)

    errs = []
    for n in (10, 20):
        s = pt.RobinPoisson(pt.Grid(n, n, BOX, "triangle"), mode="bg", robin_coef=alpha)
        s.setup(phi_circle, f_helmholtz, robin_data).assemble()
        s.solve(method="dense")
        errs.append(s.l2_h1_errors(s.u_h, u_ex))
    assert errs[1]["h1"] < 0.2, errs
    assert math.log2(errs[0]["l2"] / errs[1]["l2"]) > 1.3, errs
