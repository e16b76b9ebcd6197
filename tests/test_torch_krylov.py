"""Port parity of the outer solvers and small leftovers of slice E.

* ``solvers._pfgmres`` against JAX's on the nonlinear-preconditioner
  problem of ``tests/test_utils.py::test_pfgmres_flexible_nonlinear_
  preconditioner``: the same count, the iterate to 1e-10;
* ``solve(method="gmres")`` (left-preconditioned, restart 50, cycles as
  ``maxiter``) against JAX's on box Poisson and the S1 flower, to 10 tol;
* ``solve_ir`` and ``BoxPoisson.solve_ir`` as ``tests/test_poisson.py::
  test_box_poisson_mixed_precision_ir`` (<= 4 rounds to 1e-12 at n=32,
  the dense solve to 1e-9);
* ``levelset.detection_vector`` bit for bit, ``assembly.assemble_cellwise``
  to 1e-13;
* p-multigrid + fgmres on S3 at Q2 (the demo's tilted square), whose P1
  twin keeps the degree-2 flux (``vector_degree``) and lifts DG0 to degree
  1 in both packages: the same count as JAX, the solution to 1e-8."""

import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import phifem_tpu as pf  # noqa: E402
import phifem_tpu.models as jm  # noqa: E402
import phifem_tpu_torch as pt  # noqa: E402
from phifem_tpu.assembly import CellTerm as JCellTerm  # noqa: E402
from phifem_tpu.assembly import assemble_cellwise as j_assemble_cellwise  # noqa: E402
from phifem_tpu.levelset import detection_vector as j_detection_vector  # noqa: E402
from phifem_tpu.solvers import _pfgmres as j_pfgmres  # noqa: E402
from phifem_tpu_torch.assembly import assemble_cellwise  # noqa: E402
from phifem_tpu_torch.levelset import detection_vector  # noqa: E402
from phifem_tpu_torch.solvers import _pfgmres  # noqa: E402
from torch_s1_cases import flower, rel  # noqa: E402
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

UNIT = ((0.0, 0.0), (1.0, 1.0))


def _fgmres_problem():
    rng = np.random.default_rng(11)
    n = 120
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    A = Q @ np.diag(np.geomspace(1.0, 1e4, n)) @ Q.T  # SPD, cond 1e4
    A = A + 0.05 * rng.standard_normal((n, n))  # mildly nonsymmetric
    return A, rng.standard_normal(n)


def _truncated_cg(S, x0, r, sweeps=15):
    """Inner CG on the symmetric part at a fixed sweep cap: a NONLINEAR map
    of its input (``S``, ``x0`` and ``r`` of one package's array type)."""
    x, p, rr = x0, r, r
    rs = rr @ rr
    for _ in range(sweeps):
        Ap = S @ p
        al = rs / (p @ Ap)
        x = x + al * p
        rr = rr - al * Ap
        rs_new = rr @ rr
        p = rr + (rs_new / rs) * p
        rs = rs_new
    return x


def test_pfgmres_matches_jax_through_a_nonlinear_preconditioner():
    A, b = _fgmres_problem()
    Aj, St = jnp.asarray(A), torch.as_tensor(0.5 * (A + A.T))
    Sj = 0.5 * (Aj + Aj.T)
    At = torch.as_tensor(A)
    xj, itj = j_pfgmres(
        lambda x: {"u": Aj @ x["u"]}, {"u": jnp.asarray(b)}, {"u": jnp.zeros(len(b))},
        tol=1e-10, atol=0.0, maxiter=300, M=lambda r: {"u": _truncated_cg(Sj, jnp.zeros_like(r["u"]), r["u"])},
    )
    xt, itt, rec = _pfgmres(
        lambda x: {"u": At @ x["u"]}, {"u": torch.as_tensor(b)}, {"u": torch.zeros(len(b), dtype=torch.float64)},
        tol=1e-10, atol=0.0, maxiter=300, M=lambda r: {"u": _truncated_cg(St, torch.zeros_like(r["u"]), r["u"])},
    )
    assert itt == int(itj) and itt % 20 == 0 and itt <= 300, (itt, int(itj))
    assert rec <= 1e-10
    assert rel(xt["u"].numpy(), np.asarray(xj["u"])) <= 1e-10
    assert np.allclose(xt["u"].numpy(), np.linalg.solve(A, b), atol=1e-7)


def _box(n, pkg):
    if pkg is pf:
        uex = lambda x: jnp.sin(jnp.pi * x[..., 0]) * jnp.sin(jnp.pi * x[..., 1])
        s = jm.BoxPoisson(pf.Grid(n, n, UNIT, "triangle"))
        s.setup(lambda x: 2.0 * jnp.pi**2 * uex(x))
    else:
        uex = lambda x: torch.sin(math.pi * x[..., 0]) * torch.sin(math.pi * x[..., 1])
        s = pt.BoxPoisson(pt.Grid(n, n, UNIT, "triangle", device="cpu"))
        s.setup(lambda x: 2.0 * math.pi**2 * uex(x))
    return s.assemble()


@pytest.mark.parametrize("case", ["box", "s1"])
def test_gmres_matches_jax(case):
    """Left-preconditioned restarted GMRES: the same solution as JAX's
    ``jax.scipy`` gmres to 10 tol, iterations reported as -1."""
    tol = 1e-10
    if case == "box":
        sj, st = _box(16, pf), _box(16, pt)
        pj, ptc = sj.mg_preconditioner(min_n=4), st.mg_preconditioner(min_n=4)
        rj = sj.solve(method="gmres", tol=tol, maxiter=20, precond=pj)
        rt = st.solve(method="gmres", tol=tol, maxiter=20, precond=ptc)
    else:
        sj, st = flower(24)
        pj = sj.lattice_preconditioner(min_n=6, dtype=jnp.float64)
        ptc = st.lattice_preconditioner(min_n=6, dtype=torch.float64)
        rj = sj.solve(method="gmres", tol=tol, maxiter=20, precond=pj)
        rt = st.solve(method="gmres", tol=tol, maxiter=20, precond=ptc)
    assert rt.iterations == -1 and rj.iterations == -1
    assert rt.converged and rt.recurrence <= tol, rt
    for k in rj.x:
        assert rel(rt.x[k].numpy(), np.asarray(rj.x[k])) <= 10 * tol, k


@pytest.fixture(scope="module")
def box32():
    s = _box(32, pt)
    return s, s.solve(method="dense")


def test_solve_ir_reaches_f64_with_f32_corrections(box32):
    """The oracle of tests/test_poisson.py: float32 MG-CG corrections in a
    float64 loop reach 1e-12 in <= 4 rounds, the dense solve to 1e-9; JAX's
    round count within one."""
    s, ref = box32
    vc = s.mg_preconditioner(min_n=8, dtype=torch.float32)
    res = pt.solve_ir(s.op, s.b, bcs=s.bcs, precond=vc, tol=1e-12, inner_tol=1e-5, inner_maxiter=40)
    assert res.converged and res.residual <= 1e-12, res
    assert res.iterations <= 4, res.iterations
    du = float((res.x["u"] - ref.x["u"]).abs().max())
    assert du < 1e-9 * max(float(ref.x["u"].abs().max()), 1.0), du
    sj = _box(32, pf)
    from phifem_tpu.solvers import solve_ir as j_solve_ir

    rj = j_solve_ir(sj.op, sj.b, bcs=sj.bcs, precond=sj.mg_preconditioner(min_n=8, dtype=jnp.float32),
                    tol=1e-12, inner_tol=1e-5, inner_maxiter=40)
    assert abs(res.iterations - rj.iterations) <= 1, (res.iterations, rj.iterations)
    assert rel(res.x["u"].numpy(), np.asarray(rj.x["u"])) <= 1e-9


@pytest.mark.parametrize("method", ["cg", "bicgstab"])
def test_box_poisson_solve_ir_default_preconditioner(box32, method):
    """``BoxPoisson.solve_ir`` builds ``mg_preconditioner(dtype=float32)``
    itself; both inner methods reach 1e-10 within max_outer=6 rounds."""
    s, ref = box32
    res = s.solve_ir(tol=1e-10, method=method)
    assert res.converged and res.iterations <= 6, res
    assert s.u_h.data is res.x["u"]
    assert res.x["u"].dtype == torch.float64
    du = float((res.x["u"] - ref.x["u"]).abs().max())
    assert du < 1e-8 * max(float(ref.x["u"].abs().max()), 1.0), du


@pytest.mark.parametrize(
    "ct, box, phi",
    [
        ("quadrilateral", ((-1.5, -1.5), (1.5, 1.5)), "line"),
        ("triangle", ((-4.5, -4.5), (4.5, 4.5)), "flower"),
    ],
)
@pytest.mark.parametrize("N", [1, 2])
def test_detection_vector_bit_for_bit(ct, box, phi, N):
    from torch_s1_cases import jflower
    from phifem_tpu_torch.models import flower as tflower

    gj = pf.Grid(10, 10, box, pf.CellType(ct))
    gt = pt.Grid(10, 10, box, pt.CellType(ct), device="cpu")
    if phi == "line":
        fj = ft = lambda x: x[..., 0] + 0.35
    else:
        fj, ft = jflower.detection_levelset, tflower.detection_levelset
    dj = np.asarray(j_detection_vector(gj, fj, N))
    dt = detection_vector(gt, ft, N).numpy()
    assert np.array_equal(dt, dj)
    tags = pt.tag_cells(gt, ft, N).numpy()
    assert np.all(tags[dt == -1.0] == 1) and np.all(tags[dt == 1.0] == 3)
    assert np.all(tags[np.abs(dt) < 1.0] == 2)


@pytest.mark.parametrize("ct", ["triangle", "quadrilateral"])
def test_assemble_cellwise_matches_jax(ct):
    """Per-cell integrals of a P2 field's squared gradient over the cut and
    inside cells, in the DG0 layout, to 1e-13 of JAX's."""
    box = ((-1.0, -1.0), (1.0, 1.0))
    gj = pf.Grid(12, 10, box, pf.CellType(ct))
    gt = pt.Grid(12, 10, box, pt.CellType(ct), device="cpu")
    phi = lambda x: x[..., 0] ** 2 + x[..., 1] ** 2 - 0.5
    tags = pt.tag_cells(gt, phi, 1).numpy()
    fj = pf.interpolate(lambda x: jnp.sin(2 * x[..., 0]) * x[..., 1], pf.Space.lagrange(gj, 2))
    ft = pt.interpolate(lambda x: torch.sin(2 * x[..., 0]) * x[..., 1], pt.Space.lagrange(gt, 2))
    vj = np.asarray(j_assemble_cellwise(
        gj, JCellTerm(lambda d, x, ctx: jnp.sum(d["f"].grad ** 2) + d["f"].val, (1, 2), degree=4),
        {"f": fj}, cell_tags=tags))
    vt = assemble_cellwise(
        gt, pt.CellTerm(lambda d, x, ctx: torch.sum(d["f"].grad ** 2) + d["f"].val, (1, 2), degree=4),
        {"f": ft}, cell_tags=tags).numpy()
    assert vt.shape == (gt.num_cells,)
    assert np.all(vt[tags == 3] == 0.0) and np.any(vt != 0.0)
    assert np.abs(vt - vj).max() <= 1e-13 * np.abs(vj).max()


def test_pmg_on_s3_q2_matches_jax():
    import importlib.util
    from pathlib import Path

    from phifem_tpu_torch.models import neumann_square as tnsq

    path = Path(__file__).resolve().parents[1] / "demo" / "neumann" / "square" / "data.py"
    spec = importlib.util.spec_from_file_location("neumann_square_data", path)
    jnsq = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jnsq)
    kw = dict(mode="bg", detection_degree=1, primal_degree=2, vector_degree=2, levelset_degree=2)
    box = ((-1.0, -1.0), (1.0, 1.0))
    sj = jm.NeumannPoisson(pf.Grid(16, 16, box, pf.CellType.quadrilateral), **kw)
    sj.setup(jnsq.levelset, jnsq.source_term, jnsq.neumann_data, detection_levelset=jnsq.detection_levelset)
    st = pt.NeumannPoisson(pt.Grid(16, 16, box, pt.CellType.quadrilateral, device="cpu"), **kw)
    st.setup(tnsq.levelset, tnsq.source_term, tnsq.neumann_data, detection_levelset=tnsq.detection_levelset)
    sj.assemble()
    st.assemble()
    twin = st._p1_twin()
    assert (twin.primal_degree, twin.vector_degree, twin.auxiliary_degree) == (1, 2, 1)
    rj = sj.solve(method="fgmres", tol=1e-10, maxiter=200, precond=sj.p_multigrid_preconditioner())
    rt = st.solve(method="fgmres", tol=1e-10, maxiter=200, precond=st.p_multigrid_preconditioner())
    assert rt.converged and rt.recurrence <= 1e-10, rt
    assert rt.iterations == int(rj.iterations) == 20, (rt.iterations, rj.iterations)
    for k in rj.x:
        assert rel(rt.x[k].numpy(), np.asarray(rj.x[k])) <= 1e-8, k
