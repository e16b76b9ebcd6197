"""The port's sparse direct solve, deflation and the repairs that came with
S5, against the JAX package where it has the same function.

* ``method="sparse"`` (host SuperLU of the active submatrix) against JAX's
  on box Poisson with a Dirichlet BC (the L2 error to 1e-9 relative, the
  dense path's as well) and on S1 (x to 1e-8 of the dense solution,
  residual below 1e-10; the factor is cached and a ``reassemble``
  refactors);
* the bordered singular solve ``[[A, Q], [Q^T, 0]]`` on a pure-Neumann
  stiffness with the constant as null vector: x equals JAX's to 1e-10,
  has zero mean, and equals the dense minimum-norm solution up to the
  constant;
* deflated CG on the same system: zero component along the null vector and
  the same solution as the sparse path;
* an unknown method raises ``ValueError`` (JAX's error); gmres and fgmres
  solve the deflated singular system as the sparse path does;
  ``lattice_preconditioner`` takes
  ``ritz_arnoldi`` and ``ritz_modes`` (the Ritz modes go after the
  Fourier coarse space) and routes S5's ``sweeps_coef`` of 0.6 to the
  interface solve; the reference's S5 YAML loads.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import phifem_tpu as pf  # noqa: E402
import phifem_tpu_torch as pt  # noqa: E402
from phifem_tpu.assembly import CellTerm as JCellTerm, System as JSystem  # noqa: E402
from phifem_tpu.assembly import assemble_operator as jasm_op, assemble_vector as jasm_vec  # noqa: E402
from phifem_tpu.solvers import DirichletBC as JDirichletBC, solve as jsolve  # noqa: E402
from phifem_tpu.spaces import boundary_dof_mask as jbmask  # noqa: E402
from phifem_tpu_torch.assembly import CellTerm, System, assemble_operator, assemble_vector  # noqa: E402
from phifem_tpu_torch.solvers import DirichletBC  # noqa: E402
from phifem_tpu_torch.spaces import boundary_dof_mask  # noqa: E402
from torch_s1_cases import rel  # noqa: E402
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)


def _stiff_j(u, v, d, x, ctx):
    return jnp.dot(u["u"].grad, v["u"].grad)


def _stiff_t(u, v, d, x, ctx):
    return torch.dot(u["u"].grad, v["u"].grad)


def _mass(u, v, d, x, ctx):
    return u["u"].val * v["u"].val


def _rhs(v, d, x, ctx):
    return d["f"].val * v["u"].val


def _poisson(pkg, n, method):
    """Box Poisson with a homogeneous Dirichlet BC: the L2 error of the
    ``method`` solve against sin(pi x) sin(pi y)."""
    box = ((0.0, 0.0), (1.0, 1.0))
    if pkg == "jax":
        g = pf.Grid(n, n, box, "triangle")
        sp = pf.Space.lagrange(g, 1)
        sys_ = JSystem({"u": sp})
        uex = lambda x: jnp.sin(jnp.pi * x[..., 0]) * jnp.sin(jnp.pi * x[..., 1])
        f_h = pf.interpolate(lambda x: 2.0 * jnp.pi**2 * uex(x), sp)
        op = jasm_op(sys_, g, cell_terms=[(JCellTerm(_stiff_j, None, degree=2, uniform=True), {})])
        b = jasm_vec(sys_, g, cell_terms=[(JCellTerm(_rhs, None, degree=3), {"f": f_h})])
        bc = JDirichletBC("u", jbmask(sp), jnp.zeros(sp.dof_shape))
        res = jsolve(op, b, bcs=(bc,), method=method, tol=1e-12)
        xy = np.asarray(sp.dof_coords)
    else:
        g = pt.Grid(n, n, box, "triangle", device="cpu")
        sp = pt.Space.lagrange(g, 1)
        sys_ = System({"u": sp})
        uex = lambda x: torch.sin(np.pi * x[..., 0]) * torch.sin(np.pi * x[..., 1])
        f_h = pt.interpolate(lambda x: 2.0 * np.pi**2 * uex(x), sp)
        op = assemble_operator(sys_, g, cell_terms=[(CellTerm(_stiff_t, None, degree=2, uniform=True), {})])
        b = assemble_vector(sys_, g, cell_terms=[(CellTerm(_rhs, None, degree=3), {"f": f_h})])
        bc = DirichletBC("u", boundary_dof_mask(sp), torch.zeros(sp.dof_shape, dtype=torch.float64))
        res = pt.solve(op, b, bcs=(bc,), method=method, tol=1e-12)
        xy = sp.dof_coords.numpy()
    assert res.converged, res.residual
    u = np.asarray(res.x["u"]).reshape(-1)
    return float(np.linalg.norm(u - np.sin(np.pi * xy[:, 0]) * np.sin(np.pi * xy[:, 1]))), u


def test_sparse_matches_dense_and_jax_on_poisson():
    e_sp, u_sp = _poisson("port", 10, "sparse")
    e_dn, _ = _poisson("port", 10, "dense")
    e_j, u_j = _poisson("jax", 10, "sparse")
    assert np.isclose(e_sp, e_dn, rtol=1e-9) and np.isclose(e_sp, e_j, rtol=1e-9)
    assert rel(u_sp, u_j) <= 1e-10


def test_sparse_on_s1_matches_dense_and_refactors():
    phi = lambda x: x[..., 0] ** 2 + x[..., 1] ** 2 - 0.49
    uex = lambda x: torch.cos(x[..., 0]) * torch.sin(x[..., 1])
    s = pt.WeakDirichletPoisson(pt.Grid(12, 12, ((-1.0, -1.0), (1.0, 1.0)), "triangle", device="cpu"), mode="bg")
    s.setup(phi, lambda x: 2.0 * uex(x), u_D=uex).assemble()
    rd = pt.solve(s.op, s.b, method="dense")
    rs = pt.solve(s.op, s.b, method="sparse")
    assert rs.residual < 1e-10
    for k in rd.x:
        assert float((rd.x[k] - rs.x[k]).abs().max()) < 1e-8 * float(rd.x[k].abs().max()), k
    lu1 = s.op._splu_cache[1]
    pt.solve(s.op, s.b, method="sparse")
    assert s.op._splu_cache[1] is lu1
    s.phi_h.data = 2.0 * s.phi_h.data
    s.op.reassemble()
    r2 = pt.solve(s.op, s.b, method="sparse")
    assert s.op._splu_cache[1] is not lu1 and r2.residual < 1e-10


def _neumann_pair():
    """Pure-Neumann stiffness on a 6 x 5 grid (null space: constants) and
    a compatible RHS, in both packages: ``((op, b, const), (op, b, const))``."""
    box = ((0.0, 0.0), (2.0, 1.0))
    out = []
    for pkg in ("jax", "port"):
        if pkg == "jax":
            g = pf.Grid(6, 5, box, "triangle")
            sp = pf.Space.lagrange(g, 1)
            sys_ = JSystem({"u": sp})
            op = jasm_op(sys_, g, cell_terms=[(JCellTerm(_stiff_j, None, degree=2, uniform=True), {})])
            M = jasm_op(sys_, g, cell_terms=[(JCellTerm(_mass, None, degree=2, uniform=True), {})])
            f = pf.interpolate(lambda x: x[..., 0] - 1.0, sp)
            out.append((op, M.matvec({"u": f.data}), {"u": jnp.ones(sp.dof_shape)}))
        else:
            g = pt.Grid(6, 5, box, "triangle", device="cpu")
            sp = pt.Space.lagrange(g, 1)
            sys_ = System({"u": sp})
            op = assemble_operator(sys_, g, cell_terms=[(CellTerm(_stiff_t, None, degree=2, uniform=True), {})])
            M = assemble_operator(sys_, g, cell_terms=[(CellTerm(_mass, None, degree=2, uniform=True), {})])
            f = pt.interpolate(lambda x: x[..., 0] - 1.0, sp)
            out.append((op, M.matvec({"u": f.data}), {"u": torch.ones(sp.dof_shape, dtype=torch.float64)}))
    return out


def test_sparse_solve_bordered_singular():
    (opj, bj, cj), (op, b, c) = _neumann_pair()
    r_sp = pt.solve(op, b, method="sparse", deflate=(c,))
    r_de = pt.solve(op, b, method="dense")
    r_j = jsolve(opj, bj, method="sparse", deflate=(cj,))
    assert r_sp.residual < 1e-10
    x_sp = r_sp.x["u"].numpy().reshape(-1)
    x_de = r_de.x["u"].numpy().reshape(-1)
    assert rel(x_sp, np.asarray(r_j.x["u"]).reshape(-1)) <= 1e-10
    assert abs(x_sp.sum()) < 1e-8 * np.linalg.norm(x_sp) * len(x_sp) ** 0.5
    d = x_sp - x_de
    d -= d.mean()
    assert np.linalg.norm(d) < 1e-8 * np.linalg.norm(x_de)


def test_deflated_cg_on_singular_system():
    _, (op, b, c) = _neumann_pair()
    r = pt.solve(op, b, method="cg", tol=1e-12, deflate=(c,))
    r_sp = pt.solve(op, b, method="sparse", deflate=(c,))
    assert r.converged and r.residual <= 1e-11
    x = r.x["u"].numpy().reshape(-1)
    assert abs(x.sum()) < 1e-8 * np.linalg.norm(x) * len(x) ** 0.5
    assert rel(x, r_sp.x["u"].numpy().reshape(-1)) <= 1e-8


def test_unknown_and_unported_methods_raise():
    _, (op, b, c) = _neumann_pair()
    with pytest.raises(ValueError, match="Unknown method"):
        pt.solve(op, b, method="nope")
    # gmres and fgmres, ported since, solve the deflated singular system as
    # the sparse bordered solve does
    r_sp = pt.solve(op, b, method="sparse", deflate=(c,))
    for m in ("gmres", "fgmres"):
        r = pt.solve(op, b, method=m, deflate=(c,), tol=1e-12)
        assert r.converged, (m, r)
        assert abs(float(r.x["u"].mean())) < 1e-10, m
        assert rel(r.x["u"].numpy(), r_sp.x["u"].numpy()) <= 1e-8, m


@pytest.fixture(scope="module")
def s5_port():
    from torch_s5_cases import port_s5

    return port_s5(16)


def test_lattice_preconditioner_takes_ritz_arnoldi_and_s5_sweeps_coef(s5_port, monkeypatch):
    import phifem_tpu_torch.mg as tmg

    seen = []
    real = tmg.attach_interface_solve

    def spy(vc, op, active, **kw):
        seen.append(kw)
        return real(vc, op, active, **kw)

    monkeypatch.setattr(tmg, "attach_interface_solve", spy)
    vc = s5_port.lattice_preconditioner(coupled=False, ritz_arnoldi=12, refresh=True)
    assert seen == [{"sweeps_coef": 0.6}]
    assert vc.coarse_Z is not None
    # ritz_arnoldi is an argument of its own, not an interface keyword, and
    # an explicit sweeps_coef wins over the scheme's
    s5_port.lattice_preconditioner(coupled=False, sweeps_coef=0.3, refresh=True)
    assert seen[-1] == {"sweeps_coef": 0.3}
    # the Ritz modes are ported: they go after the Fourier coarse space
    vr = s5_port.lattice_preconditioner(coupled=False, ritz_modes=2, ritz_arnoldi=12)
    assert seen[-1] == {"sweeps_coef": 0.6}
    assert vr.coarse_Z.shape[0] == vc.coarse_Z.shape[0] + len(vr.ritz_lambdas) > vc.coarse_Z.shape[0]


def test_s1_keeps_the_default_sweeps_coef(monkeypatch):
    import phifem_tpu_torch.mg as tmg

    seen = []
    real = tmg.attach_interface_solve
    monkeypatch.setattr(tmg, "attach_interface_solve", lambda vc, op, a, **kw: seen.append(kw) or real(vc, op, a, **kw))
    circle = lambda x: x[..., 0] ** 2 + x[..., 1] ** 2 - 0.49
    s = pt.WeakDirichletPoisson(pt.Grid(16, 16, ((-1.0, -1.0), (1.0, 1.0)), device="cpu"), mode="bg")
    s.setup(circle, lambda x: torch.ones(x.shape[:-1], dtype=x.dtype)).assemble()
    s.lattice_preconditioner(min_n=4)
    assert seen == [{"sweeps_coef": 0.2}]


def test_load_reference_s5_yaml():
    from phifem_tpu.utils.config import load_config as jload
    from phifem_tpu_torch.utils.config import load_config

    path = "demo/interface-elasticity/param1.yaml"
    cfg = load_config(path)
    assert cfg.initial_mesh_size == 0.2 and cfg.num_iterations == 5
    assert cfg.mode == "bg" and cfg.bbox == ((-1.5, -1.5), (1.5, 1.5))
    assert cfg.resolve_resolution() == (15, 15)
    assert vars(cfg) == vars(jload(path))
