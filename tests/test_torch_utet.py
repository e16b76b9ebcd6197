"""Port parity of assembly on imported tetrahedral meshes (the tet paths of
``phifem_tpu_torch/uassembly.py`` and ``models/unstructured.py``) against
``phifem_tpu``, float64 on the CPU.

``demo/unstructured/main.py``'s ``main3`` problem on a ``UMesh3.box`` of
[-1, 1]^3 with its interior vertices moved by 0.2 h from a seed: the
sphere r = 0.61, u = cos x sin y cos z, level-set degree 2, bg mode.

* tet spaces of degree 1-3 (edge nodes along ascending vertex ids, one
  node per face at degree 3) and DG0: cell -> DoF maps, DoF coordinates
  and boundary masks bit for bit, ``interpolate`` to 1e-15;
* S1-S4 at n = 5: tags equal, every batch's element matrices, b and one
  operator matvec to 1e-12 relative.  Both packages assemble with their
  quadrature capped at degree 1 (the same rule on both sides, patched into
  both ``uassembly`` modules): XLA takes minutes to compile JAX's tet forms
  at their own degree (up to 125 points per cell), the port none; the card
  holds the full-degree solves to JAX's counts and errors
  (``chip_smoke.py``, ``scripts/reference_amg_counts.py``);
* S1-U's AMG set-up on the bulk of the port's tet operator (n = 12, the
  Kuhn split's rows of 15 slots): JAX's aggregation, the hierarchy's ELL
  tables (float64 and float32) from the same matrix, and one V-cycle on
  JAX's tables carried over (f64 to 1e-12, f32 to 1e-5); on the card
  (marker ``cuda``), the ELL kernel equal to its plain version on every
  table.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import phifem_tpu as pf
import phifem_tpu.uassembly as ju
import phifem_tpu_torch as pt
import phifem_tpu_torch.uassembly as tu
from torch_u_cases import np_t, rel
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

BOX3 = ((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0))
R2 = 0.61**2
TOL = 1e-12
QUAD_CAP = 1


def perturbed(n: int, amp: float = 0.2, seed: int = 0):
    m = pf.UMesh3.box(n, n, n, BOX3)
    v = m.verts.copy()
    interior = (np.abs(np.abs(v) - 1.0) > 1e-12).all(axis=1)
    v[interior] += amp * (2.0 / n) * (np.random.default_rng(seed).random((int(interior.sum()), 3)) - 0.5)
    return v, m.cells


def sphere(x):
    return (x**2).sum(-1) - R2


def problem(lib):
    """(u, f, the normal derivative on the spheres about 0) of main3."""

    def u(x):
        return lib.cos(x[..., 0]) * lib.sin(x[..., 1]) * lib.cos(x[..., 2])

    def nderiv(x):
        g = lib.stack([-lib.sin(x[..., 0]) * lib.sin(x[..., 1]) * lib.cos(x[..., 2]),
                       lib.cos(x[..., 0]) * lib.cos(x[..., 1]) * lib.cos(x[..., 2]),
                       -lib.cos(x[..., 0]) * lib.sin(x[..., 1]) * lib.sin(x[..., 2])], -1)
        r = lib.sqrt((x**2).sum(-1))
        return (g * x).sum(-1) / lib.maximum(r, 1e-12 + 0.0 * r)

    return u, lambda x: 3.0 * u(x), nderiv


def scheme(mod, mesh, name: str, lib):
    u, f, nd = problem(lib)
    if name == "s1":
        return mod.WeakDirichletPoissonU(mesh, mode="bg", levelset_degree=2).setup(sphere, f, u_D=u)
    if name == "s2":
        return mod.StrongDirichletPoissonU(mesh, mode="bg", levelset_degree=2).setup(sphere, f)
    if name == "s3":
        return mod.NeumannPoissonU(mesh, mode="bg", levelset_degree=2).setup(sphere, lambda x: f(x) + u(x), nd)
    return mod.RobinPoissonU(mesh, mode="bg", levelset_degree=2, robin_coef=1.0).setup(
        sphere, lambda x: f(x) + u(x), lambda x: nd(x) + u(x))


@pytest.fixture(scope="module")
def pair():
    v, c = perturbed(3)
    return pf.UMesh3(v, c), pt.UMesh3(v, c, device="cpu")


@pytest.mark.parametrize("degree", [1, 2, 3, 0], ids=["P1", "P2", "P3", "DG0"])
def test_tet_space_tables_bit_for_bit(pair, degree):
    jm, tm = pair
    if degree == 0:
        js, ts = ju.USpace.dg0(jm), tu.USpace.dg0(tm)
    else:
        js, ts = ju.USpace.lagrange(jm, degree, (3,)), tu.USpace.lagrange(tm, degree, (3,))
    assert ts.element.cell == "tetrahedron"
    assert (ts.num_dofs, ts.dof_shape) == (js.num_dofs, js.dof_shape)
    assert np.array_equal(ts.cell_dofs_np, js.cell_dofs_np)
    assert np.array_equal(ts.dof_coords_np, js.dof_coords_np)
    if degree:
        assert np.array_equal(np_t(tu.boundary_dof_mask(ts)), np.asarray(ju.boundary_dof_mask(js)))
        f = lambda x: x[..., 0] ** 3 - 2.0 * x[..., 1] * x[..., 2]
        assert rel(np_t(tu.interpolate(f, tu.USpace.lagrange(tm, degree)).data),
                   ju.interpolate(f, ju.USpace.lagrange(jm, degree)).data) <= 1e-15
    if degree > 1:
        # every global node is reached, and shared nodes sit where each cell puts them
        assert np.array_equal(np.unique(ts.cell_dofs_np), np.arange(ts.num_scalar_dofs))
        phys = tm.map_to_physical(ts.element.nodes)
        assert np.abs(ts.dof_coords_np[ts.cell_dofs_np] - phys).max() <= 1e-14


@pytest.fixture(scope="module", params=["s1", "s2", "s3", "s4"])
def case(request):
    import phifem_tpu.models as jmod
    import phifem_tpu_torch.models as tmod

    v, c = perturbed(5)
    mp = pytest.MonkeyPatch()
    for mod in (ju, tu):
        rule = mod.cell_rule
        mp.setattr(mod, "cell_rule", lambda cell, deg, _r=rule: _r(cell, min(deg, QUAD_CAP)))
    try:
        sj = scheme(jmod, pf.UMesh3(v, c), request.param, jnp)
        sj.assemble()
        st = scheme(tmod, pt.UMesh3(v, c, device="cpu"), request.param, torch).assemble()
    finally:
        mp.undo()
    return request.param, sj, st


def test_tet_element_matrices(case):
    name, sj, st = case
    assert np.array_equal(st.cell_tags, sj.cell_tags) and np.array_equal(st.facet_tags, sj.facet_tags)
    assert set(np.unique(st.cell_tags)) == {1, 2, 3}
    assert len(st.op.batches) == len(sj.op.batches)
    for bj, bt in zip(sj.op.batches, st.op.batches):
        assert [(n, vs) for n, _, vs in bt.segments] == [(n, vs) for n, _, vs in bj.segments]
        for (_, dj, _), (_, dt, _) in zip(bj.segments, bt.segments):
            assert np.array_equal(np_t(dt), np.asarray(dj))
        assert rel(np_t(bt.matrices), bj.matrices) <= TOL, name


def test_tet_matvec_and_rhs(case):
    name, sj, st = case
    rng = np.random.default_rng(3)
    x = {n: rng.standard_normal(s.dof_shape) for n, s in st.system.fields.items()}
    yj = sj.op.matvec({k: jnp.asarray(v) for k, v in x.items()})
    yt = st.op.matvec({k: torch.as_tensor(v) for k, v in x.items()})
    for k in x:
        assert rel(np_t(yt[k]), yj[k]) <= TOL, (name, k)
        assert rel(np_t(st.b[k]), sj.b[k]) <= TOL, (name, k)


# ------------------------------------------------------------------ AMG
def _s1_bulk(device, n=12):
    from phifem_tpu_torch.mg import data_dependent_selection
    from phifem_tpu_torch.solvers import masked_operator
    import phifem_tpu_torch.models as tmod

    st = scheme(tmod, pt.UMesh3.box(n, n, n, BOX3, device=device), "s1", torch).assemble()
    _, _, active = masked_operator(st.op, ())
    sel = data_dependent_selection(st.op, active)
    bulk = active["u"].cpu().numpy() & ~np.asarray(sel["u"])
    A, _ = st.op.restricted_csr({"u": bulk, "p": np.zeros_like(bulk)})
    return A


@pytest.fixture(scope="module")
def bulk():
    return _s1_bulk("cpu")


_TABLES = ("ecols", "evals", "inv_diag", "p_cols", "p_vals", "r_cols", "r_vals")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_tet_amg_tables_equal_jax(bulk, dtype):
    import phifem_tpu.amg as jamg
    from phifem_tpu_torch import amg as tamg

    aj, naj = jamg._aggregate(bulk, 0.08)
    at, nat = tamg._aggregate(bulk, 0.08)
    assert nat == naj and np.array_equal(at, aj)
    jh = jamg.build_amg(bulk, dtype=getattr(jnp, dtype), max_coarse=10)
    th = tamg.build_amg(bulk, dtype=getattr(torch, dtype), max_coarse=10, device="cpu")
    assert len(th.levels) == len(jh.levels) >= 2
    # the Kuhn split: an inner vertex has 14 neighbours, 15 slots a row
    assert th.levels[0].ecols.shape[0] == 15
    for lj, lt in zip(jh.levels, th.levels):
        for name in _TABLES:
            a, b = getattr(lt, name), getattr(lj, name)
            assert (a is None) == (b is None)
            if b is not None:
                a = a.numpy() if name == "inv_diag" else a.numpy().T
                assert np.array_equal(a, np.asarray(b)), name
    assert np.array_equal(th.coarse_inv.numpy(), np.asarray(jh.coarse_inv))


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-12), ("float32", 1e-5)])
def test_tet_one_vcycle_on_carried_tables(bulk, dtype, tol):
    import phifem_tpu.amg as jamg
    from phifem_tpu_torch.utils.convert import amg_from_numpy

    jh = jamg.build_amg(bulk, dtype=getattr(jnp, dtype), max_coarse=10)
    levels = [{k: (None if getattr(l, k) is None else np.asarray(getattr(l, k))) for k in _TABLES}
              for l in jh.levels]
    th = amg_from_numpy(levels, np.asarray(jh.coarse_inv), dtype=getattr(torch, dtype), device="cpu")
    b = np.random.default_rng(9).standard_normal(bulk.shape[0])
    zj = np.asarray(jh(jnp.asarray(b, getattr(jnp, dtype))), np.float64)
    zt = th(torch.as_tensor(b, dtype=getattr(torch, dtype))).double().numpy()
    assert np.abs(zt - zj).max() <= tol * np.abs(zj).max()


def test_umesh3_from_numpy(pair):
    from phifem_tpu_torch.utils.convert import ufunction_from_numpy, umesh3_from_numpy

    jm, _ = pair
    m = umesh3_from_numpy(jm.verts, jm.cells, device="cpu")
    assert np.array_equal(m.facets, jm.facets) and m.device == torch.device("cpu")
    V = tu.USpace.lagrange(m, 2)
    data = np.asarray(ju.interpolate(sphere, ju.USpace.lagrange(jm, 2)).data)
    assert np.array_equal(np_t(ufunction_from_numpy(V, data).data), data)
    with pytest.raises(ValueError):
        ufunction_from_numpy(V, data[:-1])


@pytest.mark.cuda
def test_amg_kernel_on_tet_tables():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from phifem_tpu_torch import amg as tamg
    from phifem_tpu_torch.ops import cuda_amg as ca

    amg = tamg.build_amg(_s1_bulk("cuda", n=24), dtype=torch.float32, device="cuda")
    rng = np.random.default_rng(8)
    for lvl in amg.levels:
        tables = [(lvl.ecols, lvl.evals, lvl.n, (ca.APPLY, ca.RESIDUAL, ca.JACOBI))]
        if lvl.r_cols is not None:
            tables += [(lvl.r_cols, lvl.r_vals, lvl.n, (ca.APPLY,)),
                       (lvl.p_cols, lvl.p_vals, lvl.r_cols.shape[1], (ca.APPLY, ca.PROLONG_ADD))]
        for c, v, n_x, modes in tables:
            x = torch.as_tensor(rng.standard_normal(n_x), dtype=v.dtype, device="cuda")
            b = torch.as_tensor(rng.standard_normal(c.shape[1]), dtype=v.dtype, device="cuda")
            for mode in modes:
                d = lvl.jac_diag if mode == ca.JACOBI else None
                want = ca.amg_ell_sweep_ref(mode, c, v, x, b, d)
                for lanes in ca.LANES:
                    assert torch.equal(ca.amg_ell_sweep(mode, c, v, x, b, d, lanes=lanes), want), (mode, lanes)
