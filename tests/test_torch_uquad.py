"""Port parity of assembly on imported quadrilateral meshes (the bilinear
geometry of ``phifem_tpu_torch/uassembly.py``) against
``phifem_tpu.uassembly``, float64 on the CPU.

Quads in VTK ring order: ``UMesh.from_grid`` copies of the structured quad
grid of [-1, 1]^2 with the interior vertices moved by amp h (U[0, 1) -
1/2) from a seed (``tests/torch_u_cases.py``; amplitude 0.2, the
non-parallelogram cells of ``tests/test_usolve.py``'s quad tests), and the
unmoved copy:

* spaces on quads: cell -> DoF maps (the ring / tensor vertex order, the
  edge direction flips), DoF coordinates (bilinear interior nodes),
  boundary masks of Lagrange degrees 1-3 and DG0, bit for bit;
* the per-point geometry (``_quad_geometry_at``, ``_quad_jacobian``,
  ``_quad_h``) and the Newton inversion of the map (``_quad_invert_map``),
  bit for bit (the same host float64 operations);
* S1-U and S3-U on the perturbed quads and S1-U on the unmoved copy (n =
  6): every batch's element matrices, b and one operator matvec to 1e-12
  relative;
* the facet terms without fields: both packages take the affine formula of
  ``_cell_geometry`` on a quad (ring vertices 0, 1, 2) for their ``h``
  (ROADMAP, "Known faults in the reference"; kept), held on ``assemble_scalar``
  of a boundary term that reads ``ctx.h``;
* the port's Q1 S1-U operator and b against the structured port's S1 on a
  ``from_grid`` copy, to 1e-10 of max|A| (as JAX's
  ``test_uquad_s1_matches_structured_dense``);
* the AMG set-up on the S1-U bulk of a perturbed quad mesh: JAX's
  aggregation and ELL tables from the same matrix; on the card (marker
  ``cuda``), the ELL kernel equal to its plain version on every table of
  the hierarchy.
"""

import numpy as np
import pytest
import torch

import phifem_tpu as pf
import phifem_tpu.uassembly as ju
from phifem_tpu.assembly import BoundaryTerm as JBoundaryTerm
import phifem_tpu_torch as pt
import phifem_tpu_torch.uassembly as tu
from phifem_tpu_torch.quadrature import segment_rule
from torch_u_cases import BOX, meshes, np_t, rel, schemes, u_t
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

N = 6
AMP = 0.2
TOL = 1e-12


@pytest.fixture(scope="module")
def pair():
    return meshes(N, AMP, quad=True)


@pytest.mark.parametrize("degree", [1, 2, 3, 0], ids=["Q1", "Q2", "Q3", "DG0"])
def test_quad_space_tables_bit_for_bit(pair, degree):
    jm, tm = pair
    if degree == 0:
        js, ts = ju.USpace.dg0(jm), tu.USpace.dg0(tm)
    else:
        js, ts = ju.USpace.lagrange(jm, degree, (2,)), tu.USpace.lagrange(tm, degree, (2,))
    assert ts.element.cell == "quadrilateral"
    assert (ts.num_dofs, ts.dof_shape) == (js.num_dofs, js.dof_shape)
    assert np.array_equal(ts.cell_dofs_np, js.cell_dofs_np)
    assert np.array_equal(ts.dof_coords_np, js.dof_coords_np)
    if degree:
        assert np.array_equal(np_t(tu.boundary_dof_mask(ts)), np.asarray(ju.boundary_dof_mask(js)))
        f = lambda x: x[..., 0] ** 3 - 2.0 * x[..., 1] * x[..., 0]
        assert rel(np_t(tu.interpolate(f, tu.USpace.lagrange(tm, degree)).data),
                   ju.interpolate(f, ju.USpace.lagrange(jm, degree)).data) <= 1e-15


def test_quad_geometry_and_inverse_map(pair):
    jm, tm = pair
    cells = np.arange(0, tm.num_cells, 2)
    ref = np.random.default_rng(5).random((7, 2))
    for a, b in zip(tu._quad_geometry_at(tm, cells, ref), ju._quad_geometry_at(jm, cells, ref)):
        assert np.array_equal(a, b)
    V = tm.verts[tm.cells[cells]]
    per_cell = np.broadcast_to(ref[None], (len(cells),) + ref.shape)
    for a, b in zip(tu._quad_jacobian(V, per_cell), ju._quad_jacobian(V, per_cell)):
        assert np.array_equal(a, b)
    assert np.array_equal(tu._quad_h(V), ju._quad_h(V))
    # points of the cells, mapped back: the same Newton steps, and the map's
    # inverse to rounding
    x = tu._quad_geometry_at(tm, cells, ref)[0]
    back = tu._quad_invert_map(tm, cells, x)
    assert np.array_equal(back, ju._quad_invert_map(jm, cells, x))
    assert np.abs(back - ref[None]).max() <= 1e-13
    # the cells are not parallelograms: J varies over them
    Jinv = tu._quad_geometry_at(tm, cells, ref)[1]
    assert np.abs(Jinv - Jinv[:, :1]).max() > 1e-3


CASES = {"s1-perturbed": ("s1", AMP), "s3-perturbed": ("s3", AMP), "s1-from_grid": ("s1", 0.0)}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    name, amp = CASES[request.param]
    return schemes(name, N, amp=amp, quad=True)


def _seeded(system, seed=3):
    rng = np.random.default_rng(seed)
    return {n: rng.standard_normal(s.dof_shape) for n, s in system.fields.items()}


def test_quad_element_matrices(case):
    sj, st, _, _ = case
    assert st.mesh.cell_name == "quadrilateral"
    assert len(st.op.batches) == len(sj.op.batches)
    for bj, bt in zip(sj.op.batches, st.op.batches):
        assert [(n, vs) for n, _, vs in bt.segments] == [(n, vs) for n, _, vs in bj.segments]
        for (_, dj, _), (_, dt, _) in zip(bj.segments, bt.segments):
            assert np.array_equal(np_t(dt), np.asarray(dj))
        assert rel(np_t(bt.matrices), bj.matrices) <= TOL
        assert bt.dynamic == (getattr(bj, "rebuild", None) is not None)


def test_quad_matvec_and_rhs(case):
    sj, st, _, _ = case
    assert np.array_equal(st.cell_tags, sj.cell_tags) and np.array_equal(st.facet_tags, sj.facet_tags)
    x = _seeded(st.system)
    yj = sj.op.matvec({k: np.asarray(v) for k, v in x.items()})
    yt = st.op.matvec({k: torch.as_tensor(v) for k, v in x.items()})
    for k in x:
        assert rel(np_t(yt[k]), yj[k]) <= TOL, k
        assert rel(np_t(st.b[k]), sj.b[k]) <= TOL, k


def test_quad_facet_fallback_equals_jax(pair):
    """A boundary term of callables only (no field on either side): both
    packages take h from the affine formula on the quad's ring vertices 0,
    1, 2 (the longest of its three distances), not the bilinear diameter."""
    jm, tm = pair
    r = pf.compute_tags_measures(jm, lambda x: x[..., 0] ** 2 + x[..., 1] ** 2 - 0.49, 1, box_mode=True)
    rt = pt.compute_tags_measures(tm, lambda x: x[..., 0] ** 2 + x[..., 1] ** 2 - 0.49, 1, box_mode=True)
    fj, ft = r.boundaries_measure(100), rt.boundaries_measure(100)
    assert fj.num_facets > 0

    def integrand(d, x, n, ctx):
        return ctx.h * d["g"].val * n[0] + ctx.h**2

    g_j = lambda x: 1.0 + x[..., 0] * x[..., 1]
    term_j = JBoundaryTerm(integrand, fj, npts=2)
    term_t = pt.BoundaryTerm(integrand, ft, npts=2)
    vj = float(ju.assemble_scalar(jm, boundary_terms=[(term_j, {"g": g_j})]))
    vt = float(tu.assemble_scalar(tm, boundary_terms=[(term_t, {"g": g_j})]))
    assert abs(vt - vj) <= TOL * abs(vj)
    # the h it reads is the affine one: the same sum by hand
    _, _, _, h_aff = tu._cell_geometry(tm, ft.cells)
    V = tm.verts[tm.cells[ft.cells]]
    assert not np.allclose(h_aff, tu._quad_h(V))
    t, w = segment_rule(2)
    ends = tm.facet_endpoints[ft.facets]
    x = ends[:, None, 0] * (1 - t)[None, :, None] + ends[:, None, 1] * t[None, :, None]
    vals = h_aff[:, None] * g_j(x) * ft.normals[:, None, 0] + h_aff[:, None] ** 2
    assert abs((vals * w[None] * ft.lengths[:, None]).sum() - vt) <= TOL * abs(vt)


def test_uquad_s1_matches_structured_port():
    """On a from_grid copy the imported-mesh path builds the structured S1's
    system (Q1 DoFs are vertex ids in both numberings)."""
    n = 8
    phi = lambda x: x[..., 0] ** 2 + x[..., 1] ** 2 - 0.49
    g = pt.Grid(n, n, BOX, pt.CellType.quadrilateral, device="cpu")
    ss = pt.WeakDirichletPoisson(g, mode="bg").setup(phi, lambda x: 2.0 * u_t(x), u_D=u_t).assemble()
    um, _ = pt.UMesh.from_grid(g)
    su = pt.WeakDirichletPoissonU(um, mode="bg").setup(phi, lambda x: 2.0 * u_t(x), u_D=u_t).assemble()
    A_s, A_u = ss.op.to_dense(), su.op.to_dense()
    assert np.abs(A_s - A_u).max() < 1e-10 * np.abs(A_s).max()
    for k in ss.b:
        assert np.abs(np_t(ss.b[k]) - np_t(su.b[k])).max() < 1e-12 * max(np.abs(np_t(ss.b[k])).max(), 1.0), k


# ------------------------------------------------------------------ AMG
def _s1_bulk(device, n=16):
    from phifem_tpu_torch.mg import data_dependent_selection
    from phifem_tpu_torch.solvers import masked_operator

    _, tm = meshes(n, AMP, quad=True)
    if device != "cpu":
        tm = pt.UMesh(tm.verts, tm.cells, device=device)
    s = pt.WeakDirichletPoissonU(tm, mode="bg")
    s.setup(lambda x: x[..., 0] ** 2 + x[..., 1] ** 2 - 0.49, lambda x: 2.0 * u_t(x), u_D=u_t).assemble()
    _, _, active = masked_operator(s.op, ())
    sel = data_dependent_selection(s.op, active)
    bulk = active["u"].cpu().numpy() & ~np.asarray(sel["u"])
    A, _ = s.op.restricted_csr({"u": bulk, "p": np.zeros_like(bulk)})
    return A


def test_quad_amg_tables_equal_jax():
    import jax.numpy as jnp
    import phifem_tpu.amg as jamg
    from phifem_tpu_torch import amg as tamg

    A = _s1_bulk("cpu")
    aj, naj = jamg._aggregate(A, 0.08)
    at, nat = tamg._aggregate(A, 0.08)
    assert nat == naj and np.array_equal(at, aj)
    jh = jamg.build_amg(A, dtype=jnp.float32, max_coarse=10)
    th = tamg.build_amg(A, dtype=torch.float32, max_coarse=10, device="cpu")
    assert len(th.levels) == len(jh.levels) >= 2
    # Q1 rows: 9 slots on the fine level
    assert th.levels[0].ecols.shape[0] == 9
    for lj, lt in zip(jh.levels, th.levels):
        for name in ("ecols", "evals", "p_cols", "p_vals", "r_cols", "r_vals"):
            a, b = getattr(lt, name), getattr(lj, name)
            assert (a is None) == (b is None)
            if b is not None:
                assert np.array_equal(a.numpy().T, np.asarray(b)), name


@pytest.mark.cuda
def test_amg_kernel_on_quad_tables():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from phifem_tpu_torch import amg as tamg
    from phifem_tpu_torch.ops import cuda_amg as ca

    A = _s1_bulk("cuda", n=40)
    amg = tamg.build_amg(A, dtype=torch.float32, device="cuda")
    rng = np.random.default_rng(7)
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
