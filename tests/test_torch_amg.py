"""Port parity of smoothed-aggregation AMG (``phifem_tpu_torch/amg.py``)
against ``phifem_tpu.amg``, and the ELL sweep kernel
(``phifem_tpu_torch/ops/cuda_amg.py``) against its plain version.

On the CPU (float64 unless stated):

* the plain ELL sweep against a dense numpy product, 1e-13 relative, in
  every mode (the prolongation's add against the product plus the base
  vector) on synthetic ELL tables made from a seed: padded slots, empty
  (all-pad) rows, width 1, one row of width 64, a rectangular R, the
  widths 5, 7, 8, 17, 23, 111 and 130 (every lane group and chunk
  remainder of the kernel), row counts that are no multiple of the
  kernel's 256-thread CTA or of a lane group's rows; and its argument
  checks;
* the group size per table (``lanes_for``) at the widths of the S1-U n=800
  hierarchy, and the one each AMG level keeps;
* the V-cycle (first sweep in closed form, the prolongation's add fused)
  equal by ``torch.equal`` to the composition it replaced (a Jacobi sweep
  from zero, a separate apply and add) on the carried JAX tables, float32
  and float64, with one and two pre-smoothing sweeps;
* the bulk block of S1 on the perturbed mesh (n = 16): the aggregates of the
  same scipy matrix equal; ``build_amg``'s ELL tables, inverse diagonals
  and coarse pseudo-inverse equal in float64 and float32;
* one V-cycle on JAX's tables carried by ``utils.convert.amg_from_numpy``:
  1e-12 relative in float64, 1e-5 relative in float32;
* the S1 solve with ``amg_preconditioner()``: the solution to 1e-6 of JAX's
  and the counts within max(3, 0.25 it), the allowance of the port's
  float64 Krylov dots.

JAX is imported inside the fixtures that need it, so that the ``cuda``
cases (the kernel against the plain version by ``torch.equal`` in every
mode and at every group size, float32 and float64, on the synthetic
tables; the V-cycle on the card against its composition from the plain
versions on the card, on a scipy Laplacian)
also run on a machine without it:
``python -m pytest tests/test_torch_amg.py -q -m cuda``.
"""

import numpy as np
import pytest
import torch

from phifem_tpu_torch import amg as tamg
from phifem_tpu_torch.ops import cuda_amg as ca
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

SEED = 0
MODES = [ca.APPLY, ca.RESIDUAL, ca.JACOBI, ca.PROLONG_ADD]
MODE_IDS = ["apply", "residual", "jacobi", "prolong_add"]
#: case -> (rows, columns, width)
SHAPES = {"ragged": (1001, 1001, 9), "width1": (300, 300, 1), "wide64": (257, 257, 64), "rect": (100, 901, 12),
          "w5": (1003, 1003, 5), "w7": (777, 777, 7), "w8": (260, 260, 8), "w17": (131, 131, 17),
          "w23": (300, 905, 23), "w111": (45, 400, 111), "w130": (33, 500, 130)}
SYNTH = list(SHAPES)


def synthetic(case: str, dtype=torch.float64, device="cpu", seed: int = SEED):
    """``(cols (w, n) int32, vals (w, n), x, b, d, dense (n, n_x))``: an ELL
    table with padded slots (column n_x, value 0) and its dense matrix."""
    rng = np.random.default_rng(seed)
    n, n_x, w = SHAPES[case]
    nnz = rng.integers(0, w + 1, n)
    if case == "wide64":
        nnz = rng.integers(1, 8, n)
        nnz[17] = 64  # the one row of full width
    nnz[::97] = 0  # empty rows: every slot padded
    cols = np.full((n, w), n_x, np.int64)
    vals = np.zeros((n, w))
    dense = np.zeros((n, n_x))
    for i in range(n):
        c = np.sort(rng.choice(n_x, nnz[i], replace=False))
        v = rng.standard_normal(nnz[i])
        cols[i, : nnz[i]], vals[i, : nnz[i]] = c, v
        dense[i, c] = v
    t = lambda a, dt=dtype: torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)
    x, b, d = rng.standard_normal(n_x), rng.standard_normal(n), rng.uniform(0.1, 1.0, n)
    return t(cols.T, torch.int32), t(vals.T), t(x), t(b), t(d), dense


def square(case: str) -> bool:
    return SHAPES[case][0] == SHAPES[case][1]


@pytest.mark.parametrize("case", SYNTH)
@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_plain_sweep_against_dense(case, mode):
    cols, vals, x, b, d, dense = synthetic(case)
    lanes = ca.lanes_for(*cols.shape[::-1])
    if mode == ca.JACOBI and not square(case):
        with pytest.raises(ValueError, match="square"):
            ca.amg_ell_sweep(mode, cols, vals, x, b, d, lanes=lanes)
        return
    y = ca.amg_ell_sweep(mode, cols, vals, x, b, d, lanes=lanes).numpy()
    ax = dense @ x.numpy()
    want = {ca.APPLY: ax, ca.PROLONG_ADD: b.numpy() + ax}.get(mode, b.numpy() - ax)
    if mode == ca.JACOBI:
        want = x.numpy() + d.numpy() * want
    assert np.abs(y - want).max() <= 1e-13 * max(np.abs(want).max(), 1.0)
    if mode == ca.APPLY:
        assert (y[::97] == 0.0).all()  # empty rows: exact zeros


def test_sweep_argument_checks():
    cols, vals, x, b, d, _ = synthetic("ragged")
    with pytest.raises(ValueError, match="unknown mode"):
        ca.amg_ell_sweep(5, cols, vals, x, lanes=1)
    with pytest.raises(TypeError, match="int32"):
        ca.amg_ell_sweep(ca.APPLY, cols.long(), vals, x, lanes=1)
    with pytest.raises(ValueError, match="b must be"):
        ca.amg_ell_sweep(ca.RESIDUAL, cols, vals, x, lanes=1)
    with pytest.raises(ValueError, match="d must be"):
        ca.amg_ell_sweep(ca.JACOBI, cols, vals, x, b, lanes=1)
    with pytest.raises(ValueError, match="dtype"):
        ca.amg_ell_sweep(ca.APPLY, cols, vals, x.float(), lanes=1)
    with pytest.raises(ValueError, match="no kernel"):
        ca.amg_ell_sweep(ca.APPLY, cols.to("meta"), vals.to("meta"), x.to("meta"), lanes=1)
    with pytest.raises(ValueError, match="b must be"):
        ca.amg_ell_sweep(ca.PROLONG_ADD, cols, vals, x, lanes=1)
    with pytest.raises(ValueError, match="lanes"):
        ca.amg_ell_sweep(ca.APPLY, cols, vals, x, lanes=3)
    with pytest.raises(TypeError, match="lanes"):
        ca.amg_ell_sweep(ca.APPLY, cols, vals, x)  # every call names its group size


#: (rows, width) of every table of the S1-U n=800 hierarchy (PERF.md §5):
#: A, P and R of levels 0-3, and the group size each gets
N800_TABLES = {(244349, 7): 1, (244349, 5): 1, (41824, 23): 4, (41824, 19): 4, (41824, 9): 2, (5765, 57): 8,
               (5765, 38): 8, (5765, 12): 4, (742, 111): 32, (742, 64): 32, (742, 15): 16, (123, 110): 32}


def test_lanes_per_table():
    assert {k: ca.lanes_for(*k) for k in N800_TABLES} == N800_TABLES
    for n, w in N800_TABLES:
        lanes = ca.lanes_for(n, w)
        assert -(-w // lanes) <= ca.CHUNK[lanes] or lanes == 32  # one chunk per lane
        assert lanes == 1 or n * lanes // 2 < ca.FILL or -(-w // (lanes // 2)) > ca.CHUNK[lanes // 2]
    assert ca.lanes_for(10, 1) == 1 and ca.lanes_for(10, 5) == 8 and ca.lanes_for(3, 1000) == 32
    amg = laplacian_amg(torch.float64)
    for lvl in amg.levels:
        assert lvl.e_lanes == ca.lanes_for(lvl.n, lvl.ecols.shape[0])
        if lvl.p_cols is not None:
            assert lvl.p_lanes == ca.lanes_for(lvl.n, lvl.p_cols.shape[0])
            assert lvl.r_lanes == ca.lanes_for(lvl.r_cols.shape[1], lvl.r_cols.shape[0])


def laplacian_amg(dtype, device="cpu", m: int = 40, **kw):
    """build_amg of the 5-point Laplacian on an m x m grid (scipy)."""
    import scipy.sparse as sp

    t = sp.diags([-np.ones(m - 1), 2 * np.ones(m), -np.ones(m - 1)], [-1, 0, 1])
    A = (sp.kron(sp.eye(m), t) + sp.kron(t, sp.eye(m))).tocsr()
    return tamg.build_amg(A, dtype=dtype, max_coarse=20, device=device, **kw)


def composed_cycle(amg, k: int, b: torch.Tensor, sweep=ca.amg_ell_sweep_ref) -> torch.Tensor:
    """The V-cycle as JAX composes it: Jacobi sweeps from zero, the
    prolongation applied, then added; each ELL product by ``sweep`` (by
    default the plain version; ``scripts/tune_torch_amg.py`` passes an
    older kernel's)."""
    lvl = amg.levels[k]
    if k == len(amg.levels) - 1:
        return amg.coarse_inv @ b
    x = torch.zeros_like(b)
    for _ in range(amg.pre_smooth):
        x = sweep(ca.JACOBI, lvl.ecols, lvl.evals, x, b, lvl.jac_diag)
    r = sweep(ca.RESIDUAL, lvl.ecols, lvl.evals, x, b)
    ec = composed_cycle(amg, k + 1, sweep(ca.APPLY, lvl.r_cols, lvl.r_vals, r), sweep)
    x = x + sweep(ca.APPLY, lvl.p_cols, lvl.p_vals, ec)
    for _ in range(amg.post_smooth):
        x = sweep(ca.JACOBI, lvl.ecols, lvl.evals, x, b, lvl.jac_diag)
    return x


# ------------------------------------------------------------ the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", SYNTH)
def test_kernel_equals_plain_version(cuda, case, dtype):
    cols, vals, x, b, d, _ = synthetic(case, dtype, cuda)
    for mode in MODES:
        if mode == ca.JACOBI and not square(case):
            continue
        want = ca.amg_ell_sweep_ref(mode, cols, vals, x, b, d)
        for lanes in ca.LANES:
            before = ca.launches
            y = ca.amg_ell_sweep(mode, cols, vals, x, b, d, lanes=lanes)
            torch.cuda.synchronize()
            assert ca.launches == before + 1
            assert torch.equal(y, want), (case, mode, lanes)
            assert torch.equal(torch.signbit(y), torch.signbit(want)), (case, mode, lanes)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_vcycle_on_card_equals_composed_cycle(cuda, dtype):
    amg = laplacian_amg(dtype, cuda)
    b = torch.as_tensor(np.random.default_rng(SEED + 2).standard_normal(amg.levels[0].n), dtype=dtype, device=cuda)
    before = ca.launches
    z = amg(b)
    torch.cuda.synchronize()
    assert ca.launches - before == 4 * (len(amg.levels) - 1)  # residual, R, P with its add, post sweep
    # the plain versions on the card, with the same coarse product (cuBLAS,
    # whose sums are not the CPU's)
    assert torch.equal(z, composed_cycle(amg, 0, b))


# --------------------------------------------------- against the JAX package
@pytest.fixture(scope="module")
def s1():
    pytest.importorskip("jax")
    from torch_u_cases import schemes

    return schemes("s1", 16)


@pytest.fixture(scope="module")
def bulk(s1):
    """The S1 bulk block (u field) as the port assembles it, a scipy CSR."""
    from phifem_tpu_torch.mg import data_dependent_selection
    from phifem_tpu_torch.solvers import masked_operator

    _, st, _, _ = s1
    _, _, active = masked_operator(st.op, ())
    sel = data_dependent_selection(st.op, active)
    bulk = active["u"].numpy() & ~sel["u"]
    A, _ = st.op.restricted_csr({"u": bulk, "p": np.zeros_like(bulk)})
    return A


def test_aggregates_equal(bulk):
    import phifem_tpu.amg as jamg

    for theta in (0.08, 0.25):
        aj, naj = jamg._aggregate(bulk, theta)
        at, nat = tamg._aggregate(bulk, theta)
        assert (nat == naj) and np.array_equal(at, aj)
    dinv = 1.0 / bulk.diagonal()
    assert tamg._spectral_radius(bulk, dinv) == jamg._spectral_radius(bulk, dinv)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_hierarchy_tables_equal(bulk, dtype):
    import jax.numpy as jnp
    import phifem_tpu.amg as jamg

    jh = jamg.build_amg(bulk, dtype=getattr(jnp, dtype), max_coarse=10)
    th = tamg.build_amg(bulk, dtype=getattr(torch, dtype), max_coarse=10, device="cpu")
    assert (len(th.levels) == len(jh.levels)) and (len(jh.levels) >= 3)
    for lj, lt in zip(jh.levels, th.levels):
        assert lt.n == lj.n
        for name in ("ecols", "evals", "p_cols", "p_vals", "r_cols", "r_vals"):
            a, b = getattr(lt, name), getattr(lj, name)
            if b is None:
                assert a is None
                continue
            assert np.array_equal(a.numpy().T, np.asarray(b)), name
        assert np.array_equal(lt.inv_diag.numpy(), np.asarray(lj.inv_diag))
    assert np.array_equal(th.coarse_inv.numpy(), np.asarray(jh.coarse_inv))
    assert [s[:2] for s in th.setup_levels] == [(l.n, l.ecols.shape[1]) for l in jh.levels]


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-12), ("float32", 1e-5)])
def test_one_vcycle_on_carried_tables(bulk, dtype, tol):
    import jax.numpy as jnp
    import phifem_tpu.amg as jamg
    from phifem_tpu_torch.utils.convert import amg_from_numpy

    jh = jamg.build_amg(bulk, dtype=getattr(jnp, dtype), max_coarse=10)
    levels = [{k: (None if getattr(l, k) is None else np.asarray(getattr(l, k)))
               for k in ("ecols", "evals", "inv_diag", "p_cols", "p_vals", "r_cols", "r_vals")} for l in jh.levels]
    th = amg_from_numpy(levels, np.asarray(jh.coarse_inv), dtype=getattr(torch, dtype), device="cpu")
    b = np.random.default_rng(SEED + 1).standard_normal(bulk.shape[0])
    zj = np.asarray(jh(jnp.asarray(b, getattr(jnp, dtype))), np.float64)
    zt = th(torch.as_tensor(b, dtype=getattr(torch, dtype))).double().numpy()
    assert np.abs(zt - zj).max() <= tol * np.abs(zj).max()


@pytest.mark.parametrize("pre_smooth", [1, 2])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_vcycle_equals_composed_cycle(bulk, dtype, pre_smooth):
    import jax.numpy as jnp
    import phifem_tpu.amg as jamg
    from phifem_tpu_torch.utils.convert import amg_from_numpy

    jh = jamg.build_amg(bulk, dtype=getattr(jnp, dtype), max_coarse=10)
    levels = [{k: (None if getattr(l, k) is None else np.asarray(getattr(l, k)))
               for k in ("ecols", "evals", "inv_diag", "p_cols", "p_vals", "r_cols", "r_vals")} for l in jh.levels]
    th = amg_from_numpy(levels, np.asarray(jh.coarse_inv), dtype=getattr(torch, dtype), device="cpu",
                        pre_smooth=pre_smooth)
    b = torch.as_tensor(np.random.default_rng(SEED + 3).standard_normal(bulk.shape[0]), dtype=getattr(torch, dtype))
    z = th(b)
    assert torch.equal(z, composed_cycle(th, 0, b))
    assert torch.isfinite(z).all() and z.abs().max() > 0


def test_s1_amg_solve_against_jax(s1):
    sj, st, uj, ut = s1
    rj = sj.solve(method="bicgstab", tol=1e-10, maxiter=500, precond=sj.amg_preconditioner())
    before = ca.launches
    vc = st.amg_preconditioner()
    assert st.amg_preconditioner() is vc  # memoized on the data version
    rt = st.solve(method="bicgstab", tol=1e-10, maxiter=500, precond=vc)
    assert ca.launches == before  # CPU tensors: the plain version
    assert rt.converged and rj.converged
    assert abs(rt.iterations - rj.iterations) <= max(3, 0.25 * rj.iterations), (rt.iterations, rj.iterations)
    for k in ("u", "p"):
        xj = np.asarray(rj.x[k])
        assert np.abs(rt.x[k].numpy() - xj).max() <= 1e-6 * np.abs(xj).max(), k
    assert (set(vc.amgs) == {"u"}) and (vc.amg_levels["u"][0][0] == int(vc.bulk_masks["u"].sum()))
