"""Port parity of the interface band solve (``phifem_tpu_torch/ops/cuda_band.py``)
against the JAX package's (``phifem_tpu/mg.py``: ``band_mv`` / ``band_ras``
inside ``VCycle._band_correct_flat``, and ``_band_bicgstab``).

Bands, each with the Schwarz branch forced: the S1 flower at n=40 (JAX's
tables carried across with ``utils.convert.interface_tables_from_numpy``),
the 3D Neumann scheme at n=8 (``make_interface_apply`` on both sides, JAX's
tables read from its closures and carried across) and S1-U on a tetrahedral
box at n=6 (the port's tables carried into a JAX ``VCycle``), and synthetic
tables with an unowned DoF, a pad id, empty ELL rows and m no multiple of
the dot kernel's chunk.  JAX's own ``band_mv`` / ``band_ras`` are the
closures its ``_band_correct_flat`` hands to ``_band_bicgstab``.

Tolerances, relative to the max of the reference: the plain RAS apply, ELL
product and ordered dots against JAX's (and against the port's former
``einsum`` / ``.sum`` / ``torch.dot`` forms) 1e-13, the change being one of
summation order only; the plain inner solve against JAX's
``_band_bicgstab`` with its dots in float64 (``jnp.float32`` read as
float64 inside ``phifem_tpu.mg``) 1e-12 at 1 and 3 sweeps and 1e-10 at the
band's default count (the fixed-sweep Krylov solve amplifies rounding),
and against the former form 1e-13 / 1e-12 (all measured at least 15x
inside).  The band matrix's sliced table holds each of JAX's ELL rows in its
order, and its plain product equals the former padded ascending sum bit for
bit (``tests/test_torch_band_ell.py`` does the same on synthetic bands; the
RAS table and the fused steps: ``tests/test_torch_band_ras.py``).  On the
card (marker ``cuda``) each kernel (the RAS apply in its three modes, RAS+P,
RAS+S, the ELL product, the dots, XR and SEL), one launch each, and whole
inner solves (8 launches a sweep) are ``torch.equal`` to their plain
versions at K = 6, 8 and 27.
"""

import contextlib

import numpy as np
import pytest
import torch

import phifem_tpu_torch as pt
from phifem_tpu_torch.mg import VCycle, attach_interface_solve
from phifem_tpu_torch.ops import cuda_band as cb
from phifem_tpu_torch.solvers import masked_operator
from test_torch_band_ell import assert_same_bits, check_layout, padded_product
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

SEED = 0
BOX3 = ((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0))


def rel(a, b) -> float:
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def tables_np(tab: cb.BandTables) -> dict:
    """The JAX package's Schwarz fields of a port band (``schwarz_own`` the
    (nb, K) ownership mask)."""
    ids, owner = tab.ids.long().numpy(), tab.owner.long().numpy()
    nb, K = ids.shape
    m = owner.shape[0]
    slot = np.arange(nb * K).reshape(nb, K)
    own = (ids < m) & (np.concatenate([owner, [-1]])[np.minimum(ids, m)] == slot)
    cols, vals = tab.ell_rows()
    return dict(schwarz_ids=ids, schwarz_inv=tab.inv.numpy(), schwarz_own=own, band_ids=np.arange(m),
                band_ell_cols=cols.numpy(), band_ell_vals=vals.numpy())


def synthetic(m: int, nb: int, K: int, w: int, seed: int = SEED, device="cpu") -> cb.BandTables:
    """Random Schwarz tables: blocks of 1..K ascending ids (block 0 ends in a
    pad id), each DoF owned by a random block holding it but for three
    unowned ones (and any that no block holds), ELL rows of 1..w slots with
    a dominant diagonal, the first two rows empty (all pad), and as block
    inverses the blocks' inverse diagonals, perturbed."""
    rng = np.random.default_rng(seed)
    ids = np.full((nb, K), m, np.int64)
    for b in range(nb):
        k = rng.integers(1, K + 1)
        ids[b, :k] = np.sort(rng.choice(m, k, replace=False))
    ids[0, -1] = m
    owner = np.full(m, nb * K, np.int64)
    held = np.argwhere(ids < m)
    rng.shuffle(held)
    owner[ids[held[:, 0], held[:, 1]]] = held[:, 0] * K + held[:, 1]
    owner[rng.choice(m, min(3, m - 1), replace=False)] = nb * K
    cols = np.full((m, w), m, np.int64)
    vals = np.zeros((m, w))
    for i in range(m):
        k = rng.integers(1, w + 1)
        cols[i, :k] = rng.choice(m, k, replace=False)
        cols[i, 0] = i
        vals[i, :k] = rng.standard_normal(k)
        vals[i, 0] += 2.0 * w
    cols[: min(2, m - 1)] = m
    vals[: min(2, m - 1)] = 0.0
    # block inverses: the inverse diagonal of each block's rows, perturbed
    diag = np.where(cols[:, 0] == np.arange(m), vals[:, 0], 1.0)
    inv = 1e-3 * rng.standard_normal((nb, K, K))
    k = np.arange(K)
    inv[:, k, k] += 1.0 / np.concatenate([diag, [1.0]])[ids]
    return cb.band_tables(ids, inv, owner, cols, vals, device)


# ------------------------------------------------- the former plain forms
def old_ops(tab: cb.BandTables):
    """The port's former band product (``.sum`` over the (m, nnz) rows) and
    RAS apply (``einsum`` over every block entry, then the owner gather), on
    the row-major tables they read."""
    dev = tab.ras_cols.device
    cols, vals = (t.to(dev) for t in tab.ell_rows())
    inv, ids, owner = tab.inv.to(dev), tab.ids.to(dev).long(), tab.owner.to(dev).long()

    def mv(v):
        return (vals * torch.cat([v, v.new_zeros(1)])[cols]).sum(dim=1)

    def ras(v):
        blk = torch.einsum("bkl,bl->bk", inv, torch.cat([v, v.new_zeros(1)])[ids])
        return torch.cat([blk.reshape(-1), v.new_zeros(1)])[owner]

    return mv, ras


def old_bicgstab(mv, M, b, iters):
    """The port's former ``mg._band_bicgstab`` (``torch.dot``)."""
    safe = lambda d: torch.where(torch.abs(d) > 1e-300, d, torch.full_like(d, 1e-300))
    x = torch.zeros_like(b)
    r, rhat = b, b
    p = v = torch.zeros_like(b)
    rho = alpha = omega = torch.ones((), dtype=b.dtype, device=b.device)
    xb, rrb = x, torch.dot(b, b)
    for i in range(iters):
        rho_new = torch.dot(rhat, r)
        p = r if i == 0 else r + ((rho_new / safe(rho)) * (alpha / safe(omega))) * (p - omega * v)
        ph = M(p)
        v = mv(ph)
        alpha = rho_new / safe(torch.dot(rhat, v))
        s = r - alpha * v
        sh = M(s)
        t = mv(sh)
        omega = torch.dot(t, s) / safe(torch.dot(t, t))
        x = x + alpha * ph + omega * sh
        r = s - omega * t
        rho = rho_new
        rr = torch.dot(r, r)
        better = torch.isfinite(rr) & (rr < rrb)
        xb, rrb = torch.where(better, x, xb), torch.where(better, rr, rrb)
    return xb


# ------------------------------------------------- JAX's band operators
@contextlib.contextmanager
def f64_dots():
    """``phifem_tpu.mg`` with ``jnp.float32`` read as float64: its band
    BiCGStab then takes float64 dots, as the port's."""
    import jax.numpy as jnp
    import phifem_tpu.mg as jmg

    class F64Dots:
        float32 = jnp.float64

        def __getattr__(self, name):
            return getattr(jnp, name)

    saved = jmg.jnp
    jmg.jnp = F64Dots()
    try:
        yield jmg
    finally:
        jmg.jnp = saved


def jax_ops(call):
    """``(band_mv, band_ras)``: the closures JAX's band correction ``call()``
    hands to ``phifem_tpu.mg._band_bicgstab``."""
    import jax.numpy as jnp
    import phifem_tpu.mg as jmg

    got = {}

    def record(mv, M, b, iters):
        got["ops"] = (mv, M)
        return jnp.zeros_like(b)

    saved = jmg._band_bicgstab
    jmg._band_bicgstab = record
    try:
        call()
    finally:
        jmg._band_bicgstab = saved
    return got["ops"]


def jax_vcycle_ops(fields: dict):
    """JAX's band operators on a JAX ``VCycle`` holding ``fields`` (its own
    Schwarz field names, ``band_ids`` = 0..m-1)."""
    import jax.numpy as jnp
    import phifem_tpu.mg as jmg

    vj = jmg.VCycle([], ())
    m = len(fields["band_ids"])
    vj._flat_meta = (["u"], [(m,)], [m])
    for name, a in fields.items():
        setattr(vj, name, jnp.asarray(a))
    vj.schwarz_sweeps = 1
    return jax_ops(lambda: vj._band_correct_flat(jnp.zeros(m), jnp.zeros(m)))


def closure_vars(fn) -> dict:
    return dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))


# ------------------------------------------------- the bands
def _s1_band():
    import jax.numpy as jnp
    from phifem_tpu_torch.utils.convert import interface_tables_from_numpy
    from torch_s1_cases import flower

    sj, _ = flower(40)
    vj = sj.lattice_preconditioner(dtype=jnp.float64, kind="schwarz")
    names = ("schwarz_ids", "schwarz_inv", "schwarz_own", "band_ids", "band_ell_cols", "band_ell_vals")
    vt = interface_tables_from_numpy(VCycle([], ()), vj._flat_meta, device="cpu",
                                     **{k: np.asarray(getattr(vj, k)) for k in names})
    n_flat = sum(vj._flat_meta[2])
    ops = jax_ops(lambda: vj._band_correct_flat(jnp.zeros(n_flat), jnp.zeros(n_flat)))
    return vt.band_tables, ops, int(vj.schwarz_sweeps), (np.asarray(vj.band_ell_cols), np.asarray(vj.band_ell_vals))


def _neumann3_band():
    import jax.numpy as jnp
    import phifem_tpu.models.lattice_core as jlc
    from phifem_tpu_torch.models import lattice_core
    from phifem_tpu_torch.utils.convert import interface_tables_from_numpy

    def u(x):
        return torch.cos(x[..., 0]) * torch.exp((x[..., 1] + x[..., 2]) / 2.0)

    def un(x):
        g = torch.stack([-torch.sin(x[..., 0]) * torch.exp((x[..., 1] + x[..., 2]) / 2.0), 0.5 * u(x), 0.5 * u(x)], -1)
        return (g * x).sum(-1) / torch.clamp(torch.linalg.norm(x, dim=-1), min=1e-12)

    phi = lambda x: (x**2).sum(-1) - 0.49
    st = pt.NeumannPoisson3(pt.Grid3(8, 8, 8, BOX3, device="cpu")).setup(phi, lambda x: 1.5 * u(x), un).assemble()
    total, blocks = st._interface_blocks()
    sel = np.concatenate([st.active[k].numpy().reshape(-1) for k in ("u", "y", "p")])
    ids, A, ras = lattice_core.build_interface_block(blocks, total, sel)
    rb = np.zeros(total)
    apply = jlc.make_interface_apply(ids, A, [r[r < len(ids)] for r in ras], dense_max=0, sweeps=1)
    mv, M = jax_ops(lambda: apply(jnp.asarray(rb)))
    cv, cm = closure_vars(mv), closure_vars(M)
    vt = interface_tables_from_numpy(
        VCycle([], ()), (["u"], [(len(ids),)], [len(ids)]), device="cpu", schwarz_ids=np.asarray(cm["bids"]),
        schwarz_inv=np.asarray(cm["binv"]), schwarz_own=np.asarray(cm["own"]), band_ids=np.arange(len(ids)),
        band_ell_cols=np.asarray(cv["ecols"]), band_ell_vals=np.asarray(cv["evals"]))
    host = (np.asarray(cv["ecols"]), np.asarray(cv["evals"]))
    return vt.band_tables, (mv, M), max(10, int(0.3 * len(ids) ** 0.5)), host


def _tet_band():
    m = pt.UMesh3.box(6, 6, 6, BOX3, device="cpu")
    u = lambda x: torch.cos(x[..., 0]) * torch.sin(x[..., 1]) * torch.cos(x[..., 2])
    s = pt.WeakDirichletPoissonU(m, mode="bg").setup(lambda x: (x**2).sum(-1) - 0.61**2, lambda x: 3 * u(x), u_D=u)
    s.assemble()
    vc = attach_interface_solve(VCycle([], ()), s.op, masked_operator(s.op)[2], kind="schwarz")
    return vc.band_tables, jax_vcycle_ops(tables_np(vc.band_tables)), vc.schwarz_sweeps, None


def _synthetic_band():
    tab = synthetic(1500, 700, 6, 9, seed=SEED + 1)
    return tab, jax_vcycle_ops(tables_np(tab)), 12, None


BANDS = {"s1_flower_n40": _s1_band, "neumann3_n8": _neumann3_band, "tet_n6": _tet_band,
         "synthetic": _synthetic_band}


@pytest.fixture(scope="module")
def bands():
    pytest.importorskip("jax")
    return {}


@pytest.fixture(params=list(BANDS))
def band(request, bands):
    if request.param not in bands:
        bands[request.param] = BANDS[request.param]()
    return bands[request.param]


def _vec(m: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(m)


# ------------------------------------------------- the operations
def test_tables(band):
    tab, _, sweeps, _ = band
    assert tab.sell_cols.dtype == tab.row_len.dtype == tab.ids.dtype == tab.owner.dtype == torch.int32
    assert tab.sell_cols.shape == tab.sell_vals.shape and tab.row_len.shape == (tab.m,)
    assert tab.inv.shape == (tab.nb, tab.K, tab.K) and tab.m > 0 and sweeps >= 10
    assert tab.ras_cols.shape == tab.ras_vals.shape == (tab.K, tab.m) and tab.ras_cols.dtype == torch.int32
    assert int(tab.ras_cols.max()) <= tab.m
    assert int(tab.sell_cols.max()) <= tab.m and int(tab.ids.max()) <= tab.m
    assert 1 <= int(tab.row_len.max()) <= tab.width


def test_sliced_table_holds_the_rows(band):
    """The sliced table holds each row of the host table the band was built
    from (JAX's for the S1 and Neumann bands, carried across; the port's,
    read back, for the others) in its order, each slice as wide as its
    longest row; the host table comes back from it."""
    tab, _, _, host = band
    cols, vals = (t.numpy() for t in tab.ell_rows())
    if host is not None:
        np.testing.assert_array_equal(cols, host[0])
        np.testing.assert_array_equal(vals, host[1])
    check_layout(tab, cols, vals)
    again = cb.band_tables(tab.ids, tab.inv, tab.owner, cols, vals, "cpu")
    for name in ("sell_cols", "sell_vals", "sell_off", "row_len", "row_perm"):
        assert torch.equal(getattr(again, name), getattr(tab, name)), name


def test_plain_product_equals_the_padded_sum(band):
    """The plain product on the sliced table against the former plain
    version on the padded slot-major table, bit for bit (sign of zero
    included), both modes."""
    tab = band[0]
    cols, vals = tab.ell_rows()
    x, b = torch.as_tensor(_vec(tab.m, 14)), torch.as_tensor(_vec(tab.m, 15))
    assert_same_bits(cb.band_ell_ref(tab, x), padded_product(cols, vals, x))
    assert_same_bits(cb.band_ell_ref(tab, x, b=b), padded_product(cols, vals, x, b))


def test_ras_and_ell_match_jax(band):
    """The plain RAS apply and ELL product against JAX's on the same
    tables: 1e-13; against the former plain forms: 1e-13."""
    import jax.numpy as jnp

    tab, (mv_j, ras_j), _, _ = band
    x = _vec(tab.m, 1)
    xt = torch.as_tensor(x)
    mv_o, ras_o = old_ops(tab)
    y_ras, y_ell = cb.band_ras_ref(tab, xt), cb.band_ell_ref(tab, xt)
    assert rel(y_ras, np.asarray(ras_j(jnp.asarray(x)))) <= 1e-13
    assert rel(y_ell, np.asarray(mv_j(jnp.asarray(x)))) <= 1e-13
    assert rel(y_ras, ras_o(xt)) <= 1e-13
    assert rel(y_ell, mv_o(xt)) <= 1e-13
    # the Richardson forms and the residual mode
    c = torch.as_tensor(_vec(tab.m, 2))
    assert torch.equal(cb.band_ras_ref(tab, xt, mode=cb.RAS_SCALE, om=0.7), 0.7 * y_ras)
    assert torch.equal(cb.band_ras_ref(tab, xt, mode=cb.RAS_ADD, om=0.7, c=c), c + 0.7 * y_ras)
    assert torch.equal(cb.band_ell_ref(tab, xt, b=c), c - y_ell)


def test_dots_match(band):
    """The ordered dots against float64 ``jnp.vdot`` and ``torch.dot``:
    1e-13 of the sum of |a_i b_i|."""
    import jax.numpy as jnp

    tab = band[0]
    a, b = _vec(tab.m, 3), _vec(tab.m, 4)
    at, bt = torch.as_tensor(a), torch.as_tensor(b)
    got = cb.band_dots_ref([(at, bt), (at, at), (bt, at)])
    scale = float(np.abs(a * b).sum())
    for g, want in zip(got.tolist(), (float(jnp.vdot(jnp.asarray(a), jnp.asarray(b))), float(a @ a), float(b @ a))):
        assert abs(g - want) <= 1e-13 * max(scale, float(a @ a))
    assert abs(float(got[0]) - float(torch.dot(at, bt))) <= 1e-13 * scale


@pytest.mark.parametrize("sweeps", [1, 3, None], ids=["1", "3", "default"])
def test_inner_solve_matches_jax(band, sweeps):
    """The plain inner BiCGStab against JAX's ``_band_bicgstab`` (float64
    dots) on JAX's band operators: 1e-12 at 1 and 3 sweeps, 1e-10 at the
    band's default count; against the former port form 1e-13 / 1e-12."""
    import jax.numpy as jnp

    tab, (mv_j, ras_j), default, _ = band
    n = default if sweeps is None else sweeps
    rb = _vec(tab.m, 5)
    e = cb.band_bicgstab(tab, torch.as_tensor(rb), n)
    if sweeps is None:
        assert float(e.abs().max()) > 0.0  # some sweep improved on e = 0
    with f64_dots() as jmg:
        ej = np.asarray(jmg._band_bicgstab(mv_j, ras_j, jnp.asarray(rb), n))
    assert rel(e, ej) <= (1e-10 if sweeps is None else 1e-12)
    mv_o, ras_o = old_ops(tab)
    assert rel(e, old_bicgstab(mv_o, ras_o, torch.as_tensor(rb), n)) <= (1e-12 if sweeps is None else 1e-13)


def test_richardson_matches_former_form(band):
    """``band_richardson`` against ``om RAS(rb)`` then ``z += om RAS(rb - A
    z)`` in the former forms: 1e-13."""
    tab = band[0]
    rb = torch.as_tensor(_vec(tab.m, 6))
    mv_o, ras_o = old_ops(tab)
    z = 0.7 * ras_o(rb)
    for _ in range(5):
        z = z + 0.7 * ras_o(rb - mv_o(z))
    assert rel(cb.band_richardson(tab, rb, 5, 0.7), z) <= 1e-13


# ------------------------------------------------- edge cases
def test_edge_cases_of_the_tables():
    """An unowned DoF reads 0 from the RAS apply, a pad id reads 0, an empty
    ELL row gives 0, and the plain dot tree equals a float64 sum to 1e-13 at
    sizes around the chunk."""
    tab = synthetic(37, 20, 6, 5)
    x = torch.as_tensor(_vec(37, 7))
    unowned = tab.owner >= tab.nb * tab.K
    assert int(unowned.sum()) >= 3
    y = cb.band_ras_ref(tab, x)
    assert torch.equal(y[unowned], torch.zeros(int(unowned.sum()), dtype=torch.float64))
    assert int(tab.ids[0, -1]) == tab.m
    assert torch.equal(cb.band_ell_ref(tab, x)[:2], torch.zeros(2, dtype=torch.float64))
    # a pad id contributes nothing: zeroing that column of the inverse
    inv = tab.inv.clone()
    inv[0, :, -1] = 0.0
    cols, vals = tab.ell_rows()
    assert torch.equal(cb.band_ras_ref(tab, x), cb.band_ras_ref(cb.band_tables(tab.ids, inv, tab.owner, cols, vals,
                                                                              "cpu"), x))
    for n in (1, 255, 1023, 1024, 1025, 3 * cb.CHUNK + 17):
        a, b = _vec(n, n), _vec(n, n + 1)
        got = float(cb.band_dots_ref([(torch.as_tensor(a), torch.as_tensor(b))])[0])
        assert abs(got - float(a @ b)) <= 1e-13 * float(np.abs(a * b).sum()), n
        assert cb.dot_stages(n) == 1


def test_dot_tree_is_the_halving_tree():
    """The plain dots over m > CHUNK values are the chunk sums by halving,
    then the halving tree over the zero-padded chunk sums, bit for bit."""
    rng = np.random.default_rng(8)
    n = 2 * cb.CHUNK + 300
    a, b = rng.standard_normal(n), rng.standard_normal(n)
    p = np.zeros(3 * cb.CHUNK)
    p[:n] = a * b

    def halve(v):
        while v.size > 1:
            h = v.size // 2
            v = v[:h] + v[h:]
        return v[0]

    sums = np.zeros(cb.CHUNK)
    sums[:3] = [halve(p[k * cb.CHUNK : (k + 1) * cb.CHUNK]) for k in range(3)]
    got = cb.band_dots_ref([(torch.as_tensor(a), torch.as_tensor(b))])
    assert got.tolist() == [halve(sums)]


def test_zero_sweeps_and_update_modes():
    """No sweep returns 0; ``band_update`` refuses unknown modes (P and S
    run inside the RAS launches) and missing vectors."""
    tab = synthetic(300, 120, 8, 6)
    rb = torch.as_tensor(_vec(300, 9))
    assert torch.equal(cb.band_bicgstab(tab, rb, 0), torch.zeros(300, dtype=torch.float64))
    sc = torch.zeros(cb.SLOTS, dtype=torch.float64)
    for mode in (7, cb.P, cb.S):
        with pytest.raises(ValueError, match="mode"):
            cb.band_update(mode, 0, sc, r=rb)
    with pytest.raises(ValueError, match="takes the vectors"):
        cb.band_update(cb.XR, 1, sc, x=rb)


# ------------------------------------------------- the wrappers
def test_band_tables_are_counted_and_checked():
    """Every band built adds one to ``tables_built``, through
    ``band_tables`` or the carried-across tables of
    ``interface_tables_from_numpy``; the tables are int32 and float64 on the
    device asked for, the band matrix a sliced table; bad shapes raise."""
    from phifem_tpu_torch.utils.convert import interface_tables_from_numpy

    built = cb.tables_built
    tab = synthetic(300, 120, 8, 6)
    assert cb.tables_built == built + 1
    assert (tab.ids.dtype, tab.owner.dtype, tab.sell_cols.dtype, tab.row_len.dtype) == (torch.int32,) * 4
    assert tab.inv.dtype == tab.sell_vals.dtype == torch.float64 and tab.sell_off.dtype == torch.int64
    assert tab.width == 6 and tab.sell_off.shape == (-(-300 // cb.SLICE) + 1,)
    vt = interface_tables_from_numpy(VCycle([], ()), (["u"], [(300,)], [300]), device="cpu", **tables_np(tab))
    assert cb.tables_built == built + 2
    for name in ("inv", "ids", "owner", "ras_cols", "ras_vals", "sell_cols", "sell_vals", "sell_off", "row_len",
                 "row_perm"):
        assert torch.equal(getattr(vt.band_tables, name), getattr(tab, name)), name
    with pytest.raises(ValueError, match="inconsistent"):
        cb.band_tables(tab.ids, tab.inv[:, :4], tab.owner, *tab.ell_rows(), "cpu")


def test_wrappers_dispatch_on_the_device():
    """CPU tensors take the plain versions and launch nothing; a ``meta``
    tensor raises."""
    tab = synthetic(300, 120, 8, 6)
    x = torch.as_tensor(_vec(300, 10))
    before = (cb.launches, cb.ras_launches, cb.ell_launches, cb.dot_launches, cb.update_launches)
    assert torch.equal(cb.band_ras(tab, x), cb.band_ras_ref(tab, x))
    assert torch.equal(cb.band_ell(tab, x, b=x), cb.band_ell_ref(tab, x, b=x))
    assert torch.equal(cb.band_dots([(x, x)]), cb.band_dots_ref([(x, x)]))
    assert torch.equal(cb.band_bicgstab(tab, x, 4), cb.band_bicgstab_ref(tab, x, 4))
    assert torch.equal(cb.band_richardson(tab, x, 3), cb.band_richardson_ref(tab, x, 3))
    assert (cb.launches, cb.ras_launches, cb.ell_launches, cb.dot_launches, cb.update_launches) == before
    meta = x.to("meta")
    msc = torch.zeros(cb.SLOTS, device="meta")
    for call in (lambda: cb.band_ras(tab, meta), lambda: cb.band_ell(tab, meta), lambda: cb.band_dots([(meta, meta)]),
                 lambda: cb.band_update(cb.SEL, 0, msc, x=meta, xb=meta),
                 lambda: cb.band_ras_s(tab, msc, meta, meta.clone(), meta.clone(), meta.clone())):
        with pytest.raises(ValueError, match="no kernel for device meta"):
            call()


def test_cycle_and_interface_apply_run_the_band_solve(monkeypatch):
    """``VCycle._band_correct_flat`` and ``make_interface_apply`` (both inner
    modes) go through ``cuda_band.band_bicgstab`` / ``band_richardson``."""
    import scipy.sparse as sp
    from phifem_tpu_torch.models import lattice_core

    calls = []
    for name in ("band_bicgstab", "band_richardson"):
        fn = getattr(cb, name)
        monkeypatch.setattr(cb, name, lambda *a, _fn=fn, _n=name, **k: calls.append(_n) or _fn(*a, **k))
    m = 400
    A = sp.diags([-np.ones(m - 1), 4.0 * np.ones(m), -np.ones(m - 1)], [-1, 0, 1]).tocsr()
    blocks = np.array([[i, min(i + 1, m), min(i + 2, m)] for i in range(0, m, 2)])
    ids = np.arange(m)
    for inner in ("krylov", "richardson"):
        apply = lattice_core.make_interface_apply(ids, A, blocks, dense_max=0, sweeps=5, inner=inner, device="cpu")
        _, corr = apply(torch.ones(m, dtype=torch.float64))
        assert torch.isfinite(corr).all()
    vc = apply.band
    vc._flat_meta = (["u"], [(m,)], [m])
    vc._band_correct_flat(torch.zeros(m, dtype=torch.float64), torch.ones(m, dtype=torch.float64))
    assert calls == ["band_bicgstab", "band_richardson", "band_bicgstab"]


# ------------------------------------------------- the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


CARD_CASES = {"K6": (48_642, 61_782, 6, 13), "K8": (5_000, 3_000, 8, 38), "K27": (20_001, 4_000, 27, 27)}


def _update_state(m: int, device, seed: int) -> dict:
    """Vectors and scalar slots for one call of each fused step and update
    mode: rr below the best residual of slot 0 and above that of slot 1,
    so that the select takes x after sweep 0 and keeps xb after sweep 1."""
    rng = np.random.default_rng(seed)
    st = {k: torch.as_tensor(rng.standard_normal(m), device=device)
          for k in ("r", "p", "v", "s", "t", "x", "ph", "sh", "xb", "rout", "pout")}
    sc = torch.as_tensor(0.5 + rng.random(cb.SLOTS), device=device)
    sc[cb.RR], sc[cb.RRB0], sc[cb.RRB1] = 0.5, 1.0, 0.25
    return {"sc": sc, **st}


def _one_launch(counter: str, call) -> None:
    before = getattr(cb, counter)
    call()
    torch.cuda.synchronize()
    assert getattr(cb, counter) == before + 1, counter


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_kernels_equal_plain_versions(cuda, case):
    m, nb, K, w = CARD_CASES[case]
    tab = synthetic(m, nb, K, w, seed=SEED + K, device=cuda)
    x = torch.as_tensor(_vec(m, 11), device=cuda)
    c = torch.as_tensor(_vec(m, 12), device=cuda)
    for mode in (cb.RAS_APPLY, cb.RAS_SCALE, cb.RAS_ADD):
        got = {}
        _one_launch("ras_launches", lambda: got.update(y=cb.band_ras(tab, x, mode=mode, om=0.7, c=c)))
        assert torch.equal(got["y"], cb.band_ras_ref(tab, x, mode=mode, om=0.7, c=c)), mode
    for sweep in (0, 1, 2):
        st = _update_state(m, cuda, sweep)
        ref = {k: t.clone() for k, t in st.items()}
        args = ("sc", "r", "p", "v", "x", "xb", "pout", "ph")
        _one_launch("ras_launches", lambda: cb.band_ras_p(tab, sweep, *(st[k] for k in args)))
        cb.band_ras_p_ref(tab, sweep, *(ref[k] for k in args))
        assert all(torch.equal(st[k], ref[k]) for k in st), sweep
    st = _update_state(m, cuda, 3)
    ref = {k: t.clone() for k, t in st.items()}
    _one_launch("ras_launches", lambda: cb.band_ras_s(tab, *(st[k] for k in ("sc", "r", "v", "s", "sh"))))
    cb.band_ras_s_ref(tab, *(ref[k] for k in ("sc", "r", "v", "s", "sh")))
    assert all(torch.equal(st[k], ref[k]) for k in st)
    for mode, sweep in ((cb.XR, 1), (cb.SEL, 0), (cb.SEL, 1)):
        st = _update_state(m, cuda, 4 + sweep)
        ref = {k: t.clone() for k, t in st.items()}
        names = cb.MODE_VECS[mode]
        _one_launch("update_launches", lambda: cb.band_update(mode, sweep, st["sc"], **{k: st[k] for k in names}))
        cb.band_update_ref(mode, sweep, ref["sc"], **{k: ref[k] for k in names})
        assert all(torch.equal(st[k], ref[k]) for k in st), (mode, sweep)
    for b in (None, c):
        before = cb.ell_launches
        y = cb.band_ell(tab, x, b=b)
        torch.cuda.synchronize()
        assert cb.ell_launches == before + 1
        assert torch.equal(y, cb.band_ell_ref(tab, x, b=b))
    for q in (1, 2, 3):
        pairs = [(x, c), (c, c), (x, x)][:q]
        before = cb.dot_launches
        y = cb.band_dots(pairs)
        torch.cuda.synchronize()
        assert cb.dot_launches == before + 1
        assert torch.equal(y, cb.band_dots_ref(pairs)), q


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_inner_solves_equal_plain_versions(cuda, case):
    m, nb, K, w = CARD_CASES[case]
    tab = synthetic(m, nb, K, w, seed=SEED + K, device=cuda)
    rb = torch.as_tensor(_vec(m, 13), device=cuda)
    for sweeps in (1, 2, 17):
        before = (cb.launches, cb.ras_launches, cb.update_launches)
        e = cb.band_bicgstab(tab, rb, sweeps)
        torch.cuda.synchronize()
        # the first dots, 8 a sweep (2 of them RAS, 1 XR), the select
        assert (cb.launches - before[0], cb.ras_launches - before[1], cb.update_launches - before[2]) == (
            2 + sweeps * 8, 2 * sweeps, sweeps + 1)
        assert torch.equal(e, cb.band_bicgstab_ref(tab, rb, sweeps)), sweeps
    assert torch.equal(cb.band_richardson(tab, rb, 6, 0.8), cb.band_richardson_ref(tab, rb, 6, 0.8))
