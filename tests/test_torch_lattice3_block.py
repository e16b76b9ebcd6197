"""Port parity of the block lattice cycles against the JAX package: the 3D
``Lattice3BlockMG`` (the S5-3D elasticity bulks, vsz = 3) with its block
stencil, block sweep and coarse pseudo-inverse, and the 2D
``LatticeBlockMG`` with the ``lattice_preconditioner`` branch that reaches
it (a vector P1 field with a uniform cell batch and a Dirichlet-masked
bulk).

Tolerances: the block stencils bit for bit; the block sweep in its three
modes 1e-13 relative to max|y| (JAX's einsum against the port's ordered
products); one cycle application in float64, masked and unmasked, 1e-12;
the vsz = 1 block cycle against the scalar cycle 1e-12 (the oracle of
``tests/test_lattice3.py:128``); the 2D block cycle 1e-12, and channelwise
equal to the scalar cycle on uncoupled channels (``tests/test_lattice.py:
165``); one application of the S5 flat preconditioner with its bulks on the
block cycle 1e-10."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import phifem_tpu as pf  # noqa: E402
from phifem_tpu.models import interface_elasticity3 as jie3  # noqa: E402
from phifem_tpu.ops import lattice as jlat  # noqa: E402
from phifem_tpu.ops import lattice3 as jl3  # noqa: E402
from phifem_tpu_torch.models import interface_elasticity3 as tie3  # noqa: E402
from phifem_tpu_torch.models.interface_elasticity import lame  # noqa: E402
from phifem_tpu_torch.ops import cuda_lattice3 as cl  # noqa: E402
from phifem_tpu_torch.ops import lattice as tlat  # noqa: E402
from phifem_tpu_torch.ops import lattice3 as tl3  # noqa: E402
from phifem_tpu_torch.utils.convert import lattice3_block_mg_from_numpy  # noqa: E402
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

N = 8
SP = (0.3, 0.25, 0.2)
LI, MI = lame(1.0, 0.3)


def _np(a):
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _rel(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _elem(hx, hy, hz):
    return tie3._elastic_element_matrix(hx, hy, hz, LI, MI)


def _bulk_mask(n):
    """A sphere-interior vertex mask (the floating side's bulk)."""
    D = n + 1
    c = np.arange(D) - n / 2
    r2 = c[:, None, None] ** 2 + c[None, :, None] ** 2 + c[None, None, :] ** 2
    return r2 < (0.35 * n) ** 2


def _padded(rng, vsz, D, R, C, interior=True):
    x = np.zeros((vsz, D + 2, R + 2, C + 2))
    if interior:
        x[:, 2:D, 2:R, 2:C] = rng.standard_normal((vsz, D - 2, R - 2, C - 2))
    else:
        x[:] = rng.standard_normal(x.shape)
    return x


def test_element_matrix_and_block_stencil_match_jax():
    K = _elem(*SP)
    assert np.array_equal(K, jie3._elastic_element_matrix(*SP, LI, MI))
    w = tl3.block_vertex_stencil_weights3(K, 3)
    assert np.array_equal(w, jl3.block_vertex_stencil_weights3(K, 3))
    tt, tj = tl3._block_terms3(w), jl3._block_terms3(w)
    assert [t[:3] for t in tt] == [t[:3] for t in tj]
    assert all(np.array_equal(a[3], b[3]) for a, b in zip(tt, tj))


def test_conv_interior3_block_matches_jax():
    terms = tl3._block_terms3(tl3.block_vertex_stencil_weights3(_elem(*SP), 3))
    offs = [t[:3] for t in terms]
    W = np.stack([t[3] for t in terms])
    D, R, C = 7, 9, 6
    xp = _padded(np.random.default_rng(0), 3, D, R, C, interior=False)
    yt = tl3._conv_interior3_block(torch.as_tensor(xp), offs, W, D, R, C)
    yj = jl3._conv_interior3_block(jnp.asarray(xp), offs, jnp.asarray(W), D, R, C)
    assert _rel(yt, yj) <= 1e-13


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("mode", ["matvec", "residual", "jacobi"])
def test_block_sweep_plain_version_matches_jax(mode, masked):
    """The block sweep's plain version against the JAX package's own
    expressions (``Lattice3BlockMG._smooth`` / ``_cycle``)."""
    terms = tl3._block_terms3(tl3.block_vertex_stencil_weights3(_elem(*SP), 3))
    offs = [t[:3] for t in terms]
    W = np.stack([t[3] for t in terms])
    dinv = np.linalg.inv(dict(((a, b, c), Wb) for a, b, c, Wb in terms)[(1, 1, 1)])
    D, R, C = 9, 7, 8
    rng = np.random.default_rng(1)
    x, b = _padded(rng, 3, D, R, C), _padded(rng, 3, D, R, C)
    m = (rng.random((D, R, C)) < 0.7).astype(np.float64) if masked else None
    md = {"matvec": cl.MATVEC, "residual": cl.RESIDUAL, "jacobi": cl.JACOBI}[mode]
    packed = cl.pack_block_terms(terms, dinv)
    yt = cl.lattice3_block_sweep(md, torch.as_tensor(x), packed, torch.as_tensor(b),
                                 None if m is None else torch.as_tensor(m), 0.6)
    conv = jl3._conv_interior3_block(jnp.asarray(x), offs, jnp.asarray(W), D, R, C)
    yj = np.zeros_like(x) if mode != "jacobi" else x.copy()
    mi = None if m is None else m[1 : D - 1, 1 : R - 1, 1 : C - 1]
    if mode == "matvec":
        yj[:, 2:D, 2:R, 2:C] = conv
    else:
        r = b[:, 2:D, 2:R, 2:C] - np.asarray(conv)
        v = r if mode == "residual" else 0.6 * np.einsum("ij,jdrc->idrc", dinv, r)
        if mi is not None:
            v = v * mi
        yj[:, 2:D, 2:R, 2:C] = v if mode == "residual" else x[:, 2:D, 2:R, 2:C] + v
    assert _rel(yt, yj) <= 1e-13
    with pytest.raises(ValueError, match="ascending"):
        cl.pack_block_terms(terms[::-1])


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_lattice3_block_mg_matches_jax(masked):
    """Tables and one float64 cycle application at n=8 (min_n=4: two
    levels, the coarsest a masked pseudo-inverse)."""
    mask = _bulk_mask(N) if masked else None
    mt = tl3.build_lattice3_block_mg(N, N, N, SP, _elem, 3, min_n=4, dtype=torch.float64, mask=mask, device="cpu")
    mj = jl3.build_lattice3_block_mg(N, N, N, SP, _elem, 3, min_n=4, dtype=jnp.float64, mask=mask)
    assert [(l.D, l.R, l.C) for l in mt.levels] == [(l.D, l.R, l.C) for l in mj.levels] and mt.offs == mj.offs
    for k in range(len(mt.levels)):
        assert np.array_equal(mt.Ws[k], _np(mj.Ws[k])) and np.array_equal(mt.dinvs[k], _np(mj.dinvs[k]))
    assert _rel(mt.coarse_inv, mj.coarse_inv) <= 1e-12
    D = N + 1
    bp = _padded(np.random.default_rng(2), 3, D, D, D)
    zt = mt(torch.as_tensor(bp))
    zj = mj(jnp.asarray(bp))
    assert _rel(zt, zj) <= 1e-12
    # the same cycle carried across from JAX's tables
    mc = lattice3_block_mg_from_numpy(
        [(l.D, l.R, l.C) for l in mj.levels], mj.offs, [_np(w) for w in mj.Ws], [_np(d) for d in mj.dinvs],
        _np(mj.coarse_inv), 3, None if mj.masks is None else [_np(m) for m in mj.masks], torch.float64,
        device="cpu",
    )
    assert _rel(mc(torch.as_tensor(bp)), zj) <= 1e-12


def test_block_mg_vsz1_matches_scalar():
    """The vsz = 1 block cycle is the scalar Lattice3MG (same damping)."""
    n = 8
    sp = (1.0 / n,) * 3
    mg_s = tl3.build_lattice3_mg(n, n, n, sp, stiffness=1.0, mass=0.5, min_n=4, dtype=torch.float64, device="cpu")
    elem = lambda hx, hy, hz: tl3.hex_element_matrix(hx, hy, hz, stiffness=1.0, mass=0.5)
    mg_b = tl3.build_lattice3_block_mg(n, n, n, sp, elem, vsz=1, min_n=4, dtype=torch.float64, device="cpu")
    mg_b.omega = mg_s.omega
    D = n + 1
    b = torch.as_tensor(np.random.default_rng(3).standard_normal((D + 2,) * 3))
    assert _rel(mg_b(b[None])[0], mg_s(b)) <= 1e-12


def _vector_laplacian_stencils(n):
    """The 2D P1 Laplacian's scalar stencil and its uncoupled 2-channel
    block stencil, from JAX's assembly (``tests/test_lattice.py:165``)."""
    from phifem_tpu.assembly import CellTerm, System, assemble_operator
    from phifem_tpu.ops.stencil import _TRI_OFFS, StencilCellBatch
    from phifem_tpu.spaces import Space

    g = pf.Grid(n, n, ((0.0, 0.0), (1.0, 1.0)), pf.CellType.triangle)
    lap = lambda u, v, d, x, ctx: jnp.sum(u["u"].grad * v["u"].grad)
    term = [(CellTerm(lap, None, degree=2, uniform=True), {})]
    op_s = assemble_operator(System({"u": Space.lagrange(g, 1)}), g, cell_terms=term)
    ws = sum(jlat.vertex_stencil_weights(np.asarray(b.matrices), _TRI_OFFS) for b in op_s.batches
             if isinstance(b, StencilCellBatch))
    op_v = assemble_operator(System({"u": Space.lagrange(g, 1, (2,))}), g, cell_terms=term)
    mats = [np.asarray(b.matrices) for b in op_v.batches]
    wb = sum(jlat.block_vertex_stencil_weights(m, _TRI_OFFS, 2) for m in mats)
    assert all(np.array_equal(tlat.block_vertex_stencil_weights(m, _TRI_OFFS, 2),
                              jlat.block_vertex_stencil_weights(m, _TRI_OFFS, 2)) for m in mats)
    return ws, wb


def test_lattice_block_mg_2d_matches_jax_and_scalar():
    n = 32
    ws, wb = _vector_laplacian_stencils(n)
    R = C = n + 1
    r = np.random.default_rng(0).standard_normal((R, C))
    rp = np.zeros((2, R + 2, C + 2))
    rp[0, 1 : 1 + R, 1 : 1 + C], rp[1, 1 : 1 + R, 1 : 1 + C] = r, 2 * r
    mg_s = tlat.build_lattice_mg(n, n, ws, min_n=8, dtype=torch.float64, device="cpu")
    mg_b = tlat.build_lattice_block_mg(n, n, wb, min_n=8, dtype=torch.float64, device="cpu")
    zs = mg_s(torch.as_tensor(rp[0]))
    zb = mg_b(torch.as_tensor(rp))
    assert _rel(zb[0], zs) <= 1e-12 and _rel(zb[1], 2 * zs) <= 1e-12
    # masked, against JAX (a Dirichlet ring)
    mask = np.zeros((R, C), bool)
    mask[1:-1, 1:-1] = True
    mask[10:14, 5:20] = False
    mt = tlat.build_lattice_block_mg(n, n, wb, min_n=8, dtype=torch.float64, mask=mask, device="cpu")
    mj = jlat.build_lattice_block_mg(n, n, wb, min_n=8, dtype=jnp.float64, mask=mask)
    assert _rel(mt.coarse_inv, mj.coarse_inv) <= 1e-12
    assert _rel(mt(torch.as_tensor(rp)), mj(jnp.asarray(rp))) <= 1e-12


def test_s5_flat_preconditioner_on_block_cycles_matches_jax():
    """``lattice_preconditioner`` with a vector P1 bulk that is not a
    free-boundary field takes the constant block cycle (the branch that
    raised ``NotImplementedError`` before): S5 at n=16 with both
    displacement bulks declared Dirichlet-masked, in both packages, one
    float64 application of the flat preconditioner (no band solve)."""
    from torch_s5_cases import BOX, jdisk, port_s5
    from phifem_tpu.models.interface_elasticity import InterfaceElasticity as JIE

    sj = JIE(pf.Grid(16, 16, BOX, pf.CellType.triangle), mode="bg", E_in=jdisk.E_in, nu_in=jdisk.nu_in,
             E_out=jdisk.E_out, nu_out=jdisk.nu_out)
    sj.setup(jdisk.levelset, jdisk.source_term, jdisk.exact_solution).assemble()
    st = port_s5(16)
    for s in (sj, st):
        s._bulk_neumann_fields = lambda: ()
    kw = dict(min_n=4, interface=False, coupled=False)
    Mj = sj.lattice_preconditioner(dtype=jnp.float64, **kw)
    Mt = st.lattice_preconditioner(dtype=torch.float64, **kw)
    assert {f: type(m).__name__ for f, m in Mt.mgs.items()} == {"u_in": "LatticeBlockMG", "u_out": "LatticeBlockMG"}
    assert {f: type(m).__name__ for f, m in Mj.mgs.items()} == {"u_in": "LatticeBlockMG", "u_out": "LatticeBlockMG"}
    rng = np.random.default_rng(4)
    r = {k: rng.standard_normal(sp.dof_shape) for k, sp in st.op.system.fields.items()}
    zt = Mt({k: torch.as_tensor(v) for k, v in r.items()})
    zj = Mj({k: jnp.asarray(v) for k, v in r.items()})
    for k in r:
        assert _rel(zt[k], zj[k]) <= 1e-10, k
