"""Port parity of degree 2 and 3 assembly (slice E), n=8.

S1 at P2 / P3 on triangles and Q2 / Q3 on quadrilaterals, level set of
the primal degree, on the circle of ``tests/test_schemes.py`` (the
cos x e^{y/2} solution as Dirichlet data) and on the flower (the demo's
data, detection degree 1, single-layer cut): tags bit for bit, the load
vector, one operator matvec and the Jacobi diagonal to 1e-12 of JAX's;
no tap form at degree >= 2.  ``l2_h1_errors`` of a fixed field against
JAX's (reference space of degree k + 2), and ``Function.zeros`` / ``copy``
/ ``eval_grad``."""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import phifem_tpu as pf  # noqa: E402
import phifem_tpu.models as jm  # noqa: E402
import phifem_tpu_torch as pt  # noqa: E402
from phifem_tpu_torch.models import flower as tflower  # noqa: E402
from torch_s1_cases import FLOWER_BOX, jflower, random_vec, rel  # noqa: E402
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

CIRCLE_BOX = ((-1.5, -1.5), (1.5, 1.5))
ELEMENTS = [("triangle", 2), ("triangle", 3), ("quadrilateral", 2), ("quadrilateral", 3)]
IDS = ["P2", "P3", "Q2", "Q3"]


def phi_circle(x):
    return x[..., 0] ** 2 + x[..., 1] ** 2 - 1.0


def j_uex(x):
    return jnp.cos(x[..., 0]) * jnp.exp(x[..., 1] / 2.0)


def t_uex(x):
    return torch.cos(x[..., 0]) * torch.exp(x[..., 1] / 2.0)


# -Delta (cos x e^{y/2}) = (1 - 1/4) cos x e^{y/2}
def j_f(x):
    return 0.75 * j_uex(x)


def t_f(x):
    return 0.75 * t_uex(x)


@functools.lru_cache(maxsize=None)
def pair(geo: str, ct: str, k: int, n: int = 8):
    """S1 at degree k, set up and assembled in both packages."""
    box = CIRCLE_BOX if geo == "circle" else FLOWER_BOX
    kw = dict(mode="bg", primal_degree=k, levelset_degree=k)
    if geo == "flower":
        kw.update(detection_degree=1, single_layer_cut=True)
    sj = jm.WeakDirichletPoisson(pf.Grid(n, n, box, pf.CellType(ct)), **kw)
    st = pt.WeakDirichletPoisson(pt.Grid(n, n, box, pt.CellType(ct), device="cpu"), **kw)
    if geo == "circle":
        sj.setup(phi_circle, j_f, u_D=j_uex)
        st.setup(phi_circle, t_f, u_D=t_uex)
    else:
        sj.setup(jflower.levelset, jflower.source_term, detection_levelset=jflower.detection_levelset)
        st.setup(tflower.levelset, tflower.source_term, detection_levelset=tflower.detection_levelset)
    return sj.assemble(), st.assemble()


@pytest.mark.parametrize("geo", ["circle", "flower"])
@pytest.mark.parametrize("ct, k", ELEMENTS, ids=IDS)
def test_high_degree_assembly_matches_jax(geo, ct, k):
    sj, st = pair(geo, ct, k)
    assert st.V.degree == k and st.Vphi.degree == k
    assert np.array_equal(st.cell_tags, np.asarray(sj.cell_tags))
    assert np.array_equal(st.facet_tags, np.asarray(sj.facet_tags))
    for f in sj.b:
        assert rel(st.b[f].numpy(), np.asarray(sj.b[f])) <= 1e-12, f
    xj, xt = random_vec(sj.system, seed=k)
    yj, yt = sj.op.matvec(xj), st.op.matvec(xt)
    dj, dt = sj.op.diagonal(), st.op.diagonal()
    for f in yj:
        assert rel(yt[f].numpy(), np.asarray(yj[f])) <= 1e-12, f
        assert rel(dt[f].numpy(), np.asarray(dj[f])) <= 1e-12, f
    # the degree >= 2 operator runs its entity batches: no tap form
    assert st.op.lattice_form() is None


@pytest.mark.parametrize("ct, k", ELEMENTS, ids=IDS)
def test_l2_h1_errors_match_jax(ct, k):
    """The same fixed (non-exact) field in both packages: the reference
    space is of degree k + 2 (P5 for P3)."""
    sj, st = pair("circle", ct, k)
    g = lambda x, m: m.cos(x[..., 0] + 0.1) * m.exp(x[..., 1] / 2.0) + 0.01 * x[..., 0] * x[..., 1]
    uj = pf.interpolate(lambda x: g(x, jnp), sj.V)
    ut = pt.interpolate(lambda x: g(x, torch), st.V)
    ej = sj.l2_h1_errors(uj, j_uex, region=(1, 2))
    et = st.l2_h1_errors(ut, t_uex, region=(1, 2))
    for key in ("l2", "h10", "h1"):
        assert abs(et[key] - ej[key]) <= 1e-10 * ej[key], (key, et[key], ej[key])


@pytest.mark.parametrize("ct, k", ELEMENTS, ids=IDS)
def test_function_zeros_copy_eval_grad(ct, k):
    sj, st = pair("circle", ct, k)
    z = pt.Function.zeros(st.V)
    assert z.data.shape == tuple(st.V.dof_shape) and z.data.dtype == torch.float64
    assert not z.data.any()
    u = pt.interpolate(t_uex, st.V)
    c = u.copy()
    assert c.space is u.space and torch.equal(c.data, u.data)
    c.data[0] += 1.0
    assert not torch.equal(c.data, u.data)  # its own data
    pts = np.random.default_rng(7).uniform(-1.4, 1.4, (50, 2))
    gt = u.eval_grad(torch.as_tensor(pts)).numpy()
    gj = np.asarray(pf.interpolate(j_uex, sj.V).eval_grad(jnp.asarray(pts)))
    assert gt.shape == (50, 2)
    assert np.abs(gt - gj).max() <= 1e-12 * np.abs(gj).max()
    # exact on the degree-k polynomials of the space
    poly = lambda x: x[..., 0] ** k - 2.0 * x[..., 0] * x[..., 1] ** (k - 1) + 0.5 * x[..., 1]
    gp = pt.interpolate(poly, st.V).eval_grad(torch.as_tensor(pts)).numpy()
    x, y = pts[:, 0], pts[:, 1]
    exact = np.stack([k * x ** (k - 1) - 2.0 * y ** (k - 1), -2.0 * (k - 1) * x * y ** (k - 2) + 0.5], -1)
    assert np.abs(gp - exact).max() <= 1e-11
