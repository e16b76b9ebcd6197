"""S1 problems built the same way in the JAX package and in the port, for
the port's parity tests (``tests/test_torch_*.py``).  Importing this module
imports JAX: test files call ``pytest.importorskip("jax")`` first."""

import functools
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

import phifem_tpu as pf
import phifem_tpu.models as jm
import phifem_tpu_torch as pt
from phifem_tpu_torch.models import flower as tflower

FLOWER_BOX = ((-4.5, -4.5), (4.5, 4.5))
CIRCLE_BOX = ((-1.0, -1.0), (1.0, 1.0))
R = 0.7


def _load_demo_data():
    path = Path(__file__).resolve().parents[1] / "demo" / "weak-dirichlet" / "flower" / "data.py"
    spec = importlib.util.spec_from_file_location("flower_demo_data", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jflower = _load_demo_data()


def jphi_circle(x):
    return x[..., 0] ** 2 + x[..., 1] ** 2 - R**2


def tphi_circle(x):
    return x[..., 0] ** 2 + x[..., 1] ** 2 - R**2


def grids(n, box, ct="triangle"):
    return pf.Grid(n, n, box, pf.CellType(ct)), pt.Grid(n, n, box, pt.CellType(ct))


@functools.lru_cache(maxsize=None)
def flower(n: int):
    """The bench's S1 flower scheme at n x n (bg mode, detection degree 1,
    single-layer cut), set up and assembled in both packages:
    ``(jax_scheme, port_scheme)``."""
    gj, gt = grids(n, FLOWER_BOX)
    sj = jm.WeakDirichletPoisson(gj, mode="bg", detection_degree=1, single_layer_cut=True)
    sj.setup(jflower.levelset, jflower.source_term, detection_levelset=jflower.detection_levelset)
    sj.assemble()
    st = pt.WeakDirichletPoisson(gt, mode="bg", detection_degree=1, single_layer_cut=True)
    st.setup(tflower.levelset, tflower.source_term, detection_levelset=tflower.detection_levelset)
    st.assemble()
    return sj, st


def random_vec(system_j, seed: int):
    """The same random dict vector for both packages: ``(jax, torch)``."""
    rng = np.random.default_rng(seed)
    xs = {n: rng.standard_normal(s.dof_shape) for n, s in system_j.fields.items()}
    return {n: jnp.asarray(v) for n, v in xs.items()}, {n: torch.as_tensor(v) for n, v in xs.items()}


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))
