"""S5 (two-material interface elasticity) built the same way in the JAX
package and in the port, for the port's S5 parity tests
(``tests/test_torch_s5*.py``): the demo's disk problem
(``demo/interface-elasticity/data.py``, its port
``phifem_tpu_torch.models.elasticity_disk``) on [-1.5, 1.5]^2 in bg mode,
with the exact solution as the box's Dirichlet data, as the demo runs it.
Importing this module imports JAX: test files call
``pytest.importorskip("jax")`` first."""

import functools
import importlib.util
from pathlib import Path

import numpy as np
import torch

import phifem_tpu as pf
import phifem_tpu_torch as pt
from phifem_tpu.models.interface_elasticity import InterfaceElasticity as JInterfaceElasticity
from phifem_tpu_torch.models import elasticity_disk as tdisk

BOX = ((-1.5, -1.5), (1.5, 1.5))


def _load_demo_data():
    path = Path(__file__).resolve().parents[1] / "demo" / "interface-elasticity" / "data.py"
    spec = importlib.util.spec_from_file_location("s5_demo_data", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jdisk = _load_demo_data()


def port_s5(n: int, device="cpu"):
    """The port's S5 at n x n, set up and assembled."""
    s = pt.InterfaceElasticity(
        pt.Grid(n, n, BOX, pt.CellType.triangle, device=device), mode="bg",
        E_in=tdisk.E_in, nu_in=tdisk.nu_in, E_out=tdisk.E_out, nu_out=tdisk.nu_out,
    )
    return s.setup(tdisk.levelset, tdisk.source_term, tdisk.exact_solution).assemble()


@functools.lru_cache(maxsize=None)
def s5(n: int):
    """``(jax_scheme, port_scheme)`` at n x n, set up and assembled."""
    sj = JInterfaceElasticity(
        pf.Grid(n, n, BOX, pf.CellType.triangle), mode="bg",
        E_in=jdisk.E_in, nu_in=jdisk.nu_in, E_out=jdisk.E_out, nu_out=jdisk.nu_out,
    )
    sj.setup(jdisk.levelset, jdisk.source_term, jdisk.exact_solution)
    sj.assemble()
    return sj, port_s5(n)


def random_fields(system, seed):
    """The same random vector as numpy (JAX layout) and as CPU tensors."""
    rng = np.random.default_rng(seed)
    xn = {k: rng.standard_normal(sp.dof_shape) for k, sp in system.fields.items()}
    return xn, {k: torch.as_tensor(v) for k, v in xn.items()}


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), np.finfo(float).tiny))
