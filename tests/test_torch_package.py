"""The port package stands alone: no JAX, explicit devices and dtypes."""

import subprocess
import sys

import pytest
import torch


def test_import_leaves_jax_out():
    code = (
        "import sys, phifem_tpu_torch, phifem_tpu_torch.models, "
        "phifem_tpu_torch.utils.convert, phifem_tpu_torch.ops.cuda_stencil, "
        "phifem_tpu_torch.levelset, phifem_tpu_torch.measures, phifem_tpu_torch.tagging, "
        "phifem_tpu_torch.mg, phifem_tpu_torch.models.base, "
        "phifem_tpu_torch.models.weak_dirichlet, phifem_tpu_torch.models.flower, "
        "phifem_tpu_torch.ops.taps, phifem_tpu_torch.ops.cuda_taps, "
        "phifem_tpu_torch.models.strong_dirichlet, phifem_tpu_torch.models.neumann, "
        "phifem_tpu_torch.models.robin, phifem_tpu_torch.models.neumann_square, "
        "phifem_tpu_torch.models.robin_square; "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'phifem_tpu')); "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_global_default_changed():
    import phifem_tpu_torch as pt

    before = (torch.get_default_dtype(), torch.empty(0).device)
    s = pt.BoxPoisson(pt.Grid(4, 4)).setup(lambda x: x[:, 0]).assemble()
    assert (torch.get_default_dtype(), torch.empty(0).device) == before
    assert s.b["u"].dtype == torch.float64


def test_float32_grid_flows_through():
    import phifem_tpu_torch as pt

    g = pt.Grid(8, 8, dtype=torch.float32)
    s = pt.BoxPoisson(g).setup(lambda x: torch.ones_like(x[:, 0])).assemble()
    assert s.b["u"].dtype == torch.float32
    assert s.op.batches[0].matrices.dtype == torch.float32
    assert s.u_D.data.dtype == torch.float32


def test_unported_paths_raise():
    import phifem_tpu_torch as pt

    g = pt.Grid(4, 4)
    s = pt.BoxPoisson(g).setup(lambda x: x[:, 0]).assemble()
    with pytest.raises(NotImplementedError):
        pt.solve(s.op, s.b, bcs=s.bcs, method="gmres")
    # the sub mode is ported (slice C); the Ritz modes of the lattice
    # preconditioner come with slice D
    circle = lambda x: x[:, 0] ** 2 + x[:, 1] ** 2 - 0.2
    w = pt.WeakDirichletPoisson(pt.Grid(8, 8, ((-1.0, -1.0), (1.0, 1.0))), mode="sub")
    w.setup(circle, lambda x: x[:, 0]).assemble()
    with pytest.raises(NotImplementedError, match="slice D"):
        w.lattice_preconditioner(ritz_modes=2)
