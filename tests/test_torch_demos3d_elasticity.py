"""The port's 3D demo CLI, its elasticity case (``phifem_tpu_torch.demo.
poisson3d elasticity``), on the CPU at the JAX package's demo-test size
(``tests/test_demos.py``: n=8, ``--tol 1e-6 --sweeps 12 --maxiter 120``):
JAX's printed markers, the written VTI volume equal to the scheme's lattice
field to the writer's ``%.10g``, and the run held to the JAX demo run
in-process with the same arguments (``torch_demo_jax``).  A file of its own
(the other poisson3d cases are ``tests/test_torch_demos3d.py``): with both
demos in one run it is the suite's longest test, and the suite's workers
take whole files."""

import pytest
from torch_demo_jax import hold_jax_demo3d, hold_vti

from phifem_tpu_torch.demo import poisson3d
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)


def test_poisson3d_elasticity_demo(tmp_path, capsys):
    pytest.importorskip("jax")
    argv = ["elasticity", "--n", "8", "--tol", "1e-6", "--sweeps", "12", "--maxiter", "120"]
    r = poisson3d.main(argv + ["--device", "cpu", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "converged=True" in out and "Relative L2 error" in out, out[-500:]
    for k, c in enumerate(("ux", "uy", "uz")):
        hold_vti(r["paths"][0], c, r["scheme"].u_lat[k])
    (tmp_path / "jax").mkdir()
    hold_jax_demo3d(r, argv, tmp_path, ["ux", "uy", "uz"], 1e-6)
