"""The port's 3D demo CLI (``phifem_tpu_torch.demo.poisson3d``) on the CPU
at the JAX package's demo-test sizes (``tests/test_demos.py``: n=8, the
elasticity case with ``--tol 1e-6 --sweeps 12 --maxiter 120``): JAX's
printed markers, and the written VTI volume equal to the scheme's lattice
field to the writer's ``%.10g``.  Each run is held to the JAX demo run
in-process with the same arguments (``torch_demo_jax``), and the demo's
manufactured data to the JAX demo's functions (the JAX demo module loaded
once per worker).  The elasticity case is
``tests/test_torch_demos3d_elasticity.py``: a file of its own, so that
the suite's workers run it beside the other cases."""

import functools

import numpy as np
import pytest
import torch
from torch_demo_jax import hold_jax_demo3d, hold_vti, load_demo

from phifem_tpu_torch.demo import poisson3d
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)


@pytest.mark.parametrize("scheme", ["weak", "strong", "neumann", "robin"])
def test_poisson3d_demo(scheme, tmp_path, capsys):
    pytest.importorskip("jax")
    r = poisson3d.main([scheme, "--n", "8", "--device", "cpu", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "converged=True" in out and "Relative L2 error" in out, out[-500:]
    assert r["converged"] and r["errors"]["l2"] < 0.5
    assert r["paths"] == [str(tmp_path / "solution.vti")]
    hold_vti(r["paths"][0], "u", r["scheme"].u_lat)
    (tmp_path / "jax").mkdir()
    hold_jax_demo3d(r, [scheme, "--n", "8"], tmp_path, ["u"], 1e-7)


@functools.lru_cache(maxsize=None)
def _jax_data():
    jd = load_demo("poisson3d/main.py", "jax_poisson3d_demo")
    je, jf = jd.elasticity_data(1.0, 0.001)
    te, tf = poisson3d.elasticity_data(1.0, 0.001)
    return {
        "phi": (jd.phi, poisson3d.phi),
        "u_smooth": (jd.u_smooth, poisson3d.u_smooth),
        "du_dn": (jd.du_dn, poisson3d.du_dn),
        "u_product": (jd.u_product, poisson3d.u_product),
        "neg_lap u_smooth": (jd.neg_lap(jd.u_smooth), poisson3d.neg_lap(poisson3d.u_smooth)),
        "neg_lap u_product": (jd.neg_lap(jd.u_product), poisson3d.neg_lap(poisson3d.u_product)),
        "elasticity exact": (je, te),
        "elasticity source": (jf, tf),
    }


DATA = ["phi", "u_smooth", "du_dn", "u_product", "neg_lap u_smooth", "neg_lap u_product", "elasticity exact",
        "elasticity source"]


@pytest.mark.parametrize("name", DATA)
def test_poisson3d_data_matches_jax(name):
    """Each of the demo's data functions against the JAX demo's at seeded
    points of the box (and on the sphere r = R0, where the elasticity data
    switches side), in a batch of two leading axes, to 1e-12 of the largest
    value: the same closed forms, derivatives by torch.func and by JAX."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    jfun, tfun = _jax_data()[name]
    rng = np.random.default_rng(7)
    x = rng.uniform(-1.0, 1.0, (6, 40, 3))
    x[0] *= poisson3d.R0 / np.linalg.norm(x[0], axis=-1, keepdims=True)
    ref = np.asarray(jfun(jnp.asarray(x)))
    got = tfun(torch.as_tensor(x)).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()
