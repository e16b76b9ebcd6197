"""The port's 3D demo CLI (``phifem_tpu_torch.demo.poisson3d``) on the CPU
at the JAX package's demo-test sizes (``tests/test_demos.py``: n=8, the
elasticity case with ``--tol 1e-6 --sweeps 12 --maxiter 120``): JAX's
printed markers, and the written VTI volume equal to the scheme's lattice
field to the writer's ``%.10g``.  Each run is held to the JAX demo run
in-process with the same arguments (``torch_demo_jax``), and the demo's
manufactured data to the JAX demo's functions."""

from pathlib import Path

import numpy as np
import pytest
import torch
from torch_demo_jax import load_demo, printed, printed_iterations, run_demo

from phifem_tpu_torch.demo import poisson3d

# the printed errors are %.6e (half a unit in the 7th digit: 5e-7 of the
# value); the two solves stop at the same relative residual by different
# dot products (f64 here, f32 in JAX), which moves the errors by less
# (measured on a CPU: at most 2.3e-7 with the rounding)
PRINTED_REL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Under the suite's parallel workers torch's intra-op threads only
    contend for the cores: one thread a worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def read_vti(path: str, name: str) -> np.ndarray:
    lines = Path(path).read_text().split("\n")
    i = next(k for k, s in enumerate(lines) if f'Name="{name}"' in s)
    return np.array(lines[i + 1].split(), np.float64)


def _hold_vti(path, name, field):
    ref = field.reshape(-1).numpy()
    got = read_vti(path, name)
    # ten significant digits: a relative 5e-10 of each value
    assert got.shape == ref.shape and np.all(np.abs(got - ref) <= 5e-10 * np.abs(ref) + 1e-300)


def _hold_jax_demo(r, argv, tmp_path, fields, sol_rel):
    """The JAX demo with the same arguments: its printed errors, its count
    within max(3, 25%), and its written volume to ``sol_rel`` of the
    field's largest value: the two solves' stopping points (measured on a
    CPU: at most 1.8e-9 for the Poisson schemes stopped at 1e-10, 7.8e-8
    for elasticity stopped at 1e-6)."""
    out = run_demo("poisson3d/main.py", argv, tmp_path / "jax")
    assert "converged=True" in out, out[-500:]
    for key, label in (("l2", "Relative L2 error:"), ("h10", "Relative H10 error:")):
        jerr = printed(out, label)
        assert abs(r["errors"][key] - jerr) <= PRINTED_REL * jerr, (key, r["errors"][key], jerr)
    (jit,) = printed_iterations(out)
    assert abs(r["iterations"] - jit) <= max(3, 0.25 * jit), (r["iterations"], jit)
    jpath = tmp_path / "jax" / f"{argv[0]}_output" / "solution.vti"
    for name in fields:
        got, ref = read_vti(r["paths"][0], name), read_vti(str(jpath), name)
        assert got.shape == ref.shape and np.abs(got - ref).max() <= sol_rel * np.abs(ref).max(), name


@pytest.mark.parametrize("scheme", ["weak", "strong", "neumann", "robin"])
def test_poisson3d_demo(scheme, tmp_path, capsys):
    pytest.importorskip("jax")
    r = poisson3d.main([scheme, "--n", "8", "--device", "cpu", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "converged=True" in out and "Relative L2 error" in out, out[-500:]
    assert r["converged"] and r["errors"]["l2"] < 0.5
    assert r["paths"] == [str(tmp_path / "solution.vti")]
    _hold_vti(r["paths"][0], "u", r["scheme"].u_lat)
    (tmp_path / "jax").mkdir()
    _hold_jax_demo(r, [scheme, "--n", "8"], tmp_path, ["u"], 1e-7)


def test_poisson3d_elasticity_demo(tmp_path, capsys):
    pytest.importorskip("jax")
    argv = ["elasticity", "--n", "8", "--tol", "1e-6", "--sweeps", "12", "--maxiter", "120"]
    r = poisson3d.main(argv + ["--device", "cpu", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "converged=True" in out and "Relative L2 error" in out, out[-500:]
    for k, c in enumerate(("ux", "uy", "uz")):
        _hold_vti(r["paths"][0], c, r["scheme"].u_lat[k])
    (tmp_path / "jax").mkdir()
    _hold_jax_demo(r, argv, tmp_path, ["ux", "uy", "uz"], 1e-6)


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
