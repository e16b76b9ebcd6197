"""The port's demo CLIs (``phifem_tpu_torch.demo``) on the CPU at the JAX
package's demo-test sizes (``tests/test_demos.py``: n=40, ``param_quick``;
the unstructured demo at its defaults): each prints the JAX CLI's markers
and writes the scheme's own field.  The flower demo's written solution is
held to the JAX scheme's; the S2-S4 demos (bg), the S5 demo's first level
and the unstructured demo to the JAX demo run in-process with the same
arguments (``torch_demo_jax``); the JSON parameter files to JAX's YAML."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_demo_jax import printed, printed_iterations, run_demo

from phifem_tpu_torch.demo import (
    interface_elasticity,
    neumann_square,
    robin_square,
    strong_dirichlet_flower,
    unstructured,
    weak_dirichlet_flower,
)
from phifem_tpu_torch.utils.io import _p1_point_data
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

REPO = Path(__file__).resolve().parents[1]
# the solutions of two solves stopped at the same relative residual (1e-10)
# by different dot products (f64 here, f32 in JAX): the flower test's 1e-6
# (measured on a CPU: at most 6.2e-8 of the largest value)
SOL_REL = 1e-6
# errors JAX prints or writes in full (the 2D demos' H1, the S5 demo's
# results.csv): the two stopping points move them by at most 7.4e-9
ERR_REL = 1e-7
# errors JAX prints as %.6e: half a unit in the 7th digit is 5e-7 of the
# value, and the two stopping points move them by less (at most 8.6e-8)
PRINTED_REL = 1e-6
# the JAX 2D demos' folders
JAX_2D = {
    "strong_dirichlet_flower": "strong-dirichlet/flower/main.py",
    "neumann_square": "neumann/square/main.py",
    "robin_square": "robin/square/main.py",
}


def read_point_data(path: str, name: str) -> np.ndarray:
    """The vertex field ``name`` as written: from the HDF5 file next to an
    XDMF, else from a VTU's ASCII line (``%.17g``, exact in float64)."""
    if path.endswith(".xdmf"):
        import h5py

        with h5py.File(os.path.splitext(path)[0] + ".h5") as h5:
            return np.asarray(h5[f"/Function/{name}"])
    lines = Path(path).read_text().split("\n")
    i = next(k for k, s in enumerate(lines) if f'Name="{name}"' in s)
    return np.array(lines[i + 1].split(), np.float64)


def _run(mod, args, tmp_path, capsys):
    r = mod.main(list(args) + ["--device", "cpu", "--out", str(tmp_path)])
    return r, capsys.readouterr().out


def _hold_written(r):
    s = r["scheme"]
    written = read_point_data(r["paths"][0], "solution")
    assert np.array_equal(written.reshape(-1), _p1_point_data(s.u_h).reshape(-1))


def _hold_close(got, ref, rel):
    got, ref = np.asarray(got).reshape(-1), np.asarray(ref).reshape(-1)
    assert got.shape == ref.shape and np.abs(got - ref).max() <= rel * np.abs(ref).max()


FLAT_2D = {
    "weak_dirichlet_flower": weak_dirichlet_flower,
    "strong_dirichlet_flower": strong_dirichlet_flower,
    "neumann_square": neumann_square,
    "robin_square": robin_square,
}


@pytest.mark.parametrize("mode", ["bg", "sub"])
@pytest.mark.parametrize("demo", list(FLAT_2D))
def test_2d_demo(demo, mode, tmp_path, capsys):
    """In bg mode the S2-S4 demos are also held to the JAX demo's run: the
    written solution to SOL_REL, the printed H1 error to ERR_REL (S1's
    bg run is held to the JAX scheme below; sub mode differs from bg only
    in the mode it passes the scheme)."""
    r, out = _run(FLAT_2D[demo], [mode, "--n", "40"], tmp_path, capsys)
    assert "converged=True" in out and r["converged"], out[-500:]
    if demo in ("neumann_square", "robin_square"):
        assert "Relative H1 error:" in out and r["errors"]["h1"] < 0.5
    assert "total" in out and set(r["phases"]) >= {"tag+setup", "assemble", "solve"}
    assert r["paths"] == [str(tmp_path / "solution.xdmf")] or r["paths"] == [str(tmp_path / "solution.vtu")]
    _hold_written(r)
    if mode == "bg" and demo in JAX_2D:
        pytest.importorskip("jax")
        (tmp_path / "jax").mkdir()
        jout = run_demo(JAX_2D[demo], [mode, "--n", "40"], tmp_path / "jax")
        assert "converged=True" in jout, jout[-500:]
        jpath = next((tmp_path / "jax" / "bg_output").glob("solution.*[fu]"))
        _hold_close(read_point_data(r["paths"][0], "solution"), read_point_data(str(jpath), "solution"), SOL_REL)
        if r["errors"] is not None:
            jh1 = printed(jout, "Relative H1 error:")
            assert abs(r["errors"]["h1"] - jh1) <= ERR_REL * jh1, (r["errors"]["h1"], jh1)


def test_flower_demo_matches_the_jax_scheme(tmp_path, capsys):
    """The demo's written S1 solution at n=24 (bg) against the JAX package's
    scheme built by ``torch_s1_cases.flower`` (the demo's configuration) and
    solved as the JAX demo solves it, to the solves' usual 1e-6."""
    pytest.importorskip("jax")
    from torch_s1_cases import flower, rel

    r, out = _run(weak_dirichlet_flower, ["bg", "--n", "24"], tmp_path, capsys)
    sj, _ = flower(24)
    rj = sj.solve(method="bicgstab")
    assert rj.converged and r["converged"]
    written = read_point_data(r["paths"][0], "solution")
    assert rel(written, np.asarray(sj.u_h.data)) <= 1e-6
    assert abs(r["iterations"] - rj.iterations) <= max(3, 0.25 * rj.iterations)


def test_interface_elasticity_quick_demo(tmp_path, capsys):
    """``param_quick`` (two levels, n=12 and 24), Jacobi-preconditioned: the
    default coupled preconditioner's dense coarse solve of the whole n=24
    system takes ~100 s of host pseudo-inverse on a CPU.  Its first level is
    held to the JAX demo's run of ``param_quick`` cut to that level (the
    levels run the same code on a refined grid): the DoF count, both errors
    of ``results.csv`` to ERR_REL, the count within max(3, 25%) and the
    written solution to SOL_REL."""
    r, out = _run(interface_elasticity, ["param_quick", "--precond", "none"], tmp_path, capsys)
    assert "slope" in out.lower() and out.count("converged=True") == 2, out[-500:]
    assert r["converged"] and [lv["n"] for lv in r["levels"]] == [12, 24]
    assert r["slopes"]["l2"] < -0.5 and r["slopes"]["h10"] < 0.0
    rows = (tmp_path / "results.csv").read_text().strip().split("\n")
    assert rows[0] == "dof,H10 relative error,L2 relative error" and len(rows) == 3
    assert r["paths"][-1] == str(tmp_path / "results.csv")
    _hold_written({"scheme": r["scheme"], "paths": [r["paths"][1]]})

    yaml = pytest.importorskip("yaml")
    pytest.importorskip("jax")
    jdir = tmp_path / "jax"
    jdir.mkdir()
    cfg = yaml.safe_load((REPO / "demo" / "interface-elasticity" / "param_quick.yaml").read_text())
    (jdir / "level0.yaml").write_text(yaml.safe_dump({**cfg, "num_iterations": 1}))
    jout = run_demo("interface-elasticity/main.py", ["level0", "--precond", "none"], jdir)
    (jit,) = printed_iterations(jout)
    assert abs(r["iterations"][0] - jit) <= max(3, 0.25 * jit), (r["iterations"], jit)
    jrow = (jdir / "level0_output" / "results.csv").read_text().strip().split("\n")[1].split(",")
    assert int(jrow[0]) == int(rows[1].split(",")[0])
    for key, j in (("h10", 1), ("l2", 2)):
        assert abs(r["errors"][0][key] - float(jrow[j])) <= ERR_REL * float(jrow[j]), (key, jrow)
    jpath = next((jdir / "level0_output" / "functions").glob("solution_00.*[fu]"))
    _hold_close(read_point_data(r["paths"][0], "solution"), read_point_data(str(jpath), "solution"), SOL_REL)


@pytest.mark.parametrize("args", [["s1"], ["s1", "--dim", "3"]], ids=["tri", "tet"])
def test_unstructured_demo(args, tmp_path, capsys):
    """At its defaults (the perturbed n=24 triangle mesh; the n=12 tet box)
    the errors are the JAX demo's, run in-process with the same arguments,
    to PRINTED_REL, and the count within max(3, 25%) of its."""
    r, out = _run(unstructured, args, tmp_path, capsys)
    assert "converged=True" in out and "Relative L2 error" in out, out[-500:]
    pytest.importorskip("jax")
    (tmp_path / "jax").mkdir()
    jout = run_demo("unstructured/main.py", args, tmp_path / "jax")
    assert "converged=True" in jout, jout[-500:]
    for key, label in (("l2", "Relative L2 error:"), ("h10", "Relative H10 error:")):
        jerr = printed(jout, label)
        assert abs(r["errors"][key] - jerr) <= PRINTED_REL * jerr, (key, r["errors"][key], jerr)
    (jit,) = printed_iterations(jout)
    assert abs(r["iterations"] - jit) <= max(3, 0.25 * jit), (r["iterations"], jit)
    s = r["scheme"]
    written = read_point_data(r["paths"][0], "solution")
    assert np.array_equal(written, s.u_h.data[: s.mesh.num_vertices].numpy())


@pytest.mark.parametrize("name", ["param1", "param_quick", "param1_l7"])
def test_parameter_files_equal_the_jax_yaml(name):
    yaml = pytest.importorskip("yaml")
    port = json.loads((REPO / "phifem_tpu_torch" / "demo" / "params" / f"{name}.json").read_text())
    jax_cfg = yaml.safe_load((REPO / "demo" / "interface-elasticity" / f"{name}.yaml").read_text())
    assert port == jax_cfg


def test_demo_runs_as_a_module(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "phifem_tpu_torch.demo.strong_dirichlet_flower", "bg", "--n", "16",
         "--device", "cpu"], capture_output=True, text=True, cwd=tmp_path, env=env, timeout=600,
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "converged=True" in proc.stdout
    out = tmp_path / "phifem_torch_output" / "strong_dirichlet_flower_bg"
    assert (out / "solution.xdmf").is_file() or (out / "solution.vtu").is_file()


def test_demos_default_to_the_card(tmp_path):
    import argparse

    from phifem_tpu_torch.demo import add_port_options

    p = argparse.ArgumentParser()
    add_port_options(p)
    a = p.parse_args([])
    assert a.device == "cuda" and a.out is None
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            strong_dirichlet_flower.main(["bg", "--n", "8", "--out", str(tmp_path)])
