"""The JAX package's demo CLIs (``demo/**/main.py``) run in-process, for the
port's demo parity tests: each ``main()`` reads ``sys.argv`` and writes
beside its own ``__file__``, so the module is loaded by path and its
``__file__`` pointed into a temporary directory (with copies of the files
the demo reads there).  Importing this module imports nothing of JAX; the
demos import it when they are loaded.  Also the checks that hold a
poisson3d demo run of the port to the JAX demo's (``hold_vti``,
``hold_jax_demo3d``)."""

import contextlib
import importlib.util
import io
import re
import shutil
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
DEMO = REPO / "demo"


def load_demo(rel: str, name: str):
    """The module ``demo/<rel>`` loaded by path under ``name``, with the
    demo's own ``data`` module (each 2D demo has one of that name)."""
    path = DEMO / rel
    saved_path, saved_data = list(sys.path), sys.modules.pop("data", None)
    try:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved_path
        sys.modules.pop("data", None)
        if saved_data is not None:
            sys.modules["data"] = saved_data
    return mod


def run_demo(rel: str, argv, tmp_path: Path, copy=()) -> str:
    """``python demo/<rel> *argv`` in-process with its outputs under
    ``tmp_path`` (``copy``: the files of the demo's folder it reads);
    returns what it printed."""
    mod = load_demo(rel, "jax_demo_" + re.sub(r"\W", "_", rel))
    for f in copy:
        shutil.copy(DEMO / Path(rel).parent / f, tmp_path / f)
    mod.__file__ = str(tmp_path / "main.py")
    saved_argv, buf = sys.argv, io.StringIO()
    sys.argv = ["main.py", *map(str, argv)]
    try:
        with contextlib.redirect_stdout(buf):
            mod.main()
    finally:
        sys.argv = saved_argv
    return buf.getvalue()


def printed(out: str, label: str) -> float:
    """The number after ``label`` in a demo's output."""
    return float(re.search(re.escape(label) + r"\s*([-+0-9.eE]+)", out).group(1))


def printed_iterations(out: str) -> list:
    """Every Krylov count a demo printed (``iters N`` / ``iters=N``)."""
    return [int(k) for k in re.findall(r"iters[ =](\d+)", out)]


# --------------------------------------------- poisson3d demo checks
# the printed errors are %.6e (half a unit in the 7th digit: 5e-7 of the
# value); the two solves stop at the same relative residual by different
# dot products (f64 here, f32 in JAX), which moves the errors by less
# (measured on a CPU: at most 2.3e-7 with the rounding)
PRINTED_REL_3D = 1e-6


def read_vti(path: str, name: str) -> np.ndarray:
    lines = Path(path).read_text().split("\n")
    i = next(k for k, s in enumerate(lines) if f'Name="{name}"' in s)
    return np.array(lines[i + 1].split(), np.float64)


def hold_vti(path, name, field):
    """The VTI's field ``name`` equal to ``field`` to its ten digits."""
    ref = field.reshape(-1).numpy()
    got = read_vti(path, name)
    # ten significant digits: a relative 5e-10 of each value
    assert got.shape == ref.shape and np.all(np.abs(got - ref) <= 5e-10 * np.abs(ref) + 1e-300)


def hold_jax_demo3d(r, argv, tmp_path, fields, sol_rel):
    """``demo/poisson3d/main.py`` with the same arguments: its printed
    errors, its count within max(3, 25%), and its written volume to
    ``sol_rel`` of the field's largest value: the two solves' stopping
    points (measured on a CPU: at most 1.8e-9 for the Poisson schemes
    stopped at 1e-10, 7.8e-8 for elasticity stopped at 1e-6)."""
    out = run_demo("poisson3d/main.py", argv, tmp_path / "jax")
    assert "converged=True" in out, out[-500:]
    for key, label in (("l2", "Relative L2 error:"), ("h10", "Relative H10 error:")):
        jerr = printed(out, label)
        assert abs(r["errors"][key] - jerr) <= PRINTED_REL_3D * jerr, (key, r["errors"][key], jerr)
    (jit,) = printed_iterations(out)
    assert abs(r["iterations"] - jit) <= max(3, 0.25 * jit), (r["iterations"], jit)
    jpath = tmp_path / "jax" / f"{argv[0]}_output" / "solution.vti"
    for name in fields:
        got, ref = read_vti(r["paths"][0], name), read_vti(str(jpath), name)
        assert got.shape == ref.shape and np.abs(got - ref).max() <= sol_rel * np.abs(ref).max(), name
