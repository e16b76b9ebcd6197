"""The JAX package's demo CLIs (``demo/**/main.py``) run in-process, for the
port's demo parity tests: each ``main()`` reads ``sys.argv`` and writes
beside its own ``__file__``, so the module is loaded by path and its
``__file__`` pointed into a temporary directory (with copies of the files
the demo reads there).  Importing this module imports nothing of JAX; the
demos import it when they are loaded."""

import contextlib
import importlib.util
import io
import re
import shutil
import sys
from pathlib import Path

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
