"""Build a kernel source of the package with ``nvcc`` into a shared library.

Each ``csrc/*.cu`` file has a plain C interface and is compiled on its own
for ``sm_90a`` into ``phifem_tpu_torch/_build/`` at first use, under a name
keyed by a hash of the source and flags (an edit rebuilds it); the wrappers
load it with ``ctypes``.  Several sources build in parallel when their
``build`` calls run in separate threads (each is one ``nvcc`` process).
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME)")


def library_path(source: Path) -> Path:
    key = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}_{key.hexdigest()[:16]}.so"


def build(source: Path) -> dict:
    """Compile ``source`` if its library is not built yet.  Returns
    ``{"path", "seconds", "log"}``; ``log`` holds nvcc's ptxas report of
    the build that made the library (empty when it was already built)."""
    so = library_path(source)
    t0 = time.perf_counter()
    if so.exists():
        return {"path": str(so), "seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.{time.monotonic_ns()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{source.name}: nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent build never loads a partial file
    return {"path": str(so), "seconds": time.perf_counter() - t0, "log": proc.stderr}
