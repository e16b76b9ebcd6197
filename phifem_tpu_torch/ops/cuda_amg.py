"""The ELL sweep of the AMG V-cycle: CUDA kernel wrapper and its plain
version.

Replaces the XLA-fused ELL loops of ``phifem_tpu/amg.py``: ``AMG._mv`` and
``AMG._ell_apply`` (a level's operator, R = P^T and P) and the damped-Jacobi
sweep ``AMG._smooth``.  The kernel (``phifem_tpu_torch/csrc/amg_ell.cu``) is
built with ``nvcc`` at first use (:mod:`phifem_tpu_torch.ops.nvcc_build`)
and loaded with ``ctypes``.

An ELL matrix of ``n`` rows and width ``w`` is stored slot-major: ``cols``
(w, n) int32 and ``vals`` (w, n), a padded slot holding the column
``len(x)`` and the value 0.  :func:`amg_ell_sweep` writes a new vector:

* ``APPLY``: ``A x``;
* ``RESIDUAL``: ``b - A x``;
* ``JACOBI``: ``x + d (b - A x)``, ``d`` the inverse diagonal already
  scaled by the damping weight;
* ``PROLONG_ADD``: ``b + A x``, ``b`` a base vector (the V-cycle's
  ``x + P e_c`` in one launch).

Each row is served by a group of ``lanes`` lanes (1, 2, 4, ..., 32), which
split its slots and add their products in ascending slot order; every call
names its group size.  :func:`lanes_for` picks the one of a table from its
rows and width, once, and the V-cycle keeps it per table.

It dispatches on the tensor's device: a CPU tensor goes to
:func:`amg_ell_sweep_ref`, a CUDA tensor to the kernel, anything else
raises; there is no fallback from the card to the plain version.  Each row
sums its slots in ascending order with every operation rounded on its own,
so the kernel equals the plain version bit for bit.  ``launches`` counts
the kernel launches of :func:`amg_ell_sweep`; the interface band solve's ELL
products run the same kernel through :func:`launch` and are counted in
:mod:`phifem_tpu_torch.ops.cuda_band`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import nvcc_build

__all__ = ["APPLY", "RESIDUAL", "JACOBI", "PROLONG_ADD", "amg_ell_sweep", "amg_ell_sweep_ref", "build", "lanes_for"]

APPLY, RESIDUAL, JACOBI, PROLONG_ADD = 0, 1, 2, 3
MODES = (APPLY, RESIDUAL, JACOBI, PROLONG_ADD)

#: number of kernel launches made by :func:`amg_ell_sweep`
launches = 0

SOURCE = nvcc_build.PKG / "csrc" / "amg_ell.cu"
#: the kernel's CTA size
THREADS = 256
#: the group sizes the kernel takes, and the float32 slots a lane of each
#: holds in flight (one chunk; half as many in float64)
LANES = (1, 2, 4, 8, 16, 32)
CHUNK = {1: 8, 2: 8, 4: 8, 8: 8, 16: 8, 32: 4}
#: the fewest lanes a launch should run: a coarse table's few rows get
#: wider groups up to this count (measured on the H100 at every group size
#: on the S1-U n=800 hierarchy, scripts/tune_torch_amg.py --lanes: more
#: lanes only add shuffles once the launch holds ~16k)
FILL = 2**14


def lanes_for(n: int, width: int) -> int:
    """The group size for a table of ``n`` rows and ``width`` slots: the
    smallest power of two that puts each lane's slots in one chunk and
    gives the launch ``FILL`` lanes, at most 32 and not past the width."""
    lanes = 1
    while lanes < 32 and lanes < width and (n * lanes < FILL or -(-width // lanes) > CHUNK[lanes]):
        lanes *= 2
    return lanes


def amg_ell_sweep_ref(
    mode: int,
    cols: torch.Tensor,
    vals: torch.Tensor,
    x: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    d: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version: x with a zero appended for the pad column,
    every product at once, the slots summed one by one in ascending
    order."""
    prod = vals * torch.cat([x, x.new_zeros(1)])[cols]
    acc = prod[0]
    for k in range(1, cols.shape[0]):
        acc = acc + prod[k]
    if mode == APPLY:
        return acc
    if mode == PROLONG_ADD:
        return b + acc
    r = b - acc
    if mode == RESIDUAL:
        return r
    return x + d * r


def _check(mode, cols, vals, x, b, d, lanes) -> None:
    if mode not in MODES:
        raise ValueError(f"amg_ell_sweep: unknown mode {mode}")
    if cols.dim() != 2 or cols.shape[0] < 1 or cols.shape[1] < 1:
        raise ValueError(f"amg_ell_sweep: cols must be a (width, n) table, got {tuple(cols.shape)}")
    if cols.dtype is not torch.int32:
        raise TypeError(f"amg_ell_sweep: cols must be int32, got {cols.dtype}")
    if vals.shape != cols.shape:
        raise ValueError(f"amg_ell_sweep: vals {tuple(vals.shape)} and cols {tuple(cols.shape)} differ in shape")
    if vals.dtype is not x.dtype or x.dim() != 1:
        raise ValueError("amg_ell_sweep: x must be a vector in the dtype of vals")
    n = cols.shape[1]
    if mode != APPLY:
        for name, t in [("b", b)] + ([("d", d)] if mode == JACOBI else []):
            if t is None or t.shape != (n,) or t.dtype is not x.dtype or t.device != x.device:
                raise ValueError(f"amg_ell_sweep: {name} must be a ({n},) vector like x")
    if mode == JACOBI and x.shape[0] != n:
        raise ValueError("amg_ell_sweep: a Jacobi sweep needs a square matrix (len(x) == n)")
    if lanes not in LANES:
        raise ValueError(f"amg_ell_sweep: lanes must be one of {LANES}, got {lanes}")


def amg_ell_sweep(
    mode: int,
    cols: torch.Tensor,
    vals: torch.Tensor,
    x: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    d: Optional[torch.Tensor] = None,
    *,
    lanes: int,
) -> torch.Tensor:
    """One sweep (see the module docstring); returns a new ``(n,)`` vector.
    ``lanes`` is the group size per row (one of ``LANES``; the V-cycle
    passes the :func:`lanes_for` of the table that it keeps).  The kernel
    takes float32 or float64 values, contiguous tensors on one card and
    fewer than 2^31 slots."""
    global launches
    _check(mode, cols, vals, x, b, d, lanes)
    dev = x.device
    if dev.type == "cpu":
        return amg_ell_sweep_ref(mode, cols, vals, x, b, d)
    if dev.type != "cuda":
        raise ValueError(f"amg_ell_sweep: no kernel for device {dev}")
    dt = x.dtype
    if dt is not torch.float32 and dt is not torch.float64:
        raise TypeError(f"amg_ell_sweep: values must be float32 or float64, got {dt}")
    width, n = cols.shape
    for t in (cols, vals, x) + ((b,) if mode != APPLY else ()) + ((d,) if mode == JACOBI else ()):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("amg_ell_sweep: every tensor must be contiguous and on x's device")
    if width * n >= 2**31 or lanes * n >= 2**31 or x.shape[0] >= 2**31:
        raise ValueError("amg_ell_sweep: table too large for 32-bit indexing")
    y = torch.empty(n, dtype=dt, device=dev)
    launch(mode, cols, vals, x, b, d, y, lanes)
    launches += 1
    return y


def launch(mode: int, cols, vals, x, b, d, y, lanes: int) -> None:
    """Launch the kernel into ``y`` on tensors the caller has checked (as
    :func:`amg_ell_sweep` does), without counting the launch: the band
    solve's product (``ops.cuda_band.band_ell``) counts its own."""
    dev = x.device
    fn, raw_stream, current = _LAUNCH.get("fn") or _bind()
    idx = dev.index
    args = (cols.data_ptr(), vals.data_ptr(), x.data_ptr(), None if b is None else b.data_ptr(),
            None if d is None else d.data_ptr(), y.data_ptr(), cols.shape[1], cols.shape[0], x.shape[0], mode,
            lanes, x.dtype is torch.float64, raw_stream(idx))
    if idx == current():
        err = fn(*args)
    else:
        with torch.cuda.device(dev):
            err = fn(*args)
    if err:
        msg = _library().phifem_amg_error_string(err).decode()
        raise RuntimeError(f"amg_ell_sweep kernel launch failed: CUDA error {err} ({msg})")


#: the entry point, the current raw stream of a device and the current
#: device, bound at the kernel's first launch
_LAUNCH = {}


def _bind():
    torch.cuda.init()
    _LAUNCH["fn"] = (_library().phifem_amg_ell_sweep, torch._C._cuda_getCurrentRawStream, torch._C._cuda_getDevice)
    return _LAUNCH["fn"]


def build() -> dict:
    """Compile the kernel library if it is not built yet (see
    :func:`phifem_tpu_torch.ops.nvcc_build.build`)."""
    return nvcc_build.build(SOURCE)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build()["path"])
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.phifem_amg_ell_sweep.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp]
    lib.phifem_amg_ell_sweep.restype = ci
    lib.phifem_amg_error_string.argtypes = [ci]
    lib.phifem_amg_error_string.restype = ctypes.c_char_p
    lib.phifem_amg_ell_threads.restype = ci
    lib.phifem_amg_ell_chunk.argtypes = [ci, ci]
    lib.phifem_amg_ell_chunk.restype = ci
    got = (lib.phifem_amg_ell_threads(), {k: lib.phifem_amg_ell_chunk(k, 0) for k in LANES})
    if got != (THREADS, CHUNK):
        raise RuntimeError(f"amg_ell_sweep: the library's CTA size and chunks {got} are not {(THREADS, CHUNK)}")
    return lib
