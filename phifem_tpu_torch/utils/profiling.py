"""Profiling: phase wall clocks, MDoF/s throughput, torch.profiler traces.

Counterpart of :mod:`phifem_tpu.utils.profiling` (a copy: the port imports
nothing of the JAX package).  The reference's PETSc logging becomes phase
timers plus an optional device trace.

One deliberate difference: the JAX ``Timer.phase`` waits on a fresh array
at its start, which does not wait for queued work, so a phase there times
its dispatch.  Here a ``Timer`` on a CUDA device synchronizes that device
on entry and on exit of every phase, so a phase's time includes the work
it queued; on the CPU nothing is queued and nothing syncs.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time
from typing import Dict, Optional, Union

import torch

__all__ = ["Timer", "report_throughput", "device_trace"]


class Timer:
    """Phase timer accumulating wall-clock per named phase."""

    def __init__(self, device: Union[str, torch.device] = "cuda"):
        self.device = torch.device(device)
        self.phases: Dict[str, float] = {}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.phases[name] = self.phases.get(name, 0.0) + (time.perf_counter() - t0)

    def report(self) -> str:
        total = sum(self.phases.values())
        lines = [f"{k:>24s}: {v:8.3f} s" for k, v in self.phases.items()]
        lines.append(f"{'total':>24s}: {total:8.3f} s")
        return "\n".join(lines)


def report_throughput(ndofs: int, seconds: float, label: str = "") -> float:
    """MDoF/s figure of merit."""
    mdofs = ndofs / seconds / 1e6 if seconds > 0 else float("inf")
    if label:
        print(f"{label}: {ndofs} DoF in {seconds:.4f} s = {mdofs:.2f} MDoF/s")
    return mdofs


_TRACE_IDS = itertools.count()


@contextlib.contextmanager
def device_trace(logdir: Optional[str]):
    """Optional ``torch.profiler`` trace of the block (host and, where there
    is a card, CUDA activity), written as a Chrome trace (Perfetto,
    ``chrome://tracing``) into ``logdir``; the counterpart of the JAX
    package's ``xla_trace``.  Yields the trace file's path, written when the
    block ends; a falsy ``logdir`` traces nothing and yields None."""
    if not logdir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace_{os.getpid()}_{next(_TRACE_IDS)}.json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)
