"""Deterministic scatter-add plans.

CUDA's ``index_add_`` on repeated indices sums in an order that changes
from run to run.  A plan instead gathers each target's contributions in
entity order, sums them, and adds the sum once, so the result is the
same on every run.  Used by the entity batches' scatter
(:meth:`phifem_tpu_torch.assembly.Batch.scatter_add`) and by the tap
form's weight refresh (:meth:`phifem_tpu_torch.ops.taps.TapOperator.refresh`).
"""

from __future__ import annotations

import torch

__all__ = ["scatter_plan"]


def scatter_plan(dofs: torch.Tensor):
    """Deterministic scatter-add plan for the target ids ``dofs`` (any
    shape, flattened): ``(uniq, pos)`` with the distinct ids and, per id,
    the positions of its entries in the flattened ``dofs`` in entity order,
    padded with ``dofs.numel()`` (a zero row the caller appends)."""
    flat = dofs.reshape(-1)
    n = flat.numel()
    order = torch.argsort(flat, stable=True)
    uniq, counts = torch.unique_consecutive(flat[order], return_counts=True)
    group = torch.repeat_interleave(torch.arange(uniq.numel(), device=flat.device), counts)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n, device=flat.device) - starts[group]
    kmax = int(counts.max()) if n else 0
    pos = torch.full((uniq.numel(), kmax), n, dtype=torch.int64, device=flat.device)
    pos[group, rank] = order
    return uniq, pos
