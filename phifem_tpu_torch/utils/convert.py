"""Build the port's objects from another implementation's state, given as
numpy arrays (for example ``np.asarray`` of the JAX package's fields), so
that both compute the same thing.  Nothing here imports that package."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..assembly import Batch, Operator, System
from ..grid import Grid
from ..mg import TABLE_DTYPE, VCycle, ras_owner
from ..ops.lattice import LatticeMG, _Level
from ..ops.stencil import StencilCellBatch
from ..ops.taps import TapOperator, build_tap_operator
from ..spaces import Function, Space
from ..tagging import EntityTags, TagsMeasures, box_measure

__all__ = [
    "stencil_batch_from_numpy",
    "operator_from_numpy",
    "lattice_mg_from_numpy",
    "function_from_numpy",
    "tags_from_numpy",
    "batch_from_numpy",
    "interface_tables_from_numpy",
    "tap_operator_from_numpy",
    "scheme_data_from_numpy",
]


def stencil_batch_from_numpy(
    grid: Grid, field: str, matrices: np.ndarray, masks: Optional[np.ndarray]
) -> StencilCellBatch:
    """``matrices`` (norient, nloc, nloc) and ``masks`` (norient, ny, nx)
    or None (a term covering every cell)."""
    mats = torch.tensor(np.asarray(matrices), dtype=grid.dtype)
    m = None if masks is None else grid._tensor(np.asarray(masks))
    return StencilCellBatch(grid, field, mats, m)


def operator_from_numpy(
    system: System, batches: Sequence[Tuple[str, np.ndarray, Optional[np.ndarray]]]
) -> Operator:
    """``batches``: ``(field, matrices, masks)`` per stencil batch."""
    return Operator(
        system,
        [
            stencil_batch_from_numpy(system.fields[f].grid, f, mats, masks)
            for f, mats, masks in batches
        ],
    )


def lattice_mg_from_numpy(
    levels: Sequence[Tuple[int, int]],
    terms: Sequence[Tuple[int, int, float]],
    coarse_inv: np.ndarray,
    masks: Optional[Sequence[np.ndarray]],
    dtype: torch.dtype,
    device="cpu",
    **kw,
) -> LatticeMG:
    """``levels``: ``(R, C)`` logical lattice sizes, fine to coarse."""
    return LatticeMG(
        [_Level(int(R), int(C)) for R, C in levels],
        [(int(a), int(b), float(w)) for a, b, w in terms],
        torch.tensor(np.asarray(coarse_inv), dtype=dtype, device=device),
        dtype=dtype,
        masks=None
        if masks is None
        else [torch.tensor(np.asarray(m), dtype=dtype, device=device) for m in masks],
        **kw,
    )


def function_from_numpy(space: Space, data: np.ndarray) -> Function:
    return Function(space, space.grid._tensor(np.asarray(data)))


def tags_from_numpy(grid: Grid, cell_tags: np.ndarray, facet_tags: np.ndarray) -> TagsMeasures:
    """Box-mode tags and measures (ids 100, 101) from host tag arrays."""
    ct = EntityTags("cell", torch.tensor(np.asarray(cell_tags, np.int8), device=grid.device))
    ft = EntityTags("facet", torch.tensor(np.asarray(facet_tags, np.int8), device=grid.device))
    return TagsMeasures(ct, ft, None, box_measure(grid, ct, ft), None)


def batch_from_numpy(
    system: System,
    segments: Sequence[Tuple[str, np.ndarray, Tuple[int, ...]]],
    matrices: np.ndarray,
    orient: Optional[np.ndarray] = None,
) -> Batch:
    """``segments``: ``(field, dofs (ne, nloc), value_shape)``; ``matrices``
    per entity, or per orientation with ``orient`` (ne,)."""
    grid = system.fields[segments[0][0]].grid
    dev = grid.device
    idx = lambda a: torch.tensor(np.asarray(a), dtype=torch.int64, device=dev)
    segs = [(f, idx(d), tuple(vs)) for f, d, vs in segments]
    return Batch(segs, grid._tensor(np.asarray(matrices)), orient=None if orient is None else idx(orient))


def interface_tables_from_numpy(vc: VCycle, flat_meta, device="cpu", **fields) -> VCycle:
    """Fill the interface fields of ``vc`` from numpy arrays named as the
    JAX package's (``interface_ids``, ``interface_inv``, ``schwarz_ids``,
    ``schwarz_inv``, ``schwarz_own``, ``schwarz_sweeps``, ``band_ids``,
    ``band_ell_cols``, ``band_ell_vals``), on ``device``; ``flat_meta`` is
    ``(names, shapes, sizes)`` of the flat layout.  Float tables are stored
    in the interface table dtype; the (nb, K) ownership mask becomes the
    port's per-DoF owner slots."""
    dev = torch.device(device)
    vc._flat_meta = tuple(list(m) for m in flat_meta)
    if "schwarz_own" in fields:
        own = np.asarray(fields.pop("schwarz_own"), bool)
        fields["schwarz_owner"] = ras_owner(
            np.asarray(fields["schwarz_ids"]), own, len(fields["band_ids"])
        )
    for name, val in fields.items():
        if name == "schwarz_sweeps":
            vc.schwarz_sweeps = int(val)
            continue
        a = np.array(val)  # a writable copy
        if a.dtype == bool:
            t = torch.as_tensor(a, device=dev)
        elif np.issubdtype(a.dtype, np.integer):
            t = torch.as_tensor(a, dtype=torch.int64, device=dev)
        else:
            t = torch.as_tensor(a, dtype=TABLE_DTYPE, device=dev)
        setattr(vc, name, t)
    return vc


def tap_operator_from_numpy(op: Operator, taps, tap_offsets: np.ndarray, W: np.ndarray) -> TapOperator:
    """The tap form of ``op`` carrying the weights ``W`` of another
    implementation's tap form of the same operator, whose tap list and
    offsets must equal the port's (``ValueError`` otherwise)."""
    top = build_tap_operator(op)
    if top is None:
        raise ValueError("the operator has no tap form")
    if [tuple(int(v) for v in t) for t in taps] != top.taps:
        raise ValueError("tap lists differ")
    if not np.array_equal(np.asarray(tap_offsets, np.int64), top.tap_offsets):
        raise ValueError("tap offsets differ")
    grid = top.grid
    top.W = torch.tensor(np.asarray(W), dtype=grid.dtype, device=grid.device)
    return top


def scheme_data_from_numpy(scheme, **arrays) -> None:
    """Replace the coefficients of a set-up scheme's data Functions
    (``phi_h``, ``f_h``, ``u_D``, ``u_N``, ``u_R``, ...) by numpy arrays,
    in place, so that its ``assemble`` sees another implementation's
    interpolated data bit for bit."""
    for name, data in arrays.items():
        fn = getattr(scheme, name)
        setattr(scheme, name, function_from_numpy(fn.space, data))
