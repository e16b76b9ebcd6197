"""Build the port's objects from another implementation's state, given as
numpy arrays (for example ``np.asarray`` of the JAX package's fields), so
that both compute the same thing.  Nothing here imports that package."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..amg import AMG, AMGLevel, _slot_major
from ..assembly import Batch, Operator, System
from ..grid import Grid
from ..mg import TABLE_DTYPE, VCycle, ras_owner
from ..ops.cuda_band import band_tables
from ..ops.lattice import LatticeMG, LatticeVarMG, _Level
from ..ops.lattice3 import Lattice3BlockMG, Lattice3MG, _Level3
from ..ops.stencil import StencilCellBatch
from ..ops.taps import TapOperator, build_tap_operator
from ..spaces import Function, Space
from ..tagging import EntityTags, TagsMeasures, box_measure
from ..uassembly import UFunction, USpace
from ..umesh3 import UMesh3

__all__ = [
    "stencil_batch_from_numpy",
    "operator_from_numpy",
    "lattice_mg_from_numpy",
    "lattice_var_mg_from_numpy",
    "coarse_correction_from_numpy",
    "function_from_numpy",
    "tags_from_numpy",
    "batch_from_numpy",
    "interface_tables_from_numpy",
    "tap_operator_from_numpy",
    "scheme_data_from_numpy",
    "lattice3_mg_from_numpy",
    "lattice3_block_mg_from_numpy",
    "scheme3_data_from_numpy",
    "amg_from_numpy",
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
    device="cuda",
    **kw,
) -> LatticeMG:
    """``levels``: ``(R, C)`` logical lattice sizes, fine to coarse; the
    tables go to ``device`` (the card unless the caller asks for the CPU)."""
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


def lattice_var_mg_from_numpy(
    levels: Sequence[Tuple[int, int]],
    Ws: Sequence[np.ndarray],
    Dinvs: Sequence[np.ndarray],
    coarse_inv: np.ndarray,
    vsz: int,
    masks: Optional[Sequence[np.ndarray]],
    dtype: torch.dtype,
    device="cuda",
    **kw,
) -> LatticeVarMG:
    """The variable-stencil block cycle from another implementation's
    tables: ``levels`` ``(R, C)`` fine to coarse, per level ``Ws`` (3, 3,
    vsz, vsz, R-2, C-2) and ``Dinvs`` (vsz, vsz, R-2, C-2), the coarsest
    pseudo-inverse and the (R, C) masks, on ``device`` (the card unless the
    caller asks for the CPU)."""
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype, device=device)
    return LatticeVarMG(
        [_Level(int(R), int(C)) for R, C in levels],
        [t(w) for w in Ws],
        [t(d) for d in Dinvs],
        t(coarse_inv),
        int(vsz),
        dtype=dtype,
        masks=None if masks is None else [t(m) for m in masks],
        **kw,
    )


def coarse_correction_from_numpy(vc: VCycle, flat_meta, Z: np.ndarray, AZ: np.ndarray, Ginv: np.ndarray,
                                 device="cuda") -> VCycle:
    """Set the rank-k coarse correction of ``vc`` (``coarse_Z``,
    ``coarse_AZ``, ``coarse_Ginv``) from numpy arrays, in float64 on
    ``device``; ``flat_meta`` is ``(names, shapes, sizes)`` of the flat
    layout."""
    vc._flat_meta = tuple(list(m) for m in flat_meta)
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64, device=device)
    vc.coarse_Z, vc.coarse_AZ, vc.coarse_Ginv = t(Z), t(AZ), t(Ginv)
    return vc


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


def interface_tables_from_numpy(vc: VCycle, flat_meta, device="cuda", **fields) -> VCycle:
    """Fill the interface fields of ``vc`` from numpy arrays named as the
    JAX package's (``interface_ids``, ``interface_inv``, ``schwarz_ids``,
    ``schwarz_inv``, ``schwarz_own``, ``schwarz_sweeps``, ``band_ids``,
    ``band_ell_cols``, ``band_ell_vals``), on ``device`` (the card unless
    the caller asks for the CPU); ``flat_meta`` is
    ``(names, shapes, sizes)`` of the flat layout.  Float tables are stored
    in the interface table dtype; the Schwarz tables are stored as the band
    kernels read them (``vc.band_tables``), the (nb, K) ownership mask as
    the port's per-DoF owner slots."""
    dev = torch.device(device)
    vc._flat_meta = tuple(list(m) for m in flat_meta)
    if "schwarz_inv" in fields:
        bids = np.asarray(fields.pop("schwarz_ids"))
        owner = ras_owner(bids, np.asarray(fields.pop("schwarz_own"), bool), len(fields["band_ids"]))
        vc.band_tables = band_tables(bids, fields.pop("schwarz_inv"), owner, fields.pop("band_ell_cols"),
                                     fields.pop("band_ell_vals"), dev)
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


def lattice3_mg_from_numpy(
    levels: Sequence[Tuple[int, int, int, Sequence[Tuple[int, int, int, float]]]],
    coarse_inv: np.ndarray,
    masks: Optional[Sequence[np.ndarray]],
    dtype: torch.dtype,
    device="cuda",
    **kw,
) -> Lattice3MG:
    """``levels``: ``(D, R, C, terms)`` per level, fine to coarse (the JAX
    package's ``_Level3`` fields), ``masks`` the per-level logical
    ``(D, R, C)`` masks or None; the tables go to ``device`` (the card
    unless the caller asks for the CPU)."""
    tens = lambda a: torch.tensor(np.asarray(a), dtype=dtype, device=device)
    return Lattice3MG(
        [_Level3(int(D), int(R), int(C), tuple((int(a), int(b), int(c), float(w)) for a, b, c, w in terms))
         for D, R, C, terms in levels],
        tens(coarse_inv),
        dtype=dtype,
        masks=None if masks is None else [tens(m).contiguous() for m in masks],
        **kw,
    )


def lattice3_block_mg_from_numpy(
    levels: Sequence[Tuple[int, int, int]],
    offs: Sequence[Tuple[int, int, int]],
    Ws: Sequence[np.ndarray],
    dinvs: Sequence[np.ndarray],
    coarse_inv: np.ndarray,
    vsz: int,
    masks: Optional[Sequence[np.ndarray]],
    dtype: torch.dtype,
    device="cuda",
    **kw,
) -> Lattice3BlockMG:
    """The block 3D cycle from another implementation's tables: ``levels``
    ``(D, R, C)`` fine to coarse, the terms' positions ``offs``, per level
    ``Ws`` (nterms, vsz, vsz) and ``dinvs`` (vsz, vsz) (kept on the host in
    float64, as the cycle keeps them), the coarsest pseudo-inverse and the
    per-level logical masks or None, on ``device`` (the card unless the
    caller asks for the CPU)."""
    tens = lambda a: torch.tensor(np.asarray(a), dtype=dtype, device=device)
    return Lattice3BlockMG(
        [_Level3(int(D), int(R), int(C), ()) for D, R, C in levels],
        tuple(tuple(int(v) for v in o) for o in offs),
        [np.asarray(w, np.float64) for w in Ws],
        [np.asarray(d, np.float64) for d in dinvs],
        tens(coarse_inv),
        int(vsz),
        dtype=dtype,
        masks=None if masks is None else [tens(m).contiguous() for m in masks],
        **kw,
    )


def scheme3_data_from_numpy(scheme, **arrays) -> None:
    """Replace the assembled tables of a 3D lattice scheme (after
    ``assemble``) by numpy arrays, in place, so that its matvec and
    preconditioner run on another implementation's tables: float tables in
    the grid's dtype (``A8``, ``E_uu``, ``E_up``, ``E_pp``, ``E_stat``,
    ``E_phi``, ``K_in``, ``K_out``, masks, ...), int64 index tables
    (``cut_dofs``, ``cut_cells_flat``, ``idxU``, ``idxY``), entity lists
    ``ghost`` / ``bdry`` / ``flux`` (tuples whose first item is the dofs and
    second the matrix; the rest, an axis or a field name, kept as given) and
    per-field dicts ``b`` / ``diag`` / ``x_bc`` / ``active``.  The ordered
    scatter plans follow the new ids."""
    g = scheme.grid
    flt = lambda a: torch.tensor(np.asarray(a), dtype=g.dtype, device=g.device)
    idx = lambda a: torch.tensor(np.asarray(a), dtype=torch.int64, device=g.device)
    for name, val in arrays.items():
        if name in ("ghost", "bdry", "flux"):
            val = [(idx(e[0]), flt(e[1])) + tuple(e[2:]) for e in val]
        elif name in ("b", "diag", "x_bc"):
            val = {k: flt(v) for k, v in val.items()}
        elif name == "active":
            val = {k: torch.tensor(np.asarray(v), dtype=torch.bool, device=g.device) for k, v in val.items()}
        elif name in ("cut_dofs", "cut_cells_flat", "idxU", "idxY"):
            val = idx(val)
        else:
            val = flt(val).contiguous()
        setattr(scheme, name, val)
    scheme._make_scatters()
    scheme._solve_cache = {}


def amg_from_numpy(levels: Sequence[dict], coarse_inv: np.ndarray, dtype: torch.dtype = torch.float32,
                   device="cuda", **kw) -> AMG:
    """The port's AMG V-cycle from another implementation's hierarchy:
    ``levels`` fine to coarse, each a dict of the row-major ELL arrays
    ``ecols`` / ``evals`` (n, w), ``inv_diag`` (n,) and, on every level but
    the coarsest, ``p_cols`` / ``p_vals`` and ``r_cols`` / ``r_vals``; the
    coarsest level's ``coarse_inv``.  The tables go to ``device`` (the card
    unless the caller asks for the CPU) in ``dtype``; ``kw`` are AMG's
    ``omega``, ``pre_smooth``, ``post_smooth``."""
    out = []
    for lv in levels:
        c, v = _slot_major(lv["ecols"], lv["evals"], dtype, device)
        lvl = AMGLevel(int(np.asarray(lv["ecols"]).shape[0]), c, v,
                       torch.tensor(np.asarray(lv["inv_diag"]), dtype=dtype, device=device))
        if lv.get("p_cols") is not None:
            lvl.p_cols, lvl.p_vals = _slot_major(lv["p_cols"], lv["p_vals"], dtype, device)
            lvl.r_cols, lvl.r_vals = _slot_major(lv["r_cols"], lv["r_vals"], dtype, device)
        out.append(lvl)
    return AMG(out, torch.tensor(np.asarray(coarse_inv), dtype=dtype, device=device), dtype=dtype, **kw)


def umesh3_from_numpy(verts: np.ndarray, cells: np.ndarray, device="cuda",
                      dtype: torch.dtype = torch.float64) -> UMesh3:
    """The port's tetrahedral mesh of another implementation's arrays
    (``verts (nv, 3)``, ``cells (nc, 4)``), its tensors on ``device`` (the
    card unless the caller asks for the CPU) in ``dtype``."""
    return UMesh3(np.asarray(verts, np.float64), np.asarray(cells), device, dtype)


def ufunction_from_numpy(space: USpace, data: np.ndarray) -> UFunction:
    """A :class:`UFunction` on ``space`` of coefficients ``data`` (shape
    ``space.dof_shape``), on the space's device in its dtype."""
    data = np.asarray(data)
    if data.shape != tuple(space.dof_shape):
        raise ValueError(f"coefficients of shape {data.shape}, the space has {tuple(space.dof_shape)}")
    return UFunction(space, space.mesh._tensor(data))
