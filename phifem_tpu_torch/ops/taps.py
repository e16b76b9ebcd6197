"""Tap-form ("stencil-sparse") lattice operators.

Counterpart of :mod:`phifem_tpu.ops.taps`.  An assembled phi-FEM operator
over degree-1 Lagrange (scalar / vector) and DG0 fields on the structured
grid couples DoFs only at small constant lattice offsets (cell terms within
one cell, ghost-facet terms across the two cells of a facet).  It is
re-expressed as a set of *block taps*

    y[bi][r, c, ki] += W_t[r, c, ki, kj] * x[bj][r + dr, c + dc, kj]

where ``bi``/``bj`` are *block lattices* (one ``(ny+1, nx+1, ncomp)``
vertex lattice per P1 field, one ``(ny, nx, ncomp)`` cell lattice per DG0
field and triangle orientation) and ``W_t`` a spatially varying weight
plane.  ``W`` keeps the JAX package's layout: one flat buffer, tap ``t``'s
``(R, C, vi, vj)`` plane row-major from ``tap_offsets[t]``.

The matvec is :func:`phifem_tpu_torch.ops.cuda_taps.tap_matvec`: one
hand-written CUDA kernel for tensors on the card, the per-tap loop of
shifted slices for tensors on the CPU.  Geometry-uniform scalar batches
(the bulk stiffness) keep their O(1)-weight stencil path and are added
after it.  Only the per-tap form is ported (the JAX package's dense
per-pair form is a regression there).

:meth:`TapOperator.refresh` rebuilds ``W`` after ``Operator.reassemble``
by a deterministic scatter: each weight's contributions are gathered and
summed in entity order and added once (CUDA ``index_add_`` with repeated
indices would sum in an order that changes from run to run).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..grid import Grid
from .scatter import scatter_plan

__all__ = ["TapOperator", "build_tap_operator", "supports_tap_form"]


# --------------------------------------------------------- field analysis
def _field_kind(space) -> Optional[str]:
    """'p1' | 'dg0' | None (unsupported)."""
    if space.element.family == "DG" and space.degree == 0:
        return "dg0"
    if space.element.family == "Lagrange" and space.degree == 1:
        return "p1"
    return None


def supports_tap_form(system) -> bool:
    return all(_field_kind(s) is not None for s in system.fields.values())


@dataclasses.dataclass(frozen=True)
class _FieldSpec:
    name: str
    kind: str  # 'p1' | 'dg0'
    vshape: Tuple[int, ...]
    vsz: int  # channels per block lattice
    nblocks: int  # block lattices of this field (2 for tri DG0)
    base: int  # first block-lattice id
    shape: Tuple[int, int]  # lattice (rows, cols)


def _field_specs(system, grid: Grid) -> List[_FieldSpec]:
    specs, base = [], 0
    for name, s in system.fields.items():
        kind = _field_kind(s)
        if kind == "p1":
            nb, shape = 1, (grid.ny + 1, grid.nx + 1)
        else:  # dg0
            nb = 2 if grid.is_simplex else 1
            shape = (grid.ny, grid.nx)
        specs.append(_FieldSpec(name, kind, tuple(s.value_shape), s.value_size, nb, base, shape))
        base += nb
    return specs


def _scalar_positions(spec: _FieldSpec, grid: Grid, dofs: np.ndarray):
    """Per scalar-DoF id: (block index within field, row, col)."""
    if spec.kind == "p1":
        C = grid.nx + 1
        return np.zeros_like(dofs), dofs // C, dofs % C
    if grid.is_simplex:
        o = dofs % 2
        block = dofs // 2
    else:
        o = np.zeros_like(dofs)
        block = dofs
    return o, block // grid.nx, block % grid.nx


# ------------------------------------------------------------- the operator
@dataclasses.dataclass
class TapOperator:
    """Lattice block-tap form of an assembled
    :class:`phifem_tpu_torch.assembly.Operator`.

    ``make_matvec(op)`` returns a drop-in replacement for
    ``Operator.matvec``.  Stencil batches (uniform scalar terms) keep their
    own path; ``W`` carries every other batch.  ``_static`` holds the
    summed contributions of the static (non-rebuilt) batches as
    ``(unique flat ids, values)``, or None when every batch is rebuilt (then
    ``W`` starts from zeros and no static copy of ``W`` is kept); ``_dyn``
    the flat W index of every entry of each rebuilt batch's element
    matrices, ``_plan`` the entity-ordered scatter plan over all of them.
    """

    grid: Grid
    specs: List[_FieldSpec]
    taps: List[Tuple[int, int, int, int]]  # (bi, bj, dr, dc)
    tap_offsets: np.ndarray  # (ntaps + 1,) int64 starts into the flat W buffer
    blk_shapes: List[Tuple[int, int]]  # per block id: lattice (rows, cols)
    blk_ch: List[int]  # per block id: channels
    pad: int
    W: torch.Tensor  # flat concatenated (R, C, vi, vj) planes
    _static: Optional[Tuple[torch.Tensor, torch.Tensor]]
    _dyn: List[Tuple[int, np.ndarray]]  # (batch index, host flat W ids)
    _stencil_ids: List[int]  # op.batches indices applied outside the taps
    _plan: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    data_version: int = -1

    @property
    def num_taps(self) -> int:
        return len(self.taps)

    @property
    def num_weights(self) -> int:
        return int(self.tap_offsets[-1])

    # -------------------------------------------------- lattice <-> dict
    def _decompose(self, x: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
        """Per block id, a ``(R, C, vsz)`` view of its field's tensor."""
        blocks: List[torch.Tensor] = []
        for sp in self.specs:
            R, C = sp.shape
            if sp.nblocks == 1:
                blocks.append(x[sp.name].reshape(R, C, sp.vsz))
            else:  # tri DG0: cells interleave orientation 0/1
                a = x[sp.name].reshape(R, C, 2, sp.vsz)
                blocks.extend(a[:, :, o, :] for o in range(2))
        return blocks

    def _recompose(self, blocks: List[torch.Tensor]) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        i = 0
        for sp in self.specs:
            R, C = sp.shape
            if sp.nblocks == 1:
                v = blocks[i]
            else:
                v = torch.stack(blocks[i : i + sp.nblocks], dim=2)
            i += sp.nblocks
            out[sp.name] = v.reshape((R * C * sp.nblocks,) + sp.vshape)
        return out

    # ------------------------------------------------------------- matvec
    def make_matvec(self, op, dtype: Optional[torch.dtype] = None):
        """A matvec closure computing in ``dtype`` (None: the input dtype)
        with the current weights.  ``W`` and the stencil batches are cast
        once, here."""
        from .cuda_taps import tap_matvec

        W = self.W if dtype is None else self.W.to(dtype)
        sten = [op.batches[i] if dtype is None else op.batches[i].astype(dtype) for i in self._stencil_ids]

        def matvec(x: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
            if dtype is not None:
                x = {k: v.to(dtype) for k, v in x.items()}
            out = tap_matvec(self, W, x)
            for b in sten:
                out = b.matvec_into(x, out)
            return out

        return matvec

    # ------------------------------------------------------------ refresh
    def refresh(self, op) -> "TapOperator":
        """Rebuild ``W`` from the static part and the rebuilt batches'
        current element matrices (one deterministic gather-sum)."""
        dev = self.W.device
        W = torch.zeros(self.num_weights, dtype=self.W.dtype, device=dev)
        if self._static is not None:
            ids, vals = self._static
            W[ids] = vals
        if self._dyn:
            if self._plan is None:
                flat = torch.as_tensor(np.concatenate([ids for _, ids in self._dyn]), device=dev)
                self._plan = scatter_plan(flat)
            uniq, pos = self._plan
            mats = [op.batches[bi].matrices.reshape(-1).to(W.dtype) for bi, _ in self._dyn]
            vals = torch.cat(mats + [W.new_zeros(1)])  # the last entry pads pos
            W[uniq] += vals[pos].sum(dim=1)
        self.W = W
        self.data_version = op.data_version
        return self


# ---------------------------------------------------------- construction
def _batch_local_meta(b, specs_by_name, grid: Grid):
    """Per (entity, local scalar column) in gather() order: block-lattice
    id, row, col, channel; each ``(ne, L)`` int64."""
    bl_cols, r_cols, c_cols, ch_cols = [], [], [], []
    for name, dofs, vs in b.segments:
        sp = specs_by_name[name]
        d = dofs.cpu().numpy().astype(np.int64)
        ls, r, c = _scalar_positions(sp, grid, d)  # (ne, nloc) each
        ne, nloc = d.shape
        # column order: local node major, channel minor (gather() layout)
        rep = lambda a: np.repeat(a, sp.vsz, axis=1)
        bl_cols.append(rep(sp.base + ls))
        r_cols.append(rep(r))
        c_cols.append(rep(c))
        ch_cols.append(np.tile(np.arange(sp.vsz, dtype=np.int64), (ne, nloc)))
    return tuple(np.concatenate(a, axis=1) for a in (bl_cols, r_cols, c_cols, ch_cols))


def build_tap_operator(op) -> Optional[TapOperator]:
    """Build the block-tap form of ``op``, or None when a field layout is
    unsupported (degree >= 2 Lagrange) or no batch benefits (pure-stencil
    operators keep their O(1)-weight path).  The tap set and scatter ids
    depend only on entity lists, so they survive ``reassemble``;
    :meth:`TapOperator.refresh` updates the values.

    Taps are numbered in the JAX package's order (batch by batch, local
    pair by local pair, new keys in sorted order), so ``W`` equals its
    entry for entry.  Keys are encoded as one int64 per entity, so each
    local pair costs one 1-D ``np.unique``."""
    from .stencil import StencilCellBatch

    system = op.system
    if not supports_tap_form(system):
        return None
    grid_list = [s.grid for s in system.fields.values()]
    grid = grid_list[0]
    if any(g is not grid for g in grid_list):
        return None
    stencil_ids = [i for i, b in enumerate(op.batches) if isinstance(b, StencilCellBatch)]
    generic_ids = [i for i, b in enumerate(op.batches) if not isinstance(b, StencilCellBatch)]
    if not generic_ids:
        return None  # pure uniform-stencil operator: nothing to gain

    specs = _field_specs(system, grid)
    specs_by_name = {sp.name: sp for sp in specs}
    blk_shapes: List[Tuple[int, int]] = []
    blk_ch: List[int] = []
    for sp in specs:
        blk_shapes.extend([sp.shape] * sp.nblocks)
        blk_ch.extend([sp.vsz] * sp.nblocks)
    nblk = len(blk_shapes)

    # pass 1 (host): per batch, per local scalar pair -> tap ids; pairs of a
    # static batch that are zero on every entity are pruned
    key_to_tap: Dict[Tuple[int, int, int, int], int] = {}
    per_batch = []  # (bi, {(i, j): tids}, r, c, ch, static mats or None)
    for bi in generic_ids:
        b = op.batches[bi]
        bl, r, c, ch = _batch_local_meta(b, specs_by_name, grid)
        L = bl.shape[1]
        mats = None if b.dynamic else b._host_matrices()
        nz = None if mats is None else np.abs(mats).max(axis=0) > 0.0
        D = int(max(np.ptp(r, axis=1).max(), np.ptp(c, axis=1).max())) if r.size else 0
        K = 2 * D + 1
        pairs = {}
        for i in range(L):
            for j in range(L):
                if nz is not None and not nz[i, j]:
                    continue  # structurally zero coupling
                code = ((bl[:, i] * nblk + bl[:, j]) * K + (r[:, j] - r[:, i] + D)) * K + (
                    c[:, j] - c[:, i] + D
                )
                uniq, inv = np.unique(code, return_inverse=True)
                lut = np.empty(len(uniq), np.int64)
                for u, cd in enumerate(uniq.tolist()):
                    rest, dc = divmod(cd, K)
                    rest, dr = divmod(rest, K)
                    key = (rest // nblk, rest % nblk, dr - D, dc - D)
                    lut[u] = key_to_tap.setdefault(key, len(key_to_tap))
                pairs[(i, j)] = lut[inv.reshape(-1)]
        per_batch.append((bi, pairs, r, c, ch, mats))

    taps: List[Tuple[int, int, int, int]] = [None] * len(key_to_tap)
    for key, t in key_to_tap.items():
        taps[t] = key
    pad = max([2] + [max(abs(dr), abs(dc)) for _, _, dr, dc in taps])
    sizes = np.asarray(
        [blk_shapes[bi][0] * blk_shapes[bi][1] * blk_ch[bi] * blk_ch[bj] for bi, bj, _, _ in taps],
        np.int64,
    )
    tap_offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    t_C = np.asarray([blk_shapes[t[0]][1] for t in taps], np.int64)
    t_vi = np.asarray([blk_ch[t[0]] for t in taps], np.int64)
    t_vj = np.asarray([blk_ch[t[1]] for t in taps], np.int64)

    def flat_idx(tids, ri, ci, ki, kj):
        # layout per tap: (r, c, ki, kj) row-major; 64-bit throughout
        return tap_offsets[tids] + (((ri * t_C[tids] + ci) * t_vi[tids] + ki) * t_vj[tids] + kj)

    # pass 2: flat W ids; static values summed per id in entity order (as
    # np.add.at), dynamic ids kept for the refresh
    dyn: List[Tuple[int, np.ndarray]] = []
    st_ids, st_vals = [], []
    for bi, pairs, r, c, ch, mats in per_batch:
        ne, L = r.shape
        if mats is None:
            flat = np.empty((ne, L, L), np.int64)
            for i in range(L):
                for j in range(L):
                    flat[:, i, j] = flat_idx(pairs[(i, j)], r[:, i], c[:, i], ch[:, i], ch[:, j])
            dyn.append((bi, flat.reshape(-1)))
        else:
            for (i, j), tids in pairs.items():
                st_ids.append(flat_idx(tids, r[:, i], c[:, i], ch[:, i], ch[:, j]))
                st_vals.append(mats[:, i, j])

    dev, dt = grid.device, grid.dtype
    static = None
    if st_ids:
        ids = np.concatenate(st_ids)
        uniq, inv = np.unique(ids, return_inverse=True)
        vals = np.bincount(inv.reshape(-1), weights=np.concatenate(st_vals), minlength=len(uniq))
        static = (
            torch.as_tensor(uniq, device=dev),
            torch.as_tensor(vals, dtype=dt, device=dev),
        )
    top = TapOperator(
        grid=grid,
        specs=specs,
        taps=[tuple(t) for t in taps],
        tap_offsets=tap_offsets,
        blk_shapes=blk_shapes,
        blk_ch=blk_ch,
        pad=int(pad),
        W=torch.zeros(0, dtype=dt, device=dev),
        _static=static,
        _dyn=dyn,
        _stencil_ids=stencil_ids,
    )
    return top.refresh(op)
