"""phifem_tpu_torch — the PyTorch + CUDA port of ``phifem_tpu``.

Same module and public names as the JAX package, for the part ported so
far: grids, P1 spaces, level-set tagging and one-sided measures, assembly
of cell, facet and boundary terms (stencil batches for uniform P1 terms),
CG and BiCGStab, the geometric and lattice multigrid V-cycles with the
cut-band interface solve, box Poisson and the S1 weak-Dirichlet scheme.
The P1 cell-stencil matvec runs a hand-written CUDA kernel for tensors on
an NVIDIA Hopper card (``ops/cuda_stencil.py``) and its plain PyTorch
version for tensors on the CPU.

Device and dtype are explicit: a :class:`Grid` takes ``device=`` and
``dtype=`` (default float64), and everything built on it follows.  The
package sets no global torch default.
"""

from .grid import CellType, Grid
from .spaces import Function, Space, interpolate
from .tagging import compute_tags_measures, tag_cells, tag_facets
from .assembly import (
    BoundaryTerm,
    CellTerm,
    FacetTerm,
    System,
    assemble_operator,
    assemble_scalar,
    assemble_vector,
)
from .ops.stencil import StencilCellBatch
from .ops.lattice import LatticeMG, lattice_cg
from .mg import LatticeBulkVCycle, VCycle, attach_interface_solve, build_hierarchy
from .solvers import DirichletBC, solve
from .models import BoxPoisson, WeakDirichletPoisson

__all__ = [
    "CellType",
    "Grid",
    "Space",
    "Function",
    "interpolate",
    "compute_tags_measures",
    "tag_cells",
    "tag_facets",
    "System",
    "CellTerm",
    "FacetTerm",
    "BoundaryTerm",
    "assemble_operator",
    "assemble_vector",
    "assemble_scalar",
    "StencilCellBatch",
    "LatticeMG",
    "lattice_cg",
    "VCycle",
    "LatticeBulkVCycle",
    "attach_interface_solve",
    "build_hierarchy",
    "DirichletBC",
    "solve",
    "BoxPoisson",
    "WeakDirichletPoisson",
]
