"""phifem_tpu_torch — the PyTorch + CUDA port of ``phifem_tpu``.

Same module and public names as the JAX package, for the part ported so
far: grids, P1 spaces, level-set tagging and one-sided measures, assembly
of cell, facet and boundary terms (stencil batches for uniform P1 terms),
the tap form of assembled operators, CG and BiCGStab, the geometric and
lattice multigrid V-cycles with the cut-band interface solve, box Poisson
and the phi-FEM schemes S1-S4 in bg and sub mode.  The P1 cell-stencil
matvec (``ops/cuda_stencil.py``) and the tap-form matvec
(``ops/cuda_taps.py``) run hand-written CUDA kernels for tensors on an
NVIDIA Hopper card and their plain PyTorch versions for tensors on the
CPU.

Device and dtype are explicit: a :class:`Grid` takes ``device=`` and
``dtype=`` (default float64), and everything built on it follows.  The
package sets no global torch default.
"""

from .grid import CellType, Grid
from .spaces import Function, Space, interpolate
from .tagging import Submesh, compute_tags_measures, tag_cells, tag_facets
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
from .ops.taps import TapOperator, build_tap_operator
from .mg import LatticeBulkVCycle, VCycle, attach_interface_solve, build_hierarchy
from .solvers import DirichletBC, solve
from .models import (
    BoxPoisson,
    NeumannPoisson,
    RobinPoisson,
    StrongDirichletPoisson,
    WeakDirichletPoisson,
)

__all__ = [
    "CellType",
    "Grid",
    "Space",
    "Function",
    "interpolate",
    "compute_tags_measures",
    "tag_cells",
    "tag_facets",
    "Submesh",
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
    "TapOperator",
    "build_tap_operator",
    "VCycle",
    "LatticeBulkVCycle",
    "attach_interface_solve",
    "build_hierarchy",
    "DirichletBC",
    "solve",
    "BoxPoisson",
    "WeakDirichletPoisson",
    "StrongDirichletPoisson",
    "NeumannPoisson",
    "RobinPoisson",
]
