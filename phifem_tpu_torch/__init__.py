"""phifem_tpu_torch — the PyTorch + CUDA port of ``phifem_tpu``.

Same module and public names as the JAX package, for the part ported so
far: grids, Lagrange spaces of degree 1-3 and DG0, level-set tagging and
one-sided measures, assembly of cell, facet and boundary terms (stencil
batches for uniform P1 terms), the tap form of assembled operators, CG,
BiCGStab, GMRES, flexible GMRES and mixed-precision refinement, the
geometric and lattice multigrid V-cycles with the cut-band interface solve,
p-multigrid for degree >= 2 (``pmg``), box Poisson and the phi-FEM schemes
S1-S4 in bg and sub mode and S5 (two-material interface elasticity: sparse
direct and deflated, lattice-preconditioned BiCGStab); in 3D, the hex
grid and its tagging, the scalar and block lattice multigrid, box Poisson,
S1 at Q1-Q3, S2, S3, S4 and S5; on imported triangle, quadrilateral and
tetrahedral meshes (``UMesh``, ``UMesh3``, host tagging, ``uassembly``),
S1-S4 with smoothed-aggregation AMG (``amg``) and, in 2D, S5.  The P1 cell-stencil matvec
(``ops/cuda_stencil.py``), the tap-form matvec (``ops/cuda_taps.py``), the
masked hex-cell stencil and its 3-channel block form
(``ops/cuda_hex3.py``) and the 27-point lattice sweep and its 3-channel
block form (``ops/cuda_lattice3.py``) and the AMG cycle's ELL sweep
(``ops/cuda_amg.py``) run hand-written CUDA kernels for
tensors on an NVIDIA Hopper card and their plain PyTorch versions for
tensors on the CPU.

Device and dtype are explicit: a :class:`Grid` (or :class:`Grid3`,
:class:`UMesh`, :class:`UMesh3`) takes ``device=`` and
``dtype=`` (default float64), and everything built on it follows.  The
package sets no global torch default.
"""

from .grid import CellType, Grid
from .grid3 import Grid3
from .spaces import Function, Space, interpolate
from .tagging import Submesh, compute_tags_measures, tag_cells, tag_facets
from .umesh import UDiscreteLevelset, UMesh, USideList, USubmesh
from .umesh3 import UDiscreteLevelset3, UMesh3
from .uassembly import UFunction, USpace
from .uassembly import interpolate as interpolate_u
from .amg import AMG, amg_preconditioner, build_amg
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
from .ops.lattice import LatticeBlockMG, LatticeMG, lattice_cg
from .ops.lattice3 import Lattice3BlockMG, build_lattice3_block_mg
from .ops.taps import TapOperator, build_tap_operator
from .mg import LatticeBulkVCycle, VCycle, attach_interface_solve, build_hierarchy
from .solvers import DirichletBC, solve, solve_ir
from .models import (
    BoxPoisson,
    BoxPoisson3,
    InterfaceElasticity,
    InterfaceElasticity3,
    InterfaceElasticityU,
    NeumannPoisson,
    NeumannPoisson3,
    NeumannPoissonU,
    RobinPoisson,
    RobinPoisson3,
    RobinPoissonU,
    StrongDirichletPoisson,
    StrongDirichletPoisson3,
    StrongDirichletPoissonU,
    WeakDirichletPoisson,
    WeakDirichletPoisson3,
    WeakDirichletPoissonU,
)

__all__ = [
    "CellType",
    "Grid",
    "Grid3",
    "Space",
    "Function",
    "interpolate",
    "compute_tags_measures",
    "tag_cells",
    "tag_facets",
    "Submesh",
    "UMesh",
    "UMesh3",
    "UDiscreteLevelset3",
    "UDiscreteLevelset",
    "USideList",
    "USubmesh",
    "USpace",
    "UFunction",
    "interpolate_u",
    "AMG",
    "build_amg",
    "amg_preconditioner",
    "System",
    "CellTerm",
    "FacetTerm",
    "BoundaryTerm",
    "assemble_operator",
    "assemble_vector",
    "assemble_scalar",
    "StencilCellBatch",
    "LatticeMG",
    "LatticeBlockMG",
    "Lattice3BlockMG",
    "build_lattice3_block_mg",
    "lattice_cg",
    "TapOperator",
    "build_tap_operator",
    "VCycle",
    "LatticeBulkVCycle",
    "attach_interface_solve",
    "build_hierarchy",
    "DirichletBC",
    "solve",
    "solve_ir",
    "BoxPoisson",
    "WeakDirichletPoisson",
    "StrongDirichletPoisson",
    "NeumannPoisson",
    "RobinPoisson",
    "InterfaceElasticity",
    "BoxPoisson3",
    "WeakDirichletPoisson3",
    "StrongDirichletPoisson3",
    "NeumannPoisson3",
    "RobinPoisson3",
    "InterfaceElasticity3",
    "InterfaceElasticityU",
    "WeakDirichletPoissonU",
    "StrongDirichletPoissonU",
    "NeumannPoissonU",
    "RobinPoissonU",
]
