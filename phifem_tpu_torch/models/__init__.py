"""Problem models of the port: box Poisson and the phi-FEM schemes S1
(weak Dirichlet), S2 (strong Dirichlet), S3 (Neumann), S4 (Robin) and S5
(two-material interface elasticity); in 3D, box Poisson, S1 at Q1-Q3, S2,
S3, S4 and S5 on the hex lattice; S1-S4 on imported triangle,
quadrilateral and tetrahedral meshes, and S5 on imported 2D meshes."""

from .base import SchemeBase
from .interface_elasticity import InterfaceElasticity, s5_forms
from .interface_elasticity3 import InterfaceElasticity3
from .neumann import NeumannPoisson, s3_forms
from .neumann3 import NeumannPoisson3
from .poisson import BoxPoisson
from .poisson3 import BoxPoisson3
from .robin import RobinPoisson, s4_forms
from .robin3 import RobinPoisson3
from .strong_dirichlet import StrongDirichletPoisson, s2_forms
from .strong_dirichlet3 import StrongDirichletPoisson3
from .weak_dirichlet import WeakDirichletPoisson, s1_forms
from .weak_dirichlet3 import WeakDirichletPoisson3
from .unstructured import (
    InterfaceElasticityU,
    NeumannPoissonU,
    RobinPoissonU,
    StrongDirichletPoissonU,
    USchemeBase,
    WeakDirichletPoissonU,
)

__all__ = [
    "BoxPoisson",
    "BoxPoisson3",
    "InterfaceElasticity",
    "InterfaceElasticity3",
    "InterfaceElasticityU",
    "NeumannPoisson",
    "NeumannPoisson3",
    "NeumannPoissonU",
    "RobinPoisson",
    "RobinPoisson3",
    "RobinPoissonU",
    "SchemeBase",
    "StrongDirichletPoisson",
    "StrongDirichletPoisson3",
    "StrongDirichletPoissonU",
    "USchemeBase",
    "WeakDirichletPoisson",
    "WeakDirichletPoisson3",
    "WeakDirichletPoissonU",
    "s1_forms",
    "s2_forms",
    "s3_forms",
    "s4_forms",
    "s5_forms",
]
