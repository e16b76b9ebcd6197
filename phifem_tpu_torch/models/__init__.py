"""Problem models of the port: box Poisson and the phi-FEM schemes S1
(weak Dirichlet), S2 (strong Dirichlet), S3 (Neumann), S4 (Robin) and S5
(two-material interface elasticity)."""

from .base import SchemeBase
from .interface_elasticity import InterfaceElasticity, s5_forms
from .neumann import NeumannPoisson, s3_forms
from .poisson import BoxPoisson
from .robin import RobinPoisson, s4_forms
from .strong_dirichlet import StrongDirichletPoisson, s2_forms
from .weak_dirichlet import WeakDirichletPoisson, s1_forms

__all__ = [
    "BoxPoisson",
    "InterfaceElasticity",
    "NeumannPoisson",
    "RobinPoisson",
    "SchemeBase",
    "StrongDirichletPoisson",
    "WeakDirichletPoisson",
    "s1_forms",
    "s2_forms",
    "s3_forms",
    "s4_forms",
    "s5_forms",
]
