"""Problem models of the port: box Poisson and the S1 weak-Dirichlet
phi-FEM scheme."""

from .base import SchemeBase
from .poisson import BoxPoisson
from .weak_dirichlet import WeakDirichletPoisson, s1_forms

__all__ = ["BoxPoisson", "SchemeBase", "WeakDirichletPoisson", "s1_forms"]
