"""Scheme configuration: one dataclass serializable to and from YAML.

Counterpart of :mod:`phifem_tpu.utils.config` (a copy: the port imports
nothing of the JAX package).  It reads the reference's S5 parameter files
(``demo/interface-elasticity/param1.yaml``) as well as plain configs.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

__all__ = ["SchemeConfig", "load_config"]


@dataclasses.dataclass
class SchemeConfig:
    """Parameters shared by the phi-FEM schemes; field names mirror the
    reference YAML keys where they exist."""

    scheme: str = "weak-dirichlet"
    mode: str = "bg"  # "bg" (box_mode) | "sub" (submesh)
    cell_type: str = "triangle"
    bbox: Tuple[Tuple[float, float], Tuple[float, float]] = ((-1.0, -1.0), (1.0, 1.0))
    nx: int = 200
    ny: int = 200
    initial_mesh_size: Optional[float] = None  # alternative to nx/ny (S5 yaml)
    num_iterations: int = 1  # refinement levels for convergence loops
    primal_degree: int = 1
    flux_degree: int = 1
    auxiliary_degree: int = 0
    levelset_degree: int = 1
    boundary_detection_degree: int = 1
    single_layer_cut: bool = False
    penalization_coefficient: float = 1.0
    stabilization_coefficient: float = 1.0
    solver: str = "bicgstab"
    tol: float = 1e-10
    debug: bool = False

    def resolve_resolution(self) -> Tuple[int, int]:
        """``(nx, ny)``; from ``initial_mesh_size`` and the bbox when the
        config gives a mesh size (the S5 YAML schema)."""
        if self.initial_mesh_size is None:
            return self.nx, self.ny
        (x0, y0), (x1, y1) = self.bbox
        nx = int(abs(x1 - x0) / self.initial_mesh_size)
        ny = int(abs(y1 - y0) / self.initial_mesh_size)
        return nx, ny


def load_config(path: str) -> SchemeConfig:
    """Load YAML (or JSON) into a :class:`SchemeConfig`.  The reference's
    S5 YAML stores the bbox column-wise, ``[[x0, x1], [y0, y1]]``, and
    ``box_mode`` in place of ``mode``."""
    with open(path) as f:
        text = f.read()
    try:
        import yaml

        raw = yaml.safe_load(text)
    except ImportError:
        raw = json.loads(text)

    known = {f.name for f in dataclasses.fields(SchemeConfig)}
    kwargs = {k: v for k, v in raw.items() if k in known}
    if "bbox" in raw:
        bb = raw["bbox"]
        kwargs["bbox"] = ((bb[0][0], bb[1][0]), (bb[0][1], bb[1][1]))
    if "box_mode" in raw:
        kwargs["mode"] = "bg" if raw["box_mode"] else "sub"
    return SchemeConfig(**kwargs)
