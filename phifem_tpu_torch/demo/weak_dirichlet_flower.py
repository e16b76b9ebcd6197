"""Weak-Dirichlet phi-FEM demo (S1) on the flower level set.

    python -m phifem_tpu_torch.demo.weak_dirichlet_flower bg|sub [--n 200] [--solver bicgstab]

The JAX package's ``demo/weak-dirichlet/flower/main.py``: a 200 x 200
triangle background mesh on [-4.5, 4.5]^2, P1 x P1 mixed, detection degree
1, single-layer cut.
"""

from __future__ import annotations

from typing import List, Optional

from ..grid import CellType, Grid
from ..models import WeakDirichletPoisson
from ..models import flower
from ._scheme2d import run


def _build(args):
    grid = Grid(args.n, args.n, ((-4.5, -4.5), (4.5, 4.5)), CellType.triangle, device=args.device)
    s = WeakDirichletPoisson(grid, mode=args.mesh_type, detection_degree=1, single_layer_cut=True)
    return grid, s, lambda: s.setup(flower.levelset, flower.source_term, u_D=flower.dirichlet_data,
                                    detection_levelset=flower.detection_levelset)


def main(argv: Optional[List[str]] = None) -> dict:
    return run(argv, "weak_dirichlet_flower", "Run weak dirichlet phiFEM demo.", _build, io_phase=True)


if __name__ == "__main__":
    main()
