"""Strong-Dirichlet phi-FEM demo (S2, the product space u = phi w) on the
flower level set.

    python -m phifem_tpu_torch.demo.strong_dirichlet_flower bg|sub [--n 200] [--solver bicgstab]

The JAX package's ``demo/strong-dirichlet/flower/main.py``, with the
weak-Dirichlet demo's flower data (:mod:`phifem_tpu_torch.models.flower`).
"""

from __future__ import annotations

from typing import List, Optional

from ..grid import CellType, Grid
from ..models import StrongDirichletPoisson
from ..models import flower
from ._scheme2d import run


def _build(args):
    grid = Grid(args.n, args.n, ((-4.5, -4.5), (4.5, 4.5)), CellType.triangle, device=args.device)
    s = StrongDirichletPoisson(grid, mode=args.mesh_type, detection_degree=1)
    return grid, s, lambda: s.setup(flower.levelset, flower.source_term,
                                    detection_levelset=flower.detection_levelset)


def main(argv: Optional[List[str]] = None) -> dict:
    return run(argv, "strong_dirichlet_flower", "Run strong dirichlet phiFEM demo.", _build)


if __name__ == "__main__":
    main()
