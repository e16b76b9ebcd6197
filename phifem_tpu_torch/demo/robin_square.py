"""Robin phi-FEM demo (S4) on the tilted square, triangle background.

    python -m phifem_tpu_torch.demo.robin_square bg|sub [--n 200] [--solver bicgstab]

The JAX package's ``demo/robin/square/main.py``: a 200 x 200 triangle mesh
on [-1, 1]^2; prints the relative H1 error against the analytic solution.
"""

from __future__ import annotations

from typing import List, Optional

from ..grid import CellType, Grid
from ..models import RobinPoisson
from ..models import robin_square as data
from ._scheme2d import run


def _build(args):
    grid = Grid(args.n, args.n, ((-1.0, -1.0), (1.0, 1.0)), CellType.triangle, device=args.device)
    s = RobinPoisson(grid, mode=args.mesh_type, detection_degree=1, levelset_degree=2,
                     robin_coef=data.robin_coef)
    return grid, s, lambda: s.setup(data.levelset, data.source_term, data.robin_data,
                                    detection_levelset=data.detection_levelset)


def main(argv: Optional[List[str]] = None) -> dict:
    return run(argv, "robin_square", "Run robin phiFEM demo.", _build, exact=data.exact_solution)


if __name__ == "__main__":
    main()
