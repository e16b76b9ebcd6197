"""Neumann phi-FEM demo (S3) on the tilted square, quadrilateral background.

    python -m phifem_tpu_torch.demo.neumann_square bg|sub [--n 200] [--solver bicgstab]

The JAX package's ``demo/neumann/square/main.py``: a 200 x 200 quad mesh on
[-1, 1]^2, P1 x P1-vector x DG0 mixed, level set of degree 2; prints the
relative H1 error against the rotated square's analytic solution.
"""

from __future__ import annotations

from typing import List, Optional

from ..grid import CellType, Grid
from ..models import NeumannPoisson
from ..models import neumann_square as data
from ._scheme2d import run


def _build(args):
    grid = Grid(args.n, args.n, ((-1.0, -1.0), (1.0, 1.0)), CellType.quadrilateral, device=args.device)
    s = NeumannPoisson(grid, mode=args.mesh_type, detection_degree=1, levelset_degree=2)
    return grid, s, lambda: s.setup(data.levelset, data.source_term, data.neumann_data,
                                    detection_levelset=data.detection_levelset)


def main(argv: Optional[List[str]] = None) -> dict:
    return run(argv, "neumann_square", "Run neumann phiFEM demo.", _build, exact=data.exact_solution)


if __name__ == "__main__":
    main()
