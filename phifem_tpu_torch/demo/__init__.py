"""The demo CLIs of the port, one module per demo of the JAX package's
``demo/`` tree, with its positional arguments, options and defaults:

    python -m phifem_tpu_torch.demo.weak_dirichlet_flower bg|sub [--n 200]
    python -m phifem_tpu_torch.demo.strong_dirichlet_flower bg|sub
    python -m phifem_tpu_torch.demo.neumann_square bg|sub
    python -m phifem_tpu_torch.demo.robin_square bg|sub
    python -m phifem_tpu_torch.demo.interface_elasticity param1|param_quick|param1_l7
    python -m phifem_tpu_torch.demo.poisson3d weak|strong|neumann|robin|elasticity [--n 32]
    python -m phifem_tpu_torch.demo.unstructured s1|s2|s3|s4 [--dim 3]

Each adds two options: ``--device`` (default ``cuda``; ``cpu`` runs the
plain versions of the kernels) and ``--out``, the output directory (default
``phifem_torch_output/<demo>_<mode>`` under the working directory).  Each
module's ``main(argv=None)`` prints what the JAX CLI prints, writes its
files through :mod:`phifem_tpu_torch.utils.io` and returns a dict:
iterations, residual, convergence, errors where the demo computes them,
the written paths, the phase times and the scheme.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

__all__ = ["add_port_options", "output_dir", "parse"]


def add_port_options(parser: argparse.ArgumentParser) -> None:
    """The two options the port's demos add to the JAX CLIs."""
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the grids and solves (default cuda)")
    parser.add_argument("--out", type=str, default=None,
                        help="output directory (default phifem_torch_output/<demo>_<mode>)")


def parse(parser: argparse.ArgumentParser, argv: Optional[List[str]]):
    add_port_options(parser)
    return parser.parse_args(argv)


def output_dir(args, name: str) -> str:
    """``--out``, or ``phifem_torch_output/<name>`` under the working
    directory; created."""
    out = args.out or os.path.join("phifem_torch_output", name)
    os.makedirs(out, exist_ok=True)
    return out
