"""The shared body of the four 2D Poisson demos (S1-S4): one background
grid, ``bg`` or ``sub`` mode, setup -> assemble -> solve, the solution and
the cell tags written as XDMF (VTU where h5py is missing)."""

from __future__ import annotations

import argparse
import os
from typing import Callable, List, Optional

from . import output_dir, parse
from ..utils import Timer, write_xdmf


def run(argv: Optional[List[str]], demo: str, description: str, build: Callable,
        exact: Optional[Callable] = None, io_phase: bool = False) -> dict:
    """``build(args) -> (grid, scheme, setup)``: the demo's grid, its scheme
    (not set up) and a call that sets it up.  With ``exact``, the relative
    H1 error is printed as the Neumann and Robin demos print it."""
    parser = argparse.ArgumentParser(prog=f"python -m phifem_tpu_torch.demo.{demo}", description=description)
    parser.add_argument("mesh_type", type=str, choices=["bg", "sub"])
    parser.add_argument("--n", type=int, default=200, help="background resolution")
    parser.add_argument("--solver", type=str, default="bicgstab")
    args = parse(parser, argv)
    out = output_dir(args, f"{demo}_{args.mesh_type}")

    timer = Timer(args.device)
    grid, scheme, setup = build(args)
    with timer.phase("tag+setup"):
        setup()
    with timer.phase("assemble"):
        scheme.assemble()
    with timer.phase("solve"):
        res = scheme.solve(method=args.solver)
    print(f"solver residual: {res.residual:.3e} converged={res.converged}")
    errs = None
    if exact is not None:
        with timer.phase("errors"):
            errs = scheme.l2_h1_errors(scheme.u_h, exact)
        print("Relative H1 error:")
        print(errs["h1"])
    print(timer.report())

    def write():
        return write_xdmf(os.path.join(out, "solution.xdmf"), grid,
                          point_data={"solution": scheme.u_h}, cell_data={"tags": scheme.cell_tags})

    if io_phase:
        with timer.phase("io"):
            path = write()
    else:
        path = write()
    return {"iterations": res.iterations, "residual": res.residual, "converged": res.converged,
            "errors": errs, "paths": [path], "phases": dict(timer.phases), "scheme": scheme}
