"""Two-material immersed-interface elasticity (S5) with a convergence study.

    python -m phifem_tpu_torch.demo.interface_elasticity param_quick|param1|param1_l7
        [--solver bicgstab] [--precond lattice|none] [--tol 1e-10] [--maxiter 2000]

The JAX package's ``demo/interface-elasticity/main.py``: the 5-field mixed
scheme configured by a parameter file, a uniform refinement loop, the
per-level L2 / H10 relative errors appended to ``results.csv``, and the
log-log slopes of the errors against the DoF count (about -1 for L2 and
-0.5 for H10 at P1).  The parameter files are JSON copies of the JAX
demo's YAML files (``phifem_tpu_torch/demo/params``), read through
:func:`~phifem_tpu_torch.utils.load_config`.
"""

from __future__ import annotations

import argparse
import csv
import os
from typing import List, Optional

import numpy as np

from . import output_dir, parse
from ..grid import Grid
from ..models import InterfaceElasticity
from ..models import elasticity_disk as data
from ..utils import Timer, load_config, write_xdmf

PARAMS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "params")


def main(argv: Optional[List[str]] = None) -> dict:
    parser = argparse.ArgumentParser(
        prog="python -m phifem_tpu_torch.demo.interface_elasticity",
        description="Run phiFEM on a multimaterial elasticity test case.",
    )
    parser.add_argument("parameters", type=str,
                        help="Name of parameters file (without extension).")
    parser.add_argument("--solver", type=str, default="bicgstab")
    parser.add_argument(
        "--precond", type=str, default="lattice", choices=("none", "lattice"),
        help="lattice: block lattice-MG bulk + cut-band interface solve "
        "(rigid-mode deflated Krylov); none: Jacobi only",
    )
    parser.add_argument("--tol", type=float, default=1e-10)
    parser.add_argument("--maxiter", type=int, default=2000)
    args = parse(parser, argv)

    cfg = load_config(os.path.join(PARAMS, args.parameters + ".json"))
    out = output_dir(args, f"interface_elasticity_{args.parameters}")

    nx, ny = cfg.resolve_resolution()
    grid = Grid(nx, ny, cfg.bbox, cfg.cell_type, device=args.device)

    results = {"dof": [], "H10 relative error": [], "L2 relative error": []}
    levels, paths = [], []
    timer = Timer(args.device)
    for i in range(cfg.num_iterations):
        scheme = InterfaceElasticity(
            grid,
            mode="bg",
            detection_degree=cfg.boundary_detection_degree,
            pen_coef=cfg.penalization_coefficient,
            stab_coef=cfg.stabilization_coefficient,
            primal_degree=cfg.primal_degree,
            flux_degree=cfg.flux_degree,
            auxiliary_degree=cfg.auxiliary_degree,
            levelset_degree=cfg.levelset_degree,
            E_in=data.E_in, nu_in=data.nu_in, E_out=data.E_out, nu_out=data.nu_out,
        )
        with timer.phase(f"setup_{i}"):
            scheme.setup(data.levelset, data.source_term, data.exact_solution)
            scheme.assemble()
        with timer.phase(f"solve_{i}"):
            kw = {}
            if args.solver != "dense":
                kw = dict(tol=args.tol, maxiter=args.maxiter)
                if args.precond == "lattice":
                    kw["precond"] = scheme.lattice_preconditioner()
            res = scheme.solve(method=args.solver, **kw)
        print(f"[level {i}] iters {res.iterations} residual {res.residual:.2e} converged={res.converged}")

        errs = scheme.l2_h1_errors(scheme.u_h, data.exact_solution, region=None)
        results["dof"].append(scheme.U.num_dofs)
        results["H10 relative error"].append(errs["h10"])
        results["L2 relative error"].append(errs["l2"])

        csv_path = os.path.join(out, "results.csv")
        with open(csv_path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(results.keys())
            w.writerows(zip(*results.values()))
        print({k: v[-1] for k, v in results.items()})

        paths.append(write_xdmf(
            os.path.join(out, "functions", f"solution_{str(i).zfill(2)}.xdmf"),
            grid,
            point_data={"solution": scheme.u_h},
            cell_data={"tags": scheme.cell_tags},
        ))
        levels.append({"n": grid.nx, "iterations": res.iterations, "residual": res.residual,
                       "converged": res.converged, "errors": errs})
        if i < cfg.num_iterations - 1:
            grid = grid.refine()

    h10_slope, _ = np.polyfit(np.log(results["dof"]), np.log(results["H10 relative error"]), 1)
    l2_slope, _ = np.polyfit(np.log(results["dof"]), np.log(results["L2 relative error"]), 1)
    print("H10 relative error slope:", h10_slope)
    print("L2 relative error slope:", l2_slope)
    print(timer.report())
    return {"iterations": [lv["iterations"] for lv in levels], "residual": [lv["residual"] for lv in levels],
            "converged": all(lv["converged"] for lv in levels), "errors": [lv["errors"] for lv in levels],
            "levels": levels, "slopes": {"h10": h10_slope, "l2": l2_slope}, "paths": paths + [csv_path],
            "phases": dict(timer.phases), "scheme": scheme}


if __name__ == "__main__":
    main()
