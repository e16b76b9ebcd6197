"""phi-FEM on an imported unstructured mesh.

    python -m phifem_tpu_torch.demo.unstructured s1|s2|s3|s4 [--mesh path.xdmf] [--mode bg|sub]
        [--r2 R2] [--solver bicgstab]
    python -m phifem_tpu_torch.demo.unstructured s1 --dim 3 [--n 12]

The JAX package's ``demo/unstructured/main.py``: any of the four Poisson
schemes (S1 weak Dirichlet, S2 strong Dirichlet, S3 Neumann, S4 Robin) on
an XDMF triangle mesh (``--mesh``; reading one needs h5py), by default a
randomly perturbed triangulation of [-1, 1]^2 with the immersed circle
r^2 = 0.49; prints the relative errors against a manufactured solution.
``--dim 3`` takes tetrahedral meshes: an immersed sphere on an XDMF tet
mesh, by default the Kuhn-split box of [-1, 1]^3.  The solution's vertex
values are written as a VTU (``solution.vtu``), which the JAX demo does
not write.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np
import torch
from torch.func import grad, vmap

from . import output_dir, parse
from ..grid import CellType, Grid
from ..models import NeumannPoissonU, RobinPoissonU, StrongDirichletPoissonU, WeakDirichletPoissonU
from ..umesh import UMesh
from ..umesh3 import UMesh3
from ..utils import Timer, write_vtu_umesh


def fallback_mesh(n: int = 24, amp: float = 0.25, seed: int = 0, device="cuda") -> UMesh:
    """The n x n triangle grid of [-1, 1]^2 with its interior vertices moved
    by ``amp h (U[0, 1) - 1/2)`` (``numpy.random.default_rng(seed)``)."""
    um, _ = UMesh.from_grid(Grid(n, n, ((-1.0, -1.0), (1.0, 1.0)), CellType.triangle, device="cpu"))
    verts = um.verts.copy()
    h = 2.0 / n
    rng = np.random.default_rng(seed)
    interior = (np.abs(np.abs(verts[:, 0]) - 1.0) > 1e-12) & (np.abs(np.abs(verts[:, 1]) - 1.0) > 1e-12)
    verts[interior] += amp * h * (rng.random((int(interior.sum()), 2)) - 0.5)
    return UMesh(verts, um.cells, device=device)


def _normal_derivative(uex):
    """d uex / dn with n = x / |x|, the normal of the level set |x|^2 - r^2,
    the gradient by ``torch.func``."""

    def nderiv(x):
        shape = x.shape[:-1]
        p = x.reshape(-1, x.shape[-1])
        g = vmap(grad(uex))(p)
        nrm = torch.clamp(torch.linalg.norm(p, dim=-1, keepdim=True), min=1e-12)
        return (torch.sum(g * p, dim=-1) / nrm[:, 0]).reshape(shape)

    return nderiv


def _report(s, res, uex, scheme: str, timer, out: str) -> dict:
    print(f"solver: iters={res.iterations} residual={res.residual:.3e} converged={res.converged}")
    region = (1,) if scheme in ("s3", "s4") else (1, 2)
    errs = s.l2_h1_errors(s.u_h, uex, region=region)
    print(f"Relative L2 error:  {errs['l2']:.6e}")
    print(f"Relative H10 error: {errs['h10']:.6e}")
    print(timer.report())
    path = os.path.join(out, "solution.vtu")
    write_vtu_umesh(path, s.mesh, point_data={"solution": s.u_h}, cell_data={"tags": s.cell_tags})
    return {"iterations": res.iterations, "residual": res.residual, "converged": res.converged, "errors": errs,
            "paths": [path], "phases": dict(timer.phases), "scheme": s}


def main(argv: Optional[List[str]] = None) -> dict:
    parser = argparse.ArgumentParser(prog="python -m phifem_tpu_torch.demo.unstructured",
                                     description="phi-FEM schemes on an imported mesh.")
    parser.add_argument("scheme", choices=["s1", "s2", "s3", "s4"])
    parser.add_argument("--mesh", type=str, default=None, help="XDMF mesh path")
    parser.add_argument("--mode", choices=["bg", "sub"], default="bg")
    parser.add_argument("--r2", type=float, default=None,
                        help="squared circle/sphere radius of the immersed domain")
    parser.add_argument("--solver", type=str, default="bicgstab")
    parser.add_argument("--dim", type=int, choices=[2, 3], default=2)
    parser.add_argument("--n", type=int, default=12, help="3D fallback box resolution (6 tets per hex)")
    args = parse(parser, argv)
    out = output_dir(args, f"unstructured_{args.scheme}" + ("_3d" if args.dim == 3 else ""))
    if args.dim == 3:
        return main3(args, out)

    timer = Timer(args.device)
    with timer.phase("mesh"):
        if args.mesh:
            mesh = UMesh.from_xdmf(args.mesh, device=args.device)
            r2 = args.r2 if args.r2 is not None else 0.125
        else:
            mesh = fallback_mesh(device=args.device)
            r2 = args.r2 if args.r2 is not None else 0.49
    print(f"mesh: {mesh.num_vertices} vertices, {mesh.num_cells} triangles")

    ls = lambda x: x[..., 0] ** 2 + x[..., 1] ** 2 - r2
    uex = lambda x: torch.cos(x[..., 0]) * torch.sin(x[..., 1])
    nderiv = _normal_derivative(uex)

    with timer.phase("setup+assemble"):
        if args.scheme == "s1":
            s = WeakDirichletPoissonU(mesh, mode=args.mode)
            s.setup(ls, lambda x: 2.0 * uex(x), u_D=uex)
        elif args.scheme == "s2":
            # homogeneous-Dirichlet manufactured solution: u = sin(phi)
            uex = lambda x: torch.sin(x[..., 0] ** 2 + x[..., 1] ** 2 - r2)

            def f2(x):
                r2x = x[..., 0] ** 2 + x[..., 1] ** 2
                return 4.0 * r2x * torch.sin(r2x - r2) - 4.0 * torch.cos(r2x - r2)

            s = StrongDirichletPoissonU(mesh, mode=args.mode)
            s.setup(ls, f2)
        elif args.scheme == "s3":
            s = NeumannPoissonU(mesh, mode=args.mode)
            s.setup(ls, lambda x: 2.0 * uex(x) + uex(x), nderiv)
        else:
            s = RobinPoissonU(mesh, mode=args.mode, robin_coef=1.0)
            s.setup(ls, lambda x: 2.0 * uex(x) + uex(x), lambda x: nderiv(x) + uex(x))
        s.assemble()
    with timer.phase("solve"):
        res = s.solve(method=args.solver, tol=1e-10)
    return _report(s, res, uex, args.scheme, timer, out)


def main3(args, out: str) -> dict:
    """Tetrahedral (3D) variant: immersed sphere, same scheme menu."""
    timer = Timer(args.device)
    with timer.phase("mesh"):
        if args.mesh:
            mesh = UMesh3.from_xdmf(args.mesh, device=args.device)
        else:
            mesh = UMesh3.box(args.n, args.n, args.n, ((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0)), device=args.device)
    r2 = args.r2 if args.r2 is not None else 0.61**2
    print(f"mesh: {mesh.num_vertices} vertices, {mesh.num_cells} tets")

    ls = lambda x: (x**2).sum(-1) - r2
    uex = lambda x: torch.cos(x[..., 0]) * torch.sin(x[..., 1]) * torch.cos(x[..., 2])
    fex = lambda x: 3.0 * uex(x)
    nderiv = _normal_derivative(uex)

    with timer.phase("setup+assemble"):
        if args.scheme == "s1":
            s = WeakDirichletPoissonU(mesh, mode=args.mode, levelset_degree=2)
            s.setup(ls, fex, u_D=uex)
        elif args.scheme == "s2":
            uex = lambda x: torch.sin((x**2).sum(-1) - r2)

            def f2(x):
                q = (x**2).sum(-1)
                return 4.0 * q * torch.sin(q - r2) - 6.0 * torch.cos(q - r2)

            s = StrongDirichletPoissonU(mesh, mode=args.mode, levelset_degree=2)
            s.setup(ls, f2)
        elif args.scheme == "s3":
            s = NeumannPoissonU(mesh, mode=args.mode, levelset_degree=2)
            s.setup(ls, lambda x: fex(x) + uex(x), nderiv)
        else:
            s = RobinPoissonU(mesh, mode=args.mode, levelset_degree=2, robin_coef=1.0)
            s.setup(ls, lambda x: fex(x) + uex(x), lambda x: nderiv(x) + uex(x))
        s.assemble()
    with timer.phase("solve"):
        res = s.solve(method=args.solver, tol=1e-10, maxiter=5000)
    return _report(s, res, uex, args.scheme, timer, out)


if __name__ == "__main__":
    main()
