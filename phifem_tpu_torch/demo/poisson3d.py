"""3D phi-FEM demo: Poisson problems and two-material elasticity on a sphere
immersed in a hexahedral box.

    python -m phifem_tpu_torch.demo.poisson3d weak|strong|neumann|robin|elasticity [--n 32]
        [--degree 1] [--tol 1e-10] [--maxiter 20000] [--E-out 0.001] [--sweeps N]

The JAX package's ``demo/poisson3d/main.py``: prints the relative L2 / H10
errors against the analytic solution and the Krylov counts, and writes a
VTI (VTK ImageData) volume.  The derivatives of the manufactured solutions
(normal derivative, Laplacian, the elasticity source) come from
``torch.func`` where the JAX demo takes them from ``jax.grad`` /
``jax.hessian`` / ``jax.jacfwd``.
"""

from __future__ import annotations

import argparse
import math
import os
from typing import List, Optional

import torch
from torch.func import grad, hessian, jacfwd, vmap

from . import output_dir, parse
from ..grid3 import Grid3
from ..models import (
    InterfaceElasticity3,
    NeumannPoisson3,
    RobinPoisson3,
    StrongDirichletPoisson3,
    WeakDirichletPoisson3,
)
from ..models.interface_elasticity import lame
from ..utils import Timer, write_vti

R0 = 0.7
BOX = ((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0))


def phi(x):
    return x[..., 0] ** 2 + x[..., 1] ** 2 + x[..., 2] ** 2 - R0**2


def u_smooth(x):
    return torch.cos(x[..., 0]) * torch.exp((x[..., 1] + x[..., 2]) / 2.0)


def du_dn(x):
    shape = x.shape[:-1]
    p = x.reshape(-1, 3)
    g = vmap(grad(lambda q: u_smooth(q[None])[0]))(p)
    n = p / torch.clamp(torch.linalg.norm(p, dim=-1, keepdim=True), min=1e-12)
    return torch.sum(g * n, dim=-1).reshape(shape)


def u_product(x):
    return phi(x) * torch.cos(x[..., 0] + 0.5 * x[..., 1] - 0.25 * x[..., 2])


def neg_lap(u):
    def f(x):
        shape = x.shape[:-1]
        p = x.reshape(-1, 3)
        H = vmap(hessian(lambda q: u(q[None])[0]))(p)
        return -torch.diagonal(H, dim1=-2, dim2=-1).sum(-1).reshape(shape)

    return f


def elasticity_data(E_in, E_out, nu=0.3):
    """Manufactured two-material solution (equal Poisson ratios: the stress
    of the radial cos profile is side-independent, so displacement and
    traction are exactly continuous at r = R0)."""

    def _r(x):
        return torch.sqrt(x[..., 0] ** 2 + x[..., 1] ** 2 + x[..., 2] ** 2 + 1e-30)

    def exact(x):
        val = (torch.cos(_r(x)) - math.cos(R0)) / E_in
        val = torch.where(_r(x) < R0, val * (E_in / E_out), val)
        return torch.stack([val, val, val], dim=-1)

    lmbda, mu = lame(E_in, nu)

    def _sigma(p):
        G = jacfwd(lambda q: torch.cos(torch.sqrt(q[0] ** 2 + q[1] ** 2 + q[2] ** 2 + 1e-30)) * torch.ones_like(q))(p)
        eps = 0.5 * (G + G.T)
        return lmbda * torch.trace(G) * torch.eye(3, dtype=p.dtype, device=p.device) + 2 * mu * eps

    def source(x):
        shape = x.shape[:-1]
        p = x.reshape(-1, 3)
        Dg = vmap(jacfwd(_sigma))(p)
        return (-torch.einsum("nijj->ni", Dg) / E_in).reshape(shape + (3,))

    return exact, source


def _report(r, errs, timer) -> None:
    print(f"iters {r.iterations} residual {r.residual:.2e} converged={r.converged}")
    print(f"Relative L2 error: {errs['l2']:.6e}")
    print(f"Relative H10 error: {errs['h10']:.6e}")
    print(timer.report())


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m phifem_tpu_torch.demo.poisson3d", description="3D phi-FEM demo.")
    ap.add_argument("scheme", choices=["weak", "strong", "neumann", "robin", "elasticity"])
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument(
        "--degree", type=int, default=1, choices=(1, 2, 3),
        help="Q_degree hexes (weak scheme only; degree 3 uses the sparse direct solve, like the 2D degree-3 path)",
    )
    ap.add_argument("--tol", type=float, default=1e-10)
    ap.add_argument("--maxiter", type=int, default=20000)
    ap.add_argument("--E-out", type=float, default=0.001)
    ap.add_argument("--sweeps", type=int, default=None,
                    help="inner band-Krylov sweeps of the elasticity cut-block solve")
    args = parse(ap, argv)
    out = output_dir(args, f"poisson3d_{args.scheme}")

    g = Grid3(args.n, args.n, args.n, BOX, device=args.device)
    timer = Timer(args.device)

    if args.scheme == "elasticity":
        phi_e = lambda x: R0**2 - (x[..., 0] ** 2 + x[..., 1] ** 2 + x[..., 2] ** 2)
        uex, f = elasticity_data(1.0, args.E_out)
        with timer.phase("setup+assemble"):
            s = InterfaceElasticity3(g, E_in=1.0, E_out=args.E_out)
            s.setup(phi_e, f, uex)
            s.assemble()
        with timer.phase("precond setup"):
            pc = s.lattice_preconditioner(sweeps=args.sweeps)
        with timer.phase("solve"):
            # flexible GMRES: the cut-block inner band Krylov makes the
            # preconditioner nonlinear
            r = s.solve(method="fgmres", tol=args.tol, maxiter=args.maxiter, precond=pc, deflate=s.rigid_modes())
        errs = s.l2_h1_errors(uex)
        _report(r, errs, timer)
        path = os.path.join(out, "solution.vti")
        write_vti(path, g, point_data={"ux": s.u_lat[0], "uy": s.u_lat[1], "uz": s.u_lat[2]})
    else:
        with timer.phase("setup+assemble"):
            if args.scheme == "weak":
                uex = u_smooth
                s = WeakDirichletPoisson3(g, degree=args.degree).setup(phi, neg_lap(u_smooth), u_D=u_smooth)
            elif args.scheme == "strong":
                uex = u_product
                s = StrongDirichletPoisson3(g).setup(phi, neg_lap(u_product))
            elif args.scheme == "neumann":
                uex = u_smooth
                f = lambda x: neg_lap(u_smooth)(x) + u_smooth(x)
                s = NeumannPoisson3(g).setup(phi, f, du_dn)
            else:  # robin
                uex = u_smooth
                f = lambda x: neg_lap(u_smooth)(x) + u_smooth(x)
                robin = lambda x: du_dn(x) + u_smooth(x)
                s = RobinPoisson3(g, robin_coef=1.0).setup(phi, f, robin)
            s.assemble()
        with timer.phase("solve"):
            if args.scheme == "weak" and args.degree >= 3:
                r = s.solve(method="sparse")
            else:
                kw = {}
                if args.scheme == "weak":
                    kw["precond"] = s.lattice_preconditioner()
                r = s.solve(tol=args.tol, maxiter=args.maxiter, **kw)
        errs = s.l2_h1_errors(uex)
        _report(r, errs, timer)
        path = os.path.join(out, "solution.vti")
        # degree >= 2 fields live on the degree-refined node grid
        write_vti(path, getattr(s, "_node_grid", g), point_data={"u": s.u_lat})
    return {"iterations": r.iterations, "residual": r.residual, "converged": r.converged, "errors": errs,
            "paths": [path], "phases": dict(timer.phases), "scheme": s}


if __name__ == "__main__":
    main()
