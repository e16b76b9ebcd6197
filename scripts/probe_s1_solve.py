import os, sys, time
os.environ.setdefault("PHIFEM_X64", "1")
sys.path.insert(0, "/root/repo")
import jax, jax.numpy as jnp, numpy as np
import phifem_tpu as pf
from phifem_tpu.models import WeakDirichletPoisson
from phifem_tpu.solvers import masked_operator

n = 200
grid = pf.Grid(n, n, ((-4.5, -4.5), (4.5, 4.5)), pf.CellType.triangle)
sys.path.insert(0, "/root/repo/demo/weak-dirichlet/flower")
from data import detection_levelset, levelset, source_term
s = WeakDirichletPoisson(grid, mode="bg", detection_degree=1, single_layer_cut=True)
s.setup(levelset, source_term, detection_levelset=detection_levelset)
s.assemble()
vc = s.lattice_preconditioner(min_n=13)
print("interface dense m:", None if vc.interface_inv is None else vc.interface_inv.shape,
      "schwarz:", vc.band_tables is not None, flush=True)

def timeit(fn, reps=1, label=""):
    out = fn()  # compile
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    dt = (time.perf_counter() - t0) / reps
    print(f"{label}: {dt*1e3:.2f} ms", flush=True)
    return out

# fetch-synced loops inside one jit
matvec, diag, active = masked_operator(s.op)
x0 = jax.tree.map(jnp.ones_like, s.b)

@jax.jit
def mv_loop(x):
    x = jax.lax.fori_loop(0, 50, lambda i, v: jax.tree.map(
        lambda a, d: a / jnp.maximum(d, 1e-30), matvec(v), diag), x)
    return sum(jnp.sum(jnp.abs(v)) for v in x.values())

@jax.jit
def pc_loop(x):
    x = jax.lax.fori_loop(0, 50, lambda i, v: vc(v), x)
    return sum(jnp.sum(jnp.abs(v)) for v in x.values())

timeit(lambda: float(mv_loop(x0)), 1, "matvec x50 (compile+run)")
timeit(lambda: float(mv_loop(x0)), 3, "matvec x50 warm")
timeit(lambda: float(pc_loop(x0)), 1, "precond x50 (compile+run)")
timeit(lambda: float(pc_loop(x0)), 3, "precond x50 warm")

r = s.solve(method="bicgstab", tol=1e-8, maxiter=60, precond=vc)
t0 = time.perf_counter()
r = s.solve(method="bicgstab", tol=1e-8, maxiter=60, precond=vc)
print(f"solve warm: {(time.perf_counter()-t0)*1e3:.1f} ms, iters={r.iterations}, res={r.residual:.2e}", flush=True)
