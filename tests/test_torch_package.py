"""The port package stands alone: no JAX, explicit devices and dtypes."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

REPO = Path(__file__).resolve().parents[1]


def test_import_leaves_jax_out():
    code = (
        "import sys, phifem_tpu_torch, phifem_tpu_torch.models, "
        "phifem_tpu_torch.utils.convert, phifem_tpu_torch.ops.cuda_stencil, "
        "phifem_tpu_torch.levelset, phifem_tpu_torch.measures, phifem_tpu_torch.tagging, "
        "phifem_tpu_torch.mg, phifem_tpu_torch.models.base, "
        "phifem_tpu_torch.models.weak_dirichlet, phifem_tpu_torch.models.flower, "
        "phifem_tpu_torch.ops.taps, phifem_tpu_torch.ops.cuda_taps, "
        "phifem_tpu_torch.models.strong_dirichlet, phifem_tpu_torch.models.neumann, "
        "phifem_tpu_torch.models.robin, phifem_tpu_torch.models.neumann_square, "
        "phifem_tpu_torch.models.robin_square, phifem_tpu_torch.models.interface_elasticity, "
        "phifem_tpu_torch.models.elasticity_disk, phifem_tpu_torch.utils.config, "
        "phifem_tpu_torch.pmg, phifem_tpu_torch.grid3, phifem_tpu_torch.tagging3, "
        "phifem_tpu_torch.ops.lattice3, phifem_tpu_torch.ops.cuda_lattice3, phifem_tpu_torch.ops.cuda_hex3, "
        "phifem_tpu_torch.models.lattice_core, phifem_tpu_torch.models.poisson3, "
        "phifem_tpu_torch.models.weak_dirichlet3, phifem_tpu_torch.models.strong_dirichlet3, "
        "phifem_tpu_torch.models.neumann3, phifem_tpu_torch.models.robin3, "
        "phifem_tpu_torch.models.interface_elasticity3, phifem_tpu_torch.umesh, "
        "phifem_tpu_torch.uassembly, phifem_tpu_torch.amg, phifem_tpu_torch.ops.cuda_amg, "
        "phifem_tpu_torch.models.unstructured, phifem_tpu_torch.parallel, "
        "phifem_tpu_torch.parallel.halo, phifem_tpu_torch.parallel.lattice, "
        "phifem_tpu_torch.parallel.lattice3, phifem_tpu_torch.parallel.uop; "
        "assert 'h5py' not in sys.modules, 'importing the port needs no h5py'; "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'phifem_tpu')); "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_every_module_leaves_jax_out():
    """Walk every module of the package (``pkgutil``), import each in a
    fresh interpreter, and compare ``sys.modules`` before and after: no
    ``jax`` or ``phifem_tpu`` module may appear."""
    code = (
        "import sys, pkgutil, importlib, phifem_tpu_torch as P\n"
        "before = set(sys.modules)\n"
        "names = [m.name for m in pkgutil.walk_packages(P.__path__, 'phifem_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in set(sys.modules) if m.split('.')[0] in ('jax', 'phifem_tpu'))\n"
        "assert 'phifem_tpu_torch.models.interface_elasticity' in names, names\n"
        "assert 'phifem_tpu_torch.utils.config' in names, names\n"
        "assert 'phifem_tpu_torch.pmg' in names, names\n"
        "assert {'phifem_tpu_torch.grid3', 'phifem_tpu_torch.models.weak_dirichlet3', "
        "'phifem_tpu_torch.ops.cuda_hex3', 'phifem_tpu_torch.ops.cuda_lattice3', "
        "'phifem_tpu_torch.models.neumann3', 'phifem_tpu_torch.models.robin3', "
        "'phifem_tpu_torch.models.interface_elasticity3', 'phifem_tpu_torch.umesh', "
        "'phifem_tpu_torch.uassembly', 'phifem_tpu_torch.amg', 'phifem_tpu_torch.ops.cuda_amg', "
        "'phifem_tpu_torch.models.unstructured', 'phifem_tpu_torch.parallel', "
        "'phifem_tpu_torch.parallel.sharding', 'phifem_tpu_torch.parallel.halo', "
        "'phifem_tpu_torch.parallel.lattice', 'phifem_tpu_torch.parallel.lattice3', "
        "'phifem_tpu_torch.parallel.uop'} <= set(names), names\n"
        "print(len(names), len(new), bad); sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imported_roots(path: Path) -> set:
    """Top-level package names that the source file imports, anywhere in it
    (absolute imports; a relative import stays inside its package)."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_sources_import_no_jax():
    """AST guard: no source file of the port (``phifem_tpu_torch/**.py``,
    ``parallel/`` included) nor ``chip_smoke.py`` imports ``jax``, ``jaxlib``
    or ``phifem_tpu``, not even inside a function."""
    files = sorted((REPO / "phifem_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert REPO / "phifem_tpu_torch" / "parallel" / "uop.py" in files
    bad = {str(f.relative_to(REPO)): sorted(r & {"jax", "jaxlib", "phifem_tpu"})
           for f in files for r in [_imported_roots(f)] if r & {"jax", "jaxlib", "phifem_tpu"}}
    assert not bad, bad


def test_shard_mesh_never_shrinks():
    """``make_mesh`` without devices asks for CUDA cards and raises when the
    host has fewer than asked (here, where there may be none: ``make_mesh(2)``
    on a host with fewer than two cards); one device may repeat in an
    explicit list."""
    from phifem_tpu_torch.parallel import make_mesh

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="CUDA card"):
        make_mesh(have + 1)
    if have < 2:
        with pytest.raises(RuntimeError, match="CUDA card"):
            make_mesh(2)
    else:
        assert make_mesh(2).size == 2
    if have == 0:
        with pytest.raises(RuntimeError):
            make_mesh()
        with pytest.raises(RuntimeError):
            make_mesh(devices=["cuda:0"] * 4)
    assert make_mesh(devices=["cpu"] * 4).size == 4


def test_no_global_default_changed():
    import phifem_tpu_torch as pt

    before = (torch.get_default_dtype(), torch.empty(0).device)
    s = pt.BoxPoisson(pt.Grid(4, 4, device="cpu")).setup(lambda x: x[:, 0]).assemble()
    assert (torch.get_default_dtype(), torch.empty(0).device) == before
    assert s.b["u"].dtype == torch.float64


def test_float32_grid_flows_through():
    import phifem_tpu_torch as pt

    g = pt.Grid(8, 8, dtype=torch.float32, device="cpu")
    s = pt.BoxPoisson(g).setup(lambda x: torch.ones_like(x[:, 0])).assemble()
    assert s.b["u"].dtype == torch.float32
    assert s.op.batches[0].matrices.dtype == torch.float32
    assert s.u_D.data.dtype == torch.float32


def test_unported_paths_raise():
    import phifem_tpu_torch as pt
    from phifem_tpu_torch.models import elasticity_disk as disk

    g = pt.Grid(4, 4, device="cpu")
    s = pt.BoxPoisson(g).setup(lambda x: x[:, 0]).assemble()
    # gmres and fgmres are ported (slice E); an unknown method is a ValueError
    for method in ("gmres", "fgmres"):
        assert pt.solve(s.op, s.b, bcs=s.bcs, method=method, tol=1e-10).converged
    with pytest.raises(ValueError, match="Unknown method"):
        pt.solve(s.op, s.b, bcs=s.bcs, method="minres")
    # the sub mode is ported (slice C); the Ritz modes of the lattice
    # preconditioner are ported (slice I) and now build: on this 8 x 8 grid
    # the band's dense inverse leaves no slow mode to keep (|lambda| < 0.5),
    # and ritz_modes is part of the memo key
    circle = lambda x: x[:, 0] ** 2 + x[:, 1] ** 2 - 0.2
    w = pt.WeakDirichletPoisson(pt.Grid(8, 8, ((-1.0, -1.0), (1.0, 1.0)), device="cpu"), mode="sub")
    w.setup(circle, lambda x: x[:, 0]).assemble()
    vr = w.lattice_preconditioner(ritz_modes=2)
    assert vr is w.lattice_preconditioner(ritz_modes=2) and vr is not w.lattice_preconditioner()
    assert vr.ritz_lambdas is None and vr.coarse_Z is None
    assert w.solve(tol=1e-10, precond=vr).converged
    # the constant block cycle of a vector P1 bulk with a Dirichlet-masked
    # boundary is ported (slice F2): S5 with its displacements taken as such
    # gets a LatticeBlockMG per displacement field
    e = pt.InterfaceElasticity(pt.Grid(8, 8, ((-1.5, -1.5), (1.5, 1.5)), device="cpu"), E_in=disk.E_in,
                               nu_in=disk.nu_in, E_out=disk.E_out, nu_out=disk.nu_out)
    e.setup(disk.levelset, disk.source_term, disk.exact_solution).assemble()
    e._bulk_neumann_fields = lambda: ()
    vc = e.lattice_preconditioner(coupled=False, min_n=4)
    assert {type(m).__name__ for m in vc.mgs.values()} == {"LatticeBlockMG"}
    # imported meshes: triangles (slice G1a), quadrilaterals (G1b) and
    # tetrahedra (UMesh3, G2) build their spaces and tags
    quads, _ = pt.UMesh.from_grid(pt.Grid(4, 4, cell_type="quadrilateral", device="cpu"))
    assert pt.USpace.lagrange(quads, 1).num_dofs == 25
    tets = pt.UMesh3.box(2, 2, 2, ((-1.0,) * 3, (1.0,) * 3), device="cpu")
    assert pt.USpace.lagrange(tets, 2).num_dofs == 125
    tags = pt.compute_tags_measures(tets, lambda x: (x**2).sum(-1) - 0.5, 1, box_mode=True)
    assert tags.cells_tags.as_numpy().shape == (48,)
