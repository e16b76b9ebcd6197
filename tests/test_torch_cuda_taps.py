"""The hand-written CUDA tap-matvec kernel against its plain PyTorch
version.

The card tests carry the ``cuda`` marker and skip where there is no CUDA
device; run them on a machine with an NVIDIA Hopper card with
``python -m pytest tests/test_torch_cuda_taps.py -q``.  No JAX here.
Tolerances relative to max|y|: 1e-13 in float64, 1e-5 in float32 (the
kernel sums a thread's taps in another order than the plain version's
tap-by-tap accumulation, with FMA).
"""

import numpy as np
import pytest
import torch

import phifem_tpu_torch as pt
from phifem_tpu_torch.ops import cuda_taps
from torch_tap_cases import random_tap_operator

TOL = {torch.float64: 1e-13, torch.float32: 1e-5}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel(a, b):
    return float((a - b).abs().max()) / float(b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize(
    "fields", ["u", "uy", "up", "yp", "uyp"], ids=["P1-P1", "P1-vecP1", "P1-DG0", "vecP1-DG0", "all"]
)
@pytest.mark.parametrize("ct", ["triangle", "quadrilateral"])
def test_kernel_matches_plain(cuda, ct, fields, dt):
    top, x = random_tap_operator(37, 23, ct, dt, cuda, fields=fields)
    before = cuda_taps.launches
    yk = cuda_taps.tap_matvec(top, top.W, x)
    torch.cuda.synchronize()
    assert cuda_taps.launches == before + 1
    yr = cuda_taps.tap_matvec_ref(top, top.W, x)
    for k in yr:
        assert yk[k].shape == yr[k].shape and yk[k].dtype == dt
        assert _rel(yk[k], yr[k]) <= TOL[dt], k


@pytest.mark.cuda
def test_scheme_matvec_on_the_card_matches_the_cpu(cuda):
    """S4 on the card (taps through the kernel, bulk through the stencil
    kernel) against the same scheme on the CPU (plain versions)."""
    from phifem_tpu_torch.models import robin_square as rsq

    out = {}
    before = cuda_taps.launches
    for dev in ("cpu", cuda):
        g = pt.Grid(40, 40, ((-1.0, -1.0), (1.0, 1.0)), "triangle", device=dev)
        s = pt.RobinPoisson(g, detection_degree=1, levelset_degree=2)
        s.setup(rsq.levelset, rsq.source_term, rsq.robin_data, detection_levelset=rsq.detection_levelset).assemble()
        rng = np.random.default_rng(0)
        x = {k: torch.as_tensor(rng.standard_normal(v.shape), device=dev) for k, v in s.b.items()}
        out[str(dev)] = s.op.lattice_form().make_matvec(s.op)(x)
    assert cuda_taps.launches == before + 1
    for k, v in out["cpu"].items():
        assert _rel(out["cuda"][k].cpu(), v) <= 1e-12, k


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    top, x = random_tap_operator(6, 5, "triangle", torch.float64, cuda)
    with pytest.raises(ValueError, match="must be on"):
        cuda_taps.tap_matvec(top, top.W, {k: v.float() for k, v in x.items()})
    with pytest.raises(ValueError, match="shape"):
        cuda_taps.tap_matvec(top, top.W, {k: v[:-1] for k, v in x.items()})
    with pytest.raises(ValueError, match="flat weight buffer"):
        cuda_taps.tap_matvec(top, top.W[:-1], x)
    with pytest.raises(TypeError):
        cuda_taps.tap_matvec(top, top.W.half(), x)
