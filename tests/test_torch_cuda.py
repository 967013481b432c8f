"""The CUDA stencil kernels on the card: against their plain version,
their launch counts, and the 2D and 3D paths never taking the plain
version; the breakdown kernel in every mode against its plain version,
and under a CUDA graph.

Marked ``cuda``: these skip where torch.cuda.is_available() is false and
run on a machine with an NVIDIA GPU and nvcc:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

(--noconftest: the suite's conftest configures JAX, which this file does
not use.)
"""

import numpy as np
import pytest
import torch

from pynama_tpu_torch.ops import stencil
from pynama_tpu_torch.scripts import stencil_breakdown as sb

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("xs,ws", [
    ((21, 13, 64), (3, 3, 64, 64)),
    ((17, 9, 64), (5, 5, 64, 64)),
    ((33, 11, 64), (3, 3, 64, 128)),
    ((13, 13, 128), (3, 3, 128, 192)),
    ((40, 37, 8), (5, 5, 8, 8)),
], ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_plain(cuda, xs, ws, dtype, tol):
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=xs), dtype=dtype, device=cuda)
    W = torch.as_tensor(rng.normal(size=ws), dtype=dtype, device=cuda)
    before = stencil.KERNEL.launches
    y = stencil.conv_blocked(x, W)
    torch.cuda.synchronize()
    assert stencil.KERNEL.launches == before + 1
    ref = stencil.conv_blocked_plain(x, W)
    err = float((y - ref).abs().max() / ref.abs().max())
    assert err <= tol, err


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("xs,ws", [
    ((7, 5, 9, 64), (3, 3, 3, 64, 64)),
    ((6, 4, 11, 64), (3, 3, 3, 64, 128)),
    ((6, 3, 3, 24), (5, 5, 5, 24, 24)),
    ((11, 5, 5, 192), (3, 3, 3, 192, 384)),
    ((5, 6, 3, 10), (3, 3, 3, 10, 70)),
], ids=lambda s: "x".join(map(str, s)))
def test_kernel3d_matches_plain(cuda, xs, ws, dtype, tol):
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.normal(size=xs), dtype=dtype, device=cuda)
    W = torch.as_tensor(rng.normal(size=ws), dtype=dtype, device=cuda)
    before = (stencil.KERNEL.launches, stencil.KERNEL3D.launches)
    y = stencil.conv_blocked(x, W)
    torch.cuda.synchronize()
    assert (stencil.KERNEL.launches, stencil.KERNEL3D.launches) == (
        before[0], before[1] + 1)
    ref = stencil.conv_blocked_plain(x, W)
    err = float((y - ref).abs().max() / ref.abs().max())
    assert err <= tol, err


def refuse(*args):
    raise AssertionError("plain version reached with a CUDA tensor")


def test_cavity_on_cuda_never_takes_plain_version(cuda, monkeypatch):
    from pynama_tpu_torch.cases.cavity import CavityProblem

    monkeypatch.setattr(stencil, "conv_blocked_plain", refuse)
    cfg = {
        "domain": {"ngl": 3, "box-mesh": {"nelem": [8, 8]}},
        "material-properties": {"rho": 1.0, "mu": 0.1},
        "time-solver": {"end-time": 0.5},
        "boundary-conditions": {"no-slip": {"up": [1.0, 0.0]}},
        "kle-rtol": 1e-5,
    }
    before = stencil.KERNEL.launches
    p = CavityProblem(cfg).setup()
    vort, t, n = p.run(max_steps=2)
    assert n == 2 and torch.isfinite(vort).all()
    assert stencil.KERNEL.launches > before


def test_taylor_green_3d_on_cuda_never_takes_plain_version(cuda,
                                                            monkeypatch):
    from pynama_tpu_torch.cases.analytic import CustomFuncProblem

    monkeypatch.setattr(stencil, "conv_blocked_plain", refuse)
    cfg = {
        "domain": {"ngl": 3, "box-mesh": {"nelem": [4, 4, 4]}},
        "material-properties": {"rho": 0.5, "mu": 0.01},
        "time-solver": {"end-time": 0.5, "dt0": 0.01, "max-dt": 0.01},
        "kle-rtol": 1e-5,
    }
    before = (stencil.KERNEL.launches, stencil.KERNEL3D.launches)
    p = CustomFuncProblem(cfg, case="taylor-green").setup()
    vort, t, n = p.run(max_steps=2)
    assert n == 2 and torch.isfinite(vort).all()
    assert stencil.KERNEL3D.launches > before[1]
    assert stencil.KERNEL.launches == before[0]


# fill is a copy; highest: float32 sums in another order; default: against
# the plain version on TF32-rounded inputs, tensor-core sums in another order
BREAKDOWN_TOL = {"fill": 0.0, "highest": 1e-5, "default": 1e-4}


@pytest.mark.parametrize("TR", sb.TILE_ROWS)
@pytest.mark.parametrize("shape", [(97, 97, 128), (21, 13, 32), (10, 7, 70)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("mode,prec", [r[1:] for r in sb.KERNEL_ROWS],
                         ids=[r[0] for r in sb.KERNEL_ROWS])
def test_breakdown_matches_plain(cuda, mode, prec, shape, TR):
    rng = np.random.default_rng(2)
    C = shape[-1]
    x = torch.as_tensor(rng.normal(size=shape), dtype=torch.float32,
                        device=cuda)
    W = torch.as_tensor(rng.normal(size=(3, 3, C, C)), dtype=torch.float32,
                        device=cuda)
    before = stencil.BREAKDOWN.launches
    y = sb.make_breakdown(mode, prec, TR)(x, W)
    torch.cuda.synchronize()
    assert stencil.BREAKDOWN.launches == before + 1
    ref = sb.breakdown_plain(mode, prec, x.double(), W.double())
    err = float((y.double() - ref).abs().max() / ref.abs().max())
    assert err <= BREAKDOWN_TOL["fill" if mode == "fill" else prec], err


@pytest.mark.parametrize("mode,prec", [("full", "highest"),
                                       ("mm", "default")])
def test_breakdown_graph_replays_eager_chain(cuda, mode, prec):
    rng = np.random.default_rng(4)
    C = 128
    x = torch.as_tensor(rng.normal(size=(25, 25, C)), dtype=torch.float32,
                        device=cuda)
    # entries of variance 1 / (9 C): 64 applies neither overflow nor vanish
    W = torch.as_tensor(rng.normal(size=(3, 3, C, C)) / (3 * C**0.5),
                        dtype=torch.float32, device=cuda)
    apply = sb.make_breakdown(mode, prec, 8)

    def chain(v):
        for _ in range(64):
            v = apply(v, W)
        return v

    eager = chain(x)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = stencil.BREAKDOWN.launches
    with torch.cuda.graph(graph):
        out = chain(x)
    graph.replay()
    torch.cuda.synchronize()
    # neither the capture nor the replay goes through a counted launch
    assert stencil.BREAKDOWN.launches == before
    assert torch.isfinite(eager).all() and float(eager.abs().max()) > 0
    assert torch.equal(out, eager)
