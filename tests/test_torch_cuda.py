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
    # many tiles, the last one ragged: 11,849 positions = 92 x 128 + 73
    ((41, 17, 17, 192), (3, 3, 3, 192, 192)),
    ((6, 3, 3, 192), (3, 3, 3, 192, 192)),       # K split over blocks
    ((21, 9, 9, 24), (5, 5, 5, 24, 24)),         # the 24-channel tile
    ((11, 5, 5, 384), (3, 3, 3, 384, 192)),
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("xs,ws", [
    ((7, 5, 9, 64), (3, 3, 3, 64, 64)),
    ((5, 6, 3, 10), (3, 3, 3, 10, 70)),
    ((6, 3, 3, 24), (5, 5, 5, 24, 24)),
], ids=lambda s: "x".join(map(str, s)))
def test_kernel3d_every_instance_and_split(cuda, xs, ws, dtype):
    """Each instance of the dtype, unsplit and split, matches the plain
    version (the vector path where the channels allow it, else the
    element path)."""
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.normal(size=xs), dtype=dtype, device=cuda)
    W = torch.as_tensor(rng.normal(size=ws), dtype=dtype, device=cuda)
    ref = stencil.conv_blocked_plain(x, W)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    for inst, spec in stencil.INSTANCES3D.items():
        if spec[0] != dtype:
            continue
        for split in (1, 3, 64):
            p = stencil.plan3d(xs, ws, dtype, instance=inst,
                               split=min(split, stencil.plan3d(
                                   xs, ws, dtype, instance=inst).chunks))
            y = stencil.KERNEL3D(x, W, p)
            err = float((y - ref).abs().max() / ref.abs().max())
            assert err <= tol, (p, err)


def test_kernel3d_instance_table_matches_plan(cuda):
    table = stencil.KERNEL3D.instances()
    assert {i: t[0] for i, t in table.items()} == stencil.INSTANCES3D
    for i, (spec, threads, smem) in table.items():
        dtype, bm, bn, tm, tn, bk, stages = spec
        assert threads == (bm // tm) * (bn // tn)
        v = 16 // dtype.itemsize
        assert smem == dtype.itemsize * stages * (bm * (bk + v) + bk * bn)


@pytest.mark.parametrize("xs,ws", [
    ((41, 17, 17, 192), (3, 3, 3, 192, 192)),
    ((6, 3, 3, 192), (3, 3, 3, 192, 192)),
], ids=["fine", "split"])
def test_kernel3d_repeat_launches_are_bitwise_equal(cuda, xs, ws):
    rng = np.random.default_rng(6)
    x = torch.as_tensor(rng.normal(size=xs), dtype=torch.float32,
                        device=cuda)
    W = torch.as_tensor(rng.normal(size=ws), dtype=torch.float32,
                        device=cuda)
    first = stencil.conv_blocked(x, W)
    for _ in range(3):
        assert torch.equal(stencil.conv_blocked(x, W), first)
    if xs[0] == 6:
        assert stencil.plan3d(xs, ws, torch.float32).split > 1


@pytest.mark.parametrize("xs", [(11, 5, 5, 192), (21, 9, 9, 192)],
                         ids=lambda s: "x".join(map(str, s)))
def test_kernel3d_graph_replays_eager_chain(cuda, xs):
    rng = np.random.default_rng(7)
    C = xs[-1]
    x = torch.as_tensor(rng.normal(size=xs), dtype=torch.float32,
                        device=cuda)
    # entries of variance 1 / (27 C): 16 applies neither overflow nor vanish
    W = torch.as_tensor(rng.normal(size=(3, 3, 3, C, C)) / (27 * C)**0.5,
                        dtype=torch.float32, device=cuda)
    assert stencil.plan3d(xs, W.shape, torch.float32).split > 1

    def chain(v):
        for _ in range(16):
            v = stencil.conv_blocked(v, W)
        return v

    eager = chain(x)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = stencil.KERNEL3D.launches
    with torch.cuda.graph(graph):
        out = chain(x)
    graph.replay()
    torch.cuda.synchronize()
    assert stencil.KERNEL3D.launches == before
    assert torch.isfinite(eager).all() and float(eager.abs().max()) > 0
    assert torch.equal(out, eager)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("xs,ws", [
    ((7, 5, 9, 64), (3, 3, 3, 64, 64)),
    ((6, 3, 3, 24), (5, 5, 5, 24, 24)),
], ids=lambda s: "x".join(map(str, s)))
def test_stencil3d_v1_matches_plain(cuda, xs, ws, dtype, tol):
    rng = np.random.default_rng(8)
    x = torch.as_tensor(rng.normal(size=xs), dtype=dtype, device=cuda)
    W = torch.as_tensor(rng.normal(size=ws), dtype=dtype, device=cuda)
    before = (stencil.KERNEL3D.launches, stencil.KERNEL3D.v1_launches)
    y = stencil.KERNEL3D.v1(x, W)
    torch.cuda.synchronize()
    assert (stencil.KERNEL3D.launches, stencil.KERNEL3D.v1_launches) == (
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
    p = CavityProblem(cfg, dtype=torch.float32).setup()
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
    p = CustomFuncProblem(cfg, case="taylor-green",
                          dtype=torch.float32).setup()
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
