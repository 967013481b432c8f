"""The CUDA stencil kernels on the card: against their plain version in
every instance and K split, their first designs, their launch counts,
bitwise repeats and graph replays, and the 2D and 3D paths never taking
the plain version; the refined (kle-refine) solve through the kernels
against the plain version, its inner solves on the float32 instances;
the warm-start extrapolation (kle-ws-extrapolate) through the kernels
against the plain version, its scan attempt against its stepper, and
its history on the card; the immersed-boundary path through the kernels
against the plain version, and stencil2d's float64 instance at its
non-square and 8-channel shapes; the breakdown kernel in every mode
against its plain version, and under a CUDA graph.

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("xs,ws", [
    ((21, 13, 64), (3, 3, 64, 64)),
    ((10, 7, 70), (3, 3, 70, 70)),
    ((13, 13, 8), (5, 5, 8, 8)),
], ids=lambda s: "x".join(map(str, s)))
def test_kernel2d_every_instance_and_split(cuda, xs, ws, dtype):
    """Each instance of the dtype, unsplit and split, matches the plain
    version (the vector path where the channels allow it, else the
    element path)."""
    rng = np.random.default_rng(9)
    x = torch.as_tensor(rng.normal(size=xs), dtype=dtype, device=cuda)
    W = torch.as_tensor(rng.normal(size=ws), dtype=dtype, device=cuda)
    ref = stencil.conv_blocked_plain(x, W)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    for inst, spec in stencil.INSTANCES2D.items():
        if spec[0] != dtype:
            continue
        for split in (1, 3, 64):
            p = stencil.plan2d(xs, ws, dtype, instance=inst,
                               split=min(split, stencil.plan2d(
                                   xs, ws, dtype, instance=inst).chunks))
            y = stencil.KERNEL(x, W, p)
            err = float((y - ref).abs().max() / ref.abs().max())
            assert err <= tol, (p, err)


def test_kernel2d_instance_table_matches_plan(cuda):
    table = stencil.KERNEL.instances()
    assert {i: t[0] for i, t in table.items()} == stencil.INSTANCES2D
    for i, (spec, threads, smem) in table.items():
        dtype, bm, bn, tm, tn, bk, stages = spec
        assert threads == (bm // tm) * (bn // tn)
        v = 16 // dtype.itemsize
        assert smem == dtype.itemsize * stages * (bm * (bk + v) + bk * bn)


@pytest.mark.parametrize("xs,ws", [
    ((97, 97, 128), (3, 3, 128, 128)),
    ((25, 25, 128), (3, 3, 128, 128)),
    ((385, 385, 8), (5, 5, 8, 8)),
], ids=["fine", "split", "narrow"])
def test_kernel2d_repeat_launches_are_bitwise_equal(cuda, xs, ws):
    rng = np.random.default_rng(10)
    x = torch.as_tensor(rng.normal(size=xs), dtype=torch.float32,
                        device=cuda)
    W = torch.as_tensor(rng.normal(size=ws), dtype=torch.float32,
                        device=cuda)
    first = stencil.conv_blocked(x, W)
    for _ in range(3):
        assert torch.equal(stencil.conv_blocked(x, W), first)
    assert stencil.plan2d(xs, ws, torch.float32).split > 1


@pytest.mark.parametrize("xs", [(25, 25, 128), (13, 13, 128)],
                         ids=lambda s: "x".join(map(str, s)))
def test_kernel2d_graph_replays_eager_chain(cuda, xs):
    rng = np.random.default_rng(12)
    C = xs[-1]
    x = torch.as_tensor(rng.normal(size=xs), dtype=torch.float32,
                        device=cuda)
    # entries of variance 1 / (9 C): 16 applies neither overflow nor vanish
    W = torch.as_tensor(rng.normal(size=(3, 3, C, C)) / (9 * C)**0.5,
                        dtype=torch.float32, device=cuda)
    assert stencil.plan2d(xs, W.shape, torch.float32).split > 1

    def chain(v):
        for _ in range(16):
            v = stencil.conv_blocked(v, W)
        return v

    eager = chain(x)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = stencil.KERNEL.launches
    with torch.cuda.graph(graph):
        out = chain(x)
    graph.replay()
    torch.cuda.synchronize()
    assert stencil.KERNEL.launches == before
    assert torch.isfinite(eager).all() and float(eager.abs().max()) > 0
    assert torch.equal(out, eager)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("xs,ws", [
    ((21, 13, 64), (3, 3, 64, 64)),
    ((40, 37, 8), (5, 5, 8, 8)),
], ids=lambda s: "x".join(map(str, s)))
def test_stencil2d_v1_matches_plain(cuda, xs, ws, dtype, tol):
    rng = np.random.default_rng(13)
    x = torch.as_tensor(rng.normal(size=xs), dtype=dtype, device=cuda)
    W = torch.as_tensor(rng.normal(size=ws), dtype=dtype, device=cuda)
    before = (stencil.KERNEL.launches, stencil.KERNEL.v1_launches)
    y = stencil.KERNEL.v1(x, W)
    torch.cuda.synchronize()
    assert (stencil.KERNEL.launches, stencil.KERNEL.v1_launches) == (
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


def refined_cavity(nelem):
    """A float64 cavity under kle-refine (float32 inner solves), on the
    card."""
    from pynama_tpu_torch.cases.cavity import CavityProblem

    cfg = {
        "domain": {"ngl": 3, "box-mesh": {"nelem": [nelem, nelem]}},
        "material-properties": {"rho": 1.0, "mu": 0.01},
        "time-solver": {"end-time": 0.5},
        "boundary-conditions": {"no-slip": {"up": [1.0, 0.0]}},
        "kle-refine": True,
    }
    return CavityProblem(cfg, dtype=torch.float64).setup()


def refined_solve(p, name, seed, rtol):
    """solve_ir of a seeded vorticity with the problem's mask ``name``;
    returns the result and the true float64 relative residual."""
    from pynama_tpu_torch.kle import solve_ir

    rng = np.random.default_rng(seed)
    w = p._blk(torch.as_tensor(rng.normal(size=p._gshape(1)),
                               dtype=torch.float64, device="cuda"))
    mask = getattr(p, name + "_b")
    res = solve_ir(p.system, p.system32, w, p._u_bc_b, mask,
                   getattr(p, name + "32_b"), rtol=rtol,
                   m_inv32=p._minv[name],
                   corrections=p._frees_boundary[name])
    b = p.system.rhs(w, p._u_bc_b, mask)
    r = b - p.system.apply_masked(res.x, mask)
    return res, float(torch.linalg.norm(r) / torch.linalg.norm(b))


@pytest.mark.parametrize("name", ["free_mask_fs", "free_mask"])
def test_solve_ir_kernels_match_plain(cuda, monkeypatch, name):
    """solve_ir on a 16x16 cavity through the kernels and with the plain
    version forced: both reach a true residual of 1e-10, so their
    velocities agree far below the float32 inner solves' rounding."""
    out = {}
    for mode in ("kernel", "plain"):
        if mode == "plain":
            monkeypatch.setattr(stencil, "conv_blocked",
                                stencil.conv_blocked_plain)
        before = stencil.KERNEL.launches
        res, rel = refined_solve(refined_cavity(16), name, 5, 1e-10)
        assert rel <= 1e-10, (mode, rel)
        out[mode] = res.x, stencil.KERNEL.launches - before
    (xk, lk), (xp, lp) = out["kernel"], out["plain"]
    assert lk > 0 and lp == 0
    err = float(torch.linalg.norm(xk - xp) / torch.linalg.norm(xp))
    assert err <= 1e-8, err


def test_solve_ir_inner_solve_launches_float32_only(cuda):
    """The inner multigrid-CG solve launches only float32 instances of
    stencil2d; the refined solve as a whole launches both."""
    from pynama_tpu_torch.solvers.cg import cg_solve

    p = refined_cavity(16)
    name = "free_mask_fs"
    m32 = p.free_mask_fs32_b
    rng = np.random.default_rng(6)
    r = torch.as_tensor(rng.normal(size=tuple(m32.shape)),
                        dtype=torch.float32, device="cuda") * m32
    stencil.KERNEL.reset_counts()
    d = cg_solve(lambda v: p.system32.apply_masked(
        v, m32, p._frees_boundary[name]), r, m_inv=p._minv[name],
        rtol=1e-4)
    torch.cuda.synchronize()
    assert d.iters > 0 and d.x.dtype == torch.float32
    dtypes = {key[2] for key in stencil.KERNEL.shapes}
    assert stencil.KERNEL.launches > 0 and dtypes == {"float32"}, dtypes
    stencil.KERNEL.reset_counts()
    res, rel = refined_solve(p, name, 7, 1e-8)
    assert rel <= 1e-8 and res.rounds >= 1
    by_dtype = {"float32": 0, "float64": 0}
    for key, n in stencil.KERNEL.shapes.items():
        by_dtype[key[2]] += n
    assert by_dtype["float32"] > 0 and by_dtype["float64"] > 0, by_dtype


def ws_cavity(nelem):
    """A float32 cavity with kle-ws-extrapolate on the card, stepping at
    a fixed dt of 5e-5 (every attempt accepted)."""
    from pynama_tpu_torch.cases.cavity import CavityProblem

    cfg = {
        "domain": {"ngl": 3, "box-mesh": {"nelem": [nelem, nelem]}},
        "material-properties": {"rho": 1.0, "mu": 0.01},
        "time-solver": {"end-time": 100.0, "dt0": 5e-5, "max-dt": 5e-5,
                        "atol": 1e12, "rtol": 1e12},
        "boundary-conditions": {"no-slip": {"up": [1.0, 0.0]}},
        "kle-rtol": 1e-5,
        "kle-ws-extrapolate": True,
    }
    return CavityProblem(cfg, dtype=torch.float32).setup()


def test_ws_cavity_kernels_match_plain(cuda, monkeypatch):
    """3 steps with ws (step 3 extrapolates) through the kernels and with
    the plain version forced."""
    out = {}
    for mode in ("kernel", "plain"):
        if mode == "plain":
            monkeypatch.setattr(stencil, "conv_blocked",
                                stencil.conv_blocked_plain)
        before = stencil.KERNEL.launches
        vort, t, n = ws_cavity(16).run(max_steps=3)
        assert n == 3 and torch.isfinite(vort).all()
        out[mode] = vort, stencil.KERNEL.launches - before
    (vk, lk), (vp, lp) = out["kernel"], out["plain"]
    assert lk > 0 and lp == 0
    err = float(torch.linalg.norm(vk - vp) / torch.linalg.norm(vp))
    assert err <= 1e-4, err


def ws_steps(p, make_step, steps=3):
    """``steps`` fixed-dt steps of ``make_step(rhs)`` with ws from the
    initial RHS; returns the final vorticity (blocked) and history."""
    from pynama_tpu_torch.solvers.rk import make_ws_state

    w, vel = p._blk(p.initial_vorticity()), p._blk(p.zero_vel())
    t = 0.0
    f1, vel = p.transport_rhs(t, w, vel)
    st = make_ws_state(vel, t)
    step = make_step(p.transport_rhs)
    for _ in range(steps):
        res = step(w, t, 5e-5, st, f1, 100.0)
        w, t, st, f1 = res.y, res.t, res.aux, res.f_new
    assert abs(t - steps * 5e-5) < 1e-15
    return w, st


def test_ws_scan_attempt_matches_stepper(cuda):
    """bench.py's step (the host stepper around the scan attempt) against
    make_bs5_stepper, both with ws, on the card: both controllers run
    the scan attempt and accept every attempt here, so the trajectories
    agree to the KLE tolerance."""
    from pynama_tpu_torch.solvers.rk import (make_attempt_host_stepper,
                                             make_bs5_scan_attempt,
                                             make_bs5_stepper)

    kw = dict(atol=1e12, rtol=1e12, ws_extrapolate=True)
    p = ws_cavity(16)
    w1, st1 = ws_steps(p, lambda rhs: make_bs5_stepper(rhs, **kw))
    w2, st2 = ws_steps(p, lambda rhs: make_attempt_host_stepper(
        make_bs5_scan_attempt(rhs, **kw)))
    err = float(torch.linalg.norm(w1 - w2) / torch.linalg.norm(w1))
    assert err <= 1e-4, err
    for a, b in zip(st1[0] + st1[1], st2[0] + st2[1]):
        e = float(torch.linalg.norm(a - b) / torch.linalg.norm(a))
        assert e <= 1e-4, e
    assert st1[2:] == st2[2:]


def test_ws_history_stays_on_card_in_state_dtype(cuda):
    """Every slot stack of the history lies on the card in the state's
    dtype, with one slot per derivative stage; the step times stay
    Python floats."""
    from pynama_tpu_torch.solvers.rk import BS5_STAGES, make_bs5_stepper

    p = ws_cavity(8)
    w, st = ws_steps(p, lambda rhs: make_bs5_stepper(
        rhs, atol=1e12, rtol=1e12, ws_extrapolate=True), steps=2)
    assert w.device.type == "cuda" and w.dtype == torch.float32
    H1, H2, t_prev, t_pp = st
    assert isinstance(t_prev, float) and isinstance(t_pp, float)
    assert len(H1) == len(H2) == 2  # the cavity's (vel_fs, vel) pair
    for h in H1 + H2:
        assert h.device.type == "cuda" and h.dtype == torch.float32
        assert h.shape == (BS5_STAGES - 1,) + p._bshape(p.dim)


# fill is a copy; highest: float32 sums in another order; default: against
# the plain version on TF32-rounded inputs, tensor-core sums in another order
BREAKDOWN_TOL = {"fill": 0.0, "highest": 1e-5, "default": 1e-4}


@pytest.mark.parametrize("xs,ws", [
    ((25, 37, 128), (3, 3, 128, 128)),   # 144x96 Q2: the fine K apply
    ((25, 37, 64), (3, 3, 64, 128)),     # its Rw
    ((7, 10, 128), (3, 3, 128, 128)),    # an MG level of it
    ((97, 145, 8), (5, 5, 8, 8)),        # its 8-channel patch layout
    ((13, 13, 8), (5, 5, 8, 8)),
], ids=lambda s: "x".join(map(str, s)))
def test_kernel2d_float64_ibm_shapes_match_plain(cuda, xs, ws):
    """The immersed-boundary path runs every KLE solve and V-cycle in
    float64: instance 2 at the non-square Re-40 grid's shapes and at the
    8-channel F-5 patch layouts."""
    rng = np.random.default_rng(9)
    x = torch.as_tensor(rng.normal(size=xs), dtype=torch.float64, device=cuda)
    W = torch.as_tensor(rng.normal(size=ws), dtype=torch.float64, device=cuda)
    before = stencil.KERNEL.launches
    y = stencil.conv_blocked(x, W)
    torch.cuda.synchronize()
    assert stencil.KERNEL.launches == before + 1
    assert stencil.KERNEL.plan(xs, ws, torch.float64).instance == 2
    ref = stencil.conv_blocked_plain(x, W)
    err = float((y - ref).abs().max() / ref.abs().max())
    assert err <= 1e-12, err


def ibm_case(nelem):
    """tests/test_ibm.py's ibm_config(nelem), float64, on the card."""
    from pynama_tpu_torch.cases.immersed import ImmersedBoundaryProblem

    cfg = {
        "material-properties": {"rho": 0.5, "mu": 0.01},
        "domain": {"ngl": 3, "box-mesh": {"nelem": [nelem, nelem],
                                          "lower": [-3, -3],
                                          "upper": [3, 3]}},
        "time-solver": {"start-time": 0, "end-time": 1.0, "dt0": 0.01},
        "boundary-conditions": {"constant": {"re": 20.0, "direction": 0,
                                             "longRef": "1"}},
        "bodies": [{"type": "circle", "vel": "static", "radius": 0.5,
                    "center": [0, 0]}],
        "kle-rtol": 1e-10,
    }
    return ImmersedBoundaryProblem(cfg).setup()


def test_ibm_kernels_match_plain(cuda, monkeypatch):
    """2 steps of the 12x12 IBM case through the kernels and with the
    plain version forced: the same steps, t within 1e-9, vorticity
    within 1e-8, the last cd within 1e-6; the slip at the body below
    1e-6 in both."""
    out = {}
    for mode in ("kernel", "plain"):
        if mode == "plain":
            monkeypatch.setattr(stencil, "conv_blocked",
                                stencil.conv_blocked_plain)
        before = stencil.KERNEL.launches
        p = ibm_case(12)
        vort, t, n = p.run(max_steps=2)
        assert p.vel.device.type == "cuda" and torch.isfinite(vort).all()
        X, Ub = p._body_state(t)
        nodes, weights = p.coupling.windows(X)
        slip = float((p.coupling.interp(p.vel, nodes, weights) - Ub)
                     .abs().max())
        assert slip < 1e-6, (mode, slip)
        out[mode] = p, vort, t, n, stencil.KERNEL.launches - before
    (pk, vk, tk, nk, lk), (pp, vp, tp, np_, lp) = out["kernel"], out["plain"]
    # the adaptive dt follows wlte, as wlte^(-1/5)
    assert lk > 0 and lp == 0 and nk == np_ == 2
    assert abs(tk - tp) <= 1e-9 * tp, (tk, tp)
    err = float(torch.linalg.norm(vk - vp) / torch.linalg.norm(vp))
    assert err <= 1e-8, err
    a, b = pk.cd_history[-1][0], pp.cd_history[-1][0]
    assert abs(a - b) <= 1e-6 * abs(b), (a, b)


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
