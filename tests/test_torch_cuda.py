"""The CUDA stencil kernels on the card: against their plain version in
every instance and K split, their first designs, their launch counts,
bitwise repeats and graph replays, and the 2D and 3D paths never taking
the plain version; the refined (kle-refine) solve through the kernels
against the plain version, its inner solves on the float32 instances;
the warm-start extrapolation (kle-ws-extrapolate) through the kernels
against the plain version, its scan attempt against its stepper, and
its history on the card; the immersed-boundary path through the kernels
against the plain version, and stencil2d's float64 instance at its
non-square and 8-channel shapes; a single-mask resume bit for bit, and
kle-solver: gmres against the CPU; the breakdown kernel of both designs
in every mode against its plain version and under a CUDA graph, its
full/highest tile-rows-8 launch against stencil2d bit for bit, its
instance table and bitwise TF32 repeats; a Gmsh cavity
(ElementOps, Schwarz) repeated bit for bit and against the CPU, and the
scatter of the multigrid's grid transfers repeated bit for bit; a
padded-hierarchy cavity through the kernels against the plain version,
and the padded jump's grid transfers on the card.

Marked ``cuda``: these skip where torch.cuda.is_available() is false and
run on a machine with an NVIDIA GPU and nvcc:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

(--noconftest: the suite's conftest configures JAX, which this file does
not use.)
"""

import itertools

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


def taylor_green8_config():
    """tests/test_cases.py's make_config((8, 8), 3, rho=0.5, mu=0.01,
    end=0.5, max_steps=10), written out: this file imports no JAX."""
    return {"name": "test", "material-properties": {"rho": 0.5, "mu": 0.01},
            "domain": {"ngl": 3, "box-mesh": {"nelem": [8, 8],
                                              "lower": [0, 0],
                                              "upper": [1, 1]}},
            "time-solver": {"start-time": 0.0, "end-time": 0.5,
                            "max-steps": 10}}


def test_resume_single_mask_is_bitwise_on_card(cuda, tmp_path):
    """A single-mask problem (Taylor-Green 8x8, float64) run 4 steps
    against 2 + checkpoint + resume 2 through the kernels: bit for bit
    (the checkpoint keeps every value of the state; the kernels are
    deterministic)."""
    from pynama_tpu_torch.cases.analytic import CustomFuncProblem

    cfg = taylor_green8_config()
    p1 = CustomFuncProblem(cfg, case="taylor-green").setup()
    w1, t1, n1 = p1.run(max_steps=4)
    ck = str(tmp_path / "ck.npz")
    p2 = CustomFuncProblem(cfg, case="taylor-green").setup()
    before = stencil.KERNEL.launches
    p2.run(max_steps=2, checkpoint_path=ck, checkpoint_every=2)
    w2, t2, n2 = p2.run(max_steps=4, resume_from=ck)
    assert stencil.KERNEL.launches > before
    assert (n1, t1) == (n2, t2) and w2.device.type == "cuda"
    assert torch.equal(w1, w2)


def test_gmres_kle_on_card_matches_cpu(cuda):
    """kle-solver: gmres on the card (Jacobi, 8x8 Taylor-Green, float64,
    a seeded vorticity) against the same solve on the CPU: the same
    iterations, velocities within 1e-10."""
    from pynama_tpu_torch.cases.analytic import CustomFuncProblem

    cfg = taylor_green8_config()
    cfg.update({"kle-solver": "gmres", "multigrid": False})
    out = []
    for dev in ("cpu", "cuda"):
        p = CustomFuncProblem(cfg, case="taylor-green", device=dev).setup()
        vort = torch.as_tensor(np.random.default_rng(3).normal(
            size=p._gshape(1)), device=dev)
        u = p.solve_kle(0.3, vort, rtol=1e-11, maxiter=3000)
        out.append((u.cpu(), p.cg_iters[-1]))
    (uc, ic), (ug, ig) = out
    assert ic == ig > 0
    assert float((ug - uc).abs().max() / uc.abs().max()) < 1e-10


@pytest.mark.parametrize("design", sb.DESIGNS)
@pytest.mark.parametrize("TR", sb.TILE_ROWS)
@pytest.mark.parametrize("shape", [(97, 97, 128), (21, 13, 32), (10, 7, 70),
                                   (40, 37, 8)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("mode,prec", list(itertools.product(
    sb.MODES, sb.PRECISIONS)), ids=lambda v: str(v))
def test_breakdown_matches_plain(cuda, mode, prec, shape, TR, design):
    rng = np.random.default_rng(2)
    C = shape[-1]
    x = torch.as_tensor(rng.normal(size=shape), dtype=torch.float32,
                        device=cuda)
    W = torch.as_tensor(rng.normal(size=(3, 3, C, C)), dtype=torch.float32,
                        device=cuda)
    before = stencil.BREAKDOWN.launches
    y = sb.make_breakdown(mode, prec, TR, design)(x, W)
    torch.cuda.synchronize()
    assert stencil.BREAKDOWN.launches == before + 1
    ref = sb.breakdown_plain(mode, prec, x.double(), W.double())
    err = float((y.double() - ref).abs().max() / ref.abs().max())
    assert err <= BREAKDOWN_TOL["fill" if mode == "fill" else prec], err


@pytest.mark.parametrize("design", sb.DESIGNS)
@pytest.mark.parametrize("mode,prec", [("full", "highest"),
                                       ("mm", "default"),
                                       ("full", "default")])
def test_breakdown_graph_replays_eager_chain(cuda, mode, prec, design):
    rng = np.random.default_rng(4)
    C = 128
    x = torch.as_tensor(rng.normal(size=(25, 25, C)), dtype=torch.float32,
                        device=cuda)
    # entries of variance 1 / (9 C): 64 applies neither overflow nor vanish
    W = torch.as_tensor(rng.normal(size=(3, 3, C, C)) / (3 * C**0.5),
                        dtype=torch.float32, device=cuda)
    apply = sb.make_breakdown(mode, prec, 8, design)

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


@pytest.mark.parametrize("shape", [(97, 97, 128), (25, 25, 128)],
                         ids=lambda s: "x".join(map(str, s)))
def test_breakdown_full_highest_tr8_is_conv_blocked(cuda, shape):
    rng = np.random.default_rng(5)
    C = shape[-1]
    x = torch.as_tensor(rng.normal(size=shape), dtype=torch.float32,
                        device=cuda)
    W = torch.as_tensor(rng.normal(size=(3, 3, C, C)), dtype=torch.float32,
                        device=cuda)
    y = sb.make_breakdown("full", "highest", 8)(x, W)
    assert torch.equal(y, stencil.conv_blocked(x, W))


def test_breakdown_instance_table_matches_python(cuda):
    table = sb.instances()
    assert {i: tile for i, (tile, _, _) in table.items()} == sb.INSTANCES
    for i, (tile, threads, smem) in table.items():
        if tile[0] == "highest":
            # a thread sums TM x TN
            assert threads == tile[2] * tile[3] // (tile[4] * tile[5])
        else:
            assert threads == 128 * tile[2] // tile[4]  # warpgroups
        assert 0 < smem <= 227 * 1024


@pytest.mark.parametrize("TR", sb.TILE_ROWS)
@pytest.mark.parametrize("shape", [(97, 97, 128), (25, 25, 128)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("mode", ("full", "mm"))
def test_breakdown_tf32_repeats_are_bitwise_equal(cuda, mode, shape, TR):
    rng = np.random.default_rng(6)
    C = shape[-1]
    x = torch.as_tensor(rng.normal(size=shape), dtype=torch.float32,
                        device=cuda)
    W = torch.as_tensor(rng.normal(size=(3, 3, C, C)), dtype=torch.float32,
                        device=cuda)
    # every shape and TR splits K: the split sums repeat too
    assert sb.breakdown_plan("default", TR, shape).split > 1
    ys = [sb.make_breakdown(mode, "default", TR)(x, W) for _ in range(4)]
    for y in ys[1:]:
        assert torch.equal(y, ys[0])


# ----------------------------------------------------------------------
# unstructured Gmsh meshes (ElementOps and Schwarz: no kernel of their
# own) and the scatters with colliding indices
# ----------------------------------------------------------------------
def test_gmsh_cavity_on_card_is_bitwise_repeatable(cuda, tmp_path):
    """An 8x8 distorted Gmsh cavity (float64, vertex-star Schwarz), 3
    steps twice on the card: bit for bit, with the same CG iterations
    (the ElementOps' scatter sums a fixed contributor table, never with
    atomics); and within 1e-8 of the same run on the CPU."""
    import chip_smoke
    from pynama_tpu_torch.cases.cavity import CavityProblem

    path = str(tmp_path / "c8.msh")
    pts, quads = chip_smoke.box_corner_mesh(8, 8, distort=0.15 / 8, seed=1)
    chip_smoke.write_msh22(path, pts, quads, 3)
    cfg = chip_smoke.gmsh_cavity_config(path, 8)
    runs = []
    for dev in ("cuda", "cuda", "cpu"):
        p = CavityProblem(cfg, device=dev).setup()
        runs.append((p.run(max_steps=3), p.cg_iters))
    ((w1, t1, n1), i1), ((w2, t2, n2), i2), ((w3, _, n3), _) = runs
    assert w1.device.type == "cuda" and n1 == n2 == n3 == 3
    assert torch.equal(w1, w2) and t1 == t2 and i1 == i2
    rel = float(torch.linalg.norm(w1.cpu() - w3) / torch.linalg.norm(w3))
    assert rel <= 1e-8, rel


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_grid_scatter_add_repeats_are_bitwise_equal(cuda, dtype):
    """ops/structured.py grid_scatter_add on the 384x384 cavity's fine
    node grid: every vertex shared by 4 cells, 50 repeats bit for bit
    (with index_add_ they were not: its atomics sum in any order)."""
    from pynama_tpu_torch.ops.structured import grid_scatter_add

    N, ne = 3, (384, 384)
    npts = tuple(n * (N - 1) + 1 for n in ne)
    rng = np.random.default_rng(1)
    vals = torch.as_tensor(rng.normal(size=(ne[0] * ne[1], N * N * 2)),
                           dtype=dtype, device=cuda)
    out = torch.zeros(npts[::-1] + (2,), dtype=dtype, device=cuda)
    first = grid_scatter_add(out, vals, N, ne, N - 1, (0, 0))
    for _ in range(49):
        assert torch.equal(grid_scatter_add(out, vals, N, ne, N - 1,
                                            (0, 0)), first)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mg_grid_transfers_repeat_bitwise(cuda, dtype):
    """The multigrid's grid-layout _prolong/_restrict pair (grid_scatter_add
    inside) at the 384x384 cavity's fine jump, 10 times: bit for bit
    (with index_add_ they were not)."""
    from pynama_tpu_torch.elements.spectral import SpectralElement
    from pynama_tpu_torch.mesh.structured import BoxMesh
    from pynama_tpu_torch.solvers.multigrid import MGPreconditioner

    mesh = BoxMesh(nelem=(384, 384), lower=(0, 0), upper=(1, 1), ngl=3)
    mg = MGPreconditioner(mesh, SpectralElement(3, 2), dtype=dtype,
                          device=cuda)
    lvl, nxt = mg.levels[0], mg.levels[1].mesh
    rng = np.random.default_rng(2)
    xc = torch.as_tensor(rng.normal(size=tuple(reversed(nxt.npts)) + (2,)),
                         dtype=dtype, device=cuda)
    rf = torch.as_tensor(
        rng.normal(size=tuple(reversed(mesh.npts)) + (2,)), dtype=dtype,
        device=cuda)
    p0, r0 = mg._prolong(lvl, nxt, xc), mg._restrict(lvl, nxt, rf)
    for _ in range(9):
        assert torch.equal(mg._prolong(lvl, nxt, xc), p0)
        assert torch.equal(mg._restrict(lvl, nxt, rf), r0)


def test_padded_cavity_kernels_match_plain(cuda, monkeypatch):
    """A 23x23 float32 cavity, whose multigrid takes a padded
    (fictitious-domain) jump (23 -> 12 on a 24x24 extension), 3 steps:
    through the kernels without ever reaching the plain version, then
    with the plain version forced; the vorticities within 1e-4 (phase
    6's bound for the 16x16 cavity)."""
    import chip_smoke
    from pynama_tpu_torch.cases.cavity import CavityProblem

    plain = stencil.conv_blocked_plain
    cfg = chip_smoke.cavity_config(23)
    monkeypatch.setattr(stencil, "conv_blocked_plain", refuse)
    before = stencil.KERNEL.launches
    p = CavityProblem(cfg, dtype=torch.float32).setup()
    assert p.mg.levels[0].ext_mesh.nelem == (24, 24)
    vk, tk, nk = p.run(max_steps=3)
    assert nk == 3 and torch.isfinite(vk).all()
    assert stencil.KERNEL.launches > before
    monkeypatch.setattr(stencil, "conv_blocked_plain", plain)
    monkeypatch.setattr(stencil, "conv_blocked", plain)
    before = stencil.KERNEL.launches
    vp, tp, np_ = CavityProblem(cfg, dtype=torch.float32).setup().run(
        max_steps=3)
    assert stencil.KERNEL.launches == before and np_ == nk and tp == tk
    rel = float(torch.linalg.norm(vk - vp) / torch.linalg.norm(vp))
    assert rel <= 1e-4, rel


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mg_padded_transfers_on_card(cuda, dtype):
    """The padded jump of the 383x383 cavity's hierarchy (383 -> 192 on
    a 384x384 extension): _prolong/_restrict 10 times bit for bit, and in
    float64 within 1e-13 of the same transfers on the CPU."""
    import dataclasses

    from pynama_tpu_torch.elements.spectral import SpectralElement
    from pynama_tpu_torch.mesh.structured import BoxMesh
    from pynama_tpu_torch.solvers.multigrid import MGPreconditioner

    mesh = BoxMesh(nelem=(383, 383), lower=(0, 0), upper=(1, 1), ngl=3)
    mg = MGPreconditioner(mesh, SpectralElement(3, 2), dtype=dtype,
                          device=cuda)
    lvl, nxt = mg.levels[0], mg.levels[1].mesh
    assert lvl.ext_mesh.nelem == (384, 384) and nxt.nelem == (192, 192)
    rng = np.random.default_rng(3)
    xc = torch.as_tensor(rng.normal(size=tuple(reversed(nxt.npts)) + (2,)),
                         dtype=dtype, device=cuda)
    rf = torch.as_tensor(
        rng.normal(size=tuple(reversed(mesh.npts)) + (2,)), dtype=dtype,
        device=cuda)
    p0, r0 = mg._prolong(lvl, nxt, xc), mg._restrict(lvl, nxt, rf)
    assert p0.shape == rf.shape and r0.shape == xc.shape
    for _ in range(9):
        assert torch.equal(mg._prolong(lvl, nxt, xc), p0)
        assert torch.equal(mg._restrict(lvl, nxt, rf), r0)
    if dtype == torch.float64:
        host = dataclasses.replace(lvl, interp_k=lvl.interp_k.cpu(),
                                   mult_inv=lvl.mult_inv.cpu())
        for card, cpu in ((p0, mg._prolong(host, nxt, xc.cpu())),
                          (r0, mg._restrict(host, nxt, rf.cpu()))):
            rel = float((card.cpu() - cpu).abs().max() / cpu.abs().max())
            assert rel <= 1e-13, rel
