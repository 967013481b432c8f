"""kle-ws-extrapolate on the 8x8 dual-mask cavity (the (vel_fs, vel)
pair aux, the hardest structure) in float64: the port's run with it
against its own run without it (the twin of
tests/test_cases.py::test_ws_extrapolation_matches_plain_run), the
velocity that run() hands its callback, and a fixed-dt run against the
reference's (final vorticity and the CG iterations of every KLE solve,
in order).

One run of each kind, shared by the module. The reference's time is
tracing and compiling its BS5 step; with Jacobi-CG solves (as in
tests/test_torch_cavity_setup.py) its program stays small."""

import jax
import numpy as np
import pytest
import torch

from pynama_tpu.cases.cavity import CavityProblem as RefCavity
from pynama_tpu_torch.cases.cavity import CavityProblem
from tests.test_cases import make_config
from tests.test_torch_cavity_setup import fixed_dt_config

F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ws_config(ws):
    """tests/test_cases.py::test_ws_extrapolation_matches_plain_run's
    config: 8 adaptive steps to t = 0.3, rejections included."""
    cfg = make_config((8, 8), 3, rho=1.0, mu=0.1, end=0.3, max_steps=8)
    cfg["boundary-conditions"] = {"no-slip": {"up": [1.0, 0.0]}}
    cfg["kle-ws-extrapolate"] = ws
    return cfg


@pytest.fixture(scope="module")
def port_runs():
    """{ws: (problem, final vorticity, t, steps, callback log)}."""
    out = {}
    for ws in (False, True):
        p = CavityProblem(ws_config(ws), dtype=F64, device="cpu").setup()
        log = []
        vort, t, n = p.run(callback=lambda *a: log.append(a))
        out[ws] = p, vort, t, n, log
    return out


# 4 steps at dt 0.1, below the 8x8 cavity's explicit limit: steps 3 and
# 4 extrapolate (theta = 1)
PARITY_CFG = {**fixed_dt_config(8, 0.1), "kle-ws-extrapolate": True}
PARITY_STEPS = 4


@pytest.fixture(scope="module")
def reference_run():
    """The reference's fixed-dt ws run, every KLE solve's CG iteration
    count recorded in order by a callback from inside its jitted step."""
    q = RefCavity(PARITY_CFG).setup()
    iters, solve = [], q.system.solve

    def recording(*args, **kw):
        res = solve(*args, **kw)
        jax.debug.callback(lambda i: iters.append(int(i)), res.iters,
                           ordered=True)
        return res

    q.system.solve = recording
    vort, t, n = q.run(max_steps=PARITY_STEPS)
    return np.asarray(vort), t, n, iters


def test_ws_extrapolation_matches_plain_run(port_runs):
    """ws changes only the warm starts: the same accepted steps and the
    same final state to solver tolerance."""
    _, v_off, t_off, n_off, _ = port_runs[False]
    _, v_on, t_on, n_on, _ = port_runs[True]
    assert n_on == n_off and t_on == t_off
    rel = float(torch.linalg.norm(v_on - v_off) / torch.linalg.norm(v_off))
    assert rel < 1e-6, rel


def test_ws_run_matches_reference(reference_run):
    p = CavityProblem(PARITY_CFG, dtype=F64, device="cpu").setup()
    vort, t, n = p.run(max_steps=PARITY_STEPS)
    vort_r, t_r, n_r, iters_r = reference_run
    assert n == n_r == PARITY_STEPS and abs(t - t_r) <= 1e-12 * t_r
    err = np.linalg.norm(vort.numpy() - vort_r) / np.linalg.norm(vort_r)
    assert err < 1e-8, err
    assert p.cg_iters == iters_r


def test_callback_gets_the_latest_final_stage_velocity(port_runs):
    """run() hands its callback ws_aux_vel's velocity: the last stage's
    final-mask solve, at the step's new vorticity and time (FSAL: the
    last stage evaluates the accepted state), not an older slot's nor
    the history's H2, which lie a stage or a step behind."""
    p, _, _, n, log = port_runs[True]
    assert len(log) == n
    for k, t, dt, vort, vel in log:
        assert vel.shape == p._gshape(p.dim)
        exact = p.solve_kle(t, vort)
        rel = float(torch.linalg.norm(vel - exact) / torch.linalg.norm(exact))
        assert rel < 1e-8, (k, rel)
