"""The port's immersed-boundary case under mixed-precision refinement
(kle-refine: float64 state and true float64 residuals, float32 multigrid
V-cycles through kle.solve_ir), against the reference on the CPU:
tests/test_ibm.py's 12x12 static cylinder at kle-rtol 1e-8, 2 steps in
both packages. Held equal: the accepted steps and t (1e-12 relative),
the inner CG iterations of every KLE solve (each solve's total over its
refinement rounds, recorded in the reference by an ordered callback
around kle.solve_ir), the vorticity (1e-8 relative) and the last cd
(1e-7 relative); refinement on and the inner system float32 in both.

The post-step's flux solve (ibm/coupling.py solve_correction) stays
float64 Jacobi-CG under refinement, as the reference's does.

The reference's run is ~60 s, almost all of it compiling; one run of each
package is shared by the module."""

import jax
import numpy as np
import pytest
import torch

import pynama_tpu.kle as ref_kle
from pynama_tpu.cases.immersed import ImmersedBoundaryProblem as RefProblem
from pynama_tpu_torch.cases.immersed import ImmersedBoundaryProblem
from tests.test_ibm import ibm_config

F32, F64 = torch.float32, torch.float64
STEPS = 2
RTOL = 1e-8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def refined_config():
    return {**ibm_config(12), "kle-refine": True, "kle-rtol": RTOL}


@pytest.fixture(scope="module")
def runs():
    """(reference problem, its inner CG iterations a solve in order, port
    problem, the port's flux solves' dtypes), each run for STEPS steps."""
    q = RefProblem(refined_config()).setup()
    iters, solve_ir = [], ref_kle.solve_ir

    def recording(*args, **kw):
        res = solve_ir(*args, **kw)
        jax.debug.callback(lambda i: iters.append(int(i)), res.iters,
                           ordered=True)
        return res

    mp = pytest.MonkeyPatch()
    mp.setattr(ref_kle, "solve_ir", recording)
    try:
        q.run(max_steps=STEPS)
    finally:
        mp.undo()
    p = ImmersedBoundaryProblem(refined_config(), dtype=F64,
                                device="cpu").setup()
    flux, correct = [], p.coupling.solve_correction

    def recorded(vel, *args, **kw):
        flux.append(vel.dtype)
        return correct(vel, *args, **kw)

    p.coupling.solve_correction = recorded
    p.run(max_steps=STEPS)
    return q, iters, p, flux


def rel(a, b):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_refine_is_on_with_a_float32_inner_system(runs):
    q, _, p, _ = runs
    assert q._refine and p._refine
    assert q.system32.diag_K.dtype == np.float32
    assert p.system32.diag_K.dtype == F32
    assert p.system32.K.A.dtype == p.system32.Rw.A.dtype == F32
    assert p.dtype == p.system.diag_K.dtype == F64


def test_refined_run_matches_reference_steps_and_times(runs):
    q, _, p, _ = runs
    assert len(p.t_history) == len(q.t_history) == STEPS
    np.testing.assert_allclose(p.t_history, q.t_history, rtol=1e-12)
    np.testing.assert_allclose(p.dt_history, q.dt_history, rtol=1e-12)


def test_refined_run_matches_reference_inner_iterations(runs):
    """Every KLE solve went through solve_ir in both packages (the
    post-step's too: a round count a solve, 0 where the warm start
    already met the tolerance) and took the same inner CG iterations."""
    q, iters, p, _ = runs
    assert len(p.ir_rounds) == len(p.cg_iters) == len(iters) > 0
    assert p.cg_iters == iters
    assert max(p.ir_rounds) >= 1


def test_refined_run_matches_reference_fields(runs):
    q, _, p, _ = runs
    assert rel(p.vort.numpy(), q.vort) <= 1e-8
    assert rel(p.vel.numpy(), q.vel) <= 1e-8


def test_refined_run_matches_reference_last_cd(runs):
    q, _, p, _ = runs
    a, b = p.cd_history[-1][0], q.cd_history[-1][0]
    assert abs(a - b) <= 1e-7 * abs(b), (a, b)
    assert rel(p.cd_raw_history, q.cd_raw_history) <= 1e-7


def test_flux_solve_stays_float64_jacobi_cg(runs):
    """The flux solves (1 initial + 2 a step) ran on float64 velocities,
    slip below tests/test_ibm.py's 1e-6."""
    _, _, p, flux = runs
    assert flux == [F64] * (1 + 2 * STEPS)
    assert len(p.coupling.cg_iters) == 1 + 2 * STEPS
    t = p.t_history[-1]
    X, Ub = p._body_state(t)
    nodes, weights = p.coupling.windows(X)
    slip = (p.coupling.interp(p.vel, nodes, weights) - Ub).abs().max()
    assert float(slip) < 1e-6

