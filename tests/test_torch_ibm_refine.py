"""The port's immersed-boundary case under mixed-precision refinement
(kle-refine: float64 state and true float64 residuals, float32 multigrid
V-cycles through kle.solve_ir), against the reference on the CPU: the
4.2%-blockage drag protocol's domain ([-6,12]x[-12,12],
pynama_tpu_torch/scripts/ibm_regression.py BIG_GEOM) cut to 12x16
elements, Re 40 at kle-rtol 1e-8, 2 steps in both packages. It is the
one IBM box of the tests with more element rows than columns, so the
blocked <-> grid converters, the window search and the multigrid
hierarchy (12x16 -> 6x8) meet ny > nx here.

Held: the grid (33, 25, k), the converters' round trip bitwise and the
levels' element counts equal to the reference's; the refined initial
post-step (KLE solve, velocity correction, curl) against the reference's
jitted _post_step_fn on the same inputs (velocity and vorticity 1e-8
relative, the flux q 1e-7); then the run's accepted steps and t (1e-12
relative), the inner CG iterations of every KLE solve (each solve's
total over its refinement rounds, recorded in the reference by an
ordered callback around kle.solve_ir), the vorticity and velocity (1e-8
relative) and the last cd (1e-7 relative); refinement on and the inner
system float32 in both.

The post-step's flux solve (ibm/coupling.py solve_correction) stays
float64 Jacobi-CG under refinement, as the reference's does.

The reference's setup and run are ~60 s, almost all of it compiling its
BS5 step; one reference problem and one run of each package are shared
by the module."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pynama_tpu.kle as ref_kle
from pynama_tpu.cases.immersed import ImmersedBoundaryProblem as RefProblem
from pynama_tpu_torch.cases.immersed import ImmersedBoundaryProblem
from pynama_tpu_torch.scripts import ibm_regression as R

F32, F64 = torch.float32, torch.float64
NELEM = (12, 16)
STEPS = 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def refined_config():
    return R.re40_config(**{**R.BIG_GEOM, "nelem": NELEM})


@pytest.fixture(scope="module")
def problems():
    """(reference problem, port problem), both set up, neither run."""
    return (RefProblem(refined_config()).setup(),
            ImmersedBoundaryProblem(refined_config(), dtype=F64,
                                    device="cpu").setup())


@pytest.fixture(scope="module")
def runs(problems):
    """(reference problem, its inner CG iterations a solve in order, port
    problem, the port's flux solves' dtypes), each run for STEPS steps:
    the reference's problems' one (its post-step function keeps no
    state) and a port problem of its own (the port's post-step logs its
    solves)."""
    q = problems[0]
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


def test_tall_layout_and_hierarchy(problems):
    q, p = problems
    assert tuple(p.mesh.nelem) == NELEM and NELEM[1] > NELEM[0]
    # the node grid, slowest axis (y) first: 2*16+1 rows of 2*12+1
    assert p._gshape(2) == (33, 25, 2) == q._gshape(2)
    x = torch.as_tensor(np.random.default_rng(24).normal(size=(33, 25, 2)))
    assert torch.equal(p._unblk(p._blk(x)), x)
    assert [tuple(lv.mesh.nelem) for lv in p.mg.levels] == \
        [tuple(lv.mesh.nelem) for lv in q.mg.levels] == [(12, 16), (6, 8)]


def test_initial_post_step_matches_reference(problems):
    """run()'s initial condition: the post-step from zero vorticity and
    velocity at t = 0, in each package's own layout."""
    q, p = problems
    assert p._refine and q._refine
    Xb, Ub = p._body_state(p.t_start)
    vort, vel, qf = p._post_step(p.t_start, p._blk(p.initial_vorticity()),
                                 p._blk(p.zero_vel()), Xb, Ub)
    rv, rvel, rq = q._post_step_fn()(
        jnp.asarray(q.t_start, dtype=q.dtype), q.initial_vorticity(),
        q.zero_vel(), jnp.asarray(q.body.coords_at(0.0), dtype=q.dtype),
        jnp.asarray(q.body.velocity_at(0.0), dtype=q.dtype))
    assert rel(p._unblk(vel).numpy(), rvel) <= 1e-8
    assert rel(p._unblk(vort).numpy(), rv) <= 1e-8
    assert rel(qf.numpy(), rq) <= 1e-7


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
    # the initial post-step and RHS, then a step's 7 stage RHS, its
    # post-step, the re-evaluated RHS and the force floor: 2 + 10 a step
    assert len(p.ir_rounds) == len(p.cg_iters) == len(iters) == \
        2 + 10 * STEPS
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

