"""The port's immersed-boundary cases (cases/immersed.py) on the CPU,
static body: the twin of tests/test_ibm.py::test_static_cylinder_short_run
at its config, and a 2-step float64 run of the port against the
reference's (t and the accepted dts to 1e-12, every KLE solve's CG
iterations equal, vorticity and velocity to 1e-8, the force histories
to 1e-7). tests/test_torch_ibm_dynamic.py does the same for the moving
body.

The reference's time is tracing and compiling its jitted step and
post-step (~45 s at 12x12); one run of each package is shared by the
module."""

import jax
import numpy as np
import pytest
import torch

from pynama_tpu.cases import immersed as ref_immersed
from pynama_tpu_torch.cases import immersed
from tests.test_ibm import ibm_config

F64 = torch.float64
# the cross-package run: 12x12 Q2 on [-3, 3]^2, kle-rtol 1e-10, 2 steps
SMALL = 12
STEPS = 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def config(kind, nelem):
    cfg = ibm_config(nelem)
    if kind == "dynamic":
        cfg["bodies"][0]["vel"] = "dynamic"
    return cfg


CLASSES = {
    "static": (ref_immersed.ImmersedBoundaryProblem,
               immersed.ImmersedBoundaryProblem),
    "dynamic": (ref_immersed.ImmersedBoundaryDynamicProblem,
                immersed.ImmersedBoundaryDynamicProblem),
}


def run_both(kind, nelem=SMALL, steps=STEPS):
    """The reference's and the port's run of one config: (reference
    problem, its KLE CG iterations in order, port problem). The
    reference's iterations are recorded by an ordered callback from
    inside its jitted step and post-step."""
    ref_cls, port_cls = CLASSES[kind]
    q = ref_cls(config(kind, nelem)).setup()
    iters, solve = [], q.system.solve

    def recording(*args, **kw):
        res = solve(*args, **kw)
        jax.debug.callback(lambda i: iters.append(int(i)), res.iters,
                           ordered=True)
        return res

    q.system.solve = recording
    q.run(max_steps=steps)
    p = port_cls(config(kind, nelem), dtype=F64, device="cpu").setup()
    p.run(max_steps=steps)
    return q, iters, p


def rel(a, b):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def check_times(q, p):
    assert len(p.t_history) == len(q.t_history) == STEPS
    np.testing.assert_allclose(p.t_history, q.t_history, rtol=1e-12)
    np.testing.assert_allclose(p.dt_history, q.dt_history, rtol=1e-12)


def check_fields(q, p):
    assert rel(p.vort.numpy(), q.vort) <= 1e-8
    assert rel(p.vel.numpy(), q.vel) <= 1e-8


def check_forces(q, p):
    for name in ("cd_history", "cl_history", "cd_raw_history",
                 "cl_raw_history"):
        got, want = getattr(p, name), getattr(q, name)
        assert len(got) == len(want) == STEPS, name
        assert rel(got, want) <= 1e-7, (name, got, want)


def slip(p, t):
    """max |H u - U_body| of the final corrected velocity at t."""
    X = torch.as_tensor(p.body.coords_at(t), dtype=p.dtype)
    Ub = torch.as_tensor(p.body.velocity_at(t), dtype=p.dtype)
    nodes, weights = p.coupling.windows(X)
    return float((p.coupling.interp(p.vel, nodes, weights) - Ub).abs().max())


# -- twin of tests/test_ibm.py --------------------------------------------
def test_static_cylinder_short_run():
    p = immersed.ImmersedBoundaryProblem(ibm_config(), device="cpu").setup()
    vort, t, n = p.run(max_steps=3)
    assert torch.isfinite(vort).all()
    # no-slip enforced on the body at the end of each step
    assert slip(p, t) < 1e-6
    # positive drag on a cylinder in a free stream
    assert p.cd_history and p.cd_history[-1][0] > 0


# -- against the reference --------------------------------------------------
@pytest.fixture(scope="module")
def static_runs():
    return run_both("static")


def test_static_run_matches_reference_times(static_runs):
    q, _, p = static_runs
    check_times(q, p)


def test_static_run_matches_reference_cg_iterations(static_runs):
    q, iters, p = static_runs
    assert p.cg_iters == iters
    assert len(p.coupling.cg_iters) == 1 + 2 * STEPS


def test_static_run_matches_reference_fields(static_runs):
    check_fields(*static_runs[::2])


def test_static_run_matches_reference_forces(static_runs):
    check_forces(*static_runs[::2])
