"""run_staged (parallel/sharded_problem.py), the production stepping: a
host dt controller around one BS5 attempt, or around chunks of
attempts (``ts-chunk``), with the warm-start history under
``kle-ws-extrapolate``; the twins of tests/test_sharded.py's
test_run_staged_attempt_matches_single and
test_run_staged_chunked_matches_per_attempt, Taylor-Green 4x8 on 4 gloo
ranks, Jacobi-CG. The first against the single-device run through the
same attempt and host controller, the port's and the reference's; the
second, as the reference test does, chunked against per-attempt
stepping on the ranks. One spawn, started before the single-device
runs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pynama_tpu.cases.analytic import CustomFuncProblem as RefCustomFunc
from pynama_tpu.solvers.rk import (make_attempt_host_stepper,
                                   make_bs5_scan_attempt)
from pynama_tpu_torch.parallel import launch
from tests import torch_dist_cases as cases

DEADLINE = 600.0
STEPS = 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ref_staged(cfg):
    """The reference test's single-device side: its jitted scan attempt
    and host stepper, 8 steps."""
    p = RefCustomFunc(cfg, case="taylor-green").setup()

    def rhs_s(t, w, aux):
        return p.transport_rhs(t, w, aux)

    step = make_attempt_host_stepper(jax.jit(make_bs5_scan_attempt(
        rhs_s, atol=p.ts_atol, rtol=p.ts_rtol, wlte_norm=p._wlte_norm())))
    w, vel = p._blk(p.initial_vorticity()), p._blk(p.zero_vel())
    t = jnp.asarray(p.t_start, p.dtype)
    dt = jnp.asarray(p.dt0, p.dtype)
    t_end = jnp.asarray(p.t_end, p.dtype)
    f1, vel = rhs_s(t, w, vel)
    n = 0
    while float(t) < float(t_end) - 1e-14 and n < STEPS:
        res = step(w, t, dt, vel, f1, t_end)
        w, t, dt, vel, f1 = res.y, res.t, res.dt_next, res.aux, res.f_new
        n += 1
    return np.asarray(p._unblk(w)).reshape(-1), float(t), n


@pytest.fixture(scope="module")
def runs():
    cfg = cases.tg_config(STEPS)
    jobs = []
    for ws in (False, True):
        extra = {"kle-ws-extrapolate": True} if ws else {}
        for chunk in (1, 3):
            more = {"ts-chunk": chunk} if chunk > 1 else {}
            jobs.append(((ws, chunk), "sharded_run",
                         ("taylor-green", cases.tg_config(STEPS, **extra,
                                                          **more),
                          4, STEPS, True)))
    four = launch.start(cases.run_jobs, 4, args=(jobs,))
    out = {"port": cases.single_staged(cfg, STEPS), "ref": ref_staged(cfg)}
    out.update(four.join(DEADLINE)[0])
    return out


def test_run_staged_attempt_matches_single(runs):
    """The distributed attempts and the single-device ones make the same
    accept/dt decisions (the same tensordot stage combines, real-dof
    wlte norms)."""
    w, t, n = runs[(False, 1)]
    for key in ("port", "ref"):
        w_ref, t_ref, n_ref = runs[key]
        assert n == n_ref
        assert abs(t - t_ref) < 1e-12
        assert np.linalg.norm(w - w_ref) / np.linalg.norm(w_ref) < 1e-10, key


@pytest.mark.parametrize("ws", [False, True])
def test_run_staged_chunked_matches_per_attempt(runs, ws):
    """ts-chunk=3 (the controller between the attempts of a chunk)
    against per-attempt stepping: the same trajectory, step count and
    final time; ws adds the per-slot warm-start history."""
    w1, t1, n1 = runs[(ws, 1)]
    w2, t2, n2 = runs[(ws, 3)]
    assert n2 == n1
    assert abs(t2 - t1) < 1e-12
    assert np.linalg.norm(w1 - w2) / max(np.linalg.norm(w1), 1e-30) < 1e-10
