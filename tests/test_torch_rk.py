"""The port's BS5(4) integrator (pynama_tpu_torch/solvers/rk.py).

Twins of the five tests of tests/test_rk.py on the port, then every
function of the module against the reference in float64 on a small
vector ODE whose aux (a pair of tensors) depends on y and on the
incoming aux, and whose derivative reads the incoming aux: a warm-start
guess that differs between the packages moves y. Each case compares y,
t, dt and every aux leaf (the ws slot histories included) within 1e-12
relative. Tolerances are 1e-4: wlte is a difference of two solutions
divided by the tolerance, so its last-bit differences between the
packages (XLA fuses axpys into FMAs) grow by |k| / |err|, and at a
1e-7 tolerance a step's dt_next already differs by 1e-11.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pynama_tpu.solvers import rk as ref
from pynama_tpu_torch.solvers import rk
from pynama_tpu_torch.solvers.rk import (BS5_A, BS5_B, BS5_BEMBED, BS5_C,
                                         BS5_STAGES, integrate,
                                         make_bs5_scan_attempt,
                                         make_bs5_stepper, make_ws_state,
                                         ws_aux_vel)

F64 = torch.float64
TOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def vec(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


# -- twins of tests/test_rk.py ---------------------------------------------
def test_order_conditions():
    b, c, A = BS5_B, BS5_C, BS5_A
    for name in ("BS5_A", "BS5_B", "BS5_BEMBED", "BS5_C"):
        np.testing.assert_array_equal(getattr(rk, name), getattr(ref, name))
    for k in range(5):
        np.testing.assert_allclose(np.sum(b * c**k), 1.0 / (k + 1), atol=1e-14)
    for k in range(4):
        np.testing.assert_allclose(np.sum(BS5_BEMBED * c**k), 1.0 / (k + 1),
                                   atol=1e-14)
    np.testing.assert_allclose(A.sum(axis=1), c, atol=1e-14)
    np.testing.assert_allclose(b @ A @ c, 1.0 / 6.0, atol=1e-14)
    np.testing.assert_allclose(b @ A @ A @ c, 1.0 / 24.0, atol=1e-14)
    np.testing.assert_allclose(b @ (c * (A @ c)), 1.0 / 8.0, atol=1e-14)
    np.testing.assert_allclose(b @ A @ (c * c), 1.0 / 12.0, atol=1e-14)


def test_fifth_order_convergence():
    """Fixed-dt accepted steps converge at order 5."""

    def rhs(t, y, aux):
        return -y + math.sin(3.0 * t) * torch.ones_like(y), aux

    def exact(t):
        c = 1.0 + 0.3
        return c * np.exp(-t) + (np.sin(3 * t) - 3 * np.cos(3 * t)) / 10.0

    errs = []
    for n in (2, 4):
        step = make_bs5_stepper(rhs, atol=1e10, rtol=1e10)
        y, t, dt = torch.ones(1, dtype=F64), 0.0, 1.0 / n
        f1, _ = rhs(t, y, None)
        aux = torch.zeros(1, dtype=F64)
        for _ in range(n):
            res = step(y, t, dt, aux, f1, 1.0)
            y, t, f1 = res.y, res.t, res.f_new
        errs.append(abs(float(y[0]) - exact(1.0)))
    order = np.log2(errs[0] / errs[1])
    assert order > 4.7, (errs, order)


def test_adaptive_integrate_accuracy_and_matchstep():
    def rhs(t, y, aux):
        return y * math.cos(t), aux  # y = exp(sin t)

    y, t, n = integrate(rhs, torch.ones(1, dtype=F64), 0.0, 2.5, dt0=0.5,
                        aux=torch.zeros(1, dtype=F64), atol=1e-9, rtol=1e-9)
    assert abs(t - 2.5) < 1e-12  # MATCHSTEP: exact final time
    np.testing.assert_allclose(float(y[0]), np.exp(np.sin(2.5)), rtol=1e-7)
    assert n < 100


def test_rejection_shrinks_dt():
    """A stiff start rejects and shrinks dt rather than blowing up."""

    def rhs(t, y, aux):
        return -50.0 * y, aux

    y, t, n = integrate(rhs, torch.ones(1, dtype=F64), 0.0, 1.0, dt0=1.0,
                        aux=torch.zeros(1, dtype=F64), atol=1e-6, rtol=1e-6)
    assert n > 10
    assert abs(float(y[0])) < 1e-4


def test_ws_extrapolation_scan_attempt_matches_plain():
    """ws_extrapolate slot bookkeeping never perturbs the y trajectory:
    on an rhs whose derivative ignores the incoming aux, the ws scan
    attempt gives bit-identical y5/wlte and tracks each stage's aux
    output in its slot."""

    def rhs(t, y, aux):
        return -0.7 * y + math.sin(t), y * 2.0

    plain = make_bs5_scan_attempt(rhs, atol=1e10, rtol=1e10)
    ws = make_bs5_scan_attempt(rhs, atol=1e10, rtol=1e10,
                               ws_extrapolate=True)
    y = vec(np.linspace(0.3, 1.0, 5))
    t, dt = 0.2, 0.05
    f1, aux0 = rhs(t, y, y)
    y5_p, f_p, w_p, _ = plain(y, t, dt, y, f1)
    st = make_ws_state(aux0, t)
    y5_w, f_w, w_w, st1 = ws(y, t, dt, st, f1)
    assert torch.equal(y5_p, y5_w) and torch.equal(f_p, f_w)
    assert torch.equal(w_p, w_w)
    H1, H2, t_prev, t_pp = st1
    assert t_prev == 0.2 and t_pp == 0.2
    assert H1.shape == (BS5_STAGES - 1,) + y.shape
    assert torch.equal(H2, st[0])
    y5_w2, _, _, st2 = ws(y5_w, t + dt, dt, st1, f_w)
    assert st2[2] == pytest.approx(0.25)
    assert torch.equal(st2[1], H1)
    assert torch.equal(ws_aux_vel(st2), st2[0][BS5_STAGES - 2])


# -- against the reference ---------------------------------------------------
def rhs_port(t, y, aux):
    a, b = aux
    f = -0.7 * y + math.sin(3.0 * t) + 0.05 * (a - b)
    return f, (2.0 * y + 0.1 * a, y * y - 0.2 * b)


def rhs_ref(t, y, aux):
    a, b = aux
    f = -0.7 * y + jnp.sin(3.0 * t) + 0.05 * (a - b)
    return f, (2.0 * y + 0.1 * a, y * y - 0.2 * b)


def leaves(x):
    if isinstance(x, (tuple, list)):
        return [v for part in x for v in leaves(part)]
    return [np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x,
                       dtype=np.float64)]


def leaves_t(x):
    if isinstance(x, tuple):
        return [v for part in x for v in leaves_t(part)]
    return [x] if isinstance(x, torch.Tensor) else []


def assert_close(port, reference, tol=TOL):
    lp, lr = leaves(port), leaves(reference)
    assert len(lp) == len(lr)
    for a, b in zip(lp, lr):
        assert a.shape == b.shape, (a.shape, b.shape)
        err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)
        assert err <= tol, err


def start(ws, seed=3):
    """Seeded y0, the initial RHS's f1 and aux in both packages (the aux
    as a ws history with ws on)."""
    rng = np.random.default_rng(seed)
    y0 = rng.normal(size=6)
    aux0 = (rng.normal(size=6), rng.normal(size=6))
    f1, aux = rhs_port(0.0, vec(y0), tuple(vec(a) for a in aux0))
    f1_r, aux_r = rhs_ref(jnp.asarray(0.0), jnp.asarray(y0),
                          tuple(jnp.asarray(a) for a in aux0))
    assert_close(f1, f1_r)
    if ws:
        aux, aux_r = make_ws_state(aux, 0.0), ref.make_ws_state(
            aux_r, jnp.asarray(0.0))
    return (vec(y0), f1, aux), (jnp.asarray(y0), f1_r, aux_r)


@pytest.mark.parametrize("ws", [False, True], ids=["plain", "ws"])
def test_stepper_matches_reference(ws):
    """make_bs5_stepper: a stiff first dt rejects, then three accepted
    steps (the third extrapolates with theta != 0)."""
    kw = dict(atol=1e-4, rtol=1e-4, ws_extrapolate=ws)
    step = make_bs5_stepper(rhs_port, **kw)
    step_r = jax.jit(ref.make_bs5_stepper(rhs_ref, **kw))
    (y, f1, aux), (y_r, f1_r, aux_r) = start(ws)
    t, dt, t_r, dt_r = 0.0, 0.8, jnp.asarray(0.0), jnp.asarray(0.8)
    attempts = []
    for _ in range(3):
        res = step(y, t, dt, aux, f1, 10.0)
        res_r = step_r(y_r, t_r, dt_r, aux_r, f1_r, jnp.asarray(10.0))
        y, t, dt, aux, f1 = res.y, res.t, res.dt_next, res.aux, res.f_new
        y_r, t_r, dt_r, aux_r, f1_r = (res_r.y, res_r.t, res_r.dt_next,
                                       res_r.aux, res_r.f_new)
        assert res.attempts == int(res_r.attempts)
        attempts.append(res.attempts)
        assert_close((y, f1, t, dt, aux), (y_r, f1_r, t_r, dt_r, aux_r))
    assert attempts[0] > 1 and attempts[1:] == [1, 1], attempts


def test_ws_history_after_reject_then_two_accepts():
    """The aliasing check: a rejected attempt hands the history back
    untouched, and after two accepted steps (H1, H2, t_prev, t_pp) are
    the reference's, with H2 the previous H1 and not H1's storage."""
    kw = dict(atol=1e-4, rtol=1e-4, ws_extrapolate=True)
    once = make_bs5_stepper(rhs_port, max_attempts=1, **kw)
    once_r = ref.make_bs5_stepper(rhs_ref, max_attempts=1, **kw)
    step = make_bs5_stepper(rhs_port, **kw)
    step_r = jax.jit(ref.make_bs5_stepper(rhs_ref, **kw))
    (y, f1, st), (y_r, f1_r, st_r) = start(True)
    kept = [h.clone() for h in leaves_t(st)]
    rej = once(y, 0.0, 0.8, st, f1, 10.0)
    rej_r = once_r(y_r, jnp.asarray(0.0), jnp.asarray(0.8), st_r, f1_r,
                   jnp.asarray(10.0))
    assert rej.wlte > 1.0 and float(rej_r.wlte) > 1.0
    assert rej.t == 0.0 and rej.aux is st and rej.y is y
    assert all(torch.equal(a, b) for a, b in zip(leaves_t(st), kept))
    assert_close((rej.dt_next, rej.aux), (rej_r.dt_next, rej_r.aux))
    t, dt, t_r, dt_r = 0.0, rej.dt_next, rej_r.t, rej_r.dt_next
    prev_H1 = None
    for _ in range(2):
        res = step(y, t, dt, st, f1, 10.0)
        res_r = step_r(y_r, t_r, dt_r, st_r, f1_r, jnp.asarray(10.0))
        assert res.wlte <= 1.0 and res.attempts == int(res_r.attempts)
        y, t, dt, st, f1 = res.y, res.t, res.dt_next, res.aux, res.f_new
        y_r, t_r, dt_r, st_r, f1_r = (res_r.y, res_r.t, res_r.dt_next,
                                      res_r.aux, res_r.f_new)
        assert_close((y, t, dt, st), (y_r, t_r, dt_r, st_r))
        H1, H2 = st[0], st[1]
        for h1, h2 in zip(H1, H2):
            assert h1.untyped_storage().data_ptr() != \
                h2.untyped_storage().data_ptr()
        if prev_H1 is not None:
            assert H2 is prev_H1
        prev_H1 = H1
    assert st[2] > st[3] == 0.0


@pytest.mark.parametrize("ws", [False, True], ids=["plain", "ws"])
def test_scan_attempt_matches_reference(ws):
    """One make_bs5_scan_attempt, then two more from its outputs."""
    att = make_bs5_scan_attempt(rhs_port, atol=1e-4, rtol=1e-4,
                                ws_extrapolate=ws)
    att_r = jax.jit(ref.make_bs5_scan_attempt(rhs_ref, atol=1e-4, rtol=1e-4,
                                              ws_extrapolate=ws))
    (y, f1, aux), (y_r, f1_r, aux_r) = start(ws, seed=4)
    t = 0.0
    for dt in (0.05, 0.07, 0.04):
        y, f1, w, aux = att(y, t, dt, aux, f1)
        y_r, f1_r, w_r, aux_r = att_r(y_r, jnp.asarray(t), jnp.asarray(dt),
                                      aux_r, f1_r)
        assert_close((y, f1, w, aux), (y_r, f1_r, w_r, aux_r))
        t += dt


@pytest.mark.parametrize("ws", [False, True], ids=["plain", "ws"])
def test_attempt_host_stepper_matches_reference(ws):
    kw = dict(atol=1e-4, rtol=1e-4, ws_extrapolate=ws)
    step = rk.make_attempt_host_stepper(make_bs5_scan_attempt(rhs_port, **kw))
    step_r = ref.make_attempt_host_stepper(jax.jit(
        ref.make_bs5_scan_attempt(rhs_ref, **kw)))
    (y, f1, aux), (y_r, f1_r, aux_r) = start(ws, seed=5)
    t, dt = 0.0, 0.8
    t_r, dt_r = t, dt
    for _ in range(3):
        res = step(y, t, dt, aux, f1, 10.0)
        res_r = step_r(y_r, t_r, dt_r, aux_r, f1_r, 10.0)
        y, t, dt, aux, f1 = res.y, res.t, res.dt_next, res.aux, res.f_new
        y_r, t_r, dt_r, aux_r, f1_r = (res_r.y, res_r.t, res_r.dt_next,
                                       res_r.aux, res_r.f_new)
        assert_close((y, f1, t, dt, aux), (y_r, f1_r, t_r, dt_r, aux_r))


def test_bs5_host_stepper_matches_reference():
    """make_bs5_host_stepper with rhs_port's aux pair (no ws: the
    reference's per-stage stepper has no ws option)."""
    step = rk.make_bs5_host_stepper(rhs_port, atol=1e-4, rtol=1e-4)
    step_r = ref.make_bs5_host_stepper(rhs_ref, atol=1e-4, rtol=1e-4)
    (y, f1, aux), (y_r, f1_r, aux_r) = start(False, seed=6)
    t, dt = 0.0, 0.8
    t_r, dt_r = t, dt
    for _ in range(3):
        res = step(y, t, dt, aux, f1, 1.5)
        res_r = step_r(y_r, t_r, dt_r, aux_r, f1_r, 1.5)
        y, t, dt, aux, f1 = res.y, res.t, res.dt_next, res.aux, res.f_new
        y_r, t_r, dt_r, aux_r, f1_r = (res_r.y, res_r.t, res_r.dt_next,
                                       res_r.aux, res_r.f_new)
        assert_close((y, f1, t, dt, aux), (y_r, f1_r, t_r, dt_r, aux_r))


@pytest.mark.parametrize("ws", [False, True], ids=["plain", "ws"])
@pytest.mark.parametrize("t_end,tol,n_acc", [
    (1.2, 1e-4, None),      # rejections inside the chunk
    (0.25, 1e10, 2),        # every attempt accepted; the third is past t_end
])
def test_chunk_controller_matches_reference(ws, t_end, tol, n_acc):
    """make_chunk_controller, k = 3, twice in a row: the accepted count,
    the last wlte and the state; an attempt past t_end is a no-op."""
    kw = dict(atol=tol, rtol=tol, ws_extrapolate=ws)
    chunk = rk.make_chunk_controller(make_bs5_scan_attempt(rhs_port, **kw), 3)
    chunk_r = jax.jit(ref.make_chunk_controller(
        ref.make_bs5_scan_attempt(rhs_ref, **kw), 3))
    (y, f1, aux), (y_r, f1_r, aux_r) = start(ws, seed=7)
    t, dt = 0.0, 0.15 if n_acc else 0.8
    t_r, dt_r = jnp.asarray(t), jnp.asarray(dt)
    counts = []
    for _ in range(2):
        y, t, dt, aux, f1, n, w = chunk(y, t, dt, aux, f1, t_end)
        y_r, t_r, dt_r, aux_r, f1_r, n_r, w_r = chunk_r(
            y_r, t_r, dt_r, aux_r, f1_r, jnp.asarray(t_end))
        assert n == int(n_r)
        counts.append(n)
        assert_close((y, f1, t, dt, w, aux), (y_r, f1_r, t_r, dt_r, w_r,
                                              aux_r))
    if n_acc is not None:
        # 0.15 + 0.10 reach t_end; the third attempt and the whole second
        # chunk are no-ops
        assert counts == [n_acc, 0] and t == t_end
    else:
        assert 0 < sum(counts) < 6, counts


def test_integrate_matches_reference():
    """integrate: the same accepted steps, times, dts and final y, and the
    same callback arguments."""
    rng = np.random.default_rng(8)
    y0, a0 = rng.normal(size=4), (rng.normal(size=4), rng.normal(size=4))
    log, log_r = [], []
    y, t, n = integrate(rhs_port, vec(y0), 0.0, 3.3, 0.4,
                        tuple(vec(a) for a in a0), atol=1e-4, rtol=1e-4,
                        callback=lambda *a: log.append(a))
    y_r, t_r, n_r = ref.integrate(rhs_ref, jnp.asarray(y0), 0.0, 3.3, 0.4,
                                  tuple(jnp.asarray(a) for a in a0),
                                  atol=1e-4, rtol=1e-4,
                                  callback=lambda *a: log_r.append(a))
    assert n == n_r == len(log) == len(log_r) and n > 3
    assert abs(t - 3.3) < 1e-12 and abs(t_r - 3.3) < 1e-12
    assert_close(y, y_r)
    for (k, tk, dtk, yk, auxk), (k_r, tk_r, dtk_r, yk_r, auxk_r) in zip(
            log, log_r):
        assert k == k_r
        assert_close((tk, dtk, yk, auxk), (tk_r, dtk_r, yk_r, auxk_r))


@pytest.mark.parametrize("which", ["attempt", "bs5"])
def test_host_steppers_raise_after_max_attempts(which):
    """Both host steppers raise RuntimeError after max_attempts
    rejections, as the reference's do (make_bs5_stepper instead hands
    the state back)."""
    def rhs(t, y, aux):
        return -50.0 * y, aux

    if which == "attempt":
        step = rk.make_attempt_host_stepper(
            make_bs5_scan_attempt(rhs, atol=1e-12, rtol=1e-12),
            max_attempts=2)
    else:
        step = rk.make_bs5_host_stepper(rhs, atol=1e-12, rtol=1e-12,
                                        max_attempts=2)
    y = torch.ones(3, dtype=F64)
    f1, aux = rhs(0.0, y, y)
    with pytest.raises(RuntimeError, match="max_attempts"):
        step(y, 0.0, 1.0, aux, f1, 10.0)
    res = make_bs5_stepper(rhs, atol=1e-12, rtol=1e-12, max_attempts=2)(
        y, 0.0, 1.0, aux, f1, 10.0)
    assert res.t == 0.0 and res.attempts == 2
    assert res.dt_next == pytest.approx(0.01)
