"""Adaptive explicit Runge-Kutta time integration (Bogacki-Shampine 5(4)).

Port of pynama_tpu/solvers/rk.py. The 8-stage FSAL pair and the
controller (PETSc TSAdaptBasic: weighted 2-norm local truncation error,
accept iff wlte <= 1, dt *= clip(0.9 wlte^(-1/5), 0.1, 10)) are
unchanged; the reference's ``lax.while_loop`` and ``lax.scan`` loops are
Python loops that read wlte on the host once per attempt. Step times t
and dt are Python floats (float64) everywhere in this module.

The RHS signature is ``rhs(t, y, aux) -> (f, aux)``: ``aux`` threads
solver state (the KLE warm starts) through stages and steps. An aux is a
tensor or a tuple of auxes (the cavity carries a (vel_fs, vel) pair);
``aux_map`` maps a function over its tensors.
"""

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

# Bogacki & Shampine RK5(4)8 pair (PETSc '5bs'); FSAL: b == A[7].
BS5_A = np.array(
    [
        [0, 0, 0, 0, 0, 0, 0, 0],
        [1 / 6, 0, 0, 0, 0, 0, 0, 0],
        [2 / 27, 4 / 27, 0, 0, 0, 0, 0, 0],
        [183 / 1372, -162 / 343, 1053 / 1372, 0, 0, 0, 0, 0],
        [68 / 297, -4 / 11, 42 / 143, 1960 / 3861, 0, 0, 0, 0],
        [597 / 22528, 81 / 352, 63099 / 585728, 58653 / 366080, 4617 / 20480, 0, 0, 0],
        [174197 / 959244, -30942 / 79937, 8152137 / 19744439, 666106 / 1039181,
         -29421 / 29068, 482048 / 414219, 0, 0],
        [587 / 8064, 0, 4440339 / 15491840, 24353 / 124800, 387 / 44800,
         2152 / 5985, 7267 / 94080, 0],
    ]
)
BS5_B = BS5_A[7].copy()
BS5_BEMBED = np.array(
    [2479 / 34992, 0, 123 / 416, 612941 / 3411720, 43 / 1440, 2272 / 6561,
     79937 / 1113912, 3293 / 556956]
)
BS5_C = BS5_A.sum(axis=1)
BS5_STAGES = 8
BS5_ORDER = 5


class StepResult(NamedTuple):
    y: torch.Tensor
    t: float
    dt_next: float
    aux: object
    f_new: torch.Tensor     # FSAL derivative at (t, y)
    wlte: float
    attempts: int


def aux_map(fn, *auxes):
    """``fn`` over the tensors of one or more auxes of the same structure
    (a tensor, None, or a tuple of auxes); None maps to None."""
    a = auxes[0]
    if isinstance(a, tuple):
        return tuple(aux_map(fn, *parts) for parts in zip(*auxes))
    return None if a is None else fn(*auxes)


# ----------------------------------------------------------------------
# cross-step per-stage-slot warm-start extrapolation
# ----------------------------------------------------------------------
def make_ws_state(aux, t0):
    """Initial slot-history aux for ws_extrapolate steppers.

    ``aux`` must already have its steady structure (call the RHS once
    first: dual-mask problems upgrade a bare velocity into a (vel_fs,
    vel) pair on the first solve). Returns (H1, H2, t_prev, t_prevprev):
    H1/H2 stack one aux per derivative stage slot (BS5_STAGES-1 slots,
    broadcast views here: no attempt writes into them); equal step times
    disable the extrapolation until two real steps have been accepted.
    """
    H = aux_map(lambda a: a.unsqueeze(0).expand(
        (BS5_STAGES - 1,) + tuple(a.shape)), aux)
    return (H, H, float(t0), float(t0))


def ws_aux_vel(aux_ws):
    """Latest final-stage aux from a ws_extrapolate history (slot -1)."""
    return aux_map(lambda h: h[BS5_STAGES - 2], aux_ws[0])


def _ws_theta(t, t_prev, t_prevprev):
    """Extrapolation weight (t - t_prev)/(t_prev - t_prevprev), 0 cold.

    Linear-in-time extrapolation of each stage slot's solution under the
    adaptive controller's varying dt, the plain previous-slot warm start
    while fewer than two steps of history exist. A Python float (the
    float64 quotient of the float64 step times), rounded to the state's
    dtype where it multiplies a tensor; the reference forms it in the
    state's dtype from the rounded times, so float32 runs differ in
    theta's last bits.
    """
    d = t_prev - t_prevprev
    return 0.0 if d == 0 else (t - t_prev) / d


def _ws_guess(H1, H2, slot, theta):
    """a + theta*(a - b) of each aux tensor at a stage slot."""
    return aux_map(lambda a, b: a[slot] + theta * (a[slot] - b[slot]),
                   H1, H2)


def _ws_store(H1, slot, aux_out):
    """Write a stage's aux into its slot of the attempt's own H1 buffer
    (``_ws_open``), in place."""
    aux_map(lambda h, v: h[slot].copy_(v), H1, aux_out)
    return H1


def _ws_open(aux, t):
    """A new H1 buffer for one attempt (its 7 stages write every slot)
    and the attempt's theta. The incoming history is only read: a
    rejected attempt hands it back unchanged, and an accepted one keeps
    its H1 as the new H2. Stage i reads slot i-1 of the incoming H1,
    which the reference's in-attempt H1 still holds at that stage."""
    H1_in, _, t_prev, t_pp = aux
    return aux_map(torch.empty_like, H1_in), _ws_theta(t, t_prev, t_pp)


def _ws_close(aux, H1, t):
    """The accepted attempt's history: (H1_new, H1_in, t, t_prev)."""
    return (H1, aux[0], t, aux[2])


def _wlte_norm(err, y_old, y_new, atol, rtol):
    w = atol + rtol * torch.maximum(torch.abs(y_old), torch.abs(y_new))
    e = err / w
    return torch.sqrt(torch.mean(e * e))


def _factor(wlte, safety, min_factor, max_factor):
    return float(np.clip(safety * max(wlte, 1e-30) ** (-1.0 / BS5_ORDER),
                         min_factor, max_factor))


def make_bs5_stepper(
    rhs: Callable,
    atol: float = 1e-4,
    rtol: float = 1e-4,
    safety: float = 0.9,
    min_factor: float = 0.1,
    max_factor: float = 10.0,
    max_attempts: int = 12,
    wlte_norm: Callable = _wlte_norm,
    max_dt: Optional[float] = None,
    ws_extrapolate: bool = False,
):
    """Build ``step(y, t, dt, aux, f1, t_end) -> StepResult``.

    One accepted adaptive step; rejected attempts loop inside (after
    ``max_attempts`` rejections the state comes back unchanged with the
    shrunken dt, as the reference's while_loop leaves it). ``f1`` is the
    FSAL derivative at (t, y). dt is clamped so t never overshoots t_end;
    max_dt caps the controller's proposals.

    ws_extrapolate: aux is the make_ws_state slot history and each
    stage's warm start is the linear-in-time extrapolation of ITS OWN
    slot's last two accepted solutions instead of the within-step chain.

    Each attempt is make_bs5_scan_attempt's: its tensordot stage
    combines differ from the reference stepper's chained axpys in
    rounding only.
    """
    attempt = make_bs5_scan_attempt(rhs, atol=atol, rtol=rtol,
                                    wlte_norm=wlte_norm,
                                    ws_extrapolate=ws_extrapolate)

    def step(y, t, dt, aux, f1, t_end):
        t, dt = float(t), float(dt)
        if max_dt is not None:
            dt = min(dt, max_dt)
        dt = min(dt, float(t_end) - t)
        wlte = float("inf")
        for k in range(1, max_attempts + 1):
            y5, f_new, wlte_t, aux1 = attempt(y, t, dt, aux, f1)
            wlte = float(wlte_t)
            factor = _factor(wlte, safety, min_factor, max_factor)
            if wlte <= 1.0:
                return StepResult(y=y5, t=t + dt, dt_next=dt * factor,
                                  aux=aux1, f_new=f_new, wlte=wlte,
                                  attempts=k)
            dt = dt * min(factor, 1.0)
        return StepResult(y=y, t=t, dt_next=dt, aux=aux, f_new=f1,
                          wlte=wlte, attempts=max_attempts)

    return step


def make_bs5_scan_attempt(
    rhs: Callable,
    atol: float = 1e-4,
    rtol: float = 1e-4,
    wlte_norm: Callable = _wlte_norm,
    ws_extrapolate: bool = False,
):
    """One BS5(4) attempt as one function.

    ``attempt(y, t, dt, aux, f1) -> (y5, f_new, wlte, aux_new)``: the 7
    derivative stages fill a stacked ``ks`` buffer of shape
    (BS5_STAGES, *y.shape); each stage input, y5 and the error are
    ``torch.tensordot`` of a tableau row (in y's dtype) with that buffer,
    the reference's numerics (they differ from the reference
    make_bs5_stepper's chained axpys in rounding only). wlte comes back
    as a 0-d tensor, unread.

    ws_extrapolate: aux is the make_ws_state slot history; each stage
    warm-starts from the linear-in-time extrapolation of its OWN slot
    across the last two accepted steps; a rejected attempt leaves the
    incoming history untouched.
    """
    tableau = {}

    def rows(y):
        key = (y.dtype, y.device)
        if key not in tableau:  # one host-to-device copy per dtype/device
            tableau[key] = [torch.as_tensor(m, dtype=y.dtype, device=y.device)
                            for m in (BS5_A, BS5_B, BS5_B - BS5_BEMBED)]
        return tableau[key]

    def attempt(y, t, dt, aux, f1):
        A, B, D = rows(y)
        ks = torch.zeros((BS5_STAGES,) + tuple(y.shape), dtype=y.dtype,
                         device=y.device)
        ks[0] = f1
        aux_c = aux
        if ws_extrapolate:
            H1, theta = _ws_open(aux, t)
        for i in range(1, BS5_STAGES):
            yi = y + dt * torch.tensordot(A[i], ks, dims=1)
            ti = t + float(BS5_C[i]) * dt
            if ws_extrapolate:
                fi, aux_out = rhs(ti, yi, _ws_guess(aux[0], aux[1], i - 1,
                                                   theta))
                _ws_store(H1, i - 1, aux_out)
            else:
                fi, aux_c = rhs(ti, yi, aux_c)
            ks[i] = fi
        if ws_extrapolate:
            aux_c = _ws_close(aux, H1, t)
        y5 = y + dt * torch.tensordot(B, ks, dims=1)
        err = dt * torch.tensordot(D, ks, dims=1)
        wlte = wlte_norm(err, y, y5, atol, rtol)
        return y5, ks[BS5_STAGES - 1], wlte, aux_c

    return attempt


def make_chunk_controller(
    attempt_fn: Callable,
    k: int,
    safety: float = 0.9,
    min_factor: float = 0.1,
    max_factor: float = 10.0,
    max_dt: Optional[float] = None,
):
    """k adaptive BS5 attempts (accept/reject + dt update) per call.

    ``chunk(y, t, dt, aux, f1, t_end) -> (y, t, dt, aux, f1, n_acc,
    wlte_last)``: the controller of make_attempt_host_stepper, k attempts
    with no rejection limit. t and dt are Python floats inside and out,
    and each attempt reads its wlte on the host (the reference keeps
    them on the device, one program for k attempts). Attempts past t_end
    are no-ops: dt clamps to 0, nothing is counted or kept, and dt stays.
    n_acc is an int and wlte_last the last attempt's wlte as a float.
    """
    def chunk(y, t, dt, aux, f1, t_end):
        t, dt, t_end = float(t), float(dt), float(t_end)
        n_acc, wlte = 0, float("nan")
        for _ in range(k):
            live = t < t_end
            dt_att = min(dt, t_end - t)
            if max_dt is not None:
                dt_att = min(dt_att, float(max_dt))
            dt_att = max(dt_att, 0.0)
            y5, f_new, wlte_t, aux_n = attempt_fn(y, t, dt_att, aux, f1)
            wlte = float(wlte_t)
            accepted = wlte <= 1.0 and live
            factor = _factor(wlte, safety, min_factor, max_factor)
            if live:
                dt = dt_att * (factor if accepted else min(factor, 1.0))
            if accepted:
                y, t, f1, aux = y5, t + dt_att, f_new, aux_n
                n_acc += 1
        return y, t, dt, aux, f1, n_acc, wlte

    return chunk


def make_attempt_host_stepper(
    attempt_fn: Callable,
    safety: float = 0.9,
    min_factor: float = 0.1,
    max_factor: float = 10.0,
    max_attempts: int = 12,
    max_dt: Optional[float] = None,
):
    """Host dt controller around one attempt function.

    ``attempt_fn(y, t, dt, aux, f1) -> (y5, f_new, wlte, aux)``
    (make_bs5_scan_attempt). Same accept/reject + dt logic as
    make_bs5_stepper, one wlte read per attempt, but it raises
    RuntimeError after ``max_attempts`` rejections. ``attempts`` is 1 on
    every result, as in the reference.
    """
    def step(y, t, dt, aux, f1, t_end):
        t = float(t)
        dt = min(float(dt), float(t_end) - t)
        if max_dt is not None:
            dt = min(dt, float(max_dt))
        for _ in range(max_attempts):
            y5, f_new, wlte, aux_n = attempt_fn(y, t, dt, aux, f1)
            w = float(wlte)
            factor = _factor(w, safety, min_factor, max_factor)
            if w <= 1.0:
                return StepResult(y=y5, t=t + dt, dt_next=dt * factor,
                                  aux=aux_n, f_new=f_new, wlte=w,
                                  attempts=1)
            dt = dt * min(factor, 1.0)
        raise RuntimeError("BS5 step rejected max_attempts times")

    return step


def make_bs5_host_stepper(
    rhs: Callable,
    atol: float = 1e-4,
    rtol: float = 1e-4,
    safety: float = 0.9,
    min_factor: float = 0.1,
    max_factor: float = 10.0,
    max_attempts: int = 12,
    wlte_norm: Callable = _wlte_norm,
    max_dt: Optional[float] = None,
):
    """Host-orchestrated BS5(4) step, stage by stage.

    The reference dispatches one jitted stage program (stage combine +
    RHS) 7 times an attempt to keep its compiled program small; its
    stage combine is the tensordot of make_bs5_scan_attempt. Eager
    PyTorch runs the same operations either way, so this is
    make_attempt_host_stepper around make_bs5_scan_attempt: the same
    numerics and the same RuntimeError after ``max_attempts``.
    """
    return make_attempt_host_stepper(
        make_bs5_scan_attempt(rhs, atol=atol, rtol=rtol,
                              wlte_norm=wlte_norm),
        safety=safety, min_factor=min_factor, max_factor=max_factor,
        max_attempts=max_attempts, max_dt=max_dt)


def integrate(
    rhs: Callable,
    y0,
    t0: float,
    t_end: float,
    dt0: float,
    aux,
    max_steps: int = 10**6,
    atol: float = 1e-4,
    rtol: float = 1e-4,
    callback=None,
):
    """Host-driven adaptive integration loop over make_bs5_stepper.

    ``callback(step, t, dt, y, aux)`` runs after each accepted step.
    Returns (y, t, steps); t ends at t_end exactly (MATCHSTEP).
    """
    step = make_bs5_stepper(rhs, atol=atol, rtol=rtol)
    y, t, dt = y0, float(t0), float(dt0)
    f1, aux = rhs(t, y, aux)
    n = 0
    while t < t_end - 1e-14 and n < max_steps:
        res = step(y, t, dt, aux, f1, t_end)
        y, t, dt, aux, f1 = res.y, res.t, res.dt_next, res.aux, res.f_new
        n += 1
        if callback is not None:
            callback(n, t, res.dt_next, y, aux)
    return y, t, n
