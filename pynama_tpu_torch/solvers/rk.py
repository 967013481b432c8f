"""Adaptive explicit Runge-Kutta time integration (Bogacki-Shampine 5(4)).

Port of pynama_tpu/solvers/rk.py (``make_bs5_stepper``). The 8-stage
FSAL pair and the controller (PETSc TSAdaptBasic: weighted 2-norm local
truncation error, accept iff wlte <= 1, dt *= clip(0.9 wlte^(-1/5), 0.1,
10)) are unchanged; the reference's ``lax.while_loop`` over attempts is
a Python loop that reads wlte on the host once per attempt. Step times
t and dt are Python floats (float64).

The RHS signature is ``rhs(t, y, aux) -> (f, aux)``: ``aux`` threads
solver state (the KLE warm starts) through stages and steps.
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


def _wlte_norm(err, y_old, y_new, atol, rtol):
    w = atol + rtol * torch.maximum(torch.abs(y_old), torch.abs(y_new))
    e = err / w
    return torch.sqrt(torch.mean(e * e))


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
):
    """Build ``step(y, t, dt, aux, f1, t_end) -> StepResult``.

    One accepted adaptive step; rejected attempts loop inside (after
    ``max_attempts`` rejections the state comes back unchanged with the
    shrunken dt, as the reference's while_loop leaves it). ``f1`` is the
    FSAL derivative at (t, y). dt is clamped so t never overshoots t_end;
    max_dt caps the controller's proposals.
    """
    def attempt(y, t, dt, aux, f1):
        ks = [f1]
        aux_c = aux
        for i in range(1, BS5_STAGES):
            yi = y
            for j in range(i):
                a = float(BS5_A[i, j])
                if a != 0.0:
                    yi = yi + (dt * a) * ks[j]
            fi, aux_c = rhs(t + float(BS5_C[i]) * dt, yi, aux_c)
            ks.append(fi)
        y5 = y
        for j in range(BS5_STAGES):
            b = float(BS5_B[j])
            if b != 0.0:
                y5 = y5 + (dt * b) * ks[j]
        err = torch.zeros_like(y)
        for j in range(BS5_STAGES):
            d = float(BS5_B[j] - BS5_BEMBED[j])
            if d != 0.0:
                err = err + (dt * d) * ks[j]
        wlte = wlte_norm(err, y, y5, atol, rtol)
        return y5, ks[-1], wlte, aux_c

    def step(y, t, dt, aux, f1, t_end):
        t, dt = float(t), float(dt)
        if max_dt is not None:
            dt = min(dt, max_dt)
        dt = min(dt, float(t_end) - t)
        wlte = float("inf")
        for k in range(1, max_attempts + 1):
            y5, f_new, wlte_t, aux1 = attempt(y, t, dt, aux, f1)
            wlte = float(wlte_t)
            accepted = wlte <= 1.0
            factor = float(np.clip(
                safety * max(wlte, 1e-30) ** (-1.0 / BS5_ORDER),
                min_factor, max_factor))
            if accepted:
                return StepResult(y=y5, t=t + dt, dt_next=dt * factor,
                                  aux=aux1, f_new=f_new, wlte=wlte,
                                  attempts=k)
            dt = dt * min(factor, 1.0)
        return StepResult(y=y, t=t, dt_next=dt, aux=aux, f_new=f1,
                          wlte=wlte, attempts=max_attempts)

    return step
