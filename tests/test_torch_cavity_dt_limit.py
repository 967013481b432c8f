"""The port's explicit time-step limit on the lid-driven cavity scales
as h^2: it lies above dt 0.4 on 8x8 Q2 elements and below dt 0.15 on
16x16, a ratio above the 2 that an advective (h) limit would give. Above
the limit the port steps as the reference does
(tests/test_torch_cavity_setup.py), so the limit carries to chip_smoke.py's
384x384 cavity: between 0.4 / 48^2 ~ 1.7e-4 and 0.6 / 48^2 ~ 2.6e-4."""

import torch

from pynama_tpu_torch.cases.cavity import CavityProblem
from tests.test_torch_cavity_setup import fixed_dt_config, max_vort_per_step


def run(nelem, dt, steps):
    p = CavityProblem(fixed_dt_config(nelem, dt, multigrid=True),
                      dtype=torch.float64, device="cpu").setup()
    return [w for _, w in max_vort_per_step(p, lambda v: v.numpy(), steps)]


def test_step_limit_scales_as_h_squared():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        below = run(8, 0.4, 5)
        above = run(16, 0.15, 4)
    finally:
        torch.set_num_threads(n)
    # 8x8 at 0.4 grows with the lid's forcing only: max |vort| ~ 1e2
    assert len(below) == 5 and below[-1] < 1e3
    # 16x16 at 0.15 grows by orders of magnitude per step
    assert len(above) == 4 and above[-1] > 1e3 * above[0]
