"""The port's twin of tests/test_3d.py::test_taylor_green_2d3d_transient:
the 2D Taylor-Green vortex in a 3D box, 3x3x3 Q2 hexes, float64, against
its exact solution. The reference runs to t = 0.02 in two steps; the twin
ends after the first step (t = 0.002), since each evaluation contracts
648 super-block channels on the CPU, and keeps the 0.15 bound."""

import pytest
import torch
from threadpoolctl import threadpool_limits

from pynama_tpu_torch.cases.analytic import CustomFuncProblem
from tests.test_cases import make_config


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def test_taylor_green_2d3d_transient():
    cfg = make_config((3, 3, 3), 3, rho=0.5, mu=0.01, end=0.02, max_steps=1)
    p = CustomFuncProblem(cfg, case="taylor-green2d-3d", dtype=torch.float64,
                          device="cpu").setup()
    vort, t, n = p.run()
    assert n == 1 and abs(t - 0.002) < 1e-12
    vel_e, _ = p.exact_fields(t)
    rel = float(torch.linalg.norm(p.vel - vel_e.reshape(-1))
                / torch.linalg.norm(vel_e))
    assert rel < 0.15, rel  # coarse 3x3x3 ngl3 spatial resolution
