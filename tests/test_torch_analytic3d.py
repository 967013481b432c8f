"""The port's twins of tests/test_3d.py: p-refinement of the 3D
Taylor-Green KLE error and the 3D operator errors falling with p
(float64, CPU). The 2D-in-3D transient's twin is
tests/test_torch_taylor_green2d3d.py."""

import pytest
import torch
from threadpoolctl import threadpool_limits

from pynama_tpu_torch.cases.analytic import CustomFuncProblem
from tests.test_cases import make_config

F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def problem(cfg):
    return CustomFuncProblem(cfg, case="taylor-green", dtype=F64,
                             device="cpu").setup()


def test_taylor_green_3d_kle_converges():
    errs = [problem(make_config((2, 2, 2), ngl, rho=0.5, mu=0.01))
            .kle_error([0.3])[0] for ngl in (3, 4)]
    # one order of p-refinement on the full 3D Taylor-Green
    assert errs[1] < 0.4 * errs[0], errs


def test_taylor_green_3d_operators():
    # the operators need no KLE solver: multigrid off spares the ngl=6
    # vertex-star patch matrix (a dense 27783^2 assembly)
    errs = [problem({**make_config((2, 2, 2), ngl, rho=0.5, mu=0.01),
                     "multigrid": False}).operators_test(viscous_time=0.5)
            for ngl in (4, 6)]
    (conv, diff, curl), (conv2, diff2, curl2) = errs
    assert curl2 < curl and conv2 < conv and diff2 < diff
