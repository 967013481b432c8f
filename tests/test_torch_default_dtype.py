"""The problems' default dtype is the reference's: CavityProblem,
UniformFlowProblem and CustomFuncProblem built without ``dtype`` hold
float64 state and operators in both packages, so one config gives the
same numbers in each."""

import numpy as np
import pytest
import torch

from pynama_tpu.cases.analytic import CustomFuncProblem as RefCustom
from pynama_tpu.cases.cavity import CavityProblem as RefCavity
from pynama_tpu.cases.uniform import UniformFlowProblem as RefUniform
from pynama_tpu_torch.cases.analytic import CustomFuncProblem
from pynama_tpu_torch.cases.cavity import CavityProblem
from pynama_tpu_torch.cases.uniform import UniformFlowProblem


def config(bc=None):
    cfg = {
        "domain": {"ngl": 3, "box-mesh": {"nelem": [2, 2]}},
        "material-properties": {"rho": 1.0, "mu": 0.1},
        "time-solver": {"end-time": 0.5},
        "multigrid": False,
    }
    if bc is not None:
        cfg["boundary-conditions"] = bc
    return cfg


CASES = {
    "cavity": (CavityProblem, RefCavity,
               config({"no-slip": {"up": [1.0, 0.0]}}), {}),
    "uniform": (UniformFlowProblem, RefUniform, config(), {}),
    "taylor-green": (CustomFuncProblem, RefCustom, config(),
                     {"case": "taylor-green"}),
}


def dtypes(p):
    """The problem's dtype and those of its state and operators."""
    return {
        "problem": p.dtype,
        "vorticity": p.initial_vorticity().dtype,
        "velocity": p.zero_vel().dtype,
        "K": p.system.K.A.dtype,
        "Rw": p.system.Rw.A.dtype,
        "diag_K": p.system.diag_K.dtype,
        "SrT": p.operators.SrT.A.dtype,
        "w_srt": p.operators.w_srt.dtype,
        "free_mask": p.free_mask.dtype,
    }


@pytest.mark.parametrize("name", list(CASES))
def test_default_dtype_is_float64_in_both_packages(name):
    cls, ref_cls, cfg, kw = CASES[name]
    got = dtypes(cls(cfg, device="cpu", **kw).setup())
    ref = dtypes(ref_cls(cfg, **kw).setup())
    assert set(got.values()) == {torch.float64}, got
    assert {np.dtype(d) for d in ref.values()} == {np.dtype(np.float64)}, ref
