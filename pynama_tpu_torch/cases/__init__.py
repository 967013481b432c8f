from pynama_tpu_torch.cases.analytic import CustomFuncProblem
from pynama_tpu_torch.cases.base import BaseProblem, FreeSlipProblem
from pynama_tpu_torch.cases.cavity import CavityProblem, NoSlipProblem
from pynama_tpu_torch.cases.immersed import (
    ImmersedBoundaryDynamicProblem, ImmersedBoundaryProblem)
from pynama_tpu_torch.cases.uniform import UniformFlowProblem

__all__ = ["BaseProblem", "FreeSlipProblem", "NoSlipProblem",
           "CavityProblem", "UniformFlowProblem", "CustomFuncProblem",
           "ImmersedBoundaryProblem", "ImmersedBoundaryDynamicProblem"]
