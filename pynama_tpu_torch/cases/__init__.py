from pynama_tpu_torch.cases.base import BaseProblem
from pynama_tpu_torch.cases.cavity import CavityProblem, NoSlipProblem

__all__ = ["BaseProblem", "NoSlipProblem", "CavityProblem"]
