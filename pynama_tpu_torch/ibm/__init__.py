from pynama_tpu_torch.ibm.bodies import (BodiesContainer, Circle, Line,
                                         OpenBox)
from pynama_tpu_torch.ibm.coupling import IBMCoupling

__all__ = ["Circle", "Line", "OpenBox", "BodiesContainer", "IBMCoupling"]
