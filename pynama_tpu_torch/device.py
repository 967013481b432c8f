"""Where the port runs: the card unless the caller asks for the CPU."""

import torch


def resolve_device(device=None):
    """``None`` -> "cuda"; raise when CUDA is asked for and absent, so
    nothing carries on quietly on the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return device
