"""Regularized discrete delta (dirac) kernels on tensors.

Port of pynama_tpu/ibm/diracs.py. r is |distance|/h; the kernels satisfy
the discrete mass (sum = 1) and first-moment (sum r = 0) conditions on a
uniform grid. Each kernel evaluates both of its branches everywhere and
selects with ``torch.where``, each square root guarded by max(., 0), as
the reference does, so the values agree with it to rounding.
"""

import torch


def four_grid(r):
    """Peskin 4-point kernel; support |r| < 2."""
    r = torch.abs(r)
    inner = (3.0 - 2.0 * r + torch.sqrt(torch.clamp(
        1.0 + 4.0 * r - 4.0 * r * r, min=0.0))) / 8.0
    outer = (5.0 - 2.0 * r - torch.sqrt(torch.clamp(
        -7.0 + 12.0 * r - 4.0 * r * r, min=0.0))) / 8.0
    return torch.where(r <= 1.0, inner,
                       torch.where(r <= 2.0, outer, torch.zeros_like(r)))


def three_grid(r):
    """3-point kernel; support |r| < 1.5."""
    r = torch.abs(r)
    inner = (1.0 + torch.sqrt(torch.clamp(-3.0 * r * r + 1.0, min=0.0))) / 3.0
    outer = (5.0 - 3.0 * r - torch.sqrt(torch.clamp(
        -3.0 * (1.0 - r) ** 2 + 1.0, min=0.0))) / 6.0
    return torch.where(r <= 0.5, inner,
                       torch.where(r <= 1.5, outer, torch.zeros_like(r)))


def linear(r):
    """Hat kernel; support |r| < 1."""
    r = torch.abs(r)
    return torch.where(r < 1.0, 1.0 - r, torch.zeros_like(r))


KERNELS = {"fourGrid": four_grid, "threeGrid": three_grid, "linear": linear}
# support radius in grid cells (window half-width)
SUPPORT = {"fourGrid": 2.0, "threeGrid": 1.5, "linear": 1.0}
