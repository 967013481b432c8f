from pynama_tpu_torch.elements.quadrature import gauss_points, lobatto_points
from pynama_tpu_torch.elements.lagrange import lagrange_basis
from pynama_tpu_torch.elements.spectral import SpectralElement

__all__ = ["gauss_points", "lobatto_points", "lagrange_basis", "SpectralElement"]
