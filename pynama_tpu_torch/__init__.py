"""pynama_tpu_torch — the spectral-element KLE/Navier-Stokes solver of
pynama_tpu, ported to PyTorch with hand-written CUDA kernels for Hopper.

The JAX package ``pynama_tpu`` stays the reference; this package keeps its
module names so each counterpart is easy to find, imports neither JAX nor
anything of ``pynama_tpu``, and takes an explicit ``device`` and ``dtype``
everywhere. Entry points run on ``"cuda"`` unless the caller asks for the
CPU; on the CPU every kernel wrapper runs its plain PyTorch version.
"""

__version__ = "0.1.0"

from pynama_tpu_torch.elements.spectral import SpectralElement  # noqa: E402,F401
from pynama_tpu_torch.mesh.structured import BoxMesh  # noqa: E402,F401
