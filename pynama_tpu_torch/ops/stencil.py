"""The blocked stencil contraction: CUDA kernel, its wrapper and its plain
PyTorch version.

    y[b1, b2, :] = sum_{q1, q2 < F} x[b1 + q1 - Q, b2 + q2 - Q, :] @ W[q1, q2]

zero-extended, Q = (F - 1) / 2, on a blocked tensor (B1, B2, Cin) with a
kernel W (F, F, Cin, Cout). Every operator apply of the solver goes
through ``conv_blocked``.

Replaces the TPU kernel ``pynama_tpu/ops/pallas_stencil.py``
``_kernel_xc`` / ``conv_blocked_pallas`` (and its "flat" variant
``_kernel``, which computes the same function) with the hand-written
Hopper kernel ``csrc/stencil2d.cu``. Bound on an H100 SXM at 700 W: the
fine-level K apply (97 x 97 blocks, 128 -> 128, F = 3) is 2.78 GFLOP and
10.2 MB, so arithmetic bounds it at about 41 us (67 TFLOP/s float32
without tensor cores) against about 3 us for the bytes (3.35 TB/s).

Dispatch: a CPU tensor runs ``conv_blocked_plain``; a CUDA tensor
launches the kernel or raises. The kernel is built with ``nvcc`` at its
first use into ``pynama_tpu_torch/_build/`` (listed in .gitignore) and
loaded with ctypes; building needs ``nvcc`` and raises without it.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as tnf

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "stencil2d.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
FOOTPRINTS = (3, 5)


def conv_blocked_plain(xb, W):
    """Plain PyTorch version of the kernel: F^dim shifted matmuls.

    Any dim (the 3D contraction runs here on the CPU); the reference for
    the kernel on the card and the path every CPU tensor takes.
    """
    dim = W.dim() - 2
    F = W.shape[0]
    Q = (F - 1) // 2
    B = xb.shape[-dim - 1:-1]
    g = tnf.pad(xb, (0, 0) + (Q, Q) * dim)
    out = None
    for q in np.ndindex(*(F,) * dim):
        sl = (Ellipsis,) + tuple(
            slice(q[i], q[i] + B[i]) for i in range(dim)) + (slice(None),)
        v = torch.matmul(g[sl], W[q])
        out = v if out is None else out + v
    return out


def check_args(xb, W):
    """Raise unless the 2D kernel takes (xb, W) as they are."""
    if W.dim() == 5:
        raise NotImplementedError(
            "the 3D stencil kernel is not ported yet (ROADMAP.md queue 2)")
    if xb.dim() != 3 or W.dim() != 4:
        raise ValueError(f"expected x (B1, B2, Cin) and W (F, F, Cin, Cout), "
                         f"got {tuple(xb.shape)} and {tuple(W.shape)}")
    F = W.shape[0]
    if F not in FOOTPRINTS or W.shape[1] != F:
        raise ValueError(f"footprint {tuple(W.shape[:2])} not in {FOOTPRINTS}")
    if W.shape[2] != xb.shape[2]:
        raise ValueError(f"channels: x has {xb.shape[2]}, W takes {W.shape[2]}")
    if xb.dtype != W.dtype or xb.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"dtypes {xb.dtype}, {W.dtype}: need one of "
                        "float32/float64 for both")
    if xb.device != W.device:
        raise ValueError(f"x on {xb.device}, W on {W.device}")
    if not (xb.is_contiguous() and W.is_contiguous()):
        raise ValueError("x and W must be contiguous")


class Stencil2D:
    """The CUDA kernel of csrc/stencil2d.cu, built at first use.

    ``launches`` counts the kernel launches, and nothing else.
    """

    def __init__(self, source=SOURCE, build_dir=BUILD_DIR):
        self.source = Path(source)
        self.build_dir = Path(build_dir)
        self.launches = 0
        self.build_seconds = None
        self.build_log = ""
        self._lib = None

    def build(self):
        """Compile (if not built yet) and load the shared library."""
        if self._lib is not None:
            return self._lib
        src = self.source.read_bytes()
        tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
        so = self.build_dir / f"libstencil2d-{tag[:16]}.so"
        t0 = time.perf_counter()
        if not so.exists():
            nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
            if not os.path.exists(nvcc):
                raise RuntimeError("nvcc not found: the CUDA toolkit is needed "
                                   "to build csrc/stencil2d.cu")
            self.build_dir.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
                capture_output=True, text=True)
            self.build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {self.source}:\n"
                                   f"{self.build_log}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        for name in ("stencil2d_f32", "stencil2d_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
        self.build_seconds = time.perf_counter() - t0
        self._lib = lib
        return lib

    def __call__(self, xb, W):
        check_args(xb, W)
        if xb.device.type != "cuda":
            raise ValueError(f"the CUDA kernel needs CUDA tensors, got "
                             f"{xb.device}")
        lib = self.build()
        fn = lib.stencil2d_f32 if xb.dtype == torch.float32 else \
            lib.stencil2d_f64
        B1, B2, c_in = xb.shape
        F, c_out = W.shape[0], W.shape[3]
        y = torch.empty((B1, B2, c_out), dtype=xb.dtype, device=xb.device)
        with torch.cuda.device(xb.device):
            stream = torch.cuda.current_stream(xb.device).cuda_stream
            err = fn(xb.data_ptr(), W.data_ptr(), y.data_ptr(), B1, B2, c_in,
                     c_out, F, stream)
        if err != 0:
            raise RuntimeError(f"stencil2d launch failed: CUDA error {err} "
                               f"(x {tuple(xb.shape)}, W {tuple(W.shape)})")
        self.launches += 1
        return y


KERNEL = Stencil2D()


def conv_blocked(xb, W):
    """Stencil contraction on a blocked tensor (B..., Cin) -> (B..., Cout).

    CPU tensors: the plain version. CUDA tensors: the hand-written kernel
    (2D; 3D raises NotImplementedError), never the plain version.
    """
    if xb.device.type == "cpu" and W.device.type == "cpu":
        if W.dim() == 4:
            check_args(xb, W)  # hold CPU callers to the kernel's contract
        return conv_blocked_plain(xb, W)
    return KERNEL(xb, W)
