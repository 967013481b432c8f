"""The blocked stencil contraction: CUDA kernels, their wrappers and the
plain PyTorch version.

    y[b, :] = sum_{q < F in every axis} x[b + q - Q, :] @ W[q]

zero-extended, Q = (F - 1) / 2, on a blocked tensor (B1, ..., Bdim, Cin)
with a kernel W (F, ..., F, Cin, Cout), dim 2 or 3. Every operator apply
of the solver goes through ``conv_blocked``.

Replaces the TPU kernels of ``pynama_tpu/ops/pallas_stencil.py``:
``_kernel_xc`` (2D, called from ``conv_blocked_pallas``) with the
hand-written Hopper kernel ``csrc/stencil2d.cu`` (an instance of the
tiled kernel in ``csrc/stencil2d_tile.cuh``), and ``_kernel3d_xc``
(3D, called from ``_conv3d_pallas``) with ``csrc/stencil3d.cu``; their
"flat" variants ``_kernel`` and ``_kernel3d`` compute the same functions.
Bound on an H100 SXM at 700 W, by arithmetic (67 TFLOP/s float32 without
tensor cores) at every main-path shape: the 2D fine K apply (97 x 97
blocks, 128 -> 128, F = 3) is 2.78 GFLOP, about 41 us; the 3D fine K
apply of channel3d (41 x 17 x 17 blocks, 192 -> 192, F = 3) is 23.6
GFLOP, about 0.35 ms, against about 7 us for its 22 MB at 3.35 TB/s.

Dispatch: a CPU tensor runs ``conv_blocked_plain``; a CUDA tensor
launches the kernel of its dim or raises. Each CUDA source of ``csrc/``
is built with ``nvcc`` at its first use into ``pynama_tpu_torch/_build/``
(listed in .gitignore) and loaded with ctypes (``CudaLibrary``); building
needs ``nvcc`` and raises without it. ``build_kernels`` builds every
library at once, one ``nvcc`` each: stencil2d, stencil3d and
``csrc/stencil_breakdown.cu``, whose wrapper is
``pynama_tpu_torch/scripts/stencil_breakdown.py``.
"""

import ctypes
import hashlib
import itertools
import os
import shutil
import subprocess
import time
from collections import Counter
from pathlib import Path

import torch
import torch.nn.functional as tnf

_PKG = Path(__file__).resolve().parent.parent
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
FOOTPRINTS = (3, 5)


def conv_blocked_plain(xb, W):
    """Plain PyTorch version of the kernels: F^dim shifted matmuls.

    Any dim; the reference for the kernels on the card and the path
    every CPU tensor takes.
    """
    dim = W.dim() - 2
    F = W.shape[0]
    Q = (F - 1) // 2
    B = xb.shape[-dim - 1:-1]
    g = tnf.pad(xb, (0, 0) + (Q, Q) * dim)
    out = None
    for q in itertools.product(range(F), repeat=dim):
        sl = (Ellipsis,) + tuple(
            slice(q[i], q[i] + B[i]) for i in range(dim)) + (slice(None),)
        v = torch.matmul(g[sl], W[q])
        if out is None:
            out = v
        else:
            out += v
    return out


def check_args(xb, W):
    """Raise unless the kernel of W's dim takes (xb, W) as they are:
    x (B1, .., Bdim, Cin) and W (F, .., F, Cin, Cout) with dim 2 or 3."""
    dim = W.dim() - 2
    if dim not in (2, 3) or xb.dim() != dim + 1:
        raise ValueError(f"expected x (B1, .., Bdim, Cin) and W (F, .., F, "
                         f"Cin, Cout) with dim 2 or 3, got {tuple(xb.shape)} "
                         f"and {tuple(W.shape)}")
    F = W.shape[0]
    if F not in FOOTPRINTS or any(W.shape[a] != F for a in range(dim)):
        raise ValueError(f"footprint {tuple(W.shape[:dim])} not in "
                         f"{FOOTPRINTS}")
    if W.shape[-2] != xb.shape[-1]:
        raise ValueError(f"channels: x has {xb.shape[-1]}, W takes "
                         f"{W.shape[-2]}")
    if xb.dtype != W.dtype or xb.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"dtypes {xb.dtype}, {W.dtype}: need one of "
                        "float32/float64 for both")
    if xb.device != W.device:
        raise ValueError(f"x on {xb.device}, W on {W.device}")
    if not (xb.is_contiguous() and W.is_contiguous()):
        raise ValueError("x and W must be contiguous")


class CudaLibrary:
    """The CUDA source csrc/{name}.cu, built at first use into a shared
    library with a plain C interface; the headers of csrc/ (*.cuh) are
    part of every library's build tag.

    ``symbols`` maps each C function the library exports to its ctypes
    argument types; every one returns a CUDA error code (0 on success).
    ``launches`` counts the kernel launches of the library's wrapper, and
    nothing else; ``shapes`` counts them by what the wrapper logs.
    """

    def __init__(self, name, symbols):
        self.name = name
        self.symbols = symbols
        self.source = _PKG / "csrc" / f"{name}.cu"
        self.launches = 0
        self.shapes = Counter()
        self.build_seconds = None
        self.build_log = ""
        self.path = None      # the loaded shared library
        self._lib = None

    def reset_counts(self):
        self.launches = 0
        self.shapes.clear()

    def count(self, key):
        """Log one launch under ``key``. A call made while the current
        stream captures a CUDA graph only records the kernel into the
        graph: it launches nothing and is not logged (nor are replays)."""
        if torch.cuda.is_current_stream_capturing():
            return
        self.launches += 1
        self.shapes[key] += 1

    def _so(self):
        src = self.source.read_bytes() + b"".join(
            h.read_bytes() for h in sorted(self.source.parent.glob("*.cuh")))
        tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
        return BUILD_DIR / f"lib{self.name}-{tag[:16]}.so"

    def _start_build(self):
        """Start nvcc unless the library is built; (so, process or None)."""
        so = self._so()
        if so.exists():
            return so, None
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        if not os.path.exists(nvcc):
            raise RuntimeError(f"nvcc not found: the CUDA toolkit is needed "
                               f"to build {self.source}")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return so, (proc, tmp)

    def _finish_build(self, so, started, t0):
        if started is not None:
            proc, tmp = started
            self.build_log = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {self.source}:\n"
                                   f"{self.build_log}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        self.path = so
        for symbol, argtypes in self.symbols.items():
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        self.build_seconds = time.perf_counter() - t0
        self._lib = lib
        return lib

    def build(self):
        """Compile (if not built yet) and load the shared library."""
        if self._lib is None:
            build_kernels([self])
        return self._lib


class CudaStencil(CudaLibrary):
    """The stencil kernel of csrc/stencil{dim}d.cu (float32 and float64);
    ``shapes`` counts its launches by (x shape, W shape, dtype)."""

    def __init__(self, dim):
        args = [ctypes.c_void_p] * 3 + [ctypes.c_int] * (dim + 3) + [
            ctypes.c_void_p]
        super().__init__(f"stencil{dim}d", {
            f"stencil{dim}d_{s}": args for s in ("f32", "f64")})
        self.dim = dim

    def __call__(self, xb, W):
        check_args(xb, W)
        if W.dim() - 2 != self.dim:
            raise ValueError(f"{self.name} takes {self.dim}D kernels, got W "
                             f"{tuple(W.shape)}")
        if xb.device.type != "cuda":
            raise ValueError(f"the CUDA kernel needs CUDA tensors, got "
                             f"{xb.device}")
        lib = self.build()
        fn = getattr(lib, f"{self.name}_"
                     + ("f32" if xb.dtype == torch.float32 else "f64"))
        F, c_in, c_out = W.shape[0], W.shape[-2], W.shape[-1]
        y = torch.empty(tuple(xb.shape[:-1]) + (c_out,), dtype=xb.dtype,
                        device=xb.device)
        with torch.cuda.device(xb.device):
            stream = torch.cuda.current_stream(xb.device).cuda_stream
            err = fn(xb.data_ptr(), W.data_ptr(), y.data_ptr(),
                     *xb.shape[:-1], c_in, c_out, F, stream)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: CUDA error {err} "
                               f"(x {tuple(xb.shape)}, W {tuple(W.shape)})")
        self.count((tuple(xb.shape), tuple(W.shape),
                    str(xb.dtype).replace("torch.", "")))
        return y


def build_kernels(kernels=None):
    """Build and load the libraries not built yet (default: all of
    ``LIBRARIES``), one nvcc each, all started together."""
    kernels = [k for k in (kernels or LIBRARIES) if k._lib is None]
    t0 = time.perf_counter()
    started = []
    try:
        for k in kernels:
            started.append((k, *k._start_build()))
        for k, so, proc in started:
            k._finish_build(so, proc, t0)
    finally:  # a failed build leaves no other nvcc running
        for _, _, proc in started:
            if proc is not None and proc[0].poll() is None:
                proc[0].kill()
                proc[0].wait()


KERNEL = CudaStencil(2)
KERNEL3D = CudaStencil(3)
KERNELS = {2: KERNEL, 3: KERNEL3D}
# x, W, y, B1, B2, C, TR, mode, prec, stream
BREAKDOWN = CudaLibrary("stencil_breakdown", {
    "stencil_breakdown_f32": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]})
LIBRARIES = (KERNEL, KERNEL3D, BREAKDOWN)


def conv_blocked(xb, W):
    """Stencil contraction on a blocked tensor (B..., Cin) -> (B..., Cout).

    CPU tensors: the plain version. CUDA tensors: the hand-written kernel
    of W's dim, never the plain version. Both hold the caller to the
    kernels' contract (check_args).
    """
    check_args(xb, W)
    if xb.device.type == "cpu":
        return conv_blocked_plain(xb, W)
    return KERNELS[W.dim() - 2](xb, W)
