"""The blocked stencil contraction: CUDA kernels, their wrappers and the
plain PyTorch version.

    y[b, :] = sum_{q < F in every axis} x[b + q - Q, :] @ W[q]

zero-extended, Q = (F - 1) / 2, on a blocked tensor (B1, ..., Bdim, Cin)
with a kernel W (F, ..., F, Cin, Cout), dim 2 or 3. Every operator apply
of the solver goes through ``conv_blocked``.

Replaces the TPU kernels of ``pynama_tpu/ops/pallas_stencil.py``:
``_kernel_xc`` (2D, called from ``conv_blocked_pallas``) with the
hand-written Hopper kernel ``csrc/stencil2d.cu``, and ``_kernel3d_xc``
(3D, called from ``_conv3d_pallas``) with ``csrc/stencil3d.cu``; their
"flat" variants ``_kernel`` and ``_kernel3d`` compute the same
functions. Both are implicit GEMMs whose instance and K split
``plan2d`` / ``plan3d`` pick for each shape; each keeps its first design
as ``v1``, a yardstick.
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
import functools
import hashlib
import itertools
import math
import os
import shutil
import subprocess
import time
from collections import Counter
from pathlib import Path
from typing import NamedTuple

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


# The instances of csrc/stencil2d.cu and csrc/stencil3d.cu (their
# STENCIL2D_INSTANCES / STENCIL3D_INSTANCES): id -> (dtype, BM, BN, TM, TN,
# BK, STAGES): a thread block computes BM positions x BN output channels,
# each thread TM x TN of them, over chunks of BK input channels, STAGES
# chunks in flight. In both, 0 is the wide float32 tile, 1 the narrow one
# (the parity-patch and coarsest layouts: 8 channels in 2D, 24 in 3D) and
# 2 the float64 one.
INSTANCES2D = {
    0: (torch.float32, 128, 64, 8, 8, 16, 4),
    1: (torch.float32, 256, 8, 8, 4, 8, 3),
    2: (torch.float64, 64, 64, 4, 8, 8, 3),
}
INSTANCES3D = {
    0: (torch.float32, 128, 64, 8, 8, 16, 4),
    1: (torch.float32, 128, 24, 8, 4, 8, 3),
    2: (torch.float64, 64, 64, 4, 8, 8, 3),
}
INSTANCES = {2: INSTANCES2D, 3: INSTANCES3D}
SMS = 132        # streaming multiprocessors of an H100 SXM
MAX_SPLIT = 64   # the kernels' bound on the K split
# blocks per SM a plan aims at: one less than an SM holds at once at the
# instance's registers and shared memory (ptxas: 166-168 registers a
# thread for 0 and 2, 3 blocks; 3D's 1, 96 threads of 128 registers, 5;
# 2D's 1, 64 threads of 150 registers and 37,632 bytes, 6)
FILL2D = {0: 2, 1: 5, 2: 2}
FILL3D = {0: 2, 1: 4, 2: 2}
FILL = {2: FILL2D, 3: FILL3D}
# and the busiest SM may hold at most 1 / BALANCE times the mean
BALANCE = 0.85


class Plan(NamedTuple):
    """How a stencil kernel computes one shape: ``instance`` of its
    table over ``m_tiles`` x ``n_tiles`` output tiles of ``bm`` positions x
    ``bn`` channels, the ``chunks`` K chunks (F^dim taps x ceil(Cin / bk))
    split over ``split`` thread blocks per tile; ``vec``: 16-byte copies."""
    instance: int
    bm: int
    bn: int
    bk: int
    positions: int
    m_tiles: int
    n_tiles: int
    chunks: int
    split: int
    vec: bool

    @property
    def blocks(self):
        return self.m_tiles * self.n_tiles * self.split

    @property
    def useful_positions(self):
        """Share of the computed positions that are real."""
        return self.positions / (self.m_tiles * self.bm)


def split_k(tiles, chunks, fill):
    """The K split of a shape with ``tiles`` output tiles and ``chunks``
    K chunks: the smallest that launches at least ``fill`` blocks per SM
    with the busiest SM within BALANCE of the mean, else the largest
    allowed. Splitting costs a pass over the partial sums; few or
    unevenly spread blocks leave SMs idle (PERF.md section 6 holds the
    rule against the splits scripts/stencil_sweep.py times)."""
    top = min(chunks, MAX_SPLIT)
    for split in range(1, top + 1):
        blocks = tiles * split
        if blocks >= fill * SMS and \
                blocks >= BALANCE * SMS * -(-blocks // SMS):
            return split
    return top


def _plan(dim, x_shape, W_shape, dtype, instance=None, split=None):
    """plan2d (dim 2) or plan3d (dim 3)."""
    table = INSTANCES[dim]
    x_shape, W_shape = tuple(x_shape), tuple(W_shape)
    if len(x_shape) != dim + 1 or len(W_shape) != dim + 2:
        raise ValueError(f"expected x (B1, .., B{dim}, Cin) and W ({dim} "
                         f"x F, Cin, Cout), got {x_shape} and {W_shape}")
    F, c_in, c_out = W_shape[0], W_shape[-2], W_shape[-1]
    if F not in FOOTPRINTS or W_shape[:dim] != (F,) * dim:
        raise ValueError(f"footprint {W_shape[:dim]} not in {FOOTPRINTS}")
    if x_shape[-1] != c_in:
        raise ValueError(f"channels: x has {x_shape[-1]}, W takes {c_in}")
    if min(x_shape + W_shape) <= 0:
        raise ValueError(f"empty shape: x {x_shape}, W {W_shape}")
    M = math.prod(x_shape[:-1])
    if M * max(c_in, c_out) >= 2**31:
        raise ValueError(f"x {x_shape}: too many positions for int32 "
                         "offsets")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"dtype {dtype}: stencil{dim}d takes "
                        "float32/float64")
    if instance is None:
        if dtype == torch.float64:
            instance = 2
        else:
            instance = 1 if c_out <= table[1][2] else 0
    if table.get(instance, (None,))[0] != dtype:
        raise ValueError(f"stencil{dim}d has no {dtype} instance {instance}")
    _, bm, bn, _, _, bk, _ = table[instance]
    m_tiles, n_tiles = -(-M // bm), -(-c_out // bn)
    chunks = F**dim * -(-c_in // bk)
    if split is None:
        split = split_k(m_tiles * n_tiles, chunks, FILL[dim][instance])
    if not 1 <= split <= min(chunks, MAX_SPLIT):
        raise ValueError(f"split {split} outside 1..{min(chunks, MAX_SPLIT)}")
    v = 16 // (8 if dtype == torch.float64 else 4)
    return Plan(instance, bm, bn, bk, M, m_tiles, n_tiles, chunks, split,
                c_in % v == 0 and c_out % v == 0)


def plan2d(x_shape, W_shape, dtype, instance=None, split=None):
    """The stencil2d plan for x (B1, B2, Cin), W (F, F, Cin, Cout).

    float64 takes instance 2; float32 instance 1 up to 8 output channels
    (the parity-patch and lam_max layouts), else instance 0. The K split
    is split_k's. ``instance`` and ``split`` force a choice (to time the
    alternatives). Pure: no device, no side effects; raises on a shape,
    dtype or choice outside the kernel's contract.
    """
    return _plan(2, x_shape, W_shape, dtype, instance, split)


def plan3d(x_shape, W_shape, dtype, instance=None, split=None):
    """The stencil3d plan for x (B1, B2, B3, Cin), W (F, F, F, Cin, Cout).

    float64 takes instance 2; float32 instance 1 up to 24 output
    channels (the parity-patch and coarsest layouts), else instance 0.
    The K split is split_k's. ``instance`` and ``split`` force a choice
    (to time the alternatives). Pure: no device, no side effects; raises
    on a shape, dtype or choice outside the kernel's contract.
    """
    return _plan(3, x_shape, W_shape, dtype, instance, split)


_plan_cached = functools.lru_cache(maxsize=256)(_plan)
_DTYPE_NAMES = {torch.float32: "float32", torch.float64: "float64"}


def _on_device(device, launch):
    """launch(stream) on ``device``'s current stream, with ``device``
    current (entered only when it is not)."""
    if device.index == torch.cuda.current_device():
        return launch(torch.cuda.current_stream().cuda_stream)
    with torch.cuda.device(device):
        return launch(torch.cuda.current_stream().cuda_stream)


class CudaStencil(CudaLibrary):
    """csrc/stencil{dim}d.cu (float32 and float64): the implicit-GEMM
    kernel, launched with the plan of each shape, and the first design
    as ``v1``, a yardstick that no solver path calls; ``shapes`` counts
    the kernel's launches by (x shape, W shape, dtype)."""

    def __init__(self, dim):
        v, i = ctypes.c_void_p, ctypes.c_int
        super().__init__(f"stencil{dim}d", {
            **{f"stencil{dim}d_{s}": [v] * 4 + [i] * (dim + 6) + [v]
               for s in ("f32", "f64")},
            **{f"stencil{dim}d_v1_{s}": [v] * 3 + [i] * (dim + 3) + [v]
               for s in ("f32", "f64")},
            f"stencil{dim}d_instance": [i, ctypes.POINTER(i)]})
        self.dim = dim
        self.v1_launches = 0

    def reset_counts(self):
        super().reset_counts()
        self.v1_launches = 0

    def plan(self, x_shape, W_shape, dtype, instance=None, split=None):
        """This kernel's plan of a shape (plan2d or plan3d)."""
        return _plan(self.dim, x_shape, W_shape, dtype, instance, split)

    def _check(self, xb, W):
        """Raise unless this kernel takes (xb, W) as they are."""
        check_args(xb, W)
        if W.dim() - 2 != self.dim:
            raise ValueError(f"{self.name} takes {self.dim}D kernels, got W "
                             f"{tuple(W.shape)}")
        if xb.device.type != "cuda":
            raise ValueError(f"the CUDA kernel needs CUDA tensors, got "
                             f"{xb.device}")

    def __call__(self, xb, W, plan=None):
        """y = the contraction of (xb, W), launched with ``plan``
        (default: the plan of the shape, computed once per shape: small
        shapes take less device time than this wrapper's host time)."""
        self._check(xb, W)
        lib = self._lib or self.build()
        key = (tuple(xb.shape), tuple(W.shape), xb.dtype)
        if plan is None:
            plan = _plan_cached(self.dim, *key)
        elif plan != self.plan(*key, instance=plan.instance,
                               split=plan.split):
            raise ValueError(f"{plan} is not a plan of x {key[0]}, W "
                             f"{key[1]}, {xb.dtype}")
        y = torch.empty(key[0][:-1] + key[1][-1:], dtype=xb.dtype,
                        device=xb.device)
        ws, part = 0, None   # part: the splits' partial sums
        if plan.split > 1:
            part = torch.empty((plan.split, y.numel()), dtype=xb.dtype,
                               device=xb.device)
            ws = part.data_ptr()
        ptrs = (xb.data_ptr(), W.data_ptr(), y.data_ptr(), ws)
        vec = plan.vec and not (ptrs[0] | ptrs[1] | ptrs[2] | ws) % 16
        fn = getattr(lib, f"{self.name}_"
                     + ("f32" if xb.dtype == torch.float32 else "f64"))
        args = ptrs + key[0] + key[1][-1:] + key[1][:1] + (
            plan.instance, plan.split, int(vec))
        err = _on_device(xb.device, lambda s: fn(*args, s))
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: CUDA error {err} "
                               f"(x {key[0]}, W {key[1]}, {plan})")
        self.count((key[0], key[1], _DTYPE_NAMES[xb.dtype]))
        return y

    def v1(self, xb, W):
        """The first design, for timing beside the kernel; counted in
        ``v1_launches`` only."""
        self._check(xb, W)
        lib = self._lib or self.build()
        fn = getattr(lib, f"{self.name}_v1_"
                     + ("f32" if xb.dtype == torch.float32 else "f64"))
        y = torch.empty(tuple(xb.shape[:-1]) + (W.shape[-1],),
                        dtype=xb.dtype, device=xb.device)
        args = (xb.data_ptr(), W.data_ptr(), y.data_ptr(), *xb.shape[:-1],
                W.shape[-2], W.shape[-1], W.shape[0])
        err = _on_device(xb.device, lambda s: fn(*args, s))
        if err != 0:
            raise RuntimeError(f"{self.name}_v1 launch failed: CUDA error "
                               f"{err} (x {tuple(xb.shape)}, W "
                               f"{tuple(W.shape)})")
        if not torch.cuda.is_current_stream_capturing():
            self.v1_launches += 1
        return y

    def instances(self):
        """The built library's instance table, as INSTANCES2D /
        INSTANCES3D: {id: ((dtype, BM, BN, TM, TN, BK, STAGES), threads,
        shared bytes)}."""
        lib = self.build()
        info = getattr(lib, f"{self.name}_instance")
        out, table = (ctypes.c_int * 9)(), {}
        for i in INSTANCES[self.dim]:
            if info(i, out) != 0:
                raise RuntimeError(f"{self.name} has no instance {i}")
            size, *tile, threads, smem = list(out)
            table[i] = ((torch.float32 if size == 4 else torch.float64,
                         *tile), threads, smem)
        return table


class CudaStencil2D(CudaStencil):
    """csrc/stencil2d.cu, planned by plan2d; its first design (``v1``) is
    the halo-tile kernel of csrc/stencil2d_tile.cuh.
    csrc/stencil_breakdown.cu takes this kernel's design apart."""

    def __init__(self):
        super().__init__(2)


class CudaStencil3D(CudaStencil):
    """csrc/stencil3d.cu, planned by plan3d; its first design (``v1``) is
    csrc/stencil3d_v1.cuh."""

    def __init__(self):
        super().__init__(3)


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


KERNEL = CudaStencil2D()
KERNEL3D = CudaStencil3D()
KERNELS = {2: KERNEL, 3: KERNEL3D}
_V, _I = ctypes.c_void_p, ctypes.c_int
BREAKDOWN = CudaLibrary("stencil_breakdown", {
    # x, W (or W^T), y, ws, B1, B2, C, instance, split, vec, mode, stream
    "stencil_breakdown_f32": [_V] * 4 + [_I] * 7 + [_V],
    # W, W^T, C, instance, stream
    "stencil_breakdown_prepare_w": [_V] * 2 + [_I] * 2 + [_V],
    "stencil_breakdown_instance": [_I, ctypes.POINTER(_I)],
    # the first design: x, W, y, B1, B2, C, TR, mode, prec, stream
    "stencil_breakdown_v1_f32": [_V] * 3 + [_I] * 6 + [_V]})
LIBRARIES = (KERNEL, KERNEL3D, BREAKDOWN)


def conv_blocked(xb, W):
    """Stencil contraction on a blocked tensor (B..., Cin) -> (B..., Cout).

    CPU tensors: the plain version. CUDA tensors: the hand-written kernel
    of W's dim, never the plain version. Both hold the caller to the
    kernels' contract (check_args; the kernel's wrapper checks it itself,
    once: on the solver's coarse levels this host time is most of a
    call's).
    """
    if xb.device.type != "cpu" and W.dim() - 2 in KERNELS:
        return KERNELS[W.dim() - 2](xb, W)
    check_args(xb, W)
    return conv_blocked_plain(xb, W)
