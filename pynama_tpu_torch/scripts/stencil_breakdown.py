"""Where the time of the 2D stencil kernel goes on the card: the port of
scripts/stencil_breakdown_tpu.py.

    python -m pynama_tpu_torch.scripts.stencil_breakdown [TR]

At the cavity's fine K shape (97 x 97 blocks, 128 -> 128 channels, F = 3,
float32) it times the modes of ``csrc/stencil_breakdown.cu`` (full,
fill-only and mm-only, in IEEE float32 and in TF32), a dense GEMM loop of
the same FLOPs, an elementwise pass that reads and writes x once, and the
production kernel ``stencil.conv_blocked`` (stencil2d), each as a chain of
64 applies ``v = apply(v, W)``. TR is the kernel's tile rows, 8 (the
production tile) or 16; the default is 16, as in the TPU script. Each row
prints its time as one CUDA graph of the chain (the counterpart of the
script's jitted ``fori_loop``) and launched eagerly, the card's bound for
the same work and the share of the bound reached. It needs a CUDA device.

The kernel has no CPU mode: ``make_breakdown``'s ``apply`` launches it on
CUDA tensors and raises on anything else. ``breakdown_plain`` is the plain
PyTorch version of every mode, for the tests and the checks on the card.
"""

import argparse
import contextlib
import itertools
import os
import re
import shutil
import subprocess

import numpy as np
import torch

from pynama_tpu_torch.device import resolve_device
from pynama_tpu_torch.ops import stencil

F, Q = 3, 1
SHAPE = (97, 97, 128)          # the cavity's fine K apply, 384 x 384 Q2
MODES = ("full", "fill", "mm")
PRECISIONS = ("highest", "default")
TILE_ROWS = (8, 16)
N_APPLY = 64                   # chained applies per timed run
REPEATS = 4                    # graph replays timed after a warm replay
# published H100 SXM peaks at 700 W (NVIDIA data sheet): float32 without
# tensor cores, dense TF32 on them, HBM3 bandwidth
PEAK_F32 = 67e12
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12
# the rows the TPU script times, in its order: (name, mode, precision)
KERNEL_ROWS = (("full/highest", "full", "highest"),
               ("full/default", "full", "default"),
               ("fill-only", "fill", "highest"),
               ("mm-only/highest", "mm", "highest"),
               ("mm-only/default", "mm", "default"))
PRODUCTION = "production conv_blocked [stencil2d; serves xc and flat]"


def _check_choice(mode, prec):
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    if prec not in PRECISIONS:
        raise ValueError(f"precision {prec!r} not in {PRECISIONS}")


def _check_shapes(xb, W):
    if xb.dim() != 3 or tuple(W.shape) != (F, F) + (xb.shape[-1],) * 2:
        raise ValueError(f"expected x (B1, B2, C) and W ({F}, {F}, C, C), "
                         f"got {tuple(xb.shape)} and {tuple(W.shape)}")


def make_breakdown(mode, prec, TR):
    """The breakdown kernel in one mode, as the script's ``make_pallas``:
    returns ``apply(xb, W) -> y`` for x (B1, B2, C) and W (3, 3, C, C),
    float32, contiguous, on one CUDA device. ``prec`` is "highest" (IEEE
    float32 FMA) or "default" (TF32 tensor cores); fill ignores it. TR,
    the kernel's tile rows, is 8 or 16."""
    _check_choice(mode, prec)
    if TR not in TILE_ROWS:
        raise ValueError(f"tile rows TR={TR} not in {TILE_ROWS}")
    mode_id = MODES.index(mode)
    prec_id = 0 if mode == "fill" else PRECISIONS.index(prec)

    def apply(xb, W):
        _check_shapes(xb, W)
        if xb.device.type != "cuda" or W.device != xb.device:
            raise ValueError(f"the breakdown kernel needs x and W on one "
                             f"CUDA device, got {xb.device} and {W.device}; "
                             "breakdown_plain is its plain version")
        if xb.dtype != torch.float32 or W.dtype != torch.float32:
            raise TypeError(f"float32 only, got {xb.dtype} and {W.dtype}")
        if not (xb.is_contiguous() and W.is_contiguous()):
            raise ValueError("x and W must be contiguous")
        fn = stencil.BREAKDOWN.build().stencil_breakdown_f32
        y = torch.empty_like(xb)
        with torch.cuda.device(xb.device):
            stream = torch.cuda.current_stream(xb.device).cuda_stream
            err = fn(xb.data_ptr(), W.data_ptr(), y.data_ptr(), *xb.shape,
                     TR, mode_id, prec_id, stream)
        if err != 0:
            raise RuntimeError(f"stencil_breakdown ({mode}, {prec}, TR {TR})"
                               f" launch failed: CUDA error {err} "
                               f"(x {tuple(xb.shape)})")
        stencil.BREAKDOWN.count((mode, prec if mode != "fill" else None, TR,
                                 tuple(xb.shape)))
        return y

    return apply


def round_tf32(t):
    """``t`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds: to nearest,
    ties away from zero, 10 mantissa bits kept; inf and NaN unchanged.
    Float64 values are taken to float32 first; the result has t's dtype."""
    f = t.to(torch.float32).contiguous()
    finite = torch.isfinite(f)
    bits = torch.where(finite, f.view(torch.int32), 0)
    bits = (bits + 0x1000) & -0x2000   # adds half an ulp to |f|, truncates
    return torch.where(finite, bits.view(torch.float32), f).to(t.dtype)


def breakdown_plain(mode, prec, xb, W):
    """The plain PyTorch version of every mode (any dtype and device):
    full is the stencil (``stencil.conv_blocked_plain``), fill the shift
    ``y[:, j] = x[:, j - 1]``, ``y[:, 0] = 0``, mm the 9 products
    ``sum_q x @ W[q]``. With "default", full and mm take x and W rounded
    to TF32 (``round_tf32``) first, as the kernel's tensor-core path does."""
    _check_choice(mode, prec)
    _check_shapes(xb, W)
    if mode == "fill":
        y = torch.zeros_like(xb)
        y[:, 1:] = xb[:, :-1]
        return y
    if prec == "default":
        xb, W = round_tf32(xb), round_tf32(W)
    if mode == "full":
        return stencil.conv_blocked_plain(xb, W)
    out = None
    for q1, q2 in itertools.product(range(F), repeat=2):
        v = torch.matmul(xb, W[q1, q2])
        if out is None:
            out = v
        else:
            out += v
    return out


def weights_from_script(W, device=None):
    """The script's W (F, F * C, C), numpy, as the port's (F, F, C, C)
    tensor: the script's W[q1][q2 * C + ci, co] is W[q1, q2, ci, co]."""
    W = np.asarray(W)
    if W.ndim != 3 or W.shape[0] != F or W.shape[1] != F * W.shape[2]:
        raise ValueError(f"expected W ({F}, {F} * C, C), got {W.shape}")
    c = W.shape[2]
    return torch.as_tensor(W.reshape(F, F, c, c),
                           device=resolve_device(device))


@contextlib.contextmanager
def matmul_precision(precision):
    """torch's float32 matmul precision inside the block ("highest": IEEE
    float32, "high": TF32), restored after it."""
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(precision)
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved)


def time_chain(fn, v0, n=N_APPLY, repeats=REPEATS):
    """ms per call of ``v = fn(v)``, n calls chained from v0:
    (graph, eager). graph: one CUDA graph of the chain, replayed
    ``repeats`` times after a warm replay; eager: the same n calls
    launched one by one. Both timed by CUDA events."""
    def chain(v):
        for _ in range(n):
            v = fn(v)
        return v

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    chain(v0)  # warm: loads the kernels before the capture
    torch.cuda.synchronize()
    start.record()
    chain(v0)
    end.record()
    end.synchronize()
    eager = start.elapsed_time(end) / n

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        chain(v0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        chain(v0)
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    for _ in range(repeats):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (repeats * n), eager


def bound(flop, nbytes, peak_flops):
    """(bound ms, "operations" or "bytes"): the larger of the FLOPs over
    the peak rate and the bytes over the HBM rate."""
    t_ops, t_bytes = flop / peak_flops, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), (
        "operations" if t_ops >= t_bytes else "bytes")


def stencil_work(mode, prec, B1, B2, C):
    """(FLOP, bytes, peak FLOP/s) of one apply: each input read once and
    the output written once."""
    act = 4 * B1 * B2 * C
    if mode == "fill":
        return 0.0, 2 * act, PEAK_F32
    peak = PEAK_TF32 if prec == "default" else PEAK_F32
    return 2.0 * B1 * B2 * C * C * F * F, 2 * act + 4 * F * F * C * C, peak


def _row(name, times, flop, nbytes, peak):
    graph_ms, eager_ms = times
    bound_ms, bound_by = bound(flop, nbytes, peak)
    return {"name": name, "graph_ms": graph_ms, "eager_ms": eager_ms,
            "launch_ms": eager_ms - graph_ms, "gflop": flop / 1e9,
            "mbytes": nbytes / 1e6, "bound_ms": bound_ms,
            "bound_by": bound_by, "share": bound_ms / graph_ms}


def run_breakdown(B1, B2, C, TR, device=None, seed=3):
    """Time every row of the TPU script, under its names and in its order,
    on the card: the five kernel rows, the dense GEMM loop at both
    precisions, the elementwise pass and the production kernel. Inputs are
    drawn from ``seed`` with numpy as the script draws them. Returns one
    dict a row (``graph_ms``, ``eager_ms``, ``bound_ms``, ``share`` ...)."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError(f"the breakdown times CUDA kernels; it has no "
                         f"{device.type} mode")
    rng = np.random.default_rng(seed)

    def dev(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    xb = dev(rng.normal(size=(B1, B2, C)))
    W = weights_from_script(rng.normal(size=(F, F * C, C)).astype(np.float32),
                            device)
    rows = []
    for name, mode, prec in KERNEL_ROWS:
        apply = make_breakdown(mode, prec, TR)
        rows.append(_row(name, time_chain(lambda v: apply(v, W), xb),
                         *stencil_work(mode, prec, B1, B2, C)))

    # tensor-core / CUDA-core calibration: (v @ Wd) @ Wd.T, 96 calls of
    # 2/3 the stencil's FLOPs each (96 ~= 64 * 1.5), as in the script
    M = B1 * B2
    A = dev(rng.normal(size=(M, F * C)))
    Wd = dev(rng.normal(size=(F * C, C)))
    gemm_flop = 2.0 * 2 * M * F * C * C
    gemm_bytes = 4 * (2 * M * F * C + F * C * C)
    for name, prec, peak in (("dense gemm x3/highest", "highest", PEAK_F32),
                             ("dense gemm x3/default", "high", PEAK_TF32)):
        with matmul_precision(prec):
            times = time_chain(lambda v: (v @ Wd) @ Wd.T, A, n=96)
        rows.append(_row(name, times, gemm_flop, gemm_bytes, peak))

    # HBM calibration: read and write x once
    rows.append(_row("elementwise scale (HBM r+w)",
                     time_chain(lambda v: v * 1.000001, xb),
                     0.0, 8 * B1 * B2 * C, PEAK_F32))

    W4 = dev(rng.normal(size=(F, F, C, C)))
    rows.append(_row(PRODUCTION,
                     time_chain(lambda v: stencil.conv_blocked(v, W4), xb),
                     *stencil_work("full", "highest", B1, B2, C)))
    return rows


_SASS_LINE = re.compile(
    r"/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)((?:\.\w+)*)")
_INSTANCE = re.compile(r"stencil2d_kernelI([fd])Li(\d+)ELi(\d+)ELi(\d)ELb([01])E")
_INSTANCE3D = re.compile(r"stencil3d_igemmI([fd])Li(\d+)ELi(\d+)ELi(\d+)"
                         r"ELi(\d+)ELi(\d+)ELi(\d+)ELb([01])E")
_NAMED = ((re.compile(r"stencil3d_v1\d*stencil3d_kernelI([fd])Li(\d)E"),
           "stencil3d_v1 {} F{}"),
          (re.compile(r"reduce_splitsI([fd])E"), "reduce_splits {}"))
SASS_OPS = ("LDS", "STS", "FFMA", "HMMA", "LDG", "BAR")
# stencil3d's: every shared load, its 16-byte ones, FMAs in each precision
SASS_OPS_3D = ("LDS", "LDS.128", "FFMA", "DFMA", "LDGSTS", "BAR")


def instance_name(mangled):
    """"float32 F3 TH8 full highest" for an instance of the tiled 2D
    kernel (csrc/stencil2d_tile.cuh), else the name as it is."""
    m = _INSTANCE3D.search(mangled)
    if m:
        t, bm, bn, tm, tn, bk, stages, vec = m.groups()
        return (f"stencil3d {'float32' if t == 'f' else 'float64'} "
                f"BM{bm} BN{bn} TM{tm} TN{tn} BK{bk} S{stages} "
                f"{'vec' if vec == '1' else 'scalar'}")
    for pattern, fmt in _NAMED:
        m = pattern.search(mangled)
        if m:
            return fmt.format("float32" if m.group(1) == "f" else "float64",
                              *m.groups()[1:])
    m = _INSTANCE.search(mangled)
    if not m:
        return mangled
    t, f, th, mode, tf32 = m.groups()
    return (f"{'float32' if t == 'f' else 'float64'} F{f} TH{th} "
            f"{MODES[int(mode)]} {PRECISIONS[int(tf32)]}")


def sass_counts(sass, ops=SASS_OPS):
    """{kernel: {opcode: count}} of the SASS listing ``sass`` (the text
    ``cuobjdump -sass`` prints), for the opcodes ``ops``: the static
    count of each instruction in each kernel, so per chunk for the
    unrolled sweep of the tiled kernel. An opcode counts every variant
    ("LDS" counts LDS.U.128 too); "LDS.128" counts the variants whose
    last suffix is .128."""
    counts, name = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            name = instance_name(ln.split("Function :")[1].strip())
            counts[name] = dict.fromkeys(ops, 0)
            continue
        m = _SASS_LINE.search(ln)
        if name is None or not m:
            continue
        for op in ops:
            base, _, width = op.partition(".")
            if m.group(1) == base and (
                    not width or m.group(2).endswith("." + width)):
                counts[name][op] += 1
    return counts


def library_sass(lib, ops=SASS_OPS):
    """``cuobjdump -sass`` of a built CudaLibrary, as sass_counts, or
    None where the CUDA toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if lib.path is None or not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", str(lib.path)], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    return sass_counts(out, ops)


def card_line():
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    return out[0] if out else "nvidia-smi: no output"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("TR", nargs="?", type=int, default=16, choices=TILE_ROWS,
                    help="the kernel's tile rows (default 16)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the breakdown times CUDA kernels and needs a "
                           "CUDA device")
    print(f"{torch.cuda.get_device_name(0)} | {card_line()}")
    print("shape ({},{},{}) TR={}".format(*SHAPE, args.TR))
    for r in run_breakdown(*SHAPE, args.TR):
        print(f"{r['name']:<54s} {r['graph_ms']:8.4f} ms  eager "
              f"{r['eager_ms']:8.4f} ms  bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})  {100 * r['share']:5.1f}% of the bound",
              flush=True)


if __name__ == "__main__":
    main()
