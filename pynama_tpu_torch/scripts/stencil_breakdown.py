"""Where the time of the 2D stencil kernel goes on the card: the port of
scripts/stencil_breakdown_tpu.py.

    python -m pynama_tpu_torch.scripts.stencil_breakdown [TR]

At the cavity's fine K shape (97 x 97 blocks, 128 -> 128 channels, F = 3,
float32) it times the modes of ``csrc/stencil_breakdown.cu`` (full,
fill-only and mm-only, in IEEE float32 and in TF32), a dense GEMM loop of
the same FLOPs, an elementwise pass that reads and writes x once, the
production kernel ``stencil.conv_blocked`` (stencil2d), stencil2d's first
design (``stencil.KERNEL.v1``) and the breakdown's first design (the
``[v1]`` rows), each as a chain of 64 applies ``v = apply(v, W)``; then
cuDNN's convolution with TF32 off and on, the library yardsticks. The
breakdown takes apart the design that production runs, stencil2d.cu's
implicit GEMM: its highest rows are a copy of stencil2d's tile (full at
TR 8 is stencil2d's own instance and plan, bitwise), its default rows the
same staging feeding wgmma TF32 products. TR selects the tile's
positions: 8 is production's tile, 16 one of twice the positions; the
default is 16, as in the TPU script. The ``[v1]`` rows are the first
design, the halo-tile kernel of ``csrc/stencil2d_tile.cuh`` that the
breakdown took apart until production left it (TR its tile rows). Each
row prints its time as one CUDA graph of the chain (the counterpart of
the script's jitted ``fori_loop``) and launched eagerly, the card's bound
for the same work and the share of the bound reached. It needs a CUDA
device.

The kernels have no CPU mode: ``make_breakdown``'s ``apply`` launches them
on CUDA tensors and raises on anything else. ``breakdown_plain`` is the
plain PyTorch version of every mode, for the tests and the checks on the
card.
"""

import argparse
import contextlib
import ctypes
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
# the design that production runs (stencil2d.cu's implicit GEMM), and the
# first one (the halo-tile kernel of stencil2d_tile.cuh)
DESIGNS = ("igemm", "v1")
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
V1 = "stencil2d v1 [the first design]"
CUDNN = {"highest": "cuDNN conv2d [TF32 off]",
         "default": "cuDNN conv2d [TF32 on]"}

# csrc/stencil_breakdown.cu's instances (STENCIL_BREAKDOWN_INSTANCES): id
# -> (precision, TR, BM, BN, TM, TN, BK, STAGES). highest: a thread sums
# TM x TN; 0 and 1 are stencil2d's float32 instances 0 and 1
# (stencil.INSTANCES2D), 2 and 3 the same tiles with twice the positions.
# default: a warpgroup owns TM rows, TN is the wgmma's N.
INSTANCES = {
    0: ("highest", 8, 128, 64, 8, 8, 16, 4),
    1: ("highest", 8, 256, 8, 8, 4, 8, 3),
    2: ("highest", 16, 256, 64, 8, 8, 16, 4),
    3: ("highest", 16, 512, 8, 8, 4, 8, 3),
    4: ("default", 8, 128, 64, 64, 64, 32, 4),
    5: ("default", 16, 256, 64, 128, 64, 32, 4),
}
# the blocks per SM that split_k aims at for the TR-16 IEEE tiles: one
# less than an SM holds at once, as stencil.FILL2D (2: 256 threads of
# stencil2d's instance-0 code, one block an SM; 3: 128 threads of
# instance 1's, three); never under one
FILL16 = {2: 1, 3: 2}


def _check_choice(mode, prec):
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    if prec not in PRECISIONS:
        raise ValueError(f"precision {prec!r} not in {PRECISIONS}")


def _check_shapes(xb, W):
    if xb.dim() != 3 or tuple(W.shape) != (F, F) + (xb.shape[-1],) * 2:
        raise ValueError(f"expected x (B1, B2, C) and W ({F}, {F}, C, C), "
                         f"got {tuple(xb.shape)} and {tuple(W.shape)}")


def _check_on_card(*ts):
    """Raise unless the tensors are float32, contiguous and on one CUDA
    device, as the kernels take them."""
    devices = [t.device for t in ts]
    if devices[0].type != "cuda" or len(set(devices)) > 1:
        raise ValueError(f"the breakdown kernel needs its tensors on one "
                         f"CUDA device, got {devices}; breakdown_plain is "
                         "its plain version")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError(f"float32 only, got {[t.dtype for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("the tensors must be contiguous")


def _check_tensors(xb, W):
    """Raise unless the kernels take (xb, W) as they are."""
    _check_shapes(xb, W)
    _check_on_card(xb, W)


def _tile_plan(instance, x_shape, split):
    """The stencil.Plan of ``instance`` for x (B1, B2, C): ``split`` capped
    at its chunks, or (None) split_k's with FILL16."""
    _, _, bm, bn, _, _, bk, _ = INSTANCES[instance]
    B1, B2, C = x_shape
    M = B1 * B2
    m_tiles, n_tiles = -(-M // bm), -(-C // bn)
    chunks = F * F * -(-C // bk)
    if split is None:
        split = stencil.split_k(m_tiles * n_tiles, chunks, FILL16[instance])
    return stencil.Plan(instance, bm, bn, bk, M, m_tiles, n_tiles, chunks,
                        min(split, chunks), C % 4 == 0)


def breakdown_plan(prec, TR, x_shape):
    """How the breakdown computes x (B1, B2, C) at precision ``prec`` and
    tile rows TR: a stencil.Plan of INSTANCES. highest, TR 8 is
    stencil.plan2d's plan (stencil2d's instance, K split and vector path);
    TR 16 takes the same tile with twice the positions and split_k's split
    for it. default takes the TF32 tile of its TR with the highest plan's
    split, capped at its own chunks. Pure, like plan2d."""
    _check_choice("full", prec)
    if TR not in TILE_ROWS:
        raise ValueError(f"tile rows TR={TR} not in {TILE_ROWS}")
    x_shape = tuple(x_shape)
    if len(x_shape) != 3:
        raise ValueError(f"expected x (B1, B2, C), got {x_shape}")
    C = x_shape[-1]
    plan = stencil.plan2d(x_shape, (F, F, C, C), torch.float32)
    if TR == 16:
        plan = _tile_plan(plan.instance + 2, x_shape, None)
    if prec == "default":
        plan = _tile_plan(4 if TR == 8 else 5, x_shape, plan.split)
    return plan


def prepare_weights(W, instance):
    """W (3, 3, C, C) as TF32 instance ``instance`` reads it: each tap
    transposed (Cout x Cin, Cin contiguous: tf32 wgmma takes K-major
    operands only), rounded to TF32 to nearest (cvt.rna, as round_tf32)
    and padded with zeros to whole tiles, (9, Np, Kp). Launched by the
    breakdown library's ``stencil_breakdown_prepare_w``; CUDA only. Done
    once per W, outside the timed chain, as an operator's setup would."""
    C = W.shape[-1]
    if tuple(W.shape) != (F, F, C, C):
        raise ValueError(f"expected W ({F}, {F}, C, C), got "
                         f"{tuple(W.shape)}")
    _check_on_card(W)
    prec, _, _, bn, _, _, bk, _ = INSTANCES[instance]
    if prec != "default":
        raise ValueError(f"instance {instance} is not a TF32 instance")
    wt = torch.empty((F * F, -(-C // bn) * bn, -(-C // bk) * bk),
                     dtype=torch.float32, device=W.device)
    fn = stencil.BREAKDOWN.build().stencil_breakdown_prepare_w
    err = stencil._on_device(W.device, lambda s: fn(
        W.data_ptr(), wt.data_ptr(), C, instance, s))
    if err != 0:
        raise RuntimeError(f"stencil_breakdown_prepare_w (instance "
                           f"{instance}) failed: CUDA error {err} (C {C})")
    return wt


def _make_v1(mode, prec, TR):
    """make_breakdown's first design: stencil_breakdown_v1_f32."""
    mode_id = MODES.index(mode)
    prec_id = 0 if mode == "fill" else PRECISIONS.index(prec)

    def apply(xb, W):
        _check_tensors(xb, W)
        fn = stencil.BREAKDOWN.build().stencil_breakdown_v1_f32
        y = torch.empty_like(xb)
        err = stencil._on_device(xb.device, lambda s: fn(
            xb.data_ptr(), W.data_ptr(), y.data_ptr(), *xb.shape, TR,
            mode_id, prec_id, s))
        if err != 0:
            raise RuntimeError(f"stencil_breakdown_v1 ({mode}, {prec}, TR "
                               f"{TR}) launch failed: CUDA error {err} "
                               f"(x {tuple(xb.shape)})")
        stencil.BREAKDOWN.count(("v1", mode, prec if mode != "fill" else None,
                                 TR, tuple(xb.shape)))
        return y

    return apply


def make_breakdown(mode, prec, TR, design="igemm"):
    """The breakdown kernel in one mode, as the script's ``make_pallas``:
    returns ``apply(xb, W) -> y`` for x (B1, B2, C) and W (3, 3, C, C),
    float32, contiguous, on one CUDA device. ``prec`` is "highest" (IEEE
    float32 FMA) or "default" (TF32 tensor cores); TR, the tile rows, is 8
    or 16. ``design`` "igemm" takes apart stencil2d's implicit GEMM with
    the plan of ``breakdown_plan``; fill stages as the precision's family
    does. "v1" launches the first design, whose fill ignores ``prec``. The
    default precision reads W^T (``prepare_weights``), prepared at the
    first call with a W and kept for the calls with the same W."""
    _check_choice(mode, prec)
    if TR not in TILE_ROWS:
        raise ValueError(f"tile rows TR={TR} not in {TILE_ROWS}")
    if design not in DESIGNS:
        raise ValueError(f"design {design!r} not in {DESIGNS}")
    if design == "v1":
        return _make_v1(mode, prec, TR)
    mode_id = MODES.index(mode)
    prepared = {}  # the last W's key -> its W^T

    def apply(xb, W):
        _check_tensors(xb, W)
        plan = breakdown_plan(prec, TR, xb.shape)
        fn = stencil.BREAKDOWN.build().stencil_breakdown_f32
        w = W
        if prec == "default":
            key = (W.data_ptr(), W._version, tuple(W.shape), W.device,
                   plan.instance)
            if key not in prepared:
                prepared.clear()
                prepared[key] = prepare_weights(W, plan.instance)
            w = prepared[key]
        y = torch.empty_like(xb)
        ws, part = 0, None   # part: the splits' partial sums
        if plan.split > 1 and mode != "fill":
            part = torch.empty((plan.split, y.numel()), dtype=y.dtype,
                               device=y.device)
            ws = part.data_ptr()
        ptrs = (xb.data_ptr(), w.data_ptr(), y.data_ptr(), ws)
        vec = plan.vec and not (ptrs[0] | ptrs[1] | ptrs[2] | ws) % 16
        err = stencil._on_device(xb.device, lambda s: fn(
            *ptrs, *xb.shape, plan.instance, plan.split, int(vec), mode_id,
            s))
        if err != 0:
            raise RuntimeError(f"stencil_breakdown ({mode}, {prec}, TR {TR})"
                               f" launch failed: CUDA error {err} "
                               f"(x {tuple(xb.shape)}, {plan})")
        stencil.BREAKDOWN.count(("igemm", mode, prec, TR, tuple(xb.shape)))
        return y

    return apply


def instances():
    """The built library's instance table, as INSTANCES: {id: ((precision,
    TR, BM, BN, TM, TN, BK, STAGES), threads, shared bytes)}."""
    info = stencil.BREAKDOWN.build().stencil_breakdown_instance
    out, table = (ctypes.c_int * 10)(), {}
    for i in INSTANCES:
        if info(i, out) != 0:
            raise RuntimeError(f"stencil_breakdown has no instance {i}")
        prec, *tile, threads, smem = list(out)
        table[i] = ((PRECISIONS[prec], *tile), threads, smem)
    return table


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


def _inputs(B1, B2, C, device, seed):
    """The script's inputs (x, its W as the port's (F, F, C, C)) and the
    generator, on ``device`` (CUDA only)."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError(f"the breakdown times CUDA kernels; it has no "
                         f"{device.type} mode")
    rng = np.random.default_rng(seed)
    xb = torch.as_tensor(rng.normal(size=(B1, B2, C)), dtype=torch.float32,
                         device=device)
    W = weights_from_script(rng.normal(size=(F, F * C, C)).astype(np.float32),
                            device)
    return xb, W, rng


def prepare_ms(W, TR, reps=10):
    """ms of one ``prepare_weights`` of W for the TF32 tile of TR (CUDA
    events, after a warm call)."""
    instance = 4 if TR == 8 else 5
    prepare_weights(W, instance)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        prepare_weights(W, instance)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def run_breakdown(B1, B2, C, TR, device=None, seed=3):
    """Time every row of the TPU script, under its names and in its order,
    on the card: the five kernel rows of the design that production runs,
    the dense GEMM loop at both precisions, the elementwise pass and the
    production kernel; then stencil2d's first design and the breakdown's
    first design, its five rows suffixed " [v1]". Inputs are drawn from
    ``seed`` with numpy as the script draws them. Returns one dict a row
    (``graph_ms``, ``eager_ms``, ``bound_ms``, ``share`` ...); the default
    rows of the first five also give ``prepare_ms``, the W^T preparation
    that their chain leaves out (``note``)."""
    xb, W, rng = _inputs(B1, B2, C, device, seed)
    device = xb.device

    def dev(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    def kernel_rows(design, suffix):
        rows = []
        for name, mode, prec in KERNEL_ROWS:
            apply = make_breakdown(mode, prec, TR, design)
            rows.append(_row(name + suffix,
                             time_chain(lambda v: apply(v, W), xb),
                             *stencil_work(mode, prec, B1, B2, C)))
        return rows

    rows = kernel_rows("igemm", "")
    prep = prepare_ms(W, TR)
    for r, (_, _, prec) in zip(rows, KERNEL_ROWS):
        if prec == "default":
            r["prepare_ms"] = prep
            r["note"] = (f"W^T prepared once outside the chain: {prep:.4f} "
                         "ms")

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
    rows.append(_row(V1, time_chain(lambda v: stencil.KERNEL.v1(v, W4), xb),
                     *stencil_work("full", "highest", B1, B2, C)))
    return rows + kernel_rows("v1", " [v1]")


@contextlib.contextmanager
def cudnn_tf32(on):
    """cuDNN's float32 convolutions in TF32 (``on``) or not inside the
    block, restored after it."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def cudnn_rows(B1, B2, C, device=None, seed=3):
    """The library yardsticks of the full rows: the same contraction as one
    cuDNN convolution (NCHW, ``F.conv2d``) chained as the kernel rows are,
    with TF32 off (beside the highest rows) and on (beside the default
    rows). The port never calls it."""
    xb, W, _ = _inputs(B1, B2, C, device, seed)
    xn = xb.permute(2, 0, 1).unsqueeze(0).contiguous()
    wn = W.permute(3, 2, 0, 1).contiguous()
    rows = []
    for prec in PRECISIONS:
        with cudnn_tf32(prec == "default"):
            times = time_chain(
                lambda v: torch.nn.functional.conv2d(v, wn, padding=Q), xn)
        rows.append(_row(CUDNN[prec], times,
                         *stencil_work("full", prec, B1, B2, C)))
    return rows


_SASS_LINE = re.compile(
    r"/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)((?:\.\w+)*)")
_INSTANCE = re.compile(r"stencil2d_kernelI([fd])Li(\d+)ELi(\d+)ELi(\d)ELb([01])E")
_IGEMM = re.compile(r"stencil([23])d_igemmI([fd])Li(\d+)ELi(\d+)ELi(\d+)"
                    r"ELi(\d+)ELi(\d+)ELi(\d+)ELb([01])E")
# the breakdown's two families: BM, BN, TM, TN, BK, STAGES, VEC, MODE and
# BM, BN, WM, BK, STAGES, VEC, MODE
_BREAKDOWN = (
    (re.compile(r"breakdown_igemmILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)"
                r"ELi(\d+)ELb([01])ELi(\d)E"),
     "breakdown highest BM{} BN{} TM{} TN{} BK{} S{} {} {}"),
    (re.compile(r"breakdown_wgmmaILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)"
                r"ELb([01])ELi(\d)E"),
     "breakdown default BM{} BN{} WM{} BK{} S{} {} {}"))
_NAMED = ((re.compile(r"stencil3d_v1\d*stencil3d_kernelI([fd])Li(\d)E"),
           "stencil3d_v1 {} F{}"),
          (re.compile(r"reduce_splitsI([fd])E"), "reduce_splits {}"),
          (re.compile(r"prepare_wtEPK([fd])"), "breakdown prepare_wt {}"))
SASS_OPS = ("LDS", "STS", "FFMA", "HMMA", "LDG", "BAR")
# the implicit-GEMM kernels': every shared load, its 16-byte ones, FMAs in
# each precision
SASS_OPS_3D = ("LDS", "LDS.128", "FFMA", "DFMA", "LDGSTS", "BAR")
# the breakdown's: shared loads and stores, FMAs, wgmma (HGMMA), cp.async
SASS_OPS_BREAKDOWN = ("LDS", "LDS.128", "STS", "FFMA", "HGMMA", "LDGSTS",
                      "BAR")


def instance_name(mangled):
    """"float32 F3 TH8 full highest" for an instance of the tiled 2D
    kernel (csrc/stencil2d_tile.cuh), "stencil2d float32 BM128 BN64 ..."
    for one of an implicit-GEMM kernel, "breakdown highest BM128 ... vec
    full" or "breakdown default BM128 BN64 WM64 ..." for one of the
    breakdown's, else the name as it is."""
    m = _IGEMM.search(mangled)
    if m:
        dim, t, bm, bn, tm, tn, bk, stages, vec = m.groups()
        return (f"stencil{dim}d {'float32' if t == 'f' else 'float64'} "
                f"BM{bm} BN{bn} TM{tm} TN{tn} BK{bk} S{stages} "
                f"{'vec' if vec == '1' else 'scalar'}")
    for pattern, fmt in _BREAKDOWN:
        m = pattern.search(mangled)
        if m:
            *tile, vec, mode = m.groups()
            return fmt.format(*tile, "vec" if vec == "1" else "scalar",
                              MODES[int(mode)])
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
    for r in run_breakdown(*SHAPE, args.TR) + cudnn_rows(*SHAPE):
        print(f"{r['name']:<54s} {r['graph_ms']:8.4f} ms  eager "
              f"{r['eager_ms']:8.4f} ms  bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})  {100 * r['share']:5.1f}% of the bound"
              + (f"  [{r['note']}]" if "note" in r else ""), flush=True)


if __name__ == "__main__":
    main()
