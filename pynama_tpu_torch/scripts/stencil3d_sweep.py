"""Time every instance and K split of the 3D stencil kernel on the card.

    python -m pynama_tpu_torch.scripts.stencil3d_sweep [--out FILE]

At each shape channel3d's main path gives ``stencil.conv_blocked`` (the
3D rows of PERF.md's shape table, float32), every plan that
``stencil.plan3d`` accepts for an instance of the shape's dtype, with a K
split from SPLITS, is checked against the plain version (relative 1e-5)
and timed with CUDA events, launched eagerly and as device time (the
calls captured into a CUDA graph, in brackets); the busiest shape also
in float64 (relative 1e-12). The first design (``KERNEL3D.v1``) is
timed the same way, and cuDNN's ``F.conv3d`` with TF32 off, which the
port never calls, eagerly. Each shape prints the plan of least device
time beside the one plan3d picks. It needs a CUDA device; ``--out``
writes every row as JSON.
"""

import argparse
import json
import math

import numpy as np
import torch
import torch.nn.functional as tnf

from pynama_tpu_torch.ops import stencil

C = 192
# (x, W) of every 3D shape channel3d logs (PERF.md section 6)
SHAPES = tuple(
    [((41, 17, 17, C), (3, 3, 3, C, C)),
     ((21, 9, 9, C), (3, 3, 3, C, C)),
     ((41, 17, 17, C), (3, 3, 3, C, 2 * C)),
     ((41, 17, 17, 2 * C), (3, 3, 3, 2 * C, C)),
     ((11, 5, 5, C), (3, 3, 3, C, C)),
     ((6, 3, 3, C), (3, 3, 3, C, C))]
    + [((b1, b2, b2, 24), (5, 5, 5, 24, 24))
       for b1, b2 in ((81, 33), (41, 17), (21, 9), (11, 5), (6, 3))]
    + [((6, 3, 3, 24), (3, 3, 3, 24, 24))])
SPLITS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 44, 64)
PEAK_FLOPS = 67e12   # H100 SXM float32 without tensor cores, 700 W


def event_ms(fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps=20, replays=3):
    """Device time per call of ``fn``: ``reps`` calls captured into one
    CUDA graph, replayed; no host time per call is in it."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def conv3d_call(x, W):
    """The same contraction as one cuDNN convolution (NCDHW)."""
    xn = x.permute(3, 0, 1, 2).unsqueeze(0).contiguous()
    wn = W.permute(4, 3, 0, 1, 2).contiguous()
    return lambda: tnf.conv3d(xn, wn, padding=(W.shape[0] - 1) // 2)


def plans(xs, ws, dtype):
    """Every plan of the shape: each instance of the dtype, each split,
    and plan3d's own choice."""
    out = [stencil.plan3d(xs, ws, dtype)]
    for inst, spec in stencil.INSTANCES3D.items():
        if spec[0] != dtype:
            continue
        for split in SPLITS:
            try:
                p = stencil.plan3d(xs, ws, dtype, instance=inst, split=split)
            except ValueError:
                continue
            if (p.blocks <= 8 * stencil.SMS or split == 1) and p not in out:
                out.append(p)
    return out


def sweep(shapes=SHAPES, dtype=torch.float32, seed=0):
    torch.backends.cudnn.allow_tf32 = False
    k = stencil.KERNEL3D
    rows = []
    for xs, ws in shapes:
        rng = np.random.default_rng(seed)
        x = torch.as_tensor(rng.normal(size=xs), dtype=dtype, device="cuda")
        W = torch.as_tensor(rng.normal(size=ws), dtype=dtype, device="cuda")
        ref = stencil.conv_blocked_plain(x, W)
        scale = float(ref.abs().max())
        flops = 2.0 * math.prod(xs[:-1]) * math.prod(ws)
        tol = 1e-5 if dtype == torch.float32 else 1e-12
        chosen = stencil.plan3d(xs, ws, dtype)
        row = {"x": list(xs), "W": list(ws),
               "bound_ms": 1e3 * flops / PEAK_FLOPS,
               "v1_ms": event_ms(lambda: k.v1(x, W)),
               "v1_graph_ms": graph_ms(lambda: k.v1(x, W)),
               "library_ms": event_ms(conv3d_call(x, W)), "plans": []}
        for p in plans(xs, ws, dtype):
            err = float((k(x, W, p) - ref).abs().max()) / scale
            if not err <= tol:
                raise RuntimeError(f"{p} disagrees at x {xs}: {err:.3e}")
            row["plans"].append({"instance": p.instance, "split": p.split,
                                 "blocks": p.blocks, "rel_err": err,
                                 "ms": event_ms(lambda: k(x, W, p)),
                                 "graph_ms": graph_ms(lambda: k(x, W, p)),
                                 "chosen": p == chosen})
        best = min(row["plans"], key=lambda r: r["graph_ms"])
        pick = next(r for r in row["plans"] if r["chosen"])
        rows.append(row)
        print(f"x {str(xs):18s} -> {ws[-1]:3d} F{ws[0]}: v1 "
              f"{row['v1_ms']:.4f} ({row['v1_graph_ms']:.4f}) cuDNN "
              f"{row['library_ms']:.4f} bound {row['bound_ms']:.4f} | plan3d "
              f"inst {pick['instance']} split {pick['split']} "
              f"{pick['ms']:.4f} ({pick['graph_ms']:.4f}) | best inst "
              f"{best['instance']} split {best['split']} {best['ms']:.4f} "
              f"({best['graph_ms']:.4f}) ms", flush=True)
        for r in sorted(row["plans"], key=lambda r: r["graph_ms"])[:6]:
            print(f"    inst {r['instance']} split {r['split']:2d} blocks "
                  f"{r['blocks']:4d}: {r['ms']:.4f} ({r['graph_ms']:.4f}) ms",
                  flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="write the rows as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("stencil3d_sweep needs a CUDA device")
    rows = sweep() + sweep(SHAPES[:1], torch.float64)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": torch.cuda.get_device_name(0),
                       "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
