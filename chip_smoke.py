#!/usr/bin/env python3
"""Drive pynama_tpu_torch on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each timed; any failure exits non-zero:

1. the card: name and power limit (nvidia-smi), full-float32 matmuls;
2. the build of the CUDA stencil kernel (csrc/stencil2d.cu) with nvcc;
3. the kernel against its plain PyTorch version at every shape the
   384x384 cavity gives it (float32, plus one float64 shape), with its
   time, the plain version's, F.conv2d's (cuDNN, TF32 off: a yardstick
   the port never calls) and the card's bound;
4. the main path: CavityProblem(cfg).setup().run(max_steps=3) at 384x384
   Q2 elements (1,182,722 velocity dofs), float32, multigrid-CG KLE,
   with the kernel's launch count reset just before and read just after;
5. a 16x16 cavity run twice on the card, through the kernel and with the
   plain version forced, whose vorticities must agree;
6. only with --profile: the 384x384 cavity again, its step 3 under
   torch.profiler. The device busy share is the summed device time of
   that step's kernels over the wall time of step 3 in phase 4, which ran
   the same work (same stencil launches and CG iterations, checked)
   without the profiler.

The last lines are a JSON line of every result, a JSON "kernels" line,
the nvidia-smi line and {"ok": true, "device": {...}}.
"""

import argparse
import json
import math
import subprocess
import sys
import time

# published H100 SXM peaks at 700 W (NVIDIA data sheet): float32 without
# tensor cores, float64 on the tensor cores (IEEE double, the card's
# fastest float64 rate), HBM3 bandwidth
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12}
PEAK_BYTES = 3.35e12
TOL = {"float32": 1e-5, "float64": 1e-12}


def cavity_config(nelem):
    """bench.py's cavity_config() (copied), with tolerances that accept
    every attempt and dt held at 5e-5 (dt0 = max-dt). bench.py steps at
    1e-3, above the explicit stability limit at 384x384 (on purpose
    there: its end state is not checked); at 1e-3 the float32 vorticity
    is no longer finite after 3 steps. The limit scales as h^2 and lies
    between 0.4 and 0.6 at 8x8 (tests/test_torch_cavity_dt_limit.py,
    tests/test_torch_cavity_setup.py), so between about 1.7e-4 and
    2.6e-4 at 384x384."""
    return {
        "multigrid": True,
        "name": "cavity-smoke",
        "material-properties": {"rho": 1.0, "mu": 0.01},
        "domain": {
            "ngl": 3,
            "box-mesh": {"nelem": [nelem, nelem], "lower": [0, 0],
                         "upper": [1, 1]},
        },
        "time-solver": {"start-time": 0.0, "end-time": 100.0,
                        "max-steps": 10000, "dt0": 5e-5, "max-dt": 5e-5,
                        "atol": 1e12, "rtol": 1e12},
        "boundary-conditions": {"no-slip": {"up": [1.0, 0.0]}},
        "kle-rtol": 1e-5,
        "kle-maxiter": 4000,
    }


# (label, B1, B2, Cin, Cout, F): the slice's applies at 384x384, ngl=3,
# super-block factor 4 (97x97 fine blocks), and the parity-layout patch
# apply of the lam_max power iterations (385x385 blocks, 8 channels)
SHAPES = [
    ("K / patch, fine", 97, 97, 128, 128, 3),
    ("Rw, fine", 97, 97, 64, 128, 3),
    ("Curl, fine", 97, 97, 128, 64, 3),
    ("SrT, fine", 97, 97, 128, 192, 3),
    ("DivSrT, fine", 97, 97, 192, 128, 3),
    ("K / patch, MG level 1", 49, 49, 128, 128, 3),
    ("K / patch, MG level 2", 25, 25, 128, 128, 3),
    ("K / patch, MG level 3", 13, 13, 128, 128, 3),
    ("patch, parity layout (lam_max setup)", 385, 385, 8, 8, 5),
]


def fail(msg):
    raise RuntimeError(msg)


def event_ms(torch, fn, reps, warmup=3):
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


def phase_kernels(torch, stencil, out):
    import numpy as np
    import torch.nn.functional as tnf

    torch.backends.cudnn.allow_tf32 = False
    rows = []
    cases = [(s, torch.float32) for s in SHAPES] + [(SHAPES[0], torch.float64)]
    for (label, B1, B2, cin, cout, F), dtype in cases:
        rng = np.random.default_rng(B1 * 1000 + cin + cout + F)
        x = torch.as_tensor(rng.normal(size=(B1, B2, cin)), dtype=dtype,
                            device="cuda")
        W = torch.as_tensor(rng.normal(size=(F, F, cin, cout)), dtype=dtype,
                            device="cuda")
        y = stencil.KERNEL(x, W)
        ref = stencil.conv_blocked_plain(x, W)
        torch.cuda.synchronize()
        abs_err = float((y - ref).abs().max())
        rel_err = abs_err / float(ref.abs().max())
        name = str(dtype).replace("torch.", "")
        if not rel_err <= TOL[name]:
            fail(f"kernel disagrees at {label} {name}: {rel_err:.3e}")
        # library yardstick: the same contraction as an NCHW convolution
        xn = x.permute(2, 0, 1).unsqueeze(0).contiguous()
        wn = W.permute(3, 2, 0, 1).contiguous()
        Q = (F - 1) // 2
        lib = tnf.conv2d(xn, wn, padding=Q)[0].permute(1, 2, 0)
        lib_err = float((lib - ref).abs().max()) / float(ref.abs().max())
        reps = 20 if B1 * B2 * cin * cout < 5e8 else 10
        k_ms = event_ms(torch, lambda: stencil.KERNEL(x, W), reps)
        p_ms = event_ms(torch, lambda: stencil.conv_blocked_plain(x, W), reps)
        l_ms = event_ms(torch, lambda: tnf.conv2d(xn, wn, padding=Q), reps)
        size = x.element_size()
        flops = 2.0 * B1 * B2 * F * F * cin * cout
        nbytes = size * (B1 * B2 * cin + F * F * cin * cout + B1 * B2 * cout)
        t_ops, t_bytes = flops / PEAK_FLOPS[name], nbytes / PEAK_BYTES
        row = {
            "shape": label, "dtype": name, "x": [B1, B2, cin],
            "W": [F, F, cin, cout], "max_abs_err": abs_err,
            "max_rel_err": rel_err, "library_rel_err": lib_err,
            "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
        }
        rows.append(row)
        print(f"  {label:40s} {name}  rel err {rel_err:.2e}  kernel "
              f"{k_ms:.4f} ms  plain {p_ms:.4f} ms  conv2d {l_ms:.4f} ms  "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})",
              flush=True)
    out["kernel_shapes"] = rows
    return rows


def phase_slice(torch, stencil, CavityProblem, out):
    cfg = cavity_config(384)
    marks = []

    def callback(n, t, dt, vort, vel):
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), stencil.KERNEL.launches,
                      len(p.cg_iters)))

    stencil.KERNEL.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p = CavityProblem(cfg).setup()
    torch.cuda.synchronize()
    t_setup = time.perf_counter()
    setup_launches = stencil.KERNEL.launches
    vort, t, n = p.run(max_steps=3, callback=callback)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = stencil.KERNEL.launches

    dofs = p.mesh.n_nodes * 2
    norm = float(torch.linalg.norm(vort))
    if n != 3 or len(marks) != 3:
        fail(f"expected 3 accepted steps, got {n}")
    if not math.isfinite(norm) or not bool(torch.isfinite(vort).all()):
        fail("final vorticity is not finite")
    step_ms = [1e3 * (b[0] - a[0]) for a, b in zip(marks, marks[1:])]
    step_launches = [b[1] - a[1] for a, b in zip(marks, marks[1:])]
    step_iters = [p.cg_iters[a[2]:b[2]] for a, b in zip(marks, marks[1:])]
    if not all(s > 0 for s in step_launches) or launches <= 0:
        fail("the main path launched no stencil kernel")
    iters = p.cg_iters
    res = {
        "nelem": 384, "ngl": 3, "velocity_dofs": dofs, "dtype": "float32",
        "steps": n, "t": t, "setup_s": t_setup - t0,
        "first_step_incl_initial_rhs_ms": 1e3 * (marks[0][0] - t_setup),
        "ms_per_step": sum(step_ms) / len(step_ms), "step_ms": step_ms,
        "run_s_incl_final_solve": t_end - t_setup,
        "kle_solves": len(iters), "cg_iters_per_solve": sum(iters) / len(iters),
        "cg_iters": iters, "stencil_launches": launches,
        "stencil_launches_setup": setup_launches,
        "stencil_launches_per_step": step_launches,
        "cg_iters_per_step": step_iters,
        "vort_norm": norm, "mg_ratios": p.mg.ratios,
        "lam_max": p.mg.lam_max,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    out["slice"] = res
    print(f"  {dofs} velocity dofs, setup {res['setup_s']:.2f} s, "
          f"{res['ms_per_step']:.1f} ms/step (steps 2-3), first step incl. "
          f"initial RHS {res['first_step_incl_initial_rhs_ms']:.1f} ms", flush=True)
    print(f"  {len(iters)} KLE solves, {res['cg_iters_per_solve']:.2f} CG "
          f"iterations per solve (max {max(iters)}), stencil launches per "
          f"step {step_launches}, total {launches}; |vort| = {norm:.6e}",
          flush=True)
    return res


def phase_plain_compare(torch, stencil, CavityProblem, out):
    cfg = cavity_config(16)
    runs = {}
    for mode in ("kernel", "plain"):
        before = stencil.KERNEL.launches
        saved = stencil.conv_blocked
        if mode == "plain":
            stencil.conv_blocked = stencil.conv_blocked_plain
        try:
            p = CavityProblem(cfg).setup()
            vort, t, n = p.run(max_steps=3)
        finally:
            stencil.conv_blocked = saved
        runs[mode] = (vort, t, n, stencil.KERNEL.launches - before)
    (vk, tk, nk, lk), (vp, tp, np_, lp) = runs["kernel"], runs["plain"]
    rel = float(torch.linalg.norm(vk - vp) / torch.linalg.norm(vp))
    out["plain_compare"] = {"nelem": 16, "steps": [nk, np_], "t": [tk, tp],
                            "vort_rel_diff": rel,
                            "launches": [lk, lp]}
    print(f"  16x16: steps {nk}/{np_}, vorticity rel diff {rel:.3e} "
          f"(limit 1e-4), launches kernel {lk} / plain {lp}", flush=True)
    if nk != np_ or lk <= 0 or lp != 0:
        fail("kernel and plain 16x16 runs differ in steps or launches")
    if not rel <= 1e-4:
        fail(f"16x16 vorticity kernel vs plain: {rel:.3e} > 1e-4")


def phase_profile(torch, stencil, CavityProblem, sl, out):
    from torch.profiler import ProfilerActivity, profile

    p = CavityProblem(cavity_config(384)).setup()
    prof = profile(activities=[ProfilerActivity.CUDA])
    marks = []

    def callback(n, t, dt, vort, vel):
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), stencil.KERNEL.launches,
                      len(p.cg_iters)))
        if n == 2:
            prof.start()
        elif n == 3:
            prof.stop()

    p.run(max_steps=3, callback=callback)
    (_, l2, s2), (t3, l3, s3) = marks[1], marks[2]
    launches, iters = l3 - l2, p.cg_iters[s2:s3]
    if launches != sl["stencil_launches_per_step"][1] or \
            iters != sl["cg_iters_per_step"][1]:
        fail(f"profiled step 3 ({launches} launches, CG {iters}) is not the "
             f"work of phase 4's step 3 "
             f"({sl['stencil_launches_per_step'][1]}, "
             f"{sl['cg_iters_per_step'][1]})")
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
        if "CUDA" in str(e.device_type) and dev_us > 0:
            rows.append({"name": e.key, "calls": e.count,
                         "device_ms": dev_us / 1e3})
    rows.sort(key=lambda r: -r["device_ms"])
    dev_ms = sum(r["device_ms"] for r in rows)
    if dev_ms <= 0:
        fail("the profiler recorded no device time")
    wall_ms = sl["step_ms"][1]
    stencil_ms = sum(r["device_ms"] for r in rows if "stencil2d" in r["name"])
    res = {
        "step": 3, "step_wall_ms": wall_ms,
        "profiled_step_wall_ms": 1e3 * (t3 - marks[1][0]),
        "device_kernel_ms": dev_ms, "device_busy_share": dev_ms / wall_ms,
        "stencil2d_device_ms": stencil_ms, "stencil_launches": launches,
        "cg_iters": iters, "top": rows[:25],
    }
    out["profile"] = res
    print(f"  step 3: {wall_ms:.1f} ms wall without the profiler "
          f"({res['profiled_step_wall_ms']:.1f} ms with it), kernels "
          f"{dev_ms:.1f} ms, device busy {100 * dev_ms / wall_ms:.1f}%; "
          f"stencil2d {stencil_ms:.1f} ms over {launches} launches",
          flush=True)
    for r in rows[:12]:
        print(f"  {r['device_ms']:9.2f} ms {r['calls']:7d}x  {r['name'][:80]}",
              flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="add phase 6: step 3 of the 384x384 cavity under "
                         "torch.profiler")
    args = ap.parse_args()
    t_all = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    # the port first: without it (a lone copy of this script) exit before
    # printing anything
    from pynama_tpu_torch.cases.cavity import CavityProblem
    from pynama_tpu_torch.ops import stencil

    phase_s = {}
    out = {}

    t0 = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    smi = smi[0] if smi else "nvidia-smi: no output"
    print(f"[1] card: {torch.cuda.get_device_name(0)} | {smi} | torch "
          f"{torch.__version__} CUDA {torch.version.cuda}", flush=True)
    if torch.get_float32_matmul_precision() != "highest" or \
            torch.backends.cuda.matmul.allow_tf32:
        fail("float32 matmuls are not full precision")
    phase_s["card"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    stencil.KERNEL.build()
    phase_s["build"] = time.perf_counter() - t0
    log = [ln for ln in stencil.KERNEL.build_log.splitlines()
           if "registers" in ln or "spill" in ln]
    print(f"[2] built {stencil.KERNEL.source.name} in "
          f"{stencil.KERNEL.build_seconds:.1f} s", flush=True)
    for ln in log:
        print("    " + ln.strip(), flush=True)

    t0 = time.perf_counter()
    print("[3] kernel vs plain version", flush=True)
    rows = phase_kernels(torch, stencil, out)
    phase_s["kernel_check"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    print("[4] main path: 384x384 cavity, 3 steps", flush=True)
    sl = phase_slice(torch, stencil, CavityProblem, out)
    phase_s["slice"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    print("[5] 16x16 cavity: kernel vs plain version on the card", flush=True)
    phase_plain_compare(torch, stencil, CavityProblem, out)
    phase_s["plain_compare"] = time.perf_counter() - t0

    if args.profile:
        t0 = time.perf_counter()
        print("[6] profile: step 3 of the 384x384 cavity", flush=True)
        phase_profile(torch, stencil, CavityProblem, sl, out)
        phase_s["profile"] = time.perf_counter() - t0
    phase_s["total"] = time.perf_counter() - t_all
    print("phase seconds: " + json.dumps(phase_s), flush=True)

    head = rows[0]
    kernels = {"kernels": [{
        "name": "stencil2d",
        "route": "cuda",
        "source": "pynama_tpu_torch/csrc/stencil2d.cu",
        "replaces": "pynama_tpu/ops/pallas_stencil.py:173",
        "launches": sl["stencil_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows
                           if r["dtype"] == "float32"),
        "ms": head["kernel_ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "at": "x (97, 97, 128) float32, W (3, 3, 128, 128)",
        "shapes": [{k: r[k] for k in (
            "shape", "dtype", "x", "W", "max_rel_err", "kernel_ms",
            "plain_ms", "library_ms", "bound_ms")} for r in rows],
    }]}
    out.update(phase_s=phase_s, device=torch.cuda.get_device_name(0),
               nvidia_smi=smi)
    print(json.dumps({"results": out}), flush=True)
    print(json.dumps(kernels), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
