#!/usr/bin/env python3
"""Drive pynama_tpu_torch on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--profile]

Phases, each timed; any failure exits non-zero:

1. the card: name and power limit (nvidia-smi), full-float32 matmuls;
2. the build of the three CUDA libraries (csrc/stencil2d.cu,
   csrc/stencil3d.cu, csrc/stencil_breakdown.cu), one nvcc each, started
   together;
3. 2D main path: CavityProblem(cfg).setup().run(max_steps=3) at 384x384
   Q2 elements (1,182,722 velocity dofs), float32, multigrid-CG KLE, with
   the kernels' launch counts reset just before and read just after;
4. 3D main path: UniformFlowProblem(cfg).setup().run(max_steps=3) on
   channel3d (configs/channel3d.yaml: 32x32x80 Q2 hexes, 2,040,675
   velocity dofs) with bench.py's channel3d protocol, counts reset just
   before and read just after;
5. each kernel against its plain PyTorch version at every shape the wrapper
   logged in phases 3 and 4 (float32, plus the busiest shape in float64),
   with its time (taken twice, first and last), the plain version's,
   F.conv2d's / F.conv3d's (cuDNN, TF32 off: a yardstick the port never
   calls) and the card's bound; for stencil3d also its first design
   (csrc/stencil3d_v1.cuh, ``v1_ms``), both again as device time (the
   calls captured in a CUDA graph, ``graph_ms`` / ``v1_graph_ms``: the
   new kernel may not take longer than the first design at a float32
   shape) and plan3d's plan; then each instance's registers (ptxas) and
   static SASS counts (shared loads, 16-byte ones, FMAs per K chunk),
   and four launches on the same inputs that must agree bit for bit, at
   the busiest fine shape and at the most-split coarse one;
6. a 16x16 cavity run twice on the card, through the kernel and with the
   plain version forced, whose vorticities must agree;
7. the 3D Taylor-Green case (CustomFuncProblem) on 8x8x8 Q2 hexes, 3
   steps, through the kernel and with the plain version forced: the
   vorticities must agree and the velocity must match the exact field;
8. only with --profile: each main path again, its step 3 under
   torch.profiler. The device busy share is the summed device time of
   that step's kernels over the wall time of step 3 in phase 3 or 4,
   which ran the same work (same stencil launches and CG iterations,
   checked) without the profiler;
9. the stencil cost breakdown (pynama_tpu_torch/scripts/stencil_breakdown.py,
   its own path, not the main path's): at 97x97x128 (the fine K apply)
   and 25x25x128 (MG level 2), tile rows 8 and 16, each mode of the
   breakdown kernel against its plain version (fill exactly, IEEE float32
   to 1e-5, TF32 to 1e-4 of the plain version on TF32-rounded inputs),
   then every row of run_breakdown timed with the launch counts reset
   just before; full/highest at tile rows 8 must time within 25% of the
   production stencil2d row, which runs the same design.

The last lines are a JSON line of every result, a JSON "kernels" line,
the nvidia-smi line and {"ok": true, "device": {...}}.
"""

import argparse
import json
import math
import sys
import time

# published H100 SXM peaks at 700 W (NVIDIA data sheet): float32 without
# tensor cores, float64 on the tensor cores (IEEE double, the card's
# fastest float64 rate), HBM3 bandwidth
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12}
PEAK_BYTES = 3.35e12
TOL = {"float32": 1e-5, "float64": 1e-12}
# phase 9: the fine K apply and MG level 2 (the 2D shape furthest behind
# cuDNN); fill is a copy, highest sums float32 in another order, default
# sums TF32 products on the tensor cores in another order
BREAKDOWN_SHAPES = ((97, 97, 128), (25, 25, 128))
BREAKDOWN_TOL = {"fill": 0.0, "highest": 1e-5, "default": 1e-4}
SAME_DESIGN_GAP = 0.25


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


def channel3d_config():
    """configs/channel3d.yaml's geometry with bench.py's channel3d
    protocol (bench.py:503-540): KLE rtol 1e-5, at most 4000 CG
    iterations, a fixed dt of 1e-3 (dt0 = max-dt) and tolerances that
    accept every attempt, so a step is 7 RHS evaluations. bench.py's
    cross-step warm-start extrapolation is not ported; the stages warm
    start from the previous stage. The explicit limit scales as h^2 and
    lies near 0.4 at h = 1/8 with the same nu (tests/
    test_torch_cavity_dt_limit.py), about 0.017 at h = 1/32 even with the
    3D Laplacian's 3/2 factor: 17 times the 1e-3 used here."""
    return {
        "name": "channel3d-smoke",
        "material-properties": {"rho": 1.0, "mu": 0.01},
        "domain": {
            "ngl": 3,
            "box-mesh": {"nelem": [32, 32, 80], "lower": [0, 0, 0],
                         "upper": [1, 1, 2.5]},
        },
        "time-solver": {"start-time": 0.0, "end-time": 100.0,
                        "max-steps": 10000, "dt0": 1e-3, "max-dt": 1e-3,
                        "atol": 1e12, "rtol": 1e12},
        "kle-rtol": 1e-5,
        "kle-maxiter": 4000,
    }


def taylor_green3d_config():
    """configs/taylor-green2d-3d.yaml's material (rho 0.5, mu 0.01) on
    8x8x8 Q2 hexes of the unit cube, the 3D Taylor-Green case, KLE rtol
    1e-5 (float32). dt is held at 0.01 (every attempt accepted) so the
    kernel and the plain run take the same steps; the explicit limit at
    h = 1/8 and nu = 0.02 is near 0.2 (tests/
    test_torch_cavity_dt_limit.py: 0.4 at nu = 0.01)."""
    return {
        "name": "taylor-green3d-smoke",
        "material-properties": {"rho": 0.5, "mu": 0.01},
        "domain": {
            "ngl": 3,
            "box-mesh": {"nelem": [8, 8, 8], "lower": [0, 0, 0],
                         "upper": [1, 1, 1]},
        },
        "time-solver": {"start-time": 0.0, "end-time": 1.0,
                        "max-steps": 100, "dt0": 0.01, "max-dt": 0.01,
                        "atol": 1e12, "rtol": 1e12},
        "kle-rtol": 1e-5,
        "kle-maxiter": 4000,
    }


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


def _flops(xs, ws):
    return 2.0 * math.prod(xs[:-1]) * math.prod(ws)


def library_call(tnf, x, W):
    """The same contraction as one cuDNN convolution (NCHW / NCDHW)."""
    dim = W.dim() - 2
    Q = (W.shape[0] - 1) // 2
    perm_x = (dim,) + tuple(range(dim))
    xn = x.permute(perm_x).unsqueeze(0).contiguous()
    wn = W.permute((dim + 1, dim) + tuple(range(dim))).contiguous()
    conv = tnf.conv2d if dim == 2 else tnf.conv3d
    back = tuple(range(1, dim + 1)) + (0,)
    return (lambda: conv(xn, wn, padding=Q)), back


def phase_kernels(torch, stencil, kern, logged, out, v1=None):
    """The kernel against its plain version at every logged shape
    (float32) and at the busiest one in float64; with ``v1`` (the first
    design of the kernel) timed beside it as well."""
    import numpy as np
    import torch.nn.functional as tnf

    from pynama_tpu_torch.scripts.stencil3d_sweep import graph_ms

    torch.backends.cudnn.allow_tf32 = False
    shapes = sorted(logged, key=lambda s: -logged[s] * _flops(s[0], s[1]))
    if not shapes:
        fail(f"{kern.name}: no shapes were logged on the main path")
    head = shapes[0]
    cases = [(xs, ws, "float32") for xs, ws, dt in shapes
             if dt == "float32"] + [(head[0], head[1], "float64")]
    rows = []
    for xs, ws, name in cases:
        dtype = getattr(torch, name)
        rng = np.random.default_rng(sum(xs) * 1000 + sum(ws))
        x = torch.as_tensor(rng.normal(size=xs), dtype=dtype, device="cuda")
        W = torch.as_tensor(rng.normal(size=ws), dtype=dtype, device="cuda")
        y = kern(x, W)
        ref = stencil.conv_blocked_plain(x, W)
        torch.cuda.synchronize()
        abs_err = float((y - ref).abs().max())
        rel_err = abs_err / float(ref.abs().max())
        if not rel_err <= TOL[name]:
            fail(f"{kern.name} disagrees at x {xs} W {ws} {name}: "
                 f"{rel_err:.3e}")
        lib_fn, back = library_call(tnf, x, W)
        lib = lib_fn()[0].permute(back)
        lib_err = float((lib - ref).abs().max()) / float(ref.abs().max())
        flops = _flops(xs, ws)
        reps = max(3, min(20, int(5e10 / flops)))
        k_ms = event_ms(torch, lambda: kern(x, W), reps)
        p_ms = event_ms(torch, lambda: stencil.conv_blocked_plain(x, W), reps)
        l_ms = event_ms(torch, lib_fn, reps)
        v1_ms = None if v1 is None else event_ms(torch, lambda: v1(x, W),
                                                 reps)
        k_ms2 = event_ms(torch, lambda: kern(x, W), reps)
        size = x.element_size()
        nbytes = size * (math.prod(xs) + math.prod(ws)
                         + math.prod(xs[:-1]) * ws[-1])
        t_ops, t_bytes = flops / PEAK_FLOPS[name], nbytes / PEAK_BYTES
        row = {
            "dtype": name, "x": list(xs), "W": list(ws),
            "main_path_launches": logged.get((xs, ws, name), 0),
            "max_abs_err": abs_err, "max_rel_err": rel_err,
            "library_rel_err": lib_err, "kernel_ms": k_ms,
            "kernel_ms_again": k_ms2, "plain_ms": p_ms,
            "library_ms": l_ms, "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
        }
        if v1 is not None:
            p = stencil.plan3d(xs, ws, dtype)
            row.update(v1_ms=v1_ms, plan={
                "instance": p.instance, "split": p.split, "blocks": p.blocks,
                "useful_positions": p.useful_positions},
                graph_ms=graph_ms(lambda: kern(x, W), reps),
                v1_graph_ms=graph_ms(lambda: v1(x, W), reps))
        rows.append(row)
        print(f"  x {str(xs):22s} W {str(ws):24s} {name} x{row['main_path_launches']:<6d} "
              f"rel err {rel_err:.2e}  kernel {k_ms:.4f} / {k_ms2:.4f} ms  plain "
              f"{p_ms:.4f} ms  cuDNN {l_ms:.4f} ms  bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']})"
              + ("" if v1 is None else
                 f"  v1 {v1_ms:.4f} ms; as CUDA graphs: kernel "
                 f"{row['graph_ms']:.4f}, v1 {row['v1_graph_ms']:.4f} ms  "
                 f"[instance {p.instance}, split {p.split}, {p.blocks} "
                 "blocks]"), flush=True)
        if v1 is not None and name == "float32" and \
                not row["graph_ms"] <= row["v1_graph_ms"]:
            fail(f"{kern.name} is slower than its first design at x {xs} "
                 f"W {ws}: {row['graph_ms']:.4f} > {row['v1_graph_ms']:.4f} "
                 "ms of device time")
    out[f"{kern.name}_shapes"] = rows
    return rows


def ptxas_registers(build_log, name):
    """{instance: registers} from nvcc's -Xptxas -v log; ``name`` maps a
    mangled kernel name to a readable one."""
    regs, entry = {}, None
    for ln in build_log.splitlines():
        if "Compiling entry function" in ln:
            entry = name(ln.split("'")[1])
        elif entry is not None and "Used" in ln and "registers" in ln:
            regs[entry] = int(ln.split("Used")[1].split()[0])
    return regs


def phase_kernel3d_design(torch, stencil, kern, rows, out):
    """Phase 5b's second half: each stencil3d instance's registers and
    static SASS counts, and bitwise-equal repeat launches at the busiest
    fine shape and at the most-split coarse shape."""
    import numpy as np

    from pynama_tpu_torch.scripts import stencil_breakdown as sb

    regs = ptxas_registers(kern.build_log, sb.instance_name)
    sass = sb.library_sass(kern, sb.SASS_OPS_3D) or {}
    design = {}
    for name in sorted(set(regs) | set(sass)):
        design[name] = {"registers": regs.get(name), **sass.get(name, {})}
        print(f"  {name}: {regs.get(name)} registers; static SASS "
              + ", ".join(f"{op} {n}" for op, n in sass.get(name, {}).items()),
              flush=True)
    if not sass:
        print("  no cuobjdump: no SASS counts", flush=True)
    f32 = [r for r in rows if r["dtype"] == "float32"]
    fine = f32[0]
    coarse = max(f32, key=lambda r: r["plan"]["split"])
    if coarse["plan"]["split"] < 2:
        fail("stencil3d: no logged shape splits K, so none checks the split")
    repeats = []
    for r in (fine, coarse):
        xs, ws = tuple(r["x"]), tuple(r["W"])
        rng = np.random.default_rng(11)
        x = torch.as_tensor(rng.normal(size=xs), dtype=torch.float32,
                            device="cuda")
        W = torch.as_tensor(rng.normal(size=ws), dtype=torch.float32,
                            device="cuda")
        first = kern(x, W)
        same = all(bool(torch.equal(kern(x, W), first)) for _ in range(3))
        torch.cuda.synchronize()
        repeats.append({"x": r["x"], "W": r["W"], "plan": r["plan"],
                        "bitwise_equal": same})
        print(f"  x {xs} W {ws}, split {r['plan']['split']}: 4 launches "
              f"bitwise equal: {same}", flush=True)
        if not same:
            fail(f"stencil3d is not deterministic at x {xs}, W {ws}")
    out["stencil3d_design"] = {"instances": design, "repeats": repeats}


def phase_main(torch, stencil, kern, make_problem, key, out, extra=None):
    """setup() + run(max_steps=3) through the kernels, the launch counts
    set to 0 just before and read just after."""
    marks = []

    def callback(n, t, dt, vort, vel):
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), kern.launches, len(p.cg_iters)))

    for k in stencil.LIBRARIES:
        k.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p = make_problem()
    p.setup()
    torch.cuda.synchronize()
    t_setup = time.perf_counter()
    setup_launches = kern.launches
    vort, t, n = p.run(max_steps=3, callback=callback)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = {k.name: k.launches for k in stencil.KERNELS.values()}
    logged = dict(kern.shapes)

    dofs = p.mesh.n_nodes * p.dim
    norm = float(torch.linalg.norm(vort))
    if n != 3 or len(marks) != 3:
        fail(f"{key}: expected 3 accepted steps, got {n}")
    if not math.isfinite(norm) or not bool(torch.isfinite(vort).all()):
        fail(f"{key}: final vorticity is not finite")
    step_ms = [1e3 * (b[0] - a[0]) for a, b in zip(marks, marks[1:])]
    step_launches = [b[1] - a[1] for a, b in zip(marks, marks[1:])]
    step_iters = [p.cg_iters[a[2]:b[2]] for a, b in zip(marks, marks[1:])]
    if not all(s > 0 for s in step_launches) or launches[kern.name] <= 0:
        fail(f"{key}: the main path launched no {kern.name} kernel")
    iters = p.cg_iters
    res = {
        "nelem": list(p.nelem), "ngl": p.ngl, "velocity_dofs": dofs,
        "dtype": str(p.dtype).replace("torch.", ""), "steps": n, "t": t,
        "setup_s": t_setup - t0,
        "first_step_incl_initial_rhs_ms": 1e3 * (marks[0][0] - t_setup),
        "ms_per_step": sum(step_ms) / len(step_ms), "step_ms": step_ms,
        "run_s_incl_final_solve": t_end - t_setup,
        "kle_solves": len(iters), "cg_iters_per_solve": sum(iters) / len(iters),
        "cg_iters": iters, "stencil_launches": launches[kern.name],
        "launches_by_kernel": launches,
        "stencil_launches_setup": setup_launches,
        "stencil_launches_per_step": step_launches,
        "cg_iters_per_step": step_iters,
        "logged_shapes": [[list(s[0]), list(s[1]), s[2], c]
                          for s, c in logged.items()],
        "vort_norm": norm, "mg_ratios": p.mg.ratios,
        "lam_max": p.mg.lam_max,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    if extra is not None:
        res.update(extra(p, vort))
    out[key] = res
    print(f"  {dofs} velocity dofs, setup {res['setup_s']:.2f} s, "
          f"{res['ms_per_step']:.1f} ms/step (steps 2-3), first step incl. "
          f"initial RHS {res['first_step_incl_initial_rhs_ms']:.1f} ms, "
          f"peak memory {res['peak_mem_gib']:.2f} GiB", flush=True)
    print(f"  {len(iters)} KLE solves, {res['cg_iters_per_solve']:.2f} CG "
          f"iterations per solve (max {max(iters)}), {kern.name} launches "
          f"per step {step_launches}, total {launches}; |vort| = "
          f"{norm:.6e}; {len(logged)} shapes logged", flush=True)
    return res, logged


def channel_extra(torch):
    def extra(p, vort):
        one = torch.tensor([1.0, 0.0, 0.0], dtype=p.vel.dtype,
                           device=p.vel.device)
        dev = float((p.vel.reshape(-1, 3) - one).abs().max())
        print(f"  max |u - (1,0,0)| = {dev:.3e}, max |vort| = "
              f"{float(vort.abs().max()):.3e}", flush=True)
        if not math.isfinite(dev):
            fail("channel3d: final velocity is not finite")
        return {"max_abs_u_minus_uniform": dev,
                "max_abs_vort": float(vort.abs().max())}
    return extra


def phase_plain_compare(torch, stencil, kern, make_problem, key, out,
                        exact_limit=None):
    """One small run through the kernel and one with the plain version
    forced; the vorticities must agree (and, with exact_limit, the
    velocity must match the problem's exact field)."""
    runs = {}
    for mode in ("kernel", "plain"):
        before = kern.launches
        saved = stencil.conv_blocked
        if mode == "plain":
            stencil.conv_blocked = stencil.conv_blocked_plain
        try:
            p = make_problem().setup()
            vort, t, n = p.run(max_steps=3)
        finally:
            stencil.conv_blocked = saved
        runs[mode] = (p, vort, t, n, kern.launches - before)
    (pk, vk, tk, nk, lk), (_, vp, tp, np_, lp) = runs["kernel"], runs["plain"]
    rel = float(torch.linalg.norm(vk - vp) / torch.linalg.norm(vp))
    res = {"nelem": list(pk.nelem), "steps": [nk, np_], "t": [tk, tp],
           "vort_rel_diff": rel, "launches": [lk, lp]}
    msg = (f"  {'x'.join(map(str, pk.nelem))}: steps {nk}/{np_}, t {tk:.4g}, "
           f"vorticity rel diff {rel:.3e} (limit 1e-4), launches kernel "
           f"{lk} / plain {lp}")
    if exact_limit is not None:
        vel_e, _ = pk.exact_fields(tk)
        err = float(torch.linalg.norm(pk.vel - vel_e.reshape(-1))
                    / torch.linalg.norm(vel_e))
        res["vel_rel_err_vs_exact"] = err
        msg += f"; velocity rel err vs exact {err:.3e} (limit {exact_limit})"
    out[key] = res
    print(msg, flush=True)
    if nk != np_ or tk != tp or lk <= 0 or lp != 0:
        fail(f"{key}: kernel and plain runs differ in steps or launches")
    if not rel <= 1e-4:
        fail(f"{key}: vorticity kernel vs plain: {rel:.3e} > 1e-4")
    if exact_limit is not None and not res["vel_rel_err_vs_exact"] < \
            exact_limit:
        fail(f"{key}: velocity error vs exact {res['vel_rel_err_vs_exact']}")


def phase_profile(torch, kern, make_problem, sl, key, out):
    from torch.profiler import ProfilerActivity, profile

    p = make_problem().setup()
    prof = profile(activities=[ProfilerActivity.CUDA])
    marks = []

    def callback(n, t, dt, vort, vel):
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), kern.launches, len(p.cg_iters)))
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
             f"work of the main path's step 3 "
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
    stencil_ms = sum(r["device_ms"] for r in rows if kern.name in r["name"])
    res = {
        "step": 3, "step_wall_ms": wall_ms,
        "profiled_step_wall_ms": 1e3 * (t3 - marks[1][0]),
        "device_kernel_ms": dev_ms, "device_busy_share": dev_ms / wall_ms,
        f"{kern.name}_device_ms": stencil_ms, "stencil_launches": launches,
        "cg_iters": iters, "top": rows[:25],
    }
    out[key] = res
    print(f"  step 3: {wall_ms:.1f} ms wall without the profiler "
          f"({res['profiled_step_wall_ms']:.1f} ms with it), kernels "
          f"{dev_ms:.1f} ms, device busy {100 * dev_ms / wall_ms:.1f}%; "
          f"{kern.name} {stencil_ms:.1f} ms over {launches} launches",
          flush=True)
    for r in rows[:12]:
        print(f"  {r['device_ms']:9.2f} ms {r['calls']:7d}x  {r['name'][:80]}",
              flush=True)


def kernel_entry(name, replaces, launches, head, max_abs_err, **extra):
    """One entry of the "kernels" line; ``head`` holds the kernel's,
    the plain version's and the library call's times and the bound at the
    shape the entry reports."""
    return {
        "name": name,
        "route": "cuda",
        "source": f"pynama_tpu_torch/csrc/{name}.cu",
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": head["kernel_ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        **extra,
    }


def main_path_entry(kern, rows, launches, replaces):
    """The entry of a main-path kernel from its phase-5 rows, at its
    busiest float32 shape (with the first design's time, where timed)."""
    f32 = [r for r in rows if r["dtype"] == "float32"]
    head = f32[0]
    keys = ("dtype", "x", "W", "main_path_launches", "max_rel_err",
            "kernel_ms", "kernel_ms_again", "plain_ms", "library_ms",
            "bound_ms", "v1_ms", "graph_ms", "v1_graph_ms", "plan")
    extra = {k: head[k] for k in ("v1_ms", "graph_ms", "v1_graph_ms")
             if k in head}
    return kernel_entry(
        kern.name, replaces, launches, head,
        max(r["max_abs_err"] for r in f32),
        at=f"x {tuple(head['x'])} float32, W {tuple(head['W'])}",
        shapes=[{k: r[k] for k in keys if k in r} for r in rows], **extra)


def phase_breakdown(torch, stencil, out):
    """Phase 9: the breakdown kernel against its plain version in every
    mode, then every row of run_breakdown timed; returns the kernel's
    entry for the "kernels" line."""
    import numpy as np
    import torch.nn.functional as tnf

    from pynama_tpu_torch.scripts import stencil_breakdown as sb

    torch.backends.cudnn.allow_tf32 = False
    # the static SASS of every instance of the tiled 2D kernel: shared
    # loads (LDS) and FMAs per chunk of the unrolled sweep
    sass = {}
    for k in (stencil.KERNEL, stencil.BREAKDOWN):
        counts = sb.library_sass(k)
        if counts is None:
            print(f"  {k.name}: no cuobjdump, no SASS counts", flush=True)
            continue
        for name, c in counts.items():
            sass[f"{k.name}: {name}"] = c
            print(f"  SASS {k.name}: {name}: " + ", ".join(
                f"{op} {n}" for op, n in c.items()), flush=True)
    checks, inputs = [], {}
    for shape in BREAKDOWN_SHAPES:
        rng = np.random.default_rng(sum(shape))
        C = shape[-1]
        x = torch.as_tensor(rng.normal(size=shape), dtype=torch.float32,
                            device="cuda")
        W = torch.as_tensor(rng.normal(size=(3, 3, C, C)),
                            dtype=torch.float32, device="cuda")
        inputs[shape] = x, W
        x64, W64 = x.double(), W.double()
        for TR in sb.TILE_ROWS:
            for name, mode, prec in sb.KERNEL_ROWS:
                y = sb.make_breakdown(mode, prec, TR)(x, W).double()
                ref = sb.breakdown_plain(mode, prec, x64, W64)
                abs_err = float((y - ref).abs().max())
                rel = abs_err / float(ref.abs().max())
                tol = BREAKDOWN_TOL["fill" if mode == "fill" else prec]
                row = {"x": list(shape), "TR": TR, "row": name,
                       "max_abs_err": abs_err, "max_rel_err": rel,
                       "tolerance": tol}
                msg = (f"  x {shape} TR {TR:2d} {name:16s} rel err "
                       f"{rel:.2e} (limit {tol:g})")
                if mode != "fill" and prec == "default":
                    unr = sb.breakdown_plain(mode, "highest", x64, W64)
                    row["rel_err_vs_unrounded"] = float(
                        (y - unr).abs().max()) / float(unr.abs().max())
                    msg += (f"; {row['rel_err_vs_unrounded']:.2e} against "
                            "the unrounded plain version (reported only)")
                checks.append(row)
                print(msg, flush=True)
                if not rel <= tol:
                    fail(f"stencil_breakdown {name} TR {TR} at x {shape}: "
                         f"{rel:.3e} > {tol:g}")

    for k in stencil.LIBRARIES:
        k.reset_counts()
    runs = []
    for shape in BREAKDOWN_SHAPES:
        for TR in sb.TILE_ROWS:
            print(f"  shape {shape} TR={TR}: graph ms / eager ms per apply, "
                  "bound, share of the bound", flush=True)
            rows = sb.run_breakdown(*shape, TR)
            runs.append({"x": list(shape), "TR": TR, "rows": rows})
            for r in rows:
                print(f"    {r['name']:<54s} {r['graph_ms']:8.4f} "
                      f"{r['eager_ms']:8.4f}  bound {r['bound_ms']:.4f} "
                      f"({r['bound_by']})  {100 * r['share']:5.1f}%",
                      flush=True)
    launches = stencil.BREAKDOWN.launches
    if launches <= 0:
        fail("phase 9 launched no stencil_breakdown kernel")

    split = []
    for run in runs:
        t = {r["name"]: r["graph_ms"] for r in run["rows"]}
        full, prod = t["full/highest"], t[sb.PRODUCTION]
        split.append({"x": run["x"], "TR": run["TR"], "full": full,
                      "fill": t["fill-only"], "mm": t["mm-only/highest"],
                      "production": prod, "full_over_production":
                      full / prod})
        print(f"  x {tuple(run['x'])} TR {run['TR']:2d}: full/highest "
              f"{full:.4f} ms | fill-only {t['fill-only']:.4f} + "
              f"mm-only/highest {t['mm-only/highest']:.4f} = "
              f"{t['fill-only'] + t['mm-only/highest']:.4f} ms | production "
              f"stencil2d {prod:.4f} ms, full / production "
              f"{full / prod:.3f}", flush=True)
        if run["TR"] == 8 and abs(full / prod - 1) > SAME_DESIGN_GAP:
            fail(f"full/highest at TR 8 ({full:.4f} ms) is not the "
                 f"production stencil2d ({prod:.4f} ms) at x {run['x']}: "
                 "the breakdown does not measure stencil2d")

    # the entry: full/highest at the fine K shape, tile rows 8
    shape = BREAKDOWN_SHAPES[0]
    x, W = inputs[shape]
    row = next(r for r in runs[0]["rows"] if r["name"] == "full/highest")
    lib_fn, _ = library_call(tnf, x, W)
    head = {"kernel_ms": row["eager_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "plain_ms": event_ms(torch, lambda: sb.breakdown_plain(
                "full", "highest", x, W), 20),
            "library_ms": event_ms(torch, lib_fn, 20)}
    out["stencil_breakdown"] = {"checks": checks, "runs": runs,
                                "split": split, "launches": launches,
                                "entry": head, "sass": sass}
    return kernel_entry(
        "stencil_breakdown", "scripts/stencil_breakdown_tpu.py:55",
        launches, head, max(c["max_abs_err"] for c in checks),
        main_path_launches=0, graph_ms=row["graph_ms"],
        at=f"x {shape} float32, full/highest, tile rows 8; ms is 64 "
           "eager launches, graph_ms the same chain as one CUDA graph; "
           "launches counts the eager launches, not the graph replays")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="add phase 8: step 3 of each main path under "
                         "torch.profiler")
    args = ap.parse_args()
    t_all = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    # the port first: without it (a lone copy of this script) exit before
    # printing anything
    from pynama_tpu_torch.cases.analytic import CustomFuncProblem
    from pynama_tpu_torch.cases.cavity import CavityProblem
    from pynama_tpu_torch.cases.uniform import UniformFlowProblem
    from pynama_tpu_torch.ops import stencil
    from pynama_tpu_torch.scripts.stencil_breakdown import card_line

    k2, k3 = stencil.KERNEL, stencil.KERNEL3D
    F32 = torch.float32  # every main-path and small run is float32
    phase_s = {}
    out = {}

    def phase(key, title, fn):
        t0 = time.perf_counter()
        print(title, flush=True)
        res = fn()
        phase_s[key] = time.perf_counter() - t0
        return res

    t0 = time.perf_counter()
    smi = card_line()
    print(f"[1] card: {torch.cuda.get_device_name(0)} | {smi} | torch "
          f"{torch.__version__} CUDA {torch.version.cuda}", flush=True)
    if torch.get_float32_matmul_precision() != "highest" or \
            torch.backends.cuda.matmul.allow_tf32:
        fail("float32 matmuls are not full precision")
    phase_s["card"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    stencil.build_kernels()
    phase_s["build"] = time.perf_counter() - t0
    print("[2] built " + ", ".join(
        f"{k.source.name} in {k.build_seconds:.1f} s"
        for k in stencil.LIBRARIES) + ", in parallel", flush=True)
    for k in stencil.LIBRARIES:  # each kernel's name, registers, spills
        for ln in k.build_log.splitlines():
            if "Compiling entry function" in ln:
                ln = "entry " + ln.split("'")[1]
            elif "registers" not in ln and "spill" not in ln:
                continue
            print(f"    {k.name}: " + ln.strip(), flush=True)

    sl2, logged2 = phase(
        "cavity", "[3] 2D main path: 384x384 cavity, 3 steps",
        lambda: phase_main(torch, stencil, k2,
                           lambda: CavityProblem(cavity_config(384),
                                                 dtype=F32),
                           "cavity", out))
    sl3, logged3 = phase(
        "channel3d", "[4] 3D main path: channel3d 32x32x80, 3 steps",
        lambda: phase_main(torch, stencil, k3,
                           lambda: UniformFlowProblem(channel3d_config(),
                                                      dtype=F32),
                           "channel3d", out, extra=channel_extra(torch)))
    rows2 = phase("kernel_check_2d",
                  "[5a] stencil2d vs plain version at the cavity's shapes",
                  lambda: phase_kernels(torch, stencil, k2, logged2, out))
    rows3 = phase("kernel_check_3d",
                  "[5b] stencil3d vs plain version at channel3d's shapes, "
                  "beside its first design (v1)",
                  lambda: phase_kernels(torch, stencil, k3, logged3, out,
                                        v1=k3.v1))
    phase("kernel_design_3d",
          "[5b] stencil3d instances: registers, SASS, repeat launches",
          lambda: phase_kernel3d_design(torch, stencil, k3, rows3, out))
    phase("plain_compare_2d",
          "[6] 16x16 cavity: kernel vs plain version on the card",
          lambda: phase_plain_compare(
              torch, stencil, k2,
              lambda: CavityProblem(cavity_config(16), dtype=F32),
              "plain_compare_2d", out))
    phase("plain_compare_3d",
          "[7] 8x8x8 3D Taylor-Green: kernel vs plain version on the card",
          lambda: phase_plain_compare(
              torch, stencil, k3,
              lambda: CustomFuncProblem(taylor_green3d_config(),
                                        case="taylor-green", dtype=F32),
              "plain_compare_3d", out, exact_limit=0.15))
    if args.profile:
        phase("profile_2d", "[8a] profile: step 3 of the 384x384 cavity",
              lambda: phase_profile(
                  torch, k2,
                  lambda: CavityProblem(cavity_config(384), dtype=F32), sl2,
                  "profile_2d", out))
        phase("profile_3d", "[8b] profile: step 3 of channel3d",
              lambda: phase_profile(
                  torch, k3,
                  lambda: UniformFlowProblem(channel3d_config(), dtype=F32),
                  sl3, "profile_3d", out))
    breakdown = phase(
        "breakdown", "[9] stencil2d cost breakdown (its own path): "
        "modes vs plain, then timed",
        lambda: phase_breakdown(torch, stencil, out))
    phase_s["total"] = time.perf_counter() - t_all
    print("phase seconds: " + json.dumps(phase_s), flush=True)

    kernels = {"kernels": [
        main_path_entry(k2, rows2, sl2["stencil_launches"],
                        "pynama_tpu/ops/pallas_stencil.py:173"),
        main_path_entry(k3, rows3, sl3["stencil_launches"],
                        "pynama_tpu/ops/pallas_stencil.py:218"),
        breakdown,
    ]}
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
