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
5. each kernel (5a stencil2d, 5b stencil3d) against its plain PyTorch
   version at every shape the wrapper logged in phases 3 and 4 (float32,
   plus the busiest shape in float64), with its time (taken twice, first
   and last), the plain version's, F.conv2d's / F.conv3d's (cuDNN, TF32
   off: a yardstick the port never calls), the card's bound and its
   first design's time (``KERNEL.v1`` / ``KERNEL3D.v1``, ``v1_ms``), both
   again as device time (the calls captured in a CUDA graph,
   ``graph_ms`` / ``v1_graph_ms``: the new kernel may not take longer
   than the first design at any shape) and the plan (plan2d / plan3d);
   then each instance's registers (ptxas) and static SASS counts (shared
   loads, 16-byte ones, FMAs per K chunk), and four launches on the same
   inputs that must agree bit for bit, at the busiest fine shape and at
   the most-split coarse one;
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
   stencil2d v1 row (the breakdown measures the design it takes apart:
   the same instance), with the production stencil2d row reported
   beside it;
10. the parity leg (float64 state refined by kle.solve_ir to a true
   relative residual of 1e-8, float32 multigrid-CG inner solves;
   bench.py's parity settings):
   10a CavityProblem(cfg).setup().run(max_steps=3) at 384x384 in
       float64 under kle-refine, counts reset just before and read just
       after; stencil2d's float64 launches and its float32 ones must
       each be > 0;
   10b the true float64 relative residual of solve_ir on the final mask
       at the initial vorticity and after step 3, formed anew
       (<= 1e-8);
   10c a 16x16 refined cavity through the kernel and with the plain
       version forced (vorticities within 1e-6);
   10d one refined solve_kle of the 8x8x8 3D Taylor-Green case
       (stencil3d's float64 and float32 instances): true residual
       <= 1e-8, velocity within 0.15 of the exact field;
   10e stencil2d against its plain version at every shape 10a logged,
       timed as device time, and 10a's launches and time by instance;
11. the ws legs: bench.py's float32 cavity and channel3d legs run with
   kle-ws-extrapolate on (each RK stage warm-starts its KLE solves from
   its own slot's last two accepted solutions); phases 3 and 4 stay
   ws-off, and ws changes only warm starts, so each final vorticity
   must lie within 1e-4 relative of its ws-off counterpart:
   11a CavityProblem(cfg).setup().run(max_steps=3) at 384x384 with ws
       on, counts reset just before and read just after, against
       phase 3 (step 3's CG iterations beside phase 3's);
   11b bench.py's step on 11a's problem: make_attempt_host_stepper
       around make_bs5_scan_attempt(ws_extrapolate=True), from
       make_ws_state after the initial RHS, 3 steps at cavity_config's
       dt, against 11a;
   11c UniformFlowProblem(cfg).setup().run(max_steps=3) on channel3d
       with ws on, against phase 4;
   11d a 16x16 cavity with ws on through the kernel and with the plain
       version forced (vorticities within 1e-4);
12. the immersed-boundary path (ImmersedBoundaryProblem and
   ImmersedBoundaryDynamicProblem, float64 state, stencil2d's float64
   instance through every KLE solve and its multigrid V-cycle), each
   run failing unless the vorticity is finite, the slip at the body
   max |H u - U_body| < 1e-6, the last cd > 0, and the final velocity's
   grid layout holds (the port's blocked <-> grid converters equal a
   reshape written from the layout's definition, and every boundary node
   found by the mesh's numbering holds the far field within 1e-12 u_ref;
   the slip alone cannot show a swapped layout, which the correction
   would enforce just as well):
   12a configs/ibm-static.yaml as shipped (48x48 Q2 on [-3,3]^2, Re 10,
       kle-rtol 1e-10), 3 steps through phase_main, with the flux-CG
       iterations of every post-step and stencil2d's launches by
       instance and dtype; then the same run again under torch.cuda's
       sync debug mode: host syncs per step, and whether the vorticity
       is bitwise equal to the first run's;
   12b configs/ibm-dynamic.yaml as shipped (48x48 on [-4,4]^2, Re 140),
       3 steps; the body must have moved;
   12c the Re-40 regression geometry of tests/test_ibm_physics.py
       (144x96 Q2 on [-6,12]x[-6,6], 55,777 nodes, kle-rtol 1e-8),
       3 steps: the first non-square 2D grid (25x37 blocks);
   12d tests/test_ibm.py's ibm_config(nelem=16) through the kernel and
       with the plain version forced, 3 steps: vorticity within 1e-8,
       the same steps, t within 1e-9 (the adaptive dt follows wlte, as
       wlte^(-1/5)), the last cd within 1e-6;
   12e stencil2d against its plain version at every shape 12a-12c
       logged (float64, 1e-12), timed as device time, and four
       bitwise-equal launches at the non-square fine shape and at the
       most-split float64 shape.

The last lines are a JSON line of every result, a JSON "kernels" line,
the nvidia-smi line and {"ok": true, "device": {...}}.
"""

import argparse
import gc
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
# phase 10: bench.py's parity target, a true float64 relative residual
PARITY_RTOL = 1e-8
# phase 9: the fine K apply and MG level 2 (the 2D shape furthest behind
# cuDNN); fill is a copy, highest sums float32 in another order, default
# sums TF32 products on the tensor cores in another order
BREAKDOWN_SHAPES = ((97, 97, 128), (25, 25, 128))
BREAKDOWN_TOL = {"fill": 0.0, "highest": 1e-5, "default": 1e-4}
SAME_DESIGN_GAP = 0.25
# phase 11: a ws leg's final vorticity against its ws-off phase's
WS_LIMIT = 1e-4
# phase 12: the slip at the body after the correction (tests/test_ibm.py's
# bound), and 12d's kernel-vs-plain limits (vorticity, last cd)
SLIP_LIMIT = 1e-6
# the final velocity's boundary nodes against the far field, over u_ref:
# Dirichlet dofs that the KLE and the correction leave as they are
LAYOUT_LIMIT = 1e-12
IBM_PLAIN_LIMIT = 1e-8
IBM_CD_LIMIT = 1e-6
# the adaptive dt goes as wlte^(-1/5): kernel and plain runs whose states
# differ by IBM_PLAIN_LIMIT end their steps that far apart over ~5 and more
IBM_T_LIMIT = 1e-9
# configs/ibm-static.yaml and configs/ibm-dynamic.yaml as shipped (copied:
# the card's Python may have no yaml; tests/test_torch_ibm_dynamic.py
# holds the copies equal to the files)
IBM_CONFIGS = {
    "ibm-static": {
        "name": "ibm-static", "save-dir": "run-ibm-static",
        "save-n-steps": 5,
        "domain": {"ngl": 3, "box-mesh": {"nelem": [48, 48],
                                          "lower": [-3, -3],
                                          "upper": [3, 3]}},
        "boundary-conditions": {"constant": {"re": 10, "direction": 0,
                                             "longRef": "1"}},
        "bodies": [{"type": "circle", "vel": "static", "radius": 0.5,
                    "center": [0, 0]}],
        "material-properties": {"rho": 0.5, "mu": 0.01},
        "time-solver": {"max-steps": 100, "start-time": 0, "end-time": 120,
                        "dt0": 0.01},
    },
    "ibm-dynamic": {
        "name": "ibm-dynamic", "save-dir": "run-ibm-dynamic",
        "save-n-steps": 10,
        "domain": {"ngl": 3, "box-mesh": {"nelem": [48, 48],
                                          "lower": [-4, -4],
                                          "upper": [4, 4]}},
        "bodies": [{"type": "circle", "vel": "dynamic", "radius": 0.5,
                    "center": [0, 0]}],
        "boundary-conditions": {"constant": {"re": 140, "direction": 0,
                                             "longRef": "1"}},
        "material-properties": {"rho": 0.5, "mu": 0.01},
        "time-solver": {"max-steps": 1000, "start-time": 0, "end-time": 300,
                        "dt0": 0.005},
    },
}


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
    accept every attempt, so a step is 7 RHS evaluations. bench.py runs
    it with cross-step warm-start extrapolation on; here it is off (each
    stage warm-starts from the previous stage), so phase 4 stays
    comparable with earlier runs, and phase 11c turns it on. The
    explicit limit scales as h^2 and
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


def parity_config(nelem):
    """bench.py's parity leg (bench.py:256-268): float64 state refined by
    kle.solve_ir to a true relative residual of 1e-8, the adaptive inner
    tolerance off, no warm-start extrapolation; cavity_config()'s dt of
    5e-5 (bench.py's 1e-3 lies above the explicit limit)."""
    return {**cavity_config(nelem), "kle-refine": True,
            "kle-rtol": PARITY_RTOL, "kle-adaptive-inner": False}


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


def ibm_re40_config():
    """tests/test_ibm_physics.py's _cfg() (copied; no max-dt, float64
    state, no kle-refine): the static cylinder at Re 40 on 144x96 Q2
    elements of [-6,12]x[-6,6] (55,777 nodes), rho 1, mu 0.025,
    kle-rtol 1e-8."""
    return {
        "name": "cyl-re40-regression",
        "material-properties": {"rho": 1.0, "mu": 0.025},
        "domain": {"ngl": 3, "box-mesh": {"nelem": [144, 96],
                                          "lower": [-6, -6],
                                          "upper": [12, 6]}},
        "boundary-conditions": {"constant": {"re": 40, "direction": 0,
                                             "longRef": "1"}},
        "bodies": [{"type": "circle", "vel": "static", "radius": 0.5,
                    "center": [0, 0]}],
        "time-solver": {"start-time": 0, "end-time": 40.0,
                        "max-steps": 500, "dt0": 0.01},
        "kle-rtol": 1e-8,
    }


def ibm_small_config(nelem):
    """tests/test_ibm.py's ibm_config(nelem) (copied): a static
    cylinder at Re 20 on [-3,3]^2, kle-rtol 1e-10."""
    return {
        "name": "ibm-test",
        "material-properties": {"rho": 0.5, "mu": 0.01},
        "domain": {"ngl": 3, "box-mesh": {"nelem": [nelem, nelem],
                                          "lower": [-3, -3],
                                          "upper": [3, 3]}},
        "time-solver": {"start-time": 0, "end-time": 1.0, "max-steps": 100,
                        "dt0": 0.01},
        "boundary-conditions": {"constant": {"re": 20.0, "direction": 0,
                                             "longRef": "1"}},
        "bodies": [{"type": "circle", "vel": "static", "radius": 0.5,
                    "center": [0, 0]}],
        "kle-rtol": 1e-10,
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


def bound_times(xs, ws, name):
    """(seconds by operations, seconds by bytes, bytes) of one contraction
    at the card's peaks: each input read once, the output written once."""
    size = 8 if name == "float64" else 4
    nbytes = size * (math.prod(xs) + math.prod(ws)
                     + math.prod(xs[:-1]) * ws[-1])
    return _flops(xs, ws) / PEAK_FLOPS[name], nbytes / PEAK_BYTES, nbytes


def checked_inputs(torch, stencil, kern, xs, ws, name):
    """Seeded inputs of a logged shape, the plain version's result and
    the kernel's error against it; fails above TOL[name]."""
    import numpy as np

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
    return x, W, ref, abs_err, rel_err


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


def phase_kernels(torch, stencil, kern, logged, out):
    """The kernel against its plain version at every logged shape
    (float32) and at the busiest one in float64, its first design
    (``kern.v1``) timed beside it."""
    import torch.nn.functional as tnf

    from pynama_tpu_torch.scripts.stencil_sweep import graph_ms

    torch.backends.cudnn.allow_tf32 = False
    shapes = sorted(logged, key=lambda s: -logged[s] * _flops(s[0], s[1]))
    if not shapes:
        fail(f"{kern.name}: no shapes were logged on the main path")
    head = shapes[0]
    cases = [(xs, ws, "float32") for xs, ws, dt in shapes
             if dt == "float32"] + [(head[0], head[1], "float64")]
    rows = []
    v1, v1_before = kern.v1, kern.v1_launches
    for xs, ws, name in cases:
        dtype = getattr(torch, name)
        x, W, ref, abs_err, rel_err = checked_inputs(torch, stencil, kern,
                                                     xs, ws, name)
        lib_fn, back = library_call(tnf, x, W)
        lib = lib_fn()[0].permute(back)
        lib_err = float((lib - ref).abs().max()) / float(ref.abs().max())
        flops = _flops(xs, ws)
        reps = max(3, min(20, int(5e10 / flops)))
        k_ms = event_ms(torch, lambda: kern(x, W), reps)
        p_ms = event_ms(torch, lambda: stencil.conv_blocked_plain(x, W), reps)
        l_ms = event_ms(torch, lib_fn, reps)
        v1_ms = event_ms(torch, lambda: v1(x, W), reps)
        k_ms2 = event_ms(torch, lambda: kern(x, W), reps)
        t_ops, t_bytes, nbytes = bound_times(xs, ws, name)
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
        p = kern.plan(xs, ws, dtype)
        row.update(v1_ms=v1_ms, plan={
            "instance": p.instance, "split": p.split, "blocks": p.blocks,
            "vec": p.vec, "useful_positions": p.useful_positions},
            graph_ms=graph_ms(lambda: kern(x, W), reps),
            v1_graph_ms=graph_ms(lambda: v1(x, W), reps))
        row["share_of_bound"] = row["bound_ms"] / row["graph_ms"]
        rows.append(row)
        print(f"  x {str(xs):22s} W {str(ws):24s} {name} x{row['main_path_launches']:<6d} "
              f"rel err {rel_err:.2e}  kernel {k_ms:.4f} / {k_ms2:.4f} ms  plain "
              f"{p_ms:.4f} ms  cuDNN {l_ms:.4f} ms  bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']})  v1 "
              f"{v1_ms:.4f} ms; as CUDA graphs: kernel {row['graph_ms']:.4f}, "
              f"v1 {row['v1_graph_ms']:.4f} ms  [instance {p.instance}, "
              f"split {p.split}, {p.blocks} blocks]", flush=True)
        if not row["graph_ms"] <= row["v1_graph_ms"]:
            fail(f"{kern.name} is slower than its first design at x {xs} "
                 f"W {ws} {name}: {row['graph_ms']:.4f} > "
                 f"{row['v1_graph_ms']:.4f} ms of device time")
    out[f"{kern.name}_shapes"] = rows
    out[f"{kern.name}_v1_launches"] = kern.v1_launches - v1_before
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


def phase_kernel_design(torch, stencil, kern, rows, out):
    """Phase 5a's or 5b's second half: each instance's registers and
    static SASS counts, and bitwise-equal repeat launches at the busiest
    fine shape and at the most-split coarse shape."""
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
        fail(f"{kern.name}: no logged shape splits K, so none checks the "
             "split")
    repeats = [repeat_bitwise(torch, kern, tuple(r["x"]), tuple(r["W"]),
                              "float32") for r in (fine, coarse)]
    out[f"{kern.name}_design"] = {"instances": design, "repeats": repeats}


def repeat_bitwise(torch, kern, xs, ws, name):
    """Four launches of ``kern`` on the same seeded inputs of a shape in
    dtype ``name``; fails unless they agree bit for bit."""
    import numpy as np

    dtype = getattr(torch, name)
    rng = np.random.default_rng(11)
    x = torch.as_tensor(rng.normal(size=xs), dtype=dtype, device="cuda")
    W = torch.as_tensor(rng.normal(size=ws), dtype=dtype, device="cuda")
    first = kern(x, W)
    same = all(bool(torch.equal(kern(x, W), first)) for _ in range(3))
    torch.cuda.synchronize()
    p = kern.plan(xs, ws, dtype)
    plan = {"instance": p.instance, "split": p.split, "blocks": p.blocks,
            "vec": p.vec, "useful_positions": p.useful_positions}
    print(f"  x {xs} W {ws} {name}, instance {p.instance}, split {p.split}: "
          f"4 launches bitwise equal: {same}", flush=True)
    if not same:
        fail(f"{kern.name} is not deterministic at x {xs}, W {ws}, {name}")
    return {"x": list(xs), "W": list(ws), "dtype": name, "plan": plan,
            "bitwise_equal": same}


def phase_main(torch, stencil, kern, make_problem, key, out, extra=None):
    """setup() + run(max_steps=3) through the kernels, the launch counts
    set to 0 just before and read just after."""
    marks = []

    def callback(n, t, dt, vort, vel):
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), kern.launches, len(p.cg_iters)))

    for k in stencil.LIBRARIES:
        k.reset_counts()
    gc.collect()  # earlier phases' problems can hang on in reference cycles
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
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
        "mem_at_start_gib": mem0 / 2**30,
    }
    if extra is not None:
        res.update(extra(p, vort))
    out[key] = res
    print(f"  {dofs} velocity dofs, setup {res['setup_s']:.2f} s, "
          f"{res['ms_per_step']:.1f} ms/step (steps 2-3), first step incl. "
          f"initial RHS {res['first_step_incl_initial_rhs_ms']:.1f} ms, "
          f"peak memory {res['peak_mem_gib']:.2f} GiB "
          f"({res['mem_at_start_gib']:.2f} allocated at the start)",
          flush=True)
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
                        exact_limit=None, limit=1e-4, t_rtol=0.0):
    """One small run through the kernel and one with the plain version
    forced; the vorticities must agree within ``limit`` and the final
    times within ``t_rtol`` (0: equal; an adaptive dt differs in its last
    bits when wlte does). With exact_limit, the velocity must match the
    problem's exact field. Returns the kernel run's and the plain run's
    problems."""
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
           f"vorticity rel diff {rel:.3e} (limit {limit:g}), launches kernel "
           f"{lk} / plain {lp}")
    if exact_limit is not None:
        vel_e, _ = pk.exact_fields(tk)
        err = float(torch.linalg.norm(pk.vel - vel_e.reshape(-1))
                    / torch.linalg.norm(vel_e))
        res["vel_rel_err_vs_exact"] = err
        msg += f"; velocity rel err vs exact {err:.3e} (limit {exact_limit})"
    out[key] = res
    print(msg, flush=True)
    res["t_rel_diff"] = abs(tk - tp) / abs(tp)
    if nk != np_ or res["t_rel_diff"] > t_rtol or lk <= 0 or lp != 0:
        fail(f"{key}: kernel and plain runs differ in steps, t ({tk!r} vs "
             f"{tp!r}) or launches")
    if not rel <= limit:
        fail(f"{key}: vorticity kernel vs plain: {rel:.3e} > {limit:g}")
    if exact_limit is not None and not res["vel_rel_err_vs_exact"] < \
            exact_limit:
        fail(f"{key}: velocity error vs exact {res['vel_rel_err_vs_exact']}")
    return pk, runs["plain"][0]


def launch_split(torch, kern, shapes):
    """A ``kern.shapes`` log's launches by instance and by dtype."""
    inst, dtypes = {}, {"float32": 0, "float64": 0}
    for (xs, ws, name), n in shapes.items():
        i = kern.plan(xs, ws, getattr(torch, name)).instance
        inst[i] = inst.get(i, 0) + n
        dtypes[name] += n
    return dict(sorted(inst.items())), dtypes


def parity_extra(torch, kern, held):
    """Phase 10a's record beside phase_main's: refinement rounds and
    inner CG iterations per solve, and stencil2d's launches by instance
    and dtype; keeps the problem in ``held`` for phase 10b."""
    def extra(p, vort):
        held["p"] = p
        inst, dtypes = launch_split(torch, kern, kern.shapes)
        rounds, iters = p.ir_rounds, p.cg_iters
        res = {"rounds_per_solve": sum(rounds) / len(rounds),
               "max_rounds": max(rounds), "ir_rounds": rounds,
               "inner_cg_iters_per_solve": sum(iters) / len(iters),
               "launches_by_instance": inst, "launches_by_dtype": dtypes}
        print(f"  {len(rounds)} refined solves: {res['rounds_per_solve']:.2f} "
              f"rounds per solve (max {max(rounds)}), "
              f"{res['inner_cg_iters_per_solve']:.2f} inner CG iterations "
              f"per solve; {kern.name} launches by instance {inst}, by "
              f"dtype {dtypes}", flush=True)
        if not min(dtypes.values()) > 0:
            fail(f"parity leg: {kern.name} launches by dtype {dtypes}; "
                 "both must be > 0")
        if len(rounds) != len(iters) or rounds[0] < 1:
            fail(f"parity leg: {len(rounds)} refinement records for "
                 f"{len(iters)} solves, or a cold first solve took no "
                 f"round: {rounds}")
        return res
    return extra


def phase_parity_residual(torch, p, out):
    """Phase 10b, bench.py's self-check (bench.py:344-373): solve_ir on
    the final (no-slip) mask at rtol 1e-8, at the initial vorticity and
    after step 3; the true float64 relative residual is formed anew."""
    from pynama_tpu_torch.kle import solve_ir

    name = "free_mask"
    mask, u_bc = p.free_mask_b, p._solver_bc(0.0)
    rows = []
    for label, w in (
            ("initial", p._blk(p.initial_vorticity())),
            ("after step 3", p._blk(p.vort.reshape(p._gshape(p.dim_w))))):
        res = solve_ir(p.system, p.system32, w, u_bc, mask,
                       p.free_mask32_b, rtol=PARITY_RTOL,
                       maxiter=p.kle_maxiter, inner_rtol=p.kle_inner_rtol,
                       m_inv32=p._minv[name],
                       corrections=p._frees_boundary[name])
        b = p.system.rhs(w, u_bc, mask)
        r = b - p.system.apply_masked(res.x, mask)
        rel = float(torch.linalg.norm(r) / torch.linalg.norm(b))
        rows.append({"vorticity": label, "true_rel_residual": rel,
                     "rounds": res.rounds, "inner_cg_iters": res.iters,
                     "solve_ir_rel_resnorm": float(
                         res.resnorm / torch.linalg.norm(b))})
        print(f"  {label} vorticity: true float64 relative residual "
              f"{rel:.3e} (limit {PARITY_RTOL:g}), {res.rounds} rounds, "
              f"{res.iters} inner CG iterations", flush=True)
        if not rel <= PARITY_RTOL:
            fail(f"parity self-check at the {label} vorticity: {rel:.3e} "
                 f"> {PARITY_RTOL:g}")
    out["parity_residual"] = rows


def phase_refine3d(torch, kern, make_problem, out):
    """Phase 10d: one refined solve_kle of the 3D Taylor-Green case at
    t_start; the true float64 residual, formed anew, and the velocity
    against the exact field."""
    from collections import Counter

    p = make_problem().setup()
    t = p.t_start
    w = p.initial_vorticity()
    before = Counter(kern.shapes)
    u = p.solve_kle(t, w)
    torch.cuda.synchronize()
    inst, dtypes = launch_split(torch, kern, Counter(kern.shapes) - before)
    b = p.system.rhs(p._blk(w), p._solver_bc(t), p.free_mask_b)
    r = b - p.system.apply_masked(p._blk(u), p.free_mask_b)
    rel = float(torch.linalg.norm(r) / torch.linalg.norm(b))
    vel_e, _ = p.exact_fields(t)
    err = float(torch.linalg.norm(u.reshape(-1) - vel_e.reshape(-1))
                / torch.linalg.norm(vel_e))
    out["refine3d"] = {"nelem": list(p.nelem), "true_rel_residual": rel,
                       "vel_rel_err_vs_exact": err,
                       "rounds": p.ir_rounds, "inner_cg_iters": p.cg_iters,
                       "launches_by_instance": inst,
                       "launches_by_dtype": dtypes}
    print(f"  {'x'.join(map(str, p.nelem))}: true float64 relative residual "
          f"{rel:.3e} (limit {PARITY_RTOL:g}), velocity rel err vs exact "
          f"{err:.3e} (limit 0.15), rounds {p.ir_rounds}, inner CG "
          f"{p.cg_iters}, {kern.name} launches by instance {inst}",
          flush=True)
    if not rel <= PARITY_RTOL:
        fail(f"3D refined solve: true residual {rel:.3e}")
    if not err < 0.15:
        fail(f"3D refined solve: velocity error vs exact {err:.3e}")
    if not min(dtypes.values()) > 0:
        fail(f"3D refined solve: {kern.name} launches by dtype {dtypes}; "
             "both must be > 0")


def phase_logged_kernels(torch, stencil, kern, logged, launches, key,
                         out):
    """Phases 10e and 12e: the kernel against its plain version at every
    shape a leg logged, with device time (the calls captured in a CUDA
    graph), the plain version's time and the bound; the leg's launches
    and device time by instance (launches x device time per shape)."""
    from pynama_tpu_torch.scripts.stencil_sweep import graph_ms

    rows, inst = [], {}
    for (xs, ws, name), n in sorted(
            logged.items(), key=lambda kv: -kv[1] * _flops(*kv[0][:2])):
        x, W, _, abs_err, rel_err = checked_inputs(torch, stencil, kern,
                                                   xs, ws, name)
        reps = max(3, min(20, int(5e10 / _flops(xs, ws))))
        dev = graph_ms(lambda: kern(x, W), reps)
        p_ms = event_ms(torch, lambda: stencil.conv_blocked_plain(x, W),
                        reps)
        bound = 1e3 * max(bound_times(xs, ws, name)[:2])
        i = kern.plan(xs, ws, getattr(torch, name)).instance
        rows.append({"x": list(xs), "W": list(ws), "dtype": name,
                     "instance": i, "main_path_launches": n,
                     "max_abs_err": abs_err, "max_rel_err": rel_err,
                     "graph_ms": dev, "plain_ms": p_ms, "bound_ms": bound})
        e = inst.setdefault(i, {"launches": 0, "device_ms": 0.0})
        e["launches"] += n
        e["device_ms"] += n * dev
        print(f"  x {str(xs):16s} W {str(ws):20s} {name} x{n:<6d} instance "
              f"{i}: rel err {rel_err:.2e}, device {dev:.4f} ms, plain "
              f"{p_ms:.4f} ms, bound {bound:.4f} ms", flush=True)
    if sum(e["launches"] for e in inst.values()) != launches:
        fail(f"{key}: the logged shapes hold {inst}, the leg counted "
             f"{launches} launches")
    for i, e in sorted(inst.items()):
        print(f"  instance {i}: {e['launches']} launches x device time "
              f"per shape = {e['device_ms']:.1f} ms (setup, initial RHS, "
              "3 steps, final solve)", flush=True)
    out[key] = {"shapes": rows, "by_instance": inst}
    return rows


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


def keep_run(held, name, extra=None, problem=False):
    """A phase_main ``extra`` that keeps the run's final vorticity (with
    ``problem``, the pair (problem, vorticity)) in ``held[name]`` for
    phase 11. Only 11a keeps its problem: a kept problem's tensors would
    count in every later phase's peak memory."""
    def fn(p, vort):
        held[name] = (p, vort) if problem else vort
        return extra(p, vort) if extra is not None else {}
    return fn


def step3_iters(res):
    return sum(res["cg_iters_per_step"][1])


def history_leaves(aux_ws):
    """The tensors of a ws history's two slot stacks (H1, H2)."""
    from pynama_tpu_torch.solvers.rk import aux_map

    leaves = []
    aux_map(leaves.append, (aux_ws[0], aux_ws[1]))
    return leaves


def compare_ws(torch, out, key, base_key, vort, base_vort):
    """A ws leg against its ws-off counterpart: the final vorticity
    (within WS_LIMIT), ms/step, step 3's CG iterations and peak memory
    side by side."""
    ws, base = out[key], out[base_key]
    rel = float(torch.linalg.norm(vort - base_vort)
                / torch.linalg.norm(base_vort))
    ws.update(against=base_key, vort_rel_diff=rel,
              step3_cg_iters=step3_iters(ws),
              step3_cg_iters_against=step3_iters(base),
              ms_per_step_against=base["ms_per_step"],
              peak_mem_gib_against=base["peak_mem_gib"],
              mem_at_start_gib_against=base["mem_at_start_gib"])
    per_step = [[sum(s) for s in r["cg_iters_per_step"]] for r in (ws, base)]
    print(f"  against {base_key}: vorticity rel diff {rel:.3e} (limit "
          f"{WS_LIMIT:g}); CG iterations in steps 2-3 {per_step[0]} vs "
          f"{per_step[1]}; {ws['ms_per_step']:.1f} vs "
          f"{base['ms_per_step']:.1f} ms/step; peak memory "
          f"{ws['peak_mem_gib']:.3f} vs {base['peak_mem_gib']:.3f} GiB "
          f"({ws['mem_at_start_gib']:.3f} and {base['mem_at_start_gib']:.3f} "
          "allocated at their starts)", flush=True)
    if not rel <= WS_LIMIT:
        fail(f"{key}: final vorticity {rel:.3e} off {base_key}'s")


def phase_ws_scan(torch, stencil, kern, p, base_vort, out):
    """Phase 11b, bench.py's float32 cavity step (bench.py:305-326) on
    phase 11a's problem: the host dt controller around one scan attempt
    with ws on, from make_ws_state after the initial RHS, 3 steps at
    cavity_config's dt (bench.py's 1e-3 lies above the explicit limit,
    see cavity_config), counts reset just before and read just after."""
    from pynama_tpu_torch.solvers.rk import (make_attempt_host_stepper,
                                             make_bs5_scan_attempt,
                                             make_ws_state)

    dt = cavity_config(0)["time-solver"]["max-dt"]
    step = make_attempt_host_stepper(make_bs5_scan_attempt(
        p.transport_rhs, atol=1e12, rtol=1e12, ws_extrapolate=True))
    for k in stencil.LIBRARIES:
        k.reset_counts()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    first = len(p.cg_iters)
    w, vel = p._blk(p.initial_vorticity()), p._blk(p.zero_vel())
    t = 0.0
    f1, vel = p.transport_rhs(t, w, vel)
    vel = make_ws_state(vel, t)
    marks = []
    for _ in range(3):
        res = step(w, t, dt, vel, f1, 1e9)
        w, t, vel, f1 = res.y, res.t, res.aux, res.f_new
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), kern.launches, len(p.cg_iters)))
    launches = kern.launches
    vort = p._unblk(w).reshape(-1)
    if not bool(torch.isfinite(vort).all()):
        fail("ws_scan: final vorticity is not finite")
    step_ms = [1e3 * (b[0] - a[0]) for a, b in zip(marks, marks[1:])]
    iters = p.cg_iters[first:]
    step_iters = [p.cg_iters[a[2]:b[2]] for a, b in zip(marks, marks[1:])]
    hist = history_leaves(vel)
    leaves = {h.device.type for h in hist} | {str(h.dtype) for h in hist}
    out["ws_scan"] = {
        "t": t, "dt": dt, "ms_per_step": sum(step_ms) / len(step_ms),
        "step_ms": step_ms, "kle_solves": len(iters),
        "cg_iters_per_solve": sum(iters) / len(iters), "cg_iters": iters,
        "cg_iters_per_step": step_iters, "stencil_launches": launches,
        "stencil_launches_per_step": [b[1] - a[1] for a, b in
                                      zip(marks, marks[1:])],
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "mem_at_start_gib": mem0 / 2**30,
        "history_bytes": sum(h.numel() * h.element_size() for h in hist),
        "history_leaves": sorted(leaves),
    }
    r = out["ws_scan"]
    print(f"  t {t:.6g}, {r['ms_per_step']:.1f} ms/step (steps 2-3), "
          f"{len(iters)} KLE solves, {r['cg_iters_per_solve']:.2f} CG "
          f"iterations per solve, per step {[sum(s) for s in step_iters]}, "
          f"{kern.name} launches {launches}; ws history "
          f"{r['history_bytes'] / 1e6:.1f} MB on {sorted(leaves)}",
          flush=True)
    if launches <= 0:
        fail(f"ws_scan: launched no {kern.name} kernel")
    if leaves != {"cuda", "torch.float32"}:
        fail(f"ws_scan: the ws history left the card or float32: {leaves}")
    compare_ws(torch, out, "ws_scan", "ws_cavity", vort, base_vort)


def phase_ws_legs(torch, stencil, phase, held, out):
    """Phase 11 (see the module's docstring); ``held`` holds phases 3's
    and 4's final vorticities. Returns phase_main's records of 11a and
    11c."""
    from pynama_tpu_torch.cases.cavity import CavityProblem
    from pynama_tpu_torch.cases.uniform import UniformFlowProblem

    k2, k3, F32 = stencil.KERNEL, stencil.KERNEL3D, torch.float32
    ws = {"kle-ws-extrapolate": True}
    sl11a, _ = phase(
        "ws_cavity", "[11a] ws leg: 384x384 cavity with kle-ws-extrapolate, "
        "3 steps",
        lambda: phase_main(torch, stencil, k2,
                           lambda: CavityProblem({**cavity_config(384), **ws},
                                                 dtype=F32),
                           "ws_cavity", out,
                           extra=keep_run(held, "ws_cavity", problem=True)))
    p11, vort11 = held.pop("ws_cavity")
    compare_ws(torch, out, "ws_cavity", "cavity", vort11, held.pop("cavity"))
    phase("ws_scan", "[11b] ws leg: bench.py's step (scan attempt + host "
          "stepper, ws on) on 11a's problem, 3 steps",
          lambda: phase_ws_scan(torch, stencil, k2, p11, vort11, out))
    del p11  # 11c's peak memory must not count 11a's problem
    sl11c, _ = phase(
        "ws_channel3d", "[11c] ws leg: channel3d with kle-ws-extrapolate, "
        "3 steps",
        lambda: phase_main(torch, stencil, k3,
                           lambda: UniformFlowProblem(
                               {**channel3d_config(), **ws}, dtype=F32),
                           "ws_channel3d", out,
                           extra=keep_run(held, "ws_channel3d",
                                           channel_extra(torch))))
    compare_ws(torch, out, "ws_channel3d", "channel3d",
               held.pop("ws_channel3d"), held.pop("channel3d"))
    phase("plain_compare_ws",
          "[11d] 16x16 cavity with ws: kernel vs plain version on the card",
          lambda: phase_plain_compare(
              torch, stencil, k2,
              lambda: CavityProblem({**cavity_config(16), **ws}, dtype=F32),
              "plain_compare_ws", out, limit=WS_LIMIT))
    return sl11a, sl11c


def ibm_slip(p, t):
    """max |H u - U_body| of a run's final corrected velocity at t."""
    X, Ub = p._body_state(t)
    nodes, weights = p.coupling.windows(X)
    return float((p.coupling.interp(p.vel, nodes, weights) - Ub).abs().max())


def grid_from_blocked(xb, P, npts):
    """The blocked layout written out apart from the port's converters:
    block (b1, b2) holds grid nodes (b1*P + i, b2*P + j), 0 <= i, j < P,
    in channels (i, j, k); the grid is cropped to its npts."""
    B1, B2, C = xb.shape
    k = C // (P * P)
    g = xb.reshape(B1, B2, P, P, k).permute(0, 2, 1, 3, 4)
    return g.reshape(B1 * P, B2 * P, k)[:npts[0], :npts[1]]


def ibm_layout(torch, p):
    """Witnesses that the coupling read and wrote the velocity in the
    grid layout, which the slip alone cannot show (the correction
    enforces H u = U_body on whatever field it is given): the port's
    blocked <-> grid converters agree bit for bit with grid_from_blocked
    on the final velocity; every boundary node of the flat velocity,
    found by the mesh's numbering (node = iy*npx + ix), holds the far
    field exactly; and the field is not uniform (so the boundary test
    could fail)."""
    npts = tuple(reversed(p.mesh.npts))
    grid = p.vel.reshape(npts + (p.dim,))
    vb = p._blk(grid)
    same = bool(torch.equal(
        grid_from_blocked(vb, p._solver_ngl - 1, npts), grid)) and \
        bool(torch.equal(p._unblk(vb), grid))
    u_inf = torch.as_tensor(p.cte_value, dtype=grid.dtype,
                            device=grid.device)
    dev = (grid - u_inf).abs().amax(dim=-1)
    edge = torch.cat([dev[0], dev[-1], dev[:, 0], dev[:, -1]])
    return {"layout_converters_equal": same,
            "boundary_minus_far_field": float(edge.max()),
            "max_minus_far_field": float(dev.max())}


def ibm_extra(torch, kern, key, held):
    """A phase_main ``extra`` for phase 12's legs: the slip at the body,
    the last cd, the flux-CG iterations of every post-step (the initial
    one, then the step's and the force floor's, 2 a step), stencil2d's
    launches by instance and dtype, and whether the body moved; keeps
    (problem, vorticity) in held[key]."""
    def extra(p, vort):
        t = p.t_history[-1]
        slip = ibm_slip(p, t)
        cd = p.cd_history[-1][0]
        flux = list(p.coupling.cg_iters)
        inst, dtypes = launch_split(torch, kern, kern.shapes)
        moved = float(abs(p.body.coords_at(t) - p.body.coords_at(0.0)).max())
        layout = ibm_layout(torch, p)
        res = {**layout, "slip": slip, "cd_history": p.cd_history,
               "cl_history": p.cl_history, "cd_raw_history": p.cd_raw_history,
               "dt_history": p.dt_history, "t_history": p.t_history,
               "flux_cg_iters": flux,
               "flux_cg_iters_per_post_step": sum(flux) / len(flux),
               "lagrange_points": p.body.n_nodes, "body_moved": moved,
               "launches_by_instance": inst, "launches_by_dtype": dtypes}
        print(f"  slip max |Hu - U_body| {slip:.3e} (limit {SLIP_LIMIT:g}), "
              f"cd {[c[0] for c in p.cd_history]}, dt {p.dt_history}; "
              f"{p.body.n_nodes} Lagrange points, flux CG {flux} "
              f"({res['flux_cg_iters_per_post_step']:.1f} per post-step); "
              f"body moved {moved:.4g}; {kern.name} launches by instance "
              f"{inst}, by dtype {dtypes}", flush=True)
        print(f"  layout: converters equal to the grid definition "
              f"{layout['layout_converters_equal']}; max |u - u_inf| on "
              f"the boundary {layout['boundary_minus_far_field']:.3e} "
              f"(limit {LAYOUT_LIMIT:g} u_ref), over the field "
              f"{layout['max_minus_far_field']:.3e}", flush=True)
        if not layout["layout_converters_equal"] or \
                not layout["boundary_minus_far_field"] <= LAYOUT_LIMIT * p.u_ref or \
                not layout["max_minus_far_field"] > 0.1 * p.u_ref:
            fail(f"{key}: the velocity's grid layout: {layout}")
        if not slip < SLIP_LIMIT:
            fail(f"{key}: slip at the body {slip:.3e}")
        if not cd > 0:
            fail(f"{key}: last cd {cd} is not positive")
        if p.body.is_moving and not moved > 0:
            fail(f"{key}: the body did not move")
        if dtypes["float64"] <= 0 or dtypes["float32"] != 0:
            fail(f"{key}: {kern.name} launches by dtype {dtypes}; the "
                 "float64 path must launch only the float64 instance")
        held[key] = p, vort
        return res
    return extra


def phase_ibm_repeat(torch, make_problem, held, out):
    """12a's run again under torch.cuda's sync debug mode: the host syncs
    of each step (every synchronizing call warns once), beside the reads
    that the CG loops alone account for (2 + iterations a solve, KLE and
    flux), and whether the vorticity, the CG iteration lists and the
    force histories equal the first run's bit for bit."""
    import warnings

    import numpy as np

    p0, vort0 = held.pop("ibm_static")
    p = make_problem().setup()
    marks = []

    def callback(n, t, dt, vort, vel):
        syncs = sum("synchroniz" in str(w.message) for w in caught)
        marks.append((syncs, len(p.cg_iters), len(p.coupling.cg_iters)))

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        vort, t, n = p.run(max_steps=3, callback=callback)
        torch.cuda.set_sync_debug_mode("default")
    steps = list(zip([(0, 0, 0)] + marks, marks))
    syncs = [b[0] - a[0] for a, b in steps]
    cg_reads = [sum(2 + i for i in p.cg_iters[a[1]:b[1]])
                + sum(2 + i for i in p.coupling.cg_iters[a[2]:b[2]])
                for a, b in steps]
    # the same windows, spread 4 times
    X, _ = p._body_state(t)
    nodes, weights = p.coupling.windows(X)
    q = torch.as_tensor(np.random.default_rng(12).normal(
        size=(X.shape[0], 2)), dtype=p.dtype, device="cuda")
    s0 = p.coupling.spread(q, nodes, weights, p.mesh.n_nodes)
    spread_same = all(bool(torch.equal(
        p.coupling.spread(q, nodes, weights, p.mesh.n_nodes), s0))
        for _ in range(3))
    res = {
        "vort_bitwise_equal": bool(torch.equal(vort, vort0)),
        "vort_max_abs_diff": float((vort - vort0).abs().max()),
        "cg_iters_equal": p.cg_iters == p0.cg_iters,
        "flux_cg_iters_equal": p.coupling.cg_iters == p0.coupling.cg_iters,
        "cd_history_equal": p.cd_history == p0.cd_history,
        "spread_repeats_bitwise_equal": spread_same,
        "host_syncs_per_step": syncs, "cg_host_reads_per_step": cg_reads,
        "t": t, "steps": n,
    }
    out["ibm_static_repeat"] = res
    print(f"  repeat of 12a: vorticity bitwise equal "
          f"{res['vort_bitwise_equal']} (max abs diff "
          f"{res['vort_max_abs_diff']:.3e}), KLE CG lists equal "
          f"{res['cg_iters_equal']}, flux CG lists equal "
          f"{res['flux_cg_iters_equal']}, cd equal "
          f"{res['cd_history_equal']}; spread x4 bitwise equal "
          f"{spread_same}; host syncs per step (step 1 with the initial "
          f"condition) {syncs}, of which the CG loops' reads {cg_reads}",
          flush=True)
    if n != 3 or not bool(torch.isfinite(vort).all()):
        fail("12a repeat: not 3 steps, or the vorticity is not finite")


def phase_ibm_legs(torch, stencil, phase, out):
    """Phase 12 (see the module's docstring). Returns phase_main's
    records of 12a, 12b and 12c and 12e's rows."""
    from collections import Counter

    from pynama_tpu_torch.cases.immersed import (
        ImmersedBoundaryDynamicProblem, ImmersedBoundaryProblem)

    k2, held = stencil.KERNEL, {}
    legs = {
        "ibm_static": ("[12a] ibm-static.yaml as shipped: 48x48, float64, "
                       "3 steps", ImmersedBoundaryProblem,
                       IBM_CONFIGS["ibm-static"]),
        "ibm_dynamic": ("[12b] ibm-dynamic.yaml as shipped: 48x48, "
                        "float64, 3 steps", ImmersedBoundaryDynamicProblem,
                        IBM_CONFIGS["ibm-dynamic"]),
        "ibm_re40": ("[12c] the Re-40 regression geometry: 144x96, "
                     "float64, 3 steps", ImmersedBoundaryProblem,
                     ibm_re40_config()),
    }
    records, logged = {}, Counter()
    for key, (title, cls, cfg) in legs.items():
        records[key], shapes = phase(
            key, title,
            lambda: phase_main(torch, stencil, k2, lambda: cls(cfg), key, out,
                               extra=ibm_extra(torch, k2, key, held)))
        logged.update(shapes)
        if key == "ibm_static":
            phase("ibm_static_repeat",
                  "[12a] the same run again: bitwise equal? host syncs",
                  lambda: phase_ibm_repeat(
                      torch, lambda: cls(cfg), held, out))
        held.clear()

    def plain_compare_ibm():
        pk, pp = phase_plain_compare(
            torch, stencil, k2,
            lambda: ImmersedBoundaryProblem(ibm_small_config(16)),
            "plain_compare_ibm", out, limit=IBM_PLAIN_LIMIT,
            t_rtol=IBM_T_LIMIT)
        a, b = pk.cd_history[-1][0], pp.cd_history[-1][0]
        rel = abs(a - b) / abs(b)
        out["plain_compare_ibm"].update(last_cd=[a, b], last_cd_rel_diff=rel)
        print(f"  last cd kernel {a!r} / plain {b!r}: rel diff {rel:.3e} "
              f"(limit {IBM_CD_LIMIT:g})", flush=True)
        if not rel <= IBM_CD_LIMIT:
            fail(f"12d: last cd kernel vs plain {rel:.3e}")

    phase("plain_compare_ibm",
          "[12d] 16x16 IBM case, float64: kernel vs plain version on the "
          "card", plain_compare_ibm)
    launches = sum(r["stencil_launches"] for r in records.values())

    def kernels_and_repeats():
        rows = phase_logged_kernels(torch, stencil, k2, logged, launches,
                                    "ibm_kernels", out)
        fine = max((r for r in rows if r["x"][0] != r["x"][1]),
                   key=lambda r: r["main_path_launches"]
                   * _flops(r["x"], r["W"]))
        split = max(rows, key=lambda r: k2.plan(
            tuple(r["x"]), tuple(r["W"]), torch.float64).split)
        out["ibm_kernels"]["repeats"] = [
            repeat_bitwise(torch, k2, tuple(r["x"]), tuple(r["W"]),
                           "float64") for r in (fine, split)]
        return rows

    rows = phase("ibm_kernels",
                 "[12e] stencil2d vs plain version at the IBM legs' shapes",
                 kernels_and_repeats)
    return records, rows


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


def main_path_entry(kern, rows, launches, replaces, v1_launches, **more):
    """The entry of a main-path kernel from its phase-5 rows, at its
    busiest float32 shape, with its first design's time and launches
    (phase 5's) and every row's plan."""
    f32 = [r for r in rows if r["dtype"] == "float32"]
    head = f32[0]
    keys = ("dtype", "x", "W", "main_path_launches", "max_rel_err",
            "kernel_ms", "kernel_ms_again", "plain_ms", "library_ms",
            "bound_ms", "v1_ms", "graph_ms", "v1_graph_ms", "plan",
            "share_of_bound")
    extra = {k: head[k] for k in ("v1_ms", "graph_ms", "v1_graph_ms")}
    return kernel_entry(
        kern.name, replaces, launches, head,
        max(r["max_abs_err"] for r in f32),
        at=f"x {tuple(head['x'])} float32, W {tuple(head['W'])}",
        v1_launches=v1_launches, plan=head["plan"],
        shapes=[{k: r[k] for k in keys} for r in rows], **extra, **more)


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
        full, prod, v1 = t["full/highest"], t[sb.PRODUCTION], t[sb.V1]
        split.append({"x": run["x"], "TR": run["TR"], "full": full,
                      "fill": t["fill-only"], "mm": t["mm-only/highest"],
                      "v1": v1, "full_over_v1": full / v1,
                      "production": prod, "production_over_v1": prod / v1})
        print(f"  x {tuple(run['x'])} TR {run['TR']:2d}: full/highest "
              f"{full:.4f} ms | fill-only {t['fill-only']:.4f} + "
              f"mm-only/highest {t['mm-only/highest']:.4f} = "
              f"{t['fill-only'] + t['mm-only/highest']:.4f} ms | stencil2d "
              f"v1 {v1:.4f} ms, full / v1 {full / v1:.3f} | production "
              f"stencil2d {prod:.4f} ms, production / v1 {prod / v1:.3f}",
              flush=True)
        if run["TR"] == 8 and abs(full / v1 - 1) > SAME_DESIGN_GAP:
            fail(f"full/highest at TR 8 ({full:.4f} ms) is not stencil2d's "
                 f"first design ({v1:.4f} ms) at x {run['x']}: the "
                 "breakdown does not measure the design it takes apart")

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
    # phases 3-9 run float32; phase 10, the parity leg, float64 state
    F32, F64 = torch.float32, torch.float64
    phase_s = {}
    mem_after = {}  # GiB still allocated after each phase
    out = {}

    def phase(key, title, fn):
        t0 = time.perf_counter()
        print(title, flush=True)
        res = fn()
        phase_s[key] = time.perf_counter() - t0
        mem_after[key] = torch.cuda.memory_allocated() / 2**30
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

    held = {}  # final vorticities (and 11a's problem) for phase 11
    sl2, logged2 = phase(
        "cavity", "[3] 2D main path: 384x384 cavity, 3 steps",
        lambda: phase_main(torch, stencil, k2,
                           lambda: CavityProblem(cavity_config(384),
                                                 dtype=F32),
                           "cavity", out, extra=keep_run(held, "cavity")))
    sl3, logged3 = phase(
        "channel3d", "[4] 3D main path: channel3d 32x32x80, 3 steps",
        lambda: phase_main(torch, stencil, k3,
                           lambda: UniformFlowProblem(channel3d_config(),
                                                      dtype=F32),
                           "channel3d", out,
                           extra=keep_run(held, "channel3d",
                                           channel_extra(torch))))
    rows2 = phase("kernel_check_2d",
                  "[5a] stencil2d vs plain version at the cavity's shapes, "
                  "beside its first design (v1)",
                  lambda: phase_kernels(torch, stencil, k2, logged2, out))
    phase("kernel_design_2d",
          "[5a] stencil2d instances: registers, SASS, repeat launches",
          lambda: phase_kernel_design(torch, stencil, k2, rows2, out))
    rows3 = phase("kernel_check_3d",
                  "[5b] stencil3d vs plain version at channel3d's shapes, "
                  "beside its first design (v1)",
                  lambda: phase_kernels(torch, stencil, k3, logged3, out))
    phase("kernel_design_3d",
          "[5b] stencil3d instances: registers, SASS, repeat launches",
          lambda: phase_kernel_design(torch, stencil, k3, rows3, out))
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
    sl10, logged10 = phase(
        "parity", "[10a] parity leg: 384x384 cavity, float64 refined by "
        "kle.solve_ir to 1e-8, float32 inner solves, 3 steps",
        lambda: phase_main(torch, stencil, k2,
                           lambda: CavityProblem(parity_config(384),
                                                 dtype=F64),
                           "parity", out,
                           extra=parity_extra(torch, k2, held)))
    phase("parity_residual",
          "[10b] parity self-check: true float64 residual of the final "
          "mask's solve",
          lambda: phase_parity_residual(torch, held.pop("p"), out))
    phase("plain_compare_parity",
          "[10c] 16x16 refined cavity: kernel vs plain version on the card",
          lambda: phase_plain_compare(
              torch, stencil, k2,
              lambda: CavityProblem({**cavity_config(16), "kle-refine": True,
                                     "kle-rtol": PARITY_RTOL}, dtype=F64),
              "plain_compare_parity", out, limit=1e-6))
    phase("refine3d",
          "[10d] 8x8x8 3D Taylor-Green: one refined KLE solve",
          lambda: phase_refine3d(
              torch, k3,
              lambda: CustomFuncProblem(
                  {**taylor_green3d_config(), "kle-refine": True,
                   "kle-rtol": PARITY_RTOL}, case="taylor-green", dtype=F64),
              out))
    phase("parity_kernels",
          "[10e] stencil2d vs plain version at the parity leg's shapes",
          lambda: phase_logged_kernels(torch, stencil, k2, logged10,
                                       sl10["stencil_launches"],
                                       "parity_kernels", out))
    sl11a, sl11c = phase_ws_legs(torch, stencil, phase, held, out)
    sl12, rows12 = phase_ibm_legs(torch, stencil, phase, out)
    phase_s["total"] = time.perf_counter() - t_all
    print("phase seconds: " + json.dumps(phase_s), flush=True)
    print("GiB allocated after each phase: " + json.dumps(mem_after),
          flush=True)

    ws2 = {"11a": sl11a["stencil_launches"],
           "11b": out["ws_scan"]["stencil_launches"]}
    ibm2 = {leg: sl12[key]["stencil_launches"] for leg, key in (
        ("12a", "ibm_static"), ("12b", "ibm_dynamic"), ("12c", "ibm_re40"))}
    kernels = {"kernels": [
        main_path_entry(k2, rows2, sl2["stencil_launches"]
                        + sl10["stencil_launches"] + sum(ws2.values())
                        + sum(ibm2.values()),
                        "pynama_tpu/ops/pallas_stencil.py:173",
                        out["stencil2d_v1_launches"],
                        parity_leg_launches=sl10["launches_by_instance"],
                        parity_leg_max_abs_err=max(
                            r["max_abs_err"]
                            for r in out["parity_kernels"]["shapes"]),
                        ws_leg_launches=ws2, ibm_leg_launches=ibm2,
                        ibm_leg_max_abs_err=max(
                            r["max_abs_err"] for r in rows12)),
        main_path_entry(k3, rows3, sl3["stencil_launches"]
                        + sl11c["stencil_launches"],
                        "pynama_tpu/ops/pallas_stencil.py:218",
                        out["stencil3d_v1_launches"],
                        ws_leg_launches={"11c": sl11c["stencil_launches"]}),
        breakdown,
    ]}
    out.update(phase_s=phase_s, allocated_after_gib=mem_after,
               device=torch.cuda.get_device_name(0),
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
