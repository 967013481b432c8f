"""The immersed-boundary drag regression on the card: a static cylinder at
Re 40 and 8.3% blockage, under mixed-precision refinement (kle-refine).

    python -m pynama_tpu_torch.scripts.ibm_regression re40 [--out PATH]
        [--device cuda|cpu]

Port of scripts/run_ibm_regression_tpu.py for its ``re40`` protocol, the
body of tests/test_ibm_physics.py::test_static_cylinder_re40_drag with the
reference's production solver path (float64 state and true float64
residuals, float32 multigrid V-cycles): 144x96 Q2 elements of
[-6,12]x[-6,6] (blockage D/H = 8.3%, D/h = 16), 180 adaptive steps
checkpointed every 10, then two segments resumed from the checkpoint, each
of 14 steps at a fixed max-dt of 0.06 and 0.03. The raw drag per step
scales as cd_raw(dt) = cd_phys + floor/dt, so the means of each segment's
last 8 raw coefficients and dts eliminate the floor:

    cd_phys = (cd_a dt_a - cd_b dt_b) / (dt_a - dt_b)    (the same for cl)

The test's gates decide the exit code: t > 12 after the 180 steps, the
segments' dts within 1e-6 of 0.06 and 0.03, 1.70 < cd_phys < 2.0 and
|cl_phys| < 0.1. cd_phys is printed beside the reference's recorded
1.8573 (run-artifacts/ibm_regression.json, a CPU measurement), which is
reported, not gated. Seconds of every stage, ms per accepted step, the
refinement rounds and inner float32 CG iterations of every accepted step
and stencil2d's launches by dtype are printed and written as JSON to
``--out`` (default chiprun_out/ibm_regression.json). It runs on the card
unless ``--device cpu`` is given, and raises without one.

The other protocols of the TPU script (``big``: 4.2% blockage; ``st``:
the Re-100 Strouhal number) are not ported and raise NotImplementedError.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from pynama_tpu_torch.cases.immersed import ImmersedBoundaryProblem
from pynama_tpu_torch.device import resolve_device
from pynama_tpu_torch.ops import stencil

# tests/test_ibm_physics.py's geometry of the 8.3%-blockage protocol
RE40_GEOM = {"nelem": (144, 96), "lower": (-6, -6), "upper": (12, 6)}
STEPS = 180           # the steady run, past the start-up transient
CKPT_EVERY = 10
SEG_STEPS = 14        # each fixed-dt segment resumed from the checkpoint
SEG_DTS = (0.06, 0.03)
MEAN_LAST = 8         # the segment entries averaged
# the gates of test_static_cylinder_re40_drag
T_MIN = 12.0
DT_TOL = 1e-6
CD_WINDOW = (1.70, 2.0)
CL_MAX = 0.1
# run-artifacts/ibm_regression.json "re40_blockage8.3" cd_phys (the
# reference's CPU measurement of this protocol, without refinement)
REF_CD_PHYS = 1.8572644338304616
NOT_PORTED = ("the {} protocol is not ported (ROADMAP.md queue 1 #8); "
              "only re40 runs")


def re40_config(max_dt=None, nelem=RE40_GEOM["nelem"],
                lower=RE40_GEOM["lower"], upper=RE40_GEOM["upper"]):
    """tests/test_ibm_physics.py's _cfg() with kle-refine on (the TPU
    script's PYNAMA_IBM_REFINE=1): a static cylinder of radius 0.5 at
    the origin, Re 40 (rho 1, mu 0.025, u_ref 1), kle-rtol 1e-8."""
    ts = {"start-time": 0, "end-time": 40.0, "max-steps": 500, "dt0": 0.01}
    if max_dt:
        ts["max-dt"] = max_dt
    return {
        "kle-refine": True,
        "name": "cyl-re40-regression",
        "material-properties": {"rho": 1.0, "mu": 0.025},
        "domain": {"ngl": 3, "box-mesh": {"nelem": list(nelem),
                                          "lower": list(lower),
                                          "upper": list(upper)}},
        "boundary-conditions": {"constant": {"re": 40, "direction": 0,
                                             "longRef": "1"}},
        "bodies": [{"type": "circle", "vel": "static", "radius": 0.5,
                    "center": [0, 0]}],
        "time-solver": ts,
        "kle-rtol": 1e-8,
    }


def richardson(a, dt_a, b, dt_b):
    """The dt-independent part of a coefficient measured as a at dt_a and
    b at dt_b, when it goes as c + floor/dt."""
    return (a * dt_a - b * dt_b) / (dt_a - dt_b)


def launches_by_dtype():
    """stencil2d's logged launches by dtype since its last reset."""
    out = {"float32": 0, "float64": 0}
    for (_, _, name), n in stencil.KERNEL.shapes.items():
        out[name] += n
    return out


class StepSolves:
    """A problem's KLE solves step by step: each call returns those made
    since the last, or the first since ``mark`` (entries of p.cg_iters
    and p.ir_rounds; default all of them so far): their count, their
    refinement rounds and their inner float32 CG iterations."""

    def __init__(self, p, mark=None):
        self.p = p
        self.mark = mark or (len(p.cg_iters), len(p.ir_rounds))

    def __call__(self):
        p, (ns, nr) = self.p, self.mark
        self.mark = len(p.cg_iters), len(p.ir_rounds)
        return {"kle_solves": len(p.cg_iters) - ns,
                "rounds": sum(p.ir_rounds[nr:]),
                "inner_cg_iters": sum(p.cg_iters[ns:])}


def timed_run(p, **run_kw):
    """p.run(**run_kw) with a record of every accepted step: its ms (the
    first includes the initial condition of a fresh run), KLE solves,
    refinement rounds and inner float32 CG iterations, and stencil2d's
    launches by dtype over the run."""
    cuda = p.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    stencil.KERNEL.reset_counts()
    rows, solves = [], StepSolves(p)
    sync()
    last = [time.perf_counter()]

    def callback(n, t, dt, vort, vel):
        sync()
        now = time.perf_counter()
        rows.append({"step": n, "t": t, "ms": 1e3 * (now - last[0]),
                     **solves()})
        last[0] = now

    t0 = time.perf_counter()
    _, t, n = p.run(callback=callback, **run_kw)
    sync()
    seconds = time.perf_counter() - t0
    later = [r["ms"] for r in rows[1:]] or [r["ms"] for r in rows]
    return {"t": t, "steps": n, "seconds": seconds, "step_rows": rows,
            "ms_per_step": sum(later) / max(len(later), 1),
            "rounds_per_solve": sum(p.ir_rounds) / max(len(p.ir_rounds), 1),
            "inner_cg_iters_per_solve": sum(p.cg_iters)
            / max(len(p.cg_iters), 1),
            "flux_cg_iters": list(p.coupling.cg_iters),
            "launches_by_dtype": launches_by_dtype()}


def setup_problem(cfg, device):
    """(the set-up problem, its setup seconds)."""
    t0 = time.perf_counter()
    p = ImmersedBoundaryProblem(cfg, device=device).setup()
    if p.device.type == "cuda":
        torch.cuda.synchronize()
    return p, time.perf_counter() - t0


def drag_protocol(geom, device, ckpt_dir, steps=STEPS, seg_steps=SEG_STEPS,
                  ckpt_every=CKPT_EVERY):
    """The Re-40 drag protocol at ``geom`` (nelem, lower, upper): a run
    of ``steps`` steps checkpointed every ``ckpt_every`` (into
    ``ckpt_dir``), then one segment per dt of SEG_DTS resumed from the
    last checkpoint for ``seg_steps`` steps, and the Richardson
    elimination of the means of each segment's last MEAN_LAST raw
    coefficients and dts. Returns the record of every stage and the
    results; the gates are gate_failures'."""
    if steps % ckpt_every:
        raise ValueError(f"steps ({steps}) must be a multiple of "
                         f"ckpt_every ({ckpt_every}): the segments resume "
                         "from the last step")
    device = resolve_device(device)
    ck = os.path.join(ckpt_dir, "cyl_ck_re40.npz")
    p, setup_s = setup_problem(re40_config(**geom), device)
    main = timed_run(p, max_steps=steps, checkpoint_path=ck,
                     checkpoint_every=ckpt_every)
    main.update(setup_s=setup_s, u_ref=p.u_ref, re=p.re,
                refine=p._refine, inner_dtype=str(p.system32.diag_K.dtype),
                velocity_dofs=p.mesh.n_nodes * p.dim,
                lagrange_points=p.body.n_nodes)
    segments = []
    for max_dt in SEG_DTS:
        ps, seg_setup = setup_problem(re40_config(max_dt, **geom), device)
        seg = timed_run(ps, max_steps=main["steps"] + seg_steps,
                        resume_from=ck)
        cds = [c[0] for c in ps.cd_raw_history]
        cls = [c[0] for c in ps.cl_raw_history]
        seg.update(setup_s=seg_setup, max_dt=max_dt,
                   cd_raw=cds, cl_raw=cls, dt=list(ps.dt_history),
                   cd_raw_mean=float(np.mean(cds[-MEAN_LAST:])),
                   cl_raw_mean=float(np.mean(cls[-MEAN_LAST:])),
                   dt_mean=float(np.mean(ps.dt_history[-MEAN_LAST:])),
                   cd_history_len=len(ps.cd_history),
                   t_history_head=ps.t_history[:main["steps"]])
        segments.append(seg)
    a, b = segments
    cd_phys = richardson(a["cd_raw_mean"], a["dt_mean"],
                         b["cd_raw_mean"], b["dt_mean"])
    cl_phys = richardson(a["cl_raw_mean"], a["dt_mean"],
                         b["cl_raw_mean"], b["dt_mean"])
    return {"geom": {k: list(v) for k, v in geom.items()},
            "device": str(device), "main": main, "segments": segments,
            "main_t_history": p.t_history,
            "cd_phys": cd_phys, "cl_phys": cl_phys,
            "ref_cd_phys": REF_CD_PHYS,
            "cd_phys_minus_ref": cd_phys - REF_CD_PHYS}


def gate_failures(res):
    """The gates of test_static_cylinder_re40_drag that ``res`` (a
    drag_protocol record) fails, as messages."""
    bad = []
    main, (a, b) = res["main"], res["segments"]
    if not (abs(main["u_ref"] - 1.0) < 1e-12 and abs(main["re"] - 40) < 1e-9):
        bad.append(f"u_ref {main['u_ref']!r}, Re {main['re']!r}")
    if not main["t"] > T_MIN:
        bad.append(f"t {main['t']:.6g} after {main['steps']} steps is not "
                   f"past {T_MIN:g}")
    for seg in (a, b):
        if not abs(seg["dt_mean"] - seg["max_dt"]) < DT_TOL:
            bad.append(f"segment dt {seg['dt_mean']!r} is not "
                       f"{seg['max_dt']:g}")
    lo, hi = CD_WINDOW
    if not lo < res["cd_phys"] < hi:
        bad.append(f"cd_phys {res['cd_phys']:.6f} outside ({lo:g}, {hi:g})")
    if not abs(res["cl_phys"]) < CL_MAX:
        bad.append(f"|cl_phys| {abs(res['cl_phys']):.3e} >= {CL_MAX:g}")
    return bad


def report(res):
    """Print a drag_protocol record's stages, steps and results."""
    main = res["main"]
    print(f"refine {main['refine']} (inner {main['inner_dtype']}), "
          f"{main['velocity_dofs']} velocity dofs, "
          f"{main['lagrange_points']} Lagrange points", flush=True)
    stages = [("run", main)] + [(f"segment dt {s['max_dt']:g}", s)
                                for s in res["segments"]]
    for name, st in stages:
        rows = st["step_rows"]
        print(f"[{name}] setup {st['setup_s']:.2f} s, steps "
              f"{rows[0]['step']}-{rows[-1]['step']} to t = {st['t']:.6f} "
              f"in {st['seconds']:.2f} s, {st['ms_per_step']:.1f} ms per "
              "accepted step after the first, "
              f"{st['rounds_per_solve']:.3f} rounds and "
              f"{st['inner_cg_iters_per_solve']:.2f} inner CG iterations a "
              f"solve; stencil2d launches {st['launches_by_dtype']}",
              flush=True)
        print("  per step (ms, rounds, inner CG): " + " ".join(
            f"{r['step']}:{r['ms']:.0f}/{r['rounds']}/{r['inner_cg_iters']}"
            for r in rows), flush=True)
    for s in res["segments"]:
        print(f"segment dt {s['max_dt']:g}: mean of the last {MEAN_LAST}: "
              f"cd_raw {s['cd_raw_mean']:.6f}, cl_raw {s['cl_raw_mean']:.3e},"
              f" dt {s['dt_mean']!r}", flush=True)
    print(f"cd_phys {res['cd_phys']:.6f} (reference {REF_CD_PHYS:.4f}, "
          f"difference {res['cd_phys_minus_ref']:+.6f}), cl_phys "
          f"{res['cl_phys']:.3e}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("protocol", choices=("re40", "big", "st"))
    ap.add_argument("--out", default=os.path.join("chiprun_out",
                                                  "ibm_regression.json"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.protocol != "re40":
        raise NotImplementedError(NOT_PORTED.format(args.protocol))
    device = resolve_device(args.device)
    t0 = time.perf_counter()
    card = None
    if device.type == "cuda":
        from pynama_tpu_torch.scripts.stencil_breakdown import card_line

        card = f"{torch.cuda.get_device_name(0)} | {card_line()}"
        print(card, flush=True)
        stencil.build_kernels([stencil.KERNEL])
        print(f"stencil2d built in {stencil.KERNEL.build_seconds:.1f} s",
              flush=True)
    with tempfile.TemporaryDirectory() as d:
        res = drag_protocol(RE40_GEOM, device, d, steps=STEPS,
                            seg_steps=SEG_STEPS, ckpt_every=CKPT_EVERY)
    res.update(card=card, seconds=time.perf_counter() - t0,
               gate_failures=gate_failures(res))
    report(res)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(f"wrote {args.out}; {res['seconds']:.1f} s in all", flush=True)
    for msg in res["gate_failures"]:
        print(f"gate failed: {msg}", file=sys.stderr, flush=True)
    return 1 if res["gate_failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
