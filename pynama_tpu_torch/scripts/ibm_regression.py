"""The immersed-boundary regressions on the card, under mixed-precision
refinement (kle-refine): the drag of a static cylinder at Re 40 and 8.3%
blockage (``re40``) and at 4.2% (``big``), and the shedding frequency of
a kicked cylinder at Re 100 (``st``).

    python -m pynama_tpu_torch.scripts.ibm_regression [re40] [big] [st]
        [--out PATH] [--device cuda|cpu]

Port of scripts/run_ibm_regression_tpu.py: the bodies of
tests/test_ibm_physics.py's test_static_cylinder_re40_drag,
test_static_cylinder_re40_drag_big_domain and
test_cylinder_re100_strouhal with the reference's production solver path
(float64 state and true float64 residuals, float32 multigrid V-cycles).
The protocols named run in the TPU script's order, re40, big, st; with
none named all three run. The run stops at the first protocol whose
gates fail and exits 1.

``re40``: 144x96 Q2 elements of [-6,12]x[-6,6] (blockage D/H = 8.3%,
D/h = 16), 180 adaptive steps checkpointed every 10, then two segments
resumed from the checkpoint, each of 14 steps at a fixed max-dt of 0.06
and 0.03. The raw drag per step scales as cd_raw(dt) = cd_phys +
floor/dt, so the means of each segment's last 8 raw coefficients and dts
eliminate the floor:

    cd_phys = (cd_a dt_a - cd_b dt_b) / (dt_a - dt_b)    (the same for cl)

The test's gates decide the exit code: t > 12 after the 180 steps, the
segments' dts within 1e-6 of 0.06 and 0.03, 1.70 < cd_phys < 2.0 and
|cl_phys| < 0.1. cd_phys is printed beside the reference's recorded
1.8573 (run-artifacts/ibm_regression.json "re40_blockage8.3", a CPU
measurement), which is reported, not gated.

``big``: re40's protocol at the same element size in a box twice as
tall, 144x192 Q2 elements of [-6,12]x[-12,12] (blockage 4.2%). Its gates
are re40's with the big-domain test's drag windows: cd_phys < 1.85
(strictly below the 8.3%-blockage value) and 1.45 < cd_phys < 1.90.
cd_phys is printed beside the reference's recorded 1.7658
("re40_blockage4.2", a TPU measurement under the refined path) and, as
the blockage drop, beside the 8.3% value; both are reported, not
gated.

``st``: 96x64 Q2 elements of [-4,8]x[-4,4] (24,897 nodes), Re 100, a
vortex dipole kicked into the near wake at t = 0 (KickedCylinder), run to
t = 60 in at most 1,400 adaptive steps (max-dt 0.06, kle-rtol 1e-7), the
forces recorded every step. The raw lift over t > 30, interpolated onto a
uniform grid of as many points, its mean taken out, gives the spectrum
whose largest peak above the zero bin is the shedding frequency:
St = f_peak D / u_ref, its prominence the peak over the median amplitude
above the zero bin (strouhal). The test's gates decide the exit code:
t >= 60 - 1e-9, prominence > 10 and 0.15 < St < 0.19. St is printed
beside the reference's recorded 0.1664 (run-artifacts/ibm_regression.json),
which is reported, not gated.

Seconds of every stage, ms per accepted step, the refinement rounds and
inner float32 CG iterations of every accepted step and stencil2d's
launches by dtype are printed and written as JSON, each protocol's to
its own default under chiprun_out/ (ibm_regression.json for re40,
ibm_regression_big.json for big, ibm_regression_st.json for st; never
run-artifacts/), or to ``--out`` where one protocol is named. It runs on
the card unless ``--device cpu`` is given, and raises without one;
stencil2d is built once a call.
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

# tests/test_ibm_physics.py's geometries of the 8.3%- and 4.2%-blockage
# protocols: the same element size, the second box twice as tall
RE40_GEOM = {"nelem": (144, 96), "lower": (-6, -6), "upper": (12, 6)}
BIG_GEOM = {"nelem": (144, 192), "lower": (-6, -12), "upper": (12, 12)}
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
# the drag gates of test_static_cylinder_re40_drag_big_domain: below the
# 8.3%-blockage value, and a window
BIG_CD_BELOW = 1.85
BIG_CD_WINDOW = (1.45, 1.90)
# run-artifacts/ibm_regression.json "re40_blockage4.2" cd_phys (the
# reference's measurement of this protocol under its refined path, on
# the TPU)
BIG_REF_CD_PHYS = 1.7658329218670357
# each drag protocol by the reference's record key, which blockage_tag()
# reads off the geometry and the checkpoint is named after: the recorded
# cd_phys, and the reference test's cd window and strict upper bound
RE40_TAG, BIG_TAG = "re40_blockage8.3", "re40_blockage4.2"
DRAG = {RE40_TAG: (REF_CD_PHYS, CD_WINDOW, None),
        BIG_TAG: (BIG_REF_CD_PHYS, BIG_CD_WINDOW, BIG_CD_BELOW)}
# tests/test_ibm_physics.py:159-172's configuration of the Re-100 protocol
ST_GEOM = {"nelem": (96, 64), "lower": (-4, -4), "upper": (8, 4)}
ST_END_TIME = 60.0
ST_MAX_STEPS = 1400
ST_LOG_EVERY = 100   # the steps between progress lines
# the gates of test_cylinder_re100_strouhal: the run reaches its end time,
# the lift is analysed over t > ST_T_MIN, and its spectral peak stands
# PROMINENCE_MIN above the median at a Strouhal number in ST_WINDOW
END_TOL = 1e-9
ST_T_MIN = 30.0
PROMINENCE_MIN = 10.0
ST_WINDOW = (0.15, 0.19)
# run-artifacts/ibm_regression.json "re100_strouhal" st (the reference's
# measurement of this protocol under its refined path)
REF_ST = 0.1663894618232804
# each protocol's record under chiprun_out/, in the order of
# scripts/run_ibm_regression_tpu.py
DEFAULT_OUT = {"re40": "ibm_regression.json",
               "big": "ibm_regression_big.json",
               "st": "ibm_regression_st.json"}
PROTOCOLS = tuple(DEFAULT_OUT)


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


def timed_run(p, log_every=0, **run_kw):
    """p.run(**run_kw) with a record of every accepted step: its ms (the
    first includes the initial condition of a fresh run), KLE solves,
    refinement rounds and inner float32 CG iterations, and stencil2d's
    launches by dtype over the run; a line every ``log_every`` steps
    (none if 0) says how far the run has come."""
    cuda = p.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    stencil.KERNEL.reset_counts()
    rows, solves = [], StepSolves(p)
    sync()
    t0 = time.perf_counter()
    last = [t0]

    def callback(n, t, dt, vort, vel):
        sync()
        now = time.perf_counter()
        rows.append({"step": n, "t": t, "ms": 1e3 * (now - last[0]),
                     **solves()})
        last[0] = now
        if log_every and n % log_every == 0:
            print(f"  step {n}: t {t:.6f}, dt proposed {dt:.6g}, "
                  f"{now - t0:.1f} s", flush=True)

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


def setup_problem(cfg, device, cls=ImmersedBoundaryProblem):
    """(the set-up problem, its setup seconds)."""
    t0 = time.perf_counter()
    p = cls(cfg, device=device).setup()
    if p.device.type == "cuda":
        torch.cuda.synchronize()
    return p, time.perf_counter() - t0


def blockage_tag(geom):
    """The reference's record key of the drag protocol at ``geom``: its
    blockage D/H in percent, D = 1 the cylinder's diameter and H the
    box's height (so a cut of the element counts keeps the key)."""
    height = geom["upper"][1] - geom["lower"][1]
    return f"re40_blockage{100.0 / height:.1f}"


def drag_protocol(geom, device, ckpt_dir, steps=STEPS, seg_steps=SEG_STEPS,
                  ckpt_every=CKPT_EVERY):
    """The Re-40 drag protocol at ``geom`` (nelem, lower, upper): a run
    of ``steps`` steps checkpointed every ``ckpt_every`` (into
    ``ckpt_dir``, as cyl_ck_{tag}.npz with blockage_tag's key), then one
    segment per dt of SEG_DTS resumed from the last checkpoint for
    ``seg_steps`` steps, and the Richardson elimination of the means of
    each segment's last MEAN_LAST raw coefficients and dts. cd_phys is
    reported beside the tag's recorded value in DRAG, and beside the
    8.3%-blockage one as the blockage drop. Returns the record of every
    stage and the results; the gates are gate_failures'."""
    if steps % ckpt_every:
        raise ValueError(f"steps ({steps}) must be a multiple of "
                         f"ckpt_every ({ckpt_every}): the segments resume "
                         "from the last step")
    tag = blockage_tag(geom)
    ref = DRAG[tag][0]
    device = resolve_device(device)
    ck = os.path.join(ckpt_dir, f"cyl_ck_{tag}.npz")
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
    return {"tag": tag, "geom": {k: list(v) for k, v in geom.items()},
            "device": str(device), "checkpoint": os.path.basename(ck),
            "main": main, "segments": segments,
            "main_t_history": p.t_history,
            "cd_phys": cd_phys, "cl_phys": cl_phys,
            "ref_cd_phys": ref, "cd_phys_minus_ref": cd_phys - ref,
            "ref_cd_phys_blockage83": REF_CD_PHYS,
            "blockage_drop": cd_phys - REF_CD_PHYS,
            "ref_blockage_drop": ref - REF_CD_PHYS}


def gate_failures(res, cd_window=CD_WINDOW, cd_below=None):
    """The gates that ``res`` (a drag_protocol record) fails, as
    messages: test_static_cylinder_re40_drag's by default, and with
    DRAG's windows of BIG_TAG (cd_phys strictly below BIG_CD_BELOW)
    test_static_cylinder_re40_drag_big_domain's."""
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
    if cd_below is not None and not res["cd_phys"] < cd_below:
        bad.append(f"cd_phys {res['cd_phys']:.6f} is not below "
                   f"{cd_below:g}")
    lo, hi = cd_window
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
    print(f"cd_phys {res['cd_phys']:.6f} (reference {res['ref_cd_phys']:.4f}"
          f", difference {res['cd_phys_minus_ref']:+.6f}), cl_phys "
          f"{res['cl_phys']:.3e}", flush=True)
    print(f"blockage drop from the 8.3% value {REF_CD_PHYS:.4f}: "
          f"{res['blockage_drop']:+.6f} (reference "
          f"{res['ref_blockage_drop']:+.6f})", flush=True)


def st_config(nelem=ST_GEOM["nelem"], lower=ST_GEOM["lower"],
              upper=ST_GEOM["upper"], end_time=ST_END_TIME,
              max_steps=ST_MAX_STEPS):
    """tests/test_ibm_physics.py:159-172's configuration with kle-refine
    on (the TPU script's PYNAMA_IBM_REFINE=1): a static cylinder of radius
    0.5 at the origin, Re 100 (rho 1, mu 0.01, u_ref 1), adaptive steps
    from dt0 0.01 up to max-dt 0.06, kle-rtol 1e-7."""
    return {
        "kle-refine": True,
        "name": "cyl-re100-strouhal",
        "material-properties": {"rho": 1.0, "mu": 0.01},
        "domain": {"ngl": 3, "box-mesh": {"nelem": list(nelem),
                                          "lower": list(lower),
                                          "upper": list(upper)}},
        "boundary-conditions": {"constant": {"re": 100, "direction": 0,
                                             "longRef": "1"}},
        "bodies": [{"type": "circle", "vel": "static", "radius": 0.5,
                    "center": [0, 0]}],
        "time-solver": {"start-time": 0, "end-time": end_time,
                        "max-steps": max_steps, "dt0": 0.01,
                        "max-dt": 0.06},
        "kle-rtol": 1e-7,
    }


def kick(coords):
    """The vortex dipole of tests/test_ibm_physics.py:145-157 at (n, 2)
    node coordinates, in numpy float64: 3 blob(1.2, 0.45, 0.35) -
    3 blob(1.6, -0.4, 0.35), blob a Gaussian of the distance to its
    centre over its width."""
    c = np.asarray(coords)
    x, y = c[:, 0], c[:, 1]

    def blob(x0, y0, s):
        return np.exp(-(((x - x0) ** 2 + (y - y0) ** 2) / s**2))

    return 3.0 * blob(1.2, 0.45, 0.35) - 3.0 * blob(1.6, -0.4, 0.35)


class KickedCylinder(ImmersedBoundaryProblem):
    """The static cylinder started from kick()'s dipole in its near wake
    (tests/test_ibm_physics.py:145-157), which seeds the instability so
    that the shedding frequency locks within t <= 60."""

    def initial_vorticity(self):
        w = kick(self.mesh.coords)
        return self._tensor(w.reshape(self._gshape(self.dim_w)))


def strouhal(t_history, cl_raw, u_ref, t_min=ST_T_MIN):
    """(St, prominence) of a lift history (one coefficient per entry of
    t_history), as test_cylinder_re100_strouhal computes them: the lift
    over t > t_min interpolated onto a uniform grid of as many points, its
    mean taken out; the largest amplitude of its real FFT above the zero
    bin gives f_peak, St = f_peak D / u_ref (D = 1), and the prominence is
    that amplitude over the median amplitude above the zero bin."""
    ts = np.asarray(t_history)
    cls = np.asarray(cl_raw)
    sel = ts > t_min
    tu = np.linspace(ts[sel][0], ts[sel][-1], sel.sum())
    yu = np.interp(tu, ts[sel], cls[sel])
    yu -= yu.mean()
    freqs = np.fft.rfftfreq(len(tu), d=tu[1] - tu[0])
    amp = np.abs(np.fft.rfft(yu))
    i = int(np.argmax(amp[1:]) + 1)
    st = float(freqs[i]) * 1.0 / u_ref
    prominence = float(amp[i] / np.median(amp[1:]))
    return st, prominence


def st_protocol(device):
    """The Re-100 Strouhal protocol at the module's ST_ constants, read
    when called: KickedCylinder at ST_GEOM (nelem, lower, upper) set up
    and run to ST_END_TIME in at most ST_MAX_STEPS steps with the forces
    recorded every step and a progress line every ST_LOG_EVERY, then
    strouhal() of the raw lift over t > ST_T_MIN (None where fewer than
    two entries lie past it). Returns the record of the run and the
    results; the gates are st_gate_failures'."""
    device = resolve_device(device)
    geom, end_time, max_steps, t_min = (ST_GEOM, ST_END_TIME, ST_MAX_STEPS,
                                        ST_T_MIN)
    p, setup_s = setup_problem(st_config(end_time=end_time,
                                         max_steps=max_steps, **geom),
                               device, cls=KickedCylinder)
    res = timed_run(p, log_every=ST_LOG_EVERY, save_forces_every=1)
    res["run_s"] = res.pop("seconds")
    steps = res["step_rows"]
    cls = [c[0] for c in p.cl_raw_history]
    st = prominence = None
    if sum(t > t_min for t in p.t_history) >= 2:
        st, prominence = strouhal(p.t_history, cls, p.u_ref, t_min)
    res.update(
        geom={k: list(v) for k, v in geom.items()}, device=str(device),
        setup_s=setup_s, u_ref=p.u_ref, re=p.re, refine=p._refine,
        inner_dtype=str(p.system32.diag_K.dtype),
        velocity_dofs=p.mesh.n_nodes * p.dim,
        lagrange_points=p.body.n_nodes, end_time=end_time,
        max_steps=max_steps, t_min=t_min,
        kle_solves_per_step=sum(r["kle_solves"] for r in steps[1:])
        / max(len(steps) - 1, 1),
        t_history=list(p.t_history), cl_raw_history=cls,
        dt_history=list(p.dt_history), st=st, prominence=prominence,
        ref_st=REF_ST,
        st_minus_ref=None if st is None else st - REF_ST)
    return res


def st_gate_failures(res):
    """The gates of test_cylinder_re100_strouhal that ``res`` (an
    st_protocol record) fails, as messages."""
    bad = []
    if not res["t"] >= res["end_time"] - END_TOL:
        bad.append(f"t {res['t']:.6g} after {res['steps']} steps is short "
                   f"of {res['end_time']:g}")
    if not res["steps"] <= res["max_steps"]:
        bad.append(f"{res['steps']} steps, over {res['max_steps']}")
    if res["st"] is None:
        bad.append(f"fewer than two lift entries past t = {res['t_min']:g}")
        return bad
    if not res["prominence"] > PROMINENCE_MIN:
        bad.append(f"prominence {res['prominence']:.3f} <= "
                   f"{PROMINENCE_MIN:g}")
    lo, hi = ST_WINDOW
    if not lo < res["st"] < hi:
        bad.append(f"St {res['st']:.6f} outside ({lo:g}, {hi:g})")
    return bad


def st_report(res):
    """Print an st_protocol record's run and results."""
    rows = res["step_rows"]
    print(f"refine {res['refine']} (inner {res['inner_dtype']}), "
          f"{res['velocity_dofs']} velocity dofs, "
          f"{res['lagrange_points']} Lagrange points; setup "
          f"{res['setup_s']:.2f} s", flush=True)
    print(f"[run] {res['steps']} steps to t = {res['t']:.6f} in "
          f"{res['run_s']:.2f} s, {res['ms_per_step']:.1f} ms per accepted "
          f"step after the first (step 1 {rows[0]['ms']:.1f} ms), "
          f"{res['kle_solves_per_step']:.2f} KLE solves a step, "
          f"{res['rounds_per_solve']:.3f} rounds and "
          f"{res['inner_cg_iters_per_solve']:.2f} inner CG iterations a "
          f"solve, {len(res['flux_cg_iters'])} flux solves of "
          f"{np.mean(res['flux_cg_iters']):.2f} CG iterations; stencil2d "
          f"launches {res['launches_by_dtype']}", flush=True)
    if res["st"] is None:
        print(f"St: fewer than two lift entries past t = {res['t_min']:g}",
              flush=True)
        return
    print(f"St {res['st']:.6f} (reference {REF_ST:.4f}, difference "
          f"{res['st_minus_ref']:+.6f}), prominence {res['prominence']:.2f}",
          flush=True)


def run_protocol(name, device):
    """(record, gate failures, report) of one protocol at the module's
    constants, read when called."""
    if name == "st":
        res = st_protocol(device)
        return res, st_gate_failures(res), st_report
    geom = RE40_GEOM if name == "re40" else BIG_GEOM
    with tempfile.TemporaryDirectory() as d:
        res = drag_protocol(geom, device, d, steps=STEPS, seg_steps=SEG_STEPS,
                            ckpt_every=CKPT_EVERY)
    _, cd_window, cd_below = DRAG[res["tag"]]
    return res, gate_failures(res, cd_window, cd_below), report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("protocols", nargs="*", choices=PROTOCOLS,
                    help="run in the order re40, big, st (default: all)")
    ap.add_argument("--out", help="the JSON record, where one protocol is "
                    "named (default chiprun_out/ibm_regression.json for "
                    "re40, chiprun_out/ibm_regression_big.json for big, "
                    "chiprun_out/ibm_regression_st.json for st)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    names = [n for n in PROTOCOLS if n in args.protocols] or list(PROTOCOLS)
    if args.out and len(names) > 1:
        ap.error(f"--out takes one protocol; {' '.join(names)} write to "
                 "their defaults")
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
    for name in names:
        if len(names) > 1:
            print(f"[{name}] start", flush=True)
        res, gates, rep = run_protocol(name, device)
        # seconds since the last protocol ended (the first: the build too)
        res.update(card=card, seconds=time.perf_counter() - t0,
                   gate_failures=gates)
        rep(res)
        out = args.out or os.path.join("chiprun_out", DEFAULT_OUT[name])
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump(res, f, indent=1)
        print(f"wrote {out}; {res['seconds']:.1f} s in all", flush=True)
        for msg in gates:
            print(f"gate failed: {msg}", file=sys.stderr, flush=True)
        if gates:
            return 1
        t0 = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
