"""CLI driver: production runs, convergence charts, operator tests.

Port of pynama_tpu/run_case.py:

  python -m pynama_tpu_torch.run_case -case <name> [-device cuda|cpu]
         [-test kle|chart|operators|chartkle] [-log LEVEL] [-ngl N]
         [-nelem N ...] [-gmsh FILE] [-resume ckpt] [-dtype float32|float64]
         [-max-steps N] [-kle-rtol R] [-max-dt DT] [-opt KEY=VALUE ...]

Modes:
  (default)        transient production run with XDMF/HDF5 output (where
                   h5py is installed), checkpoints and step logging
  -test kle        KLE solves from the exact vorticity at the viscous-time
                   sequence, computed and exact fields written for ParaView
  -test chart      p- and h-refinement KLE convergence chart
  -test operators  convective/diffusive/curl error chart
  -test chartkle   transient error tracking against the analytic solution

The run is on the card unless ``-device cpu`` is given; without a card
the driver exits with an error. Charts need matplotlib: without it they
are skipped with a warning, and everything else is still written. Case
configs are YAML files of the reference's schema, looked up in
./configs/ or by path. ``-gmsh FILE`` (or a config's domain
``gmsh-file``) runs the production run on an unstructured Gmsh mesh,
the IBM cases too (their config's domain then needs ``h-min``, the
spacing of the uniform region around the body: ``-opt
domain.h-min=...``). The -test modes build their problem from the
config's domain and ignore ``-gmsh``; on a Gmsh config ``kle`` and
``chartkle`` run, and ``chart`` (which refines a box mesh) raises
ValueError. Every ``-nelem`` runs, prime element counts too (``-nelem
383 383``: the multigrid pads such a level to the next even count, a
fictitious-domain jump). ``-sharded N`` runs the production run on N
ranks (parallel/sharded_problem.py, run_staged): N gloo processes with
``-device cpu``, else N NCCL processes, rank r on cuda:r, which needs N
visible cards (with fewer the command exits with an error). Rank 0 writes
owner.vtk (each node's owning rank), ``{case}-sharded{N}-metrics.yaml``
and the metrics as a JSON line; like the reference's, the distributed
run ignores ``-gmsh`` and ``-resume`` and saves no checkpoints.
"""

import argparse
import importlib.util
import json
import logging
import os
import time

import numpy as np
import torch
import yaml

from pynama_tpu_torch.device import resolve_device

logger = logging.getLogger("pynama_tpu_torch")

CASE_CLASSES = {
    "uniform": ("pynama_tpu_torch.cases.uniform", "UniformFlowProblem", {}),
    "cavity": ("pynama_tpu_torch.cases.cavity", "CavityProblem", {}),
    "taylor-green": ("pynama_tpu_torch.cases.analytic", "CustomFuncProblem",
                     {"case": "taylor-green"}),
    "taylor-green2d-3d": ("pynama_tpu_torch.cases.analytic",
                          "CustomFuncProblem", {"case": "taylor-green2d-3d"}),
    "senoidal": ("pynama_tpu_torch.cases.analytic", "CustomFuncProblem",
                 {"case": "senoidal"}),
    "flat-plate": ("pynama_tpu_torch.cases.analytic", "CustomFuncProblem",
                   {"case": "flat-plate"}),
    "ibm-static": ("pynama_tpu_torch.cases.immersed",
                   "ImmersedBoundaryProblem", {}),
    "ibm-dynamic": ("pynama_tpu_torch.cases.immersed",
                    "ImmersedBoundaryDynamicProblem", {}),
    # the 3D hex channel: uniform inflow
    "channel3d": ("pynama_tpu_torch.cases.uniform", "UniformFlowProblem", {}),
}

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def load_config(case: str, path=None):
    candidates = [
        path,
        case if case and case.endswith((".yaml", ".yml")) else None,
        os.path.join(os.path.dirname(__file__), "..", "configs", f"{case}.yaml"),
        os.path.join("configs", f"{case}.yaml"),
    ]
    for c in candidates:
        if c and os.path.exists(c):
            with open(c) as f:
                return yaml.safe_load(f)
    raise FileNotFoundError(f"no YAML config found for case '{case}'")


def apply_opts(config, opts):
    """Merge ``-opt key=value`` overrides into the loaded config dict.

    Dotted keys address nested sections (``-opt multigrid.pre=2``);
    values parse as YAML scalars (``-opt kle-rtol=1e-9``,
    ``-opt kle-refine=true``). A section holding a scalar
    (``multigrid: true``) becomes a dict so its sub-keys are
    addressable.
    """
    for item in opts or []:
        if "=" not in item:
            raise SystemExit(f"-opt expects key=value, got {item!r}")
        key, val = item.split("=", 1)
        val = yaml.safe_load(val)
        if isinstance(val, str):
            try:  # YAML 1.1 reads '1e-7' (no dot) as a string
                val = float(val)
            except ValueError:
                pass
        d = config
        parts = key.split(".")
        for p in parts[:-1]:
            cur = d.get(p)
            if not isinstance(cur, dict):
                cur = {}
                d[p] = cur
            d = cur
        d[parts[-1]] = val
    return config


def make_problem(case, config, device=None, dtype=None, **overrides):
    """The case's problem on ``device`` (None: the card); ``dtype`` is
    "float32", "float64" or None (the class's default, float64);
    overrides that are None are dropped."""
    mod_name, cls_name, kw = CASE_CLASSES[case]
    cls = getattr(importlib.import_module(mod_name), cls_name)
    kw = dict(kw, device=device)
    if dtype:
        kw["dtype"] = DTYPES[dtype]
    kw.update({k: v for k, v in overrides.items() if v is not None})
    return cls(config, **kw)


def _apply_run_overrides(p, args):
    """CLI overrides of run length and tolerance."""
    if getattr(args, "max_steps", None) is not None:
        p.max_steps = args.max_steps
    if getattr(args, "kle_rtol", None) is not None:
        p.kle_rtol = args.kle_rtol
    if getattr(args, "max_dt", None) is not None:
        p.ts_max_dt = args.max_dt


def _xdmf_writer(save_dir, p):
    """An XdmfWriter with the mesh saved, or None (and a warning) where
    h5py is not installed."""
    if importlib.util.find_spec("h5py") is None:
        logger.warning("XDMF output disabled: h5py is not installed")
        return None
    from pynama_tpu_torch.io.xdmf import XdmfWriter

    writer = XdmfWriter(save_dir, p.dim)
    writer.save_mesh(p.mesh.coords)
    return writer


def _has_matplotlib(what):
    if importlib.util.find_spec("matplotlib") is None:
        logger.warning("%s skipped: matplotlib is not installed", what)
        return False
    return True


def _host(x):
    return x.reshape(-1).cpu().numpy()


def time_solving(args, config):
    """Production run; returns the metrics it writes."""
    p = make_problem(args.case, config, device=args.device, ngl=args.ngl,
                     nelem=args.nelem, dtype=args.dtype,
                     gmsh_file=getattr(args, "gmsh", None)).setup()
    _apply_run_overrides(p, args)
    save_dir = config.get("save-dir", f"run-{args.case}")
    save_every = int(config.get("save-n-steps", 1))
    writer = _xdmf_writer(save_dir, p)

    t0 = time.perf_counter()

    def cb(step, t, dt, vort, vel):
        logger.info("Converged: Step %4d | Time %.4e | Increment Time: %.2e",
                    step, t, dt)
        if writer is not None and step % save_every == 0:
            writer.save_fields(step, t, velocity=_host(vel),
                               vorticity=_host(vort))
            writer.write_xmf(config.get("name", args.case))

    vort, t, n = p.run(
        callback=cb,
        checkpoint_path=os.path.join(save_dir, "checkpoint.npz"),
        checkpoint_every=max(save_every, 1),
        resume_from=args.resume,
    )
    elapsed = time.perf_counter() - t0
    logger.info("Total Time: %.3f s (%d steps to t=%.4f)", elapsed, n, t)

    metrics = {"steps": n, "final_time": t, "elapsed_s": elapsed}
    if hasattr(p, "cd_history") and p.cd_history:
        from pynama_tpu_torch.io.plots import (drag_lift_chart,
                                               shedding_frequency)

        metrics["cd"] = [c[0] for c in p.cd_history]
        metrics["cl"] = [c[0] for c in p.cl_history]
        metrics["times"] = p.t_history
        if _has_matplotlib("drag-lift chart"):
            drag_lift_chart(p.t_history, metrics["cd"], metrics["cl"],
                            os.path.join(save_dir, "drag-lift.png"))
        f, st = shedding_frequency(p.t_history, metrics["cl"],
                                   u_ref=getattr(p, "u_ref", 1.0))
        metrics["shedding_frequency"] = f
        metrics["strouhal"] = st
    os.makedirs(save_dir, exist_ok=True)
    with open(os.path.join(save_dir, f"{args.case}-metrics.yaml"), "w") as f:
        yaml.safe_dump(metrics, f)
    return metrics


def time_solving_sharded(args, config):
    """Distributed production run over ``-sharded N`` ranks (the
    analogue of running the reference under ``mpirun -n N``): N spawned
    processes, gloo on the CPU and NCCL on the cards; returns rank 0's
    metrics."""
    from pynama_tpu_torch.parallel import launch

    n_dev = int(args.sharded)
    backend = "gloo"
    if args.device.type == "cuda":
        backend = "nccl"
        count = torch.cuda.device_count()
        if count < n_dev:
            raise SystemExit(
                f"-sharded {n_dev}: only {count} devices visible. For CPU "
                f"ranks pass -device cpu")
    return launch.spawn(_sharded_rank, n_dev, args=(args, config, backend),
                        backend=backend, deadline=None)[0]


def _sharded_rank(rank, args, config, backend):
    """One rank of time_solving_sharded."""
    from pynama_tpu_torch.io.vtk import write_point_cloud
    from pynama_tpu_torch.parallel import launch
    from pynama_tpu_torch.parallel.sharded_problem import ShardedNSProblem

    logging.basicConfig(
        level=(getattr(logging, args.log.upper(), logging.INFO) if rank == 0
               else logging.WARNING),
        format=f"%(levelname)s %(name)s [rank {rank}]: %(message)s")
    n_dev = int(args.sharded)
    device = launch.rank_device(backend)
    p = make_problem(args.case, config, device=device, ngl=args.ngl,
                     nelem=args.nelem, dtype=args.dtype).setup()
    _apply_run_overrides(p, args)
    sp = ShardedNSProblem(p, n_dev)
    save_dir = config.get("save-dir", f"run-{args.case}")
    if rank == 0:
        logger.info("sharded run: %d ranks (%s), %d nodes (%d vel dofs), "
                    "distributed multigrid %s", n_dev, backend,
                    p.mesh.n_nodes, p.mesh.n_nodes * p.dim,
                    "active" if sp._dmg is not None else "OFF (Jacobi-CG)")
        # rank-ownership debug field (the reference's createNumProcVec)
        os.makedirs(save_dir, exist_ok=True)
        write_point_cloud(os.path.join(save_dir, "owner.vtk"),
                          np.asarray(p.mesh.coords),
                          fields={"owner": sp.slab.owner_field()})

    t0 = time.perf_counter()
    step_times = []
    last = [t0]

    def cb(step, t, dt, w, vel):
        now = time.perf_counter()
        step_times.append(now - last[0])
        last[0] = now
        logger.info("Converged: Step %4d | Time %.4e | Increment Time: "
                    "%.2e | %.1f s", step, t, dt, step_times[-1])

    w, t, n = sp.run_staged(callback=cb)
    elapsed = time.perf_counter() - t0
    w_global = sp.unshard(w, p.dim_w)
    if not np.isfinite(w_global).all():
        raise RuntimeError("non-finite vorticity")
    logger.info("Total Time: %.3f s (%d steps to t=%.4f)", elapsed, n, t)
    metrics = {
        "steps": n, "final_time": t, "elapsed_s": elapsed,
        "devices": n_dev, "n_dofs": p.mesh.n_nodes * p.dim,
        "platform": device.type,
        "distributed_multigrid": sp._dmg is not None,
        "s_per_step_steady": (float(np.median(step_times[1:]))
                              if len(step_times) > 1 else None),
        "vort_norm": float(np.linalg.norm(w_global)),
    }
    if rank == 0:
        with open(os.path.join(save_dir,
                               f"{args.case}-sharded{n_dev}-metrics.yaml"),
                  "w") as f:
            yaml.safe_dump(metrics, f)
        print(json.dumps(metrics), flush=True)
    return metrics


def kle_field_dump(args, config):
    """Solve the KLE from the exact vorticity at the viscous-time
    sequence t = tau^2 / (4 nu), and write the computed and exact fields
    (the vorticity check-field is Curl of the exact velocity) for
    ParaView. Prints and returns the errors ||u - u_e||."""
    p = make_problem(args.case, config, device=args.device, ngl=args.ngl,
                     nelem=args.nelem, dtype=args.dtype).setup()
    save_dir = config.get("save-dir", f"run-{args.case}-kle")
    writer = _xdmf_writer(save_dir, p)

    viscous_times = [0.01, 0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8,
                     0.9]
    errors = []
    for step, tau in enumerate(viscous_times):
        t = (tau**2) / (4.0 * p.nu)
        vel_e, vort_e = p.exact_fields(t)
        vel = p.solve_kle(t, vort_e.reshape(p._gshape(p.dim_w)),
                          rtol=1e-13, maxiter=30000, restarts=2)
        vort = p.operators.curl(vel_e.reshape(p._gshape(p.dim)))
        err = float(torch.linalg.norm(vel.reshape(-1) - vel_e.reshape(-1)))
        errors.append(err)
        logger.info("Saving time: %.3f | Step: %d | ||u-u_e|| %.3e",
                    t, step, err)
        if writer is not None:
            writer.save_fields(
                step, t, velocity=_host(vel), vorticity=_host(vort),
                exact_velocity=_host(vel_e), exact_vorticity=_host(vort_e))
            writer.write_xmf(config.get("name", args.case) + "-kle")
    out = {"viscous_times": viscous_times, "errors": errors,
           "save_dir": save_dir}
    print(json.dumps(out))
    return out


def chart_kle(args, config):
    """p- and h-refinement KLE convergence charts: the p-refinement error
    per viscous time beside a Q2 h-refinement curve, both against the
    per-axis node count N*. A Gmsh mesh has no per-axis node count and
    no nelem to refine: it raises ValueError."""
    if config.get("domain", {}).get("gmsh-file"):
        raise ValueError("-test chart refines a box mesh (ngl and nelem); "
                         "a Gmsh mesh has no per-axis node count N*")
    ngls = list(range(3, int(args.max_ngl) + 1, 2))
    taus = [0.2, 0.5, 0.9]
    rows = []
    for ngl in ngls:
        p = make_problem(args.case, config, device=args.device, ngl=ngl,
                         nelem=args.nelem, dtype=args.dtype).setup()
        errs = p.kle_error(taus)
        nstar = max(p.mesh.npts)
        rows.append((ngl, nstar, errs))
        logger.info("p-ref ngl=%2d N*=%3d errors=%s", ngl, nstar,
                    ["%.3e" % e for e in errs])

    # h-refinement at fixed Q2, doubling nelem until the per-axis node
    # count reaches the largest p-refinement mesh's
    n_max = max(r[1] for r in rows)
    dim = p.dim
    h_rows = []
    ne = 2
    while 2 * ne + 1 <= n_max:
        p = make_problem(args.case, config, device=args.device, ngl=3,
                         nelem=(ne,) * dim, dtype=args.dtype).setup()
        errs = p.kle_error(taus)
        h_rows.append((ne, max(p.mesh.npts), errs))
        logger.info("h-ref Q2 nelem=%3d N*=%3d errors=%s", ne,
                    h_rows[-1][1], ["%.3e" % e for e in errs])
        ne *= 2
    out = None
    if _has_matplotlib("KLE convergence chart"):
        from pynama_tpu_torch.io.plots import loglog_error_chart

        series = [
            (f"p-ref tau={tau}", np.array([r[1] for r in rows]),
             np.array([r[2][i] for r in rows]))
            for i, tau in enumerate(taus)
        ] + [
            (f"h-ref Q2 tau={tau}", np.array([r[1] for r in h_rows]),
             np.array([r[2][i] for r in h_rows]))
            for i, tau in enumerate(taus)
            if h_rows
        ]
        out = loglog_error_chart(series, f"chart-kle-{args.case}.png",
                                 xlabel="N* (nodes per axis)",
                                 ylabel="||u - u_exact||")
    res = {"ngl": [r[0] for r in rows], "errors": [r[2] for r in rows],
           "h_nelem": [r[0] for r in h_rows],
           "h_errors": [r[2] for r in h_rows], "chart": out}
    print(json.dumps(res))
    return res


def chart_operators(args, config):
    """Operator-error convergence over ngl."""
    ngls = list(range(3, int(args.max_ngl) + 1, 2))
    rows = []
    for ngl in ngls:
        p = make_problem(args.case, config, device=args.device, ngl=ngl,
                         nelem=args.nelem, dtype=args.dtype).setup()
        conv, diff, curl = p.operators_test(viscous_time=1.0)
        rows.append((ngl, conv, diff, curl))
        logger.info("ngl=%2d conv=%.3e diff=%.3e curl=%.3e",
                    ngl, conv, diff, curl)
    out = None
    if _has_matplotlib("operator-error chart"):
        from pynama_tpu_torch.io.plots import loglog_error_chart

        x = np.array([r[0] for r in rows])
        out = loglog_error_chart(
            [("convective", x, np.array([r[1] for r in rows])),
             ("diffusive", x, np.array([r[2] for r in rows])),
             ("curl", x, np.array([r[3] for r in rows]))],
            f"chart-operators-{args.case}.png", xlabel="ngl", ylabel="error",
        )
    res = {"rows": rows, "chart": out}
    print(json.dumps(res))
    return res


def chart_kle_transient(args, config):
    """Transient error tracking against the exact solution, written to
    chartkle-<case>.yaml; the run's length is the config's (-max-steps
    does not apply, as in the reference)."""
    p = make_problem(args.case, config, device=args.device, ngl=args.ngl,
                     nelem=args.nelem, dtype=args.dtype).setup()
    hist = {"step": [], "time": [], "error2": [], "errorInf": []}

    def cb(step, t, dt, vort, vel):
        vel_e, _ = p.exact_fields(t)
        e = vel.reshape(-1) - vel_e.reshape(-1)
        hist["step"].append(step)
        hist["time"].append(t)
        hist["error2"].append(float(torch.linalg.norm(e)))
        hist["errorInf"].append(float(torch.max(torch.abs(e))))
        logger.info("Step %4d | t=%.4e | e2=%.3e einf=%.3e", step, t,
                    hist["error2"][-1], hist["errorInf"][-1])

    p.run(callback=cb)
    with open(f"chartkle-{args.case}.yaml", "w") as f:
        yaml.safe_dump(hist, f)
    res = {k: v[-1] if v else None for k, v in hist.items()}
    print(json.dumps(res))
    return res


def main(argv=None):
    """Parse ``argv`` and run the mode; returns what the mode returns
    (the metrics of a production run, a -test mode's JSON)."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-case", required=True, choices=sorted(CASE_CLASSES))
    ap.add_argument("-config", default=None, help="explicit YAML path")
    ap.add_argument("-device", default="cuda", choices=["cuda", "cpu"],
                    help="where the run goes (default: the card; without "
                         "one the driver exits with an error)")
    ap.add_argument("-test", default=None,
                    choices=["kle", "chart", "operators", "chartkle"])
    ap.add_argument("-log", default="INFO")
    ap.add_argument("-ngl", type=int, default=None)
    ap.add_argument("-nelem", type=int, nargs="+", default=None)
    ap.add_argument("-gmsh", default=None, metavar="FILE",
                    help="run the case on an unstructured Gmsh mesh "
                         "(overrides the config's domain)")
    ap.add_argument("-max-ngl", type=int, default=9)
    ap.add_argument("-resume", default=None, help="checkpoint to resume from")
    ap.add_argument("-dtype", default=None, choices=["float32", "float64"])
    ap.add_argument("-max-steps", type=int, default=None, dest="max_steps",
                    help="override the config's time-solver max-steps")
    ap.add_argument("-kle-rtol", type=float, default=None, dest="kle_rtol",
                    help="override the config's KLE solve tolerance")
    ap.add_argument("-max-dt", type=float, default=None, dest="max_dt",
                    help="cap the adaptive time step (config 'max-dt')")
    ap.add_argument("-sharded", type=int, default=None, metavar="N",
                    help="a distributed run over N ranks: gloo processes "
                         "with -device cpu, else one card each (NCCL)")
    ap.add_argument("-opt", action="append", default=[], metavar="KEY=VALUE",
                    help="override any config entry (repeatable; dotted "
                         "keys reach nested sections, values parse as "
                         "YAML): -opt multigrid.smoother=jacobi "
                         "-opt kle-solver=gmres")
    args = ap.parse_args(argv)

    logging.basicConfig(
        level=getattr(logging, args.log.upper(), logging.INFO),
        format="%(levelname)s %(name)s: %(message)s",
    )
    try:
        args.device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"{e} (-device cpu on the command line)")
    config = apply_opts(load_config(args.case, args.config), args.opt)
    if args.nelem is not None:
        args.nelem = tuple(args.nelem)

    # -test modes need an analytic exact solution (kle_error and
    # operators_test exist on CustomFuncProblem only)
    analytic = {"taylor-green", "taylor-green2d-3d", "senoidal", "flat-plate"}
    if args.test and args.case not in analytic:
        ap.error(
            f"-test {args.test} requires an analytic-solution case "
            f"({', '.join(sorted(analytic))}); got '{args.case}'"
        )

    if args.test == "kle":
        return kle_field_dump(args, config)
    if args.test == "chart":
        return chart_kle(args, config)
    if args.test == "operators":
        return chart_operators(args, config)
    if args.test == "chartkle":
        return chart_kle_transient(args, config)
    if args.sharded:
        return time_solving_sharded(args, config)
    return time_solving(args, config)


if __name__ == "__main__":
    main()
