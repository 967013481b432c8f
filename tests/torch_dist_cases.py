"""The cases that the distributed twins run on gloo ranks
(tests/test_torch_sharded.py, tests/test_torch_dist_mg.py,
tests/test_torch_unstructured_dist*.py): the configs of
tests/test_sharded.py and the port's runs of them, on ranks and on one
device. Spawned ranks import this module by name, so it
imports torch, numpy and the port, never JAX.

``run_jobs(rank, jobs)`` runs a list of (key, case name, args) on every
rank of the group and returns the rank's {key: result}."""

import numpy as np
import torch
import torch.distributed as dist

from pynama_tpu_torch.cases.analytic import CustomFuncProblem
from pynama_tpu_torch.cases.cavity import CavityProblem
from pynama_tpu_torch.cases.uniform import UniformFlowProblem
from pynama_tpu_torch.parallel.sharded_problem import ShardedNSProblem
from pynama_tpu_torch.parallel.unstructured import ShardedUnstructuredProblem

CASES = {"taylor-green": lambda cfg: CustomFuncProblem(
             cfg, case="taylor-green", device="cpu"),
         "cavity": lambda cfg: CavityProblem(cfg, device="cpu"),
         "uniform": lambda cfg: UniformFlowProblem(cfg, device="cpu")}


def make_config(nelem, ngl, rho=1.0, mu=0.01, **ts):
    """tests/test_cases.py's make_config (copied: that module imports
    JAX)."""
    dim = len(nelem)
    return {
        "name": "test",
        "material-properties": {"rho": rho, "mu": mu},
        "domain": {"ngl": ngl, "box-mesh": {
            "nelem": list(nelem), "lower": [0] * dim, "upper": [1] * dim}},
        "time-solver": {"start-time": ts.get("start", 0.0),
                        "end-time": ts.get("end", 1.0),
                        "max-steps": ts.get("max_steps", 50)},
    }


def tg_config(max_steps=20, **extra):
    """test_sharded.py's Taylor-Green: 4x8 Q2, Jacobi-CG."""
    cfg = make_config((4, 8), 3, rho=0.5, mu=0.01, end=0.02,
                      max_steps=max_steps)
    cfg["multigrid"] = False
    cfg.update(extra)
    return cfg


def cavity_config():
    """test_sharded.py's 4x8 cavity, Jacobi-CG."""
    cfg = make_config((4, 8), 3, rho=1.0, mu=0.1, end=0.1, max_steps=10)
    cfg["boundary-conditions"] = {"no-slip": {"up": [1.0, 0.0]}}
    cfg["multigrid"] = False
    return cfg


def mg_cavity_config(n):
    """test_sharded.py's n x n multigrid cavity at KLE rtol 1e-11."""
    cfg = make_config((n, n), 3, rho=1.0, mu=0.1, end=0.05, max_steps=6)
    cfg["boundary-conditions"] = {"no-slip": {"up": [1.0, 0.0]}}
    cfg["kle-rtol"] = 1e-11
    return cfg


def channel3d_config():
    """test_sharded.py's channel3d: 3x3x8 Q2, Jacobi-CG."""
    return {
        "name": "ch3d",
        "material-properties": {"rho": 1.0, "mu": 0.01},
        "domain": {"ngl": 3, "box-mesh": {
            "nelem": [3, 3, 8], "lower": [0, 0, 0], "upper": [1, 1, 2.5]}},
        "time-solver": {"start-time": 0.0, "end-time": 0.01,
                        "max-steps": 4},
        "kle-rtol": 1e-10,
        "multigrid": False,
    }


def flat(x):
    return x.reshape(-1).numpy()


# ----------------------------------------------------------------------
# on the ranks
# ----------------------------------------------------------------------
def sharded_run(kind, cfg, pgrid, max_steps=None, staged=False):
    """(global vorticity, t, steps) of ShardedNSProblem(p, pgrid).run()
    (or run_staged())."""
    p = CASES[kind](cfg).setup()
    sp = ShardedNSProblem(p, pgrid)
    run = sp.run_staged if staged else sp.run
    w, t, n = run(max_steps=max_steps)
    return sp.unshard(w, p.dim_w), t, n


def _diff(mine, ref, n_dev, rank):
    """The largest relative difference between the tensors of ``mine``
    and the reference's stacked arrays (same keys, nested dicts and
    lists) at ``rank``; inf where keys or shapes differ."""
    from pynama_tpu_torch.convert import stacked_to_rank

    theirs = stacked_to_rank(ref, (n_dev,), rank, device="cpu")

    def diff(a, b):
        if isinstance(b, dict):
            if a.keys() != b.keys():
                return float("inf")
            return max(diff(a[k], b[k]) for k in b)
        if isinstance(b, list):
            if len(a) != len(b):
                return float("inf")
            return max(map(diff, a, b))
        if a.shape != b.shape:
            return float("inf")
        return float((a - b).abs().max() / b.abs().max().clamp(min=1e-300))

    return diff(mine, theirs)


def sharded_rhs(cfg, n_dev, ref):
    """The distributed RHS of a multigrid cavity at its initial
    vorticity, the vorticity fed through convert.stacked_to_rank from
    the reference's ShardedNSProblem.shard (``ref["w"]``). Returns the
    global RHS, the distributed hierarchy's facts, and whether this
    rank's shard is bitwise the reference's (``ref["w"]``) and how far
    its per-level tensors are from the reference's stacked dist-MG
    pytree (``ref["levels"]``)."""
    from pynama_tpu_torch.convert import stacked_to_rank

    p = CavityProblem(cfg, device="cpu").setup()
    sp = ShardedNSProblem(p, n_dev)
    meta, local, _ = sp._dmg
    rank = sp.ranks.rank
    w = stacked_to_rank(ref["w"], (n_dev,), rank, device="cpu")
    vel = sp.shard(np.zeros(p.mesh.n_nodes * p.dim), p.dim)
    sp.ranks.counts.clear()
    f, _ = sp.build_rhs()(w, (vel, vel), 0.0)
    return {"f": sp.unshard(f, p.dim_w), "tms": meta.tms,
            "aggl": meta.aggl, "n_local_levels": len(local),
            "use_patch": meta.use_patch, "lam_max": meta.lam_max,
            "sbs": meta.sbs, "cg_iters": list(p.cg_iters),
            "counts": dict(sp.ranks.counts),
            "same_shard": torch.equal(sp.shard(p.initial_vorticity(),
                                               p.dim_w), w),
            "levels_diff": _diff(local, ref["levels"], n_dev, rank)}


def patch_apply(cfg, n_dev, ref):
    """dist_patch_apply of a seeded residual on the fine level, its
    inputs (the half weights, the mask, the residual's shard) fed
    through convert.stacked_to_rank from the reference's; and whether
    the port's own are bitwise the same."""
    from pynama_tpu_torch.convert import stacked_to_rank
    from pynama_tpu_torch.parallel.dist_mg import dist_patch_apply

    p = CavityProblem(cfg, device="cpu").setup()
    sp = ShardedNSProblem(p, n_dev)
    meta, local, repl = sp._dmg
    rank = sp.ranks.rank
    half, mask, r = (stacked_to_rank(ref[k], (n_dev,), rank, device="cpu")
                     for k in ("half", "mask", "r"))
    y = dist_patch_apply(repl["levels"][0]["patch_W"], half, mask, r,
                         sp.ranks)
    return {"y": sp.unshard(y, p.dim), "use_patch": meta.use_patch,
            "same_inputs": (torch.equal(local[0]["half"], half)
                            and torch.equal(sp.mask, mask)
                            and torch.equal(sp.shard(ref["r_flat"], p.dim),
                                            r))}


def unstructured_run(kind, cfg):
    """(flat vorticity, t, steps, CG iterations, all-reduces) of
    ShardedUnstructuredProblem(p, world size).run()."""
    p = CASES[kind](cfg).setup()
    sp = ShardedUnstructuredProblem(p, dist.get_world_size())
    w, t, n = sp.run()
    return flat(w), t, n, list(p.cg_iters), sp.counts["all_reduce"]


def unstructured_rhs(cfg, chunks):
    """The initial RHS of a cavity through ShardedUnstructuredProblem(p,
    world size)._eval_rhs_once, its chunk ElementOps made from the
    reference's chunk tables (``chunks``: name -> (A_c, in_c, out_c))
    through convert.chunk_tables_to_rank. Returns (f, CG iterations,
    all-reduces)."""
    from pynama_tpu_torch.convert import chunk_tables_to_rank
    from pynama_tpu_torch.ops.assembly import ElementOp

    p = CavityProblem(cfg, device="cpu").setup()
    sp = ShardedUnstructuredProblem(p, dist.get_world_size())
    for name, op in sp.ops.items():
        sp.ops[name] = ElementOp(*chunk_tables_to_rank(
            chunks[name], p.mesh.n_cells, dist.get_rank(), device="cpu"),
            op.out_size)
    w = sp._flat(p.initial_vorticity())
    f = sp._eval_rhs_once(w, p.t_start, torch.zeros_like(sp.mask))
    return flat(f), list(p.cg_iters), sp.counts["all_reduce"]


def unstructured_refusals(kind, cfg):
    """The errors of ShardedUnstructuredProblem with n_dev other than the
    group's size, and with a problem whose device is the card in a gloo
    group (its device read before any tensor is made), by name."""
    p = CASES[kind](cfg).setup()
    out = {}
    for name, n_dev, device in (
            ("n_dev", dist.get_world_size() + 1, p.device),
            ("device", dist.get_world_size(), torch.device("cuda", 0))):
        p.device, cpu = device, p.device
        try:
            ShardedUnstructuredProblem(p, n_dev)
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
        p.device = cpu
    return out


def run_jobs(rank, jobs):
    """Run (key, case name, args) jobs in order on every rank; this
    rank's {key: result}."""
    return {key: globals()[name](*args) for key, name, args in jobs}


# ----------------------------------------------------------------------
# on one device
# ----------------------------------------------------------------------
def single_run(kind, cfg, max_steps=None):
    """(flat vorticity, t, steps) of the port's single-device run."""
    p = CASES[kind](cfg).setup()
    w, t, n = p.run(max_steps=max_steps)
    return flat(w), t, n


def _shares(dec, coords, k):
    """(local grid) weights that split each interface plane between its
    owners: 1/2 per partitioned axis on a plane shared with a
    neighbour, so the ranks' shares of a node sum to 1 exactly."""
    w = np.ones(dec.local_grid_shape(k))
    for j, p in enumerate(dec.pgrid):
        idx = [slice(None)] * w.ndim
        if coords[j] > 0:
            idx[j] = 0
            w[tuple(idx)] *= 0.5
        if coords[j] < p - 1:
            idx[j] = -1
            w[tuple(idx)] *= 0.5
    return w


def halo_checks(rank):
    """Every halo sum of parallel/slab.py on local partial sums (each
    interface node split between its owners by _shares): after the sums
    each rank's block must equal the global field's, bit for bit; the
    owned-weight dot and RMS norm against the global ones, and
    local_element_apply against the global ElementOp. Returns this
    rank's {check: value}."""
    from pynama_tpu_torch.mesh.structured import BoxMesh
    from pynama_tpu_torch.ops import conv
    from pynama_tpu_torch.ops.assembly import make_element_op
    from pynama_tpu_torch.parallel import slab

    out = {}
    k = 2
    for name, nelem, pgrid in (("slab2d", (3, 8), (4,)),
                               ("pencil2d", (4, 8), (2, 2)),
                               ("slab3d", (2, 3, 4), (4,)),
                               ("pencil3d", (2, 4, 4), (2, 2))):
        dim = len(nelem)
        m = BoxMesh(nelem=nelem, lower=(0,) * dim, upper=(1,) * dim, ngl=3)
        dec = slab.GridDecomposition(m, pgrid)
        ranks = slab.RankGrid(pgrid)
        g = np.random.default_rng(0).normal(size=m.n_nodes * k)
        L = dec.to_local_grid(g, k)[ranks.coords]
        part = L * _shares(dec, ranks.coords, k)
        x = torch.tensor(part)
        for j in range(len(pgrid)):
            x = slab.halo_sum_grid_axis(x, j, ranks)
        out[name + " halo_sum_grid_axis"] = np.array_equal(x.numpy(), L)
        xb = torch.tensor(conv.to_blocked_np(part, 3))
        for j in range(len(pgrid)):
            xb = slab.halo_sum_blocked_axis(xb, 2, dim, j, ranks)
        out[name + " halo_sum_blocked_axis"] = np.array_equal(
            conv.from_blocked(xb, 3, L.shape[:-1]).numpy(), L)
        own = conv.to_blocked_np(dec.owned_grid_weights(k)[ranks.coords], 3)
        Lb = torch.tensor(conv.to_blocked_np(L, 3))
        d = slab.make_pdot(torch.tensor(own), ranks)(Lb, Lb)
        out[name + " make_pdot"] = abs(float(d) / np.dot(g, g) - 1.0)
        e = slab.make_pnorm_mean(torch.tensor(own), g.size, ranks)(Lb * Lb)
        out[name + " make_pnorm_mean"] = abs(
            float(e) / np.sqrt(np.mean(g * g)) - 1.0)
        if len(pgrid) > 1:
            continue
        x = slab.halo_sum_grid(torch.tensor(part), ranks)
        out[name + " halo_sum_grid"] = np.array_equal(x.numpy(), L)
        xb = slab.halo_sum_blocked(
            torch.tensor(conv.to_blocked_np(part, 3)), 2**(dim - 1) * k,
            ranks)
        out[name + " halo_sum_blocked"] = np.array_equal(
            conv.from_blocked(xb, 3, L.shape[:-1]).numpy(), L)
        sd = slab.SlabDecomposition(m, pgrid[0])
        x = slab.halo_sum(torch.tensor(part.reshape(-1)), sd.plane * k,
                          ranks)
        out[name + " halo_sum"] = np.array_equal(
            x.numpy(), sd.to_local(g, k)[ranks.rank])
        A = np.random.default_rng(1).normal(size=(3**dim * k,) * 2)
        glob = make_element_op(A, m.cell_dofs(k), m.cell_dofs(k),
                               m.n_nodes * k, device="cpu")
        cells = sd.local_cell_dofs(k)[ranks.rank]
        loc = make_element_op(A, cells, cells, sd.n_loc * k, device="cpu")
        y = slab.local_element_apply(
            loc, torch.tensor(sd.to_local(g, k)[ranks.rank]), sd.plane * k,
            ranks)
        y_ref = sd.to_local(glob(torch.tensor(g)).numpy(), k)[ranks.rank]
        out[name + " local_element_apply"] = float(
            np.abs(y.numpy() - y_ref).max() / np.abs(y_ref).max())
        out[name + " counts"] = dict(ranks.counts)
    return out


def single_staged(cfg, max_steps):
    """(flat vorticity, t, steps) of the port's single-device Taylor-Green
    run through run_staged's stepping: make_attempt_host_stepper around
    make_bs5_scan_attempt (tests/test_sharded.py's single-device side of
    test_run_staged_attempt_matches_single)."""
    from pynama_tpu_torch.solvers.rk import (make_attempt_host_stepper,
                                             make_bs5_scan_attempt)

    p = CASES["taylor-green"](cfg).setup()
    step = make_attempt_host_stepper(make_bs5_scan_attempt(
        p.transport_rhs, atol=p.ts_atol, rtol=p.ts_rtol,
        wlte_norm=p._wlte_norm()))
    w, vel = p._blk(p.initial_vorticity()), p._blk(p.zero_vel())
    t, dt = p.t_start, p.dt0
    f1, vel = p.transport_rhs(t, w, vel)
    n = 0
    while t < p.t_end - 1e-14 and n < max_steps:
        res = step(w, t, dt, vel, f1, p.t_end)
        w, t, dt, vel, f1 = res.y, res.t, res.dt_next, res.aux, res.f_new
        n += 1
    return flat(p._unblk(w)), t, n
