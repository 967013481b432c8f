"""The distributed V-cycle (parallel/dist_mg.py) on gloo ranks: the twins
of tests/test_sharded.py's distributed-multigrid tests (the agglomerated
one is tests/test_torch_dist_mg_agglomerated.py), each held to
the reference test's bound against the port's single-device run and the
reference's single-device run (transport_rhs, MGPreconditioner.
_patch_apply), never against the reference's ShardedNSProblem runs (its
shard_map programs take minutes to compile); the reference's
ShardedNSProblem is only constructed, for its stacked inputs, which
convert.stacked_to_rank carries to the ranks and which the port's own
must equal (to rounding in the assembled coarse diagonals). Then
lam_max_jacobi, single-process, against the reference's.

The 16x16 and 32x32 multigrid cavities on 4 ranks, KLE rtol 1e-11,
float64; one spawn, started before the reference's JAX work, which
overlaps it."""

from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pynama_tpu.cases.cavity as ref_cavity
from pynama_tpu.parallel.sharded_problem import ShardedNSProblem as RefSharded
from pynama_tpu_torch.cases.cavity import CavityProblem
from pynama_tpu_torch.parallel import launch
from tests import torch_dist_cases as cases

RHS_TOL = 1e-6      # tests/test_sharded.py's distributed RHS bound
PATCH_TOL = 1e-12   # its dist_patch_apply bound
LAM_TOL = 1e-12     # float64 power iterations, same draws
LEVEL_TOL = 1e-13   # the port's dist-MG tensors against the reference's
DEADLINE = 600.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1.0)


def ref_inputs(p, n_dev, r_flat=None):
    """The reference ShardedNSProblem's stacked inputs, as numpy: the
    initial vorticity's shard, the dist-MG pytree and its meta; with
    ``r_flat`` the fine level's half weights, the final mask and the
    residual's shard (patch-apply inputs)."""
    sp = RefSharded(p, n_dev)
    meta, stacked, _ = sp._dmg
    out = {"w": np.asarray(sp.shard(np.asarray(p.initial_vorticity())
                                    .reshape(-1), p.dim_w)),
           "levels": [{k: np.asarray(v) for k, v in st.items()}
                      for st in stacked],
           "meta": {"tms": meta.tms, "use_patch": meta.use_patch,
                    "lam_max": meta.lam_max, "sbs": meta.sbs,
                    "aggl": meta.aggl}}
    if r_flat is not None:
        out.update(half=out["levels"][0]["half"], mask=np.asarray(sp.mask),
                   r=np.asarray(sp.shard(r_flat, p.dim)), r_flat=r_flat)
    return out


def ref_rhs(p):
    f, _ = p.transport_rhs(jnp.asarray(0.0, p.dtype), p.initial_vorticity(),
                           p.zero_vel())
    return np.asarray(f).reshape(-1)


def port_rhs(n):
    p = CavityProblem(cases.mg_cavity_config(n), device="cpu").setup()
    f, _ = p.transport_rhs(0.0, p.initial_vorticity(), p.zero_vel())
    return p, f.reshape(-1).numpy()


@pytest.fixture(scope="module")
def runs():
    ref = {n: ref_cavity.CavityProblem(cases.mg_cavity_config(n)).setup()
           for n in (16, 32)}
    r_flat = np.random.default_rng(3).normal(
        size=ref[16].mesh.n_nodes * ref[16].dim)
    inputs = {16: ref_inputs(ref[16], 4, r_flat), 32: ref_inputs(ref[32], 4)}
    four = launch.start(cases.run_jobs, 4, args=([
        ("rhs16", "sharded_rhs", (cases.mg_cavity_config(16), 4,
                                  inputs[16])),
        ("patch", "patch_apply", (cases.mg_cavity_config(16), 4,
                                  inputs[16])),
        ("rhs32", "sharded_rhs", (cases.mg_cavity_config(32), 4,
                                  inputs[32]))],))
    out = {"inputs": inputs, "ref": ref, "r_flat": r_flat}
    for n in (16, 32):
        out[f"ref_f{n}"] = ref_rhs(ref[n])
        out[f"port{n}"], out[f"port_f{n}"] = port_rhs(n)
    out["ranks4"] = four.join(DEADLINE)
    return out


def check_rhs(runs, n, key, ranks):
    res = [r[key] for r in runs[ranks]]
    assert all(r["same_shard"] for r in res)
    # the masks, weights and multiplicities are copies (bitwise); the
    # coarse diagonals are assembled sums, equal to rounding
    assert max(r["levels_diff"] for r in res) < LEVEL_TOL
    meta = runs["inputs"][n]["meta"]
    head = res[0]
    assert head["tms"] == meta["tms"]
    assert head["use_patch"] == meta["use_patch"]
    assert head["sbs"] == meta["sbs"] and head["aggl"] == meta["aggl"]
    np.testing.assert_allclose(head["lam_max"], meta["lam_max"],
                               rtol=LAM_TOL)
    assert rel(head["f"], runs[f"port_f{n}"]) < RHS_TOL
    assert rel(head["f"], runs[f"ref_f{n}"]) < RHS_TOL
    return head


def test_distributed_multigrid_rhs_matches_single(runs):
    """The slab-partitioned multigrid-preconditioned RHS matches the
    single-device MG path (16x16 over 4 ranks: 16/8/4 slabs)."""
    head = check_rhs(runs, 16, "rhs16", "ranks4")
    assert head["n_local_levels"] == len(runs["port16"].mg.levels)
    # every CG iteration all-reduces pAp, r.z and r.r
    its = sum(head["cg_iters"])
    assert head["counts"]["all_reduce"] >= 3 * its


def test_distributed_patch_apply_matches_single(runs):
    """dist_patch_apply (slab-decomposed vertex-star Schwarz, 0.5-weighted
    shared interface planes, a 2-block ghost-margin exchange) equals the
    single-device MGPreconditioner._patch_apply to machine precision."""
    res = [r["patch"] for r in runs["ranks4"]]
    assert all(r["same_inputs"] for r in res)
    assert res[0]["use_patch"][0], "fine level must smooth with patches"
    y = res[0]["y"]
    p = runs["port16"]
    r_b = p._blk(torch.tensor(runs["r_flat"]).reshape(p._gshape(p.dim)))
    y_port = p._unblk(p.mg._patch_apply(0, p.free_mask_b, r_b,
                                        blocked=True)).reshape(-1).numpy()
    q = runs["ref"][16]
    rq = q._blk(jnp.asarray(runs["r_flat"].reshape(q._gshape(q.dim)),
                            q.dtype))
    y_ref = np.asarray(q._unblk(q.mg._patch_apply(
        0, q._m("free_mask"), rq, blocked=True))).reshape(-1)
    for target in (y_port, y_ref):
        assert np.linalg.norm(y - target) / np.linalg.norm(target) \
            < PATCH_TOL


def test_distributed_blocked_transfers_engage_and_match(runs):
    """The blocked-native distributed transfers (ghost-margin exchange)
    engage at 32x32 over 4 slabs (tms[0] is not None) and the RHS
    matches the single-device MG path."""
    head = check_rhs(runs, 32, "rhs32", "ranks4")
    assert head["tms"] and head["tms"][0] is not None, head["tms"]


def _lam_max_parent(mg):
    """MGPreconditioner._estimate_lam_max as it was before the Jacobi
    window (a verbatim copy of its loop)."""
    rng = np.random.default_rng(7)
    lam_max = []
    for li, lvl in enumerate(mg.levels):
        pc = partial(mg._patch_apply, li, lvl.mask, blocked=False)
        x = torch.as_tensor(rng.normal(size=lvl.mask.shape), dtype=mg.dtype,
                            device=mg.device) * lvl.mask
        for _ in range(24):
            y = pc(mg._masked_apply(lvl, lvl.mask, x))
            x = y / torch.linalg.norm(y)
        y = pc(mg._masked_apply(lvl, lvl.mask, x))
        lam_max.append(1.05 * float(torch.linalg.norm(y)
                                    / torch.linalg.norm(x)))
    return lam_max


def test_lam_max_jacobi_matches_reference(runs):
    """lam_max_jacobi per level against the reference's (float64, the
    same default_rng(7) draws); computed only when asked for; lam_max
    bitwise what it was."""
    mg, ref_mg = runs["port16"].mg, runs["ref"][16].mg
    fresh = CavityProblem(cases.mg_cavity_config(16), device="cpu").setup()
    assert fresh.mg._lam_jacobi is None, "single-device setup paid Jacobi"
    np.testing.assert_allclose(mg.lam_max_jacobi, ref_mg.lam_max_jacobi,
                               rtol=LAM_TOL)
    assert len(mg.lam_max_jacobi) == len(mg.levels)
    assert mg.lam_max == _lam_max_parent(mg)
    np.testing.assert_allclose(mg.lam_max, ref_mg.lam_max, rtol=LAM_TOL)
