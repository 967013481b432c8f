"""Coarse-grid agglomeration of the distributed V-cycle: the twin of
tests/test_sharded.py's test_distributed_multigrid_agglomerated_tail (the
48x48 multigrid cavity on 8 gloo ranks, whose 48/24/12 hierarchy
distributes only its first two levels: the coarser tail runs as the
single-device V-cycle on every rank after an all-gather), held to the
reference test's bound against the port's and the reference's
single-device RHS; and that tail V-cycle, MGPreconditioner.build(
start_level=1), against the reference's on one seeded residual."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pynama_tpu.cases.cavity as ref_cavity
from pynama_tpu_torch.ops import conv
from pynama_tpu_torch.parallel import launch
from tests import torch_dist_cases as cases
from tests.test_torch_dist_mg import (DEADLINE, check_rhs, port_rhs,
                                      ref_inputs, ref_rhs)

TAIL_TOL = 1e-12    # one float64 V-cycle


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs():
    ref = ref_cavity.CavityProblem(cases.mg_cavity_config(48)).setup()
    inputs = ref_inputs(ref, 8)
    eight = launch.start(cases.run_jobs, 8, args=([
        ("rhs48", "sharded_rhs", (cases.mg_cavity_config(48), 8,
                                  inputs))],))
    port, port_f = port_rhs(48)
    return {"inputs": {48: inputs}, "ref_f48": ref_rhs(ref),
            "port_f48": port_f, "ref48": ref, "port48": port,
            "ranks8": eight.join(DEADLINE)}


def test_distributed_multigrid_agglomerated_tail(runs):
    """On 8 slabs the 48/24/12 hierarchy distributes only its first two
    levels (12 % 8 != 0); the coarser tail runs as the single-device
    V-cycle after an all-gather, and the RHS matches single-device."""
    head = check_rhs(runs, 48, "rhs48", "ranks8")
    assert head["aggl"] and head["n_local_levels"] == 2


def test_tail_vcycle_matches_reference(runs):
    """build(start_level=1), the tail V-cycle with level 1's own mask,
    against the reference's on one seeded level-1 residual."""
    mg, ref_mg = runs["port48"].mg, runs["ref48"].mg
    assert len(mg.levels) >= 3, "the tail must be a V-cycle"
    lvl = mg.levels[1]
    g = np.random.default_rng(11).normal(size=tuple(reversed(lvl.mesh.npts))
                                         + (mg.dim,))
    rb = conv.to_blocked_np(g, lvl.K.eff_ngl)
    x = mg.build(start_level=1)(torch.tensor(rb)).numpy()
    x_ref = np.asarray(ref_mg.build(start_level=1)(jnp.asarray(rb)))
    assert np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref) < TAIL_TOL
