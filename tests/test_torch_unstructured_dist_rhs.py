"""The dual-mask branch of ShardedUnstructuredProblem (the no-slip cavity:
free-slip solve, the wall fix-up, its curl, the final solve warm-started
from it), which the Taylor-Green twin does not reach: the initial RHS
of an 8x8 jittered Gmsh cavity on 2 gloo ranks, each fed the
reference's own chunk tables through convert.chunk_tables_to_rank,
against the reference's ShardedUnstructuredProblem(p, 2) on 2 of the 8
virtual CPU devices of tests/conftest.py; and the all-reduces it took."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from pynama_tpu.cases.cavity import CavityProblem as RefCavity
from pynama_tpu.parallel.unstructured import \
    ShardedUnstructuredProblem as RefSharded
from pynama_tpu_torch.parallel import launch
from tests import torch_dist_cases as cases
from tests.test_unstructured import _write_msh22_quads, box_corner_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE = 300.0
# the applies of one dual-mask RHS besides those of its CG solves: Rw and
# K bc for each of the two solves, the curl of the free-slip velocity and
# of the result, SrT and DivSrT
FIXED_APPLIES = 2 * 2 + 2 + 1 + 1


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cavity_config(path):
    """configs/cavity.yaml's material and boundary conditions on a Gmsh
    file, at KLE rtol 1e-11."""
    with open(os.path.join(ROOT, "configs", "cavity.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["domain"] = {"ngl": 3, "gmsh-file": str(path)}
    cfg["kle-rtol"] = 1e-11
    return cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    path = tmp_path_factory.mktemp("unstructured_rhs") / "cavity8.msh"
    pts, quads = box_corner_mesh(8, 8, distort=0.15 / 8, seed=1)
    _write_msh22_quads(str(path), pts, quads)
    cfg = cavity_config(path)
    ref = RefSharded(RefCavity(cfg).setup(), 2)
    chunks = {name: tuple(np.asarray(x) for x in getattr(ref, name + "_c"))
              for name in ("K", "Rw", "Curl", "SrT", "Div")}
    ranks = launch.start(cases.run_jobs, 2, args=([
        ("rhs", "unstructured_rhs", (cfg, chunks))],))
    dt = ref.p.dtype
    f_ref = ref._eval_rhs_once(jnp.zeros(ref.n_vort, dtype=dt),
                               jnp.asarray(0.0, dtype=dt),
                               jnp.zeros(ref.n_vel, dtype=dt))
    return np.asarray(f_ref), [r["rhs"] for r in ranks.join(DEADLINE)]


def test_unstructured_dual_mask_rhs_matches_reference(runs):
    f_ref, ranks = runs
    for f, _, _ in ranks:
        assert np.linalg.norm(f_ref) > 0
        assert np.linalg.norm(f - f_ref) / np.linalg.norm(f_ref) < 1e-10


def test_unstructured_dual_mask_rhs_all_reduces(runs):
    """One all-reduce an elemental apply: CG's first residual and one a
    CG iteration in each solve, and the RHS's fixed applies; the same on
    every rank."""
    _, ranks = runs
    _, iters, n_ar = ranks[0]
    assert len(iters) == 2
    assert n_ar == sum(it + 1 for it in iters) + FIXED_APPLIES
    assert all(r[1] == iters and r[2] == n_ar for r in ranks)
