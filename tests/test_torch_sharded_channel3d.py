"""The twin of tests/test_sharded.py's test_sharded_channel3d_matches_single:
uniform channel flow on 3x3x8 Q2 hexes (Jacobi-CG, KLE rtol 1e-10)
distributed over 4 gloo ranks, against the reference's single-device
run under the reference test's bound, and against the port's
single-device run in steps and t.

The vorticity is held against the reference's run, not the port's: the
exact vorticity is zero, so what the test compares is the CG stopping
point of the first KLE solve. The reference's single-device run and the
port's distributed runs stop it after 73 iterations; the port's
single-device run stops after 72, its residual 1.3% under the
tolerance, where the reductions of 2 or 4 ranks (another summation
order, ~1e-16 apart) have drifted 13-18% by iteration 72. That one
iteration leaves 1.48e-9 between the port's single-device vorticity and
either of the others (3.2e-11 between those two), above the 1e-9 bound.
The reference's jitted 3D run compiles for ~50 s when the persistent
cache is cold (tests/test_sharded.py runs the same program)."""

import numpy as np
import pytest
import torch

from pynama_tpu.cases.uniform import UniformFlowProblem as RefUniform
from pynama_tpu_torch.parallel import launch
from tests import torch_dist_cases as cases

DEADLINE = 600.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs():
    cfg = cases.channel3d_config()
    four = launch.start(cases.run_jobs, 4, args=([
        ("channel3d", "sharded_run", ("uniform", cfg, 4))],))
    w, t, n = RefUniform(cfg).setup().run()
    return {"ref": (np.asarray(w).reshape(-1), float(t), n),
            "port": cases.single_run("uniform", cfg),
            "dist": four.join(DEADLINE)[0]["channel3d"]}


def test_sharded_channel3d_matches_single(runs):
    """3D slabs over 4 ranks match the single-device run."""
    w, t, n = runs["dist"]
    w_ref, t_ref, n_ref = runs["ref"]
    assert n == n_ref == runs["port"][2]
    assert abs(t - t_ref) < 1e-14 and abs(t - runs["port"][1]) < 1e-14
    assert np.linalg.norm(w - w_ref) < 1e-9
