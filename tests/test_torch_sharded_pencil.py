"""The pencil twins of tests/test_sharded.py: N-D rank grids over the two
slowest grid axes, one halo exchange per partitioned axis in sequence
(the second carries the first's corner sums). Taylor-Green on (2, 2) and
(4, 2) ranks and the dual-mask cavity on (2, 2), Jacobi-CG, each against
the port's and the reference's single-device run (``p.run()``) under
the reference tests' bounds. One spawn per world size (4 and 8), started
before the single-device runs, which overlap them."""

import numpy as np
import pytest
import torch

from pynama_tpu.cases.analytic import CustomFuncProblem as RefCustomFunc
from pynama_tpu.cases.cavity import CavityProblem as RefCavity
from pynama_tpu_torch.parallel import launch
from tests import torch_dist_cases as cases

# the (2, 2) cavity: ~7,000 Jacobi-CG iterations, two halo exchanges each
DEADLINE = 600.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ref_run(problem, max_steps=None):
    w, t, n = problem.setup().run(max_steps=max_steps)
    return np.asarray(w).reshape(-1), float(t), n


@pytest.fixture(scope="module")
def runs():
    tg, cav = cases.tg_config(), cases.cavity_config()
    four = launch.start(cases.run_jobs, 4, args=([
        ("tg(2, 2)", "sharded_run", ("taylor-green", tg, (2, 2))),
        ("cavity", "sharded_run", ("cavity", cav, (2, 2), 4))],))
    eight = launch.start(cases.run_jobs, 8, args=([
        ("tg(4, 2)", "sharded_run", ("taylor-green", tg, (4, 2)))],))
    out = {
        "port_tg": cases.single_run("taylor-green", tg),
        "port_cavity": cases.single_run("cavity", cav, 4),
        "ref_tg": ref_run(RefCustomFunc(tg, case="taylor-green")),
        "ref_cavity": ref_run(RefCavity(cav), 4),
    }
    out.update(four.join(DEADLINE)[0])
    out.update(eight.join(DEADLINE)[0])
    return out


def rel(a, b, floor=0.0):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), floor)


@pytest.mark.parametrize("pgrid", [(2, 2), (4, 2)])
def test_pencil_taylor_green_matches_single(runs, pgrid):
    w, t, n = runs[f"tg{pgrid}"]
    for key in ("port_tg", "ref_tg"):
        w_ref, t_ref, n_ref = runs[key]
        assert n == n_ref
        assert rel(w, w_ref) < 1e-10, key


def test_pencil_cavity_matches_single(runs):
    """Dual-mask cavity solve on a (2, 2) rank grid."""
    w, t, n = runs["cavity"]
    for key in ("port_cavity", "ref_cavity"):
        w_ref, t_ref, n_ref = runs[key]
        assert n == n_ref
        assert rel(w, w_ref, 1.0) < 1e-8, key
