"""ShardedNSProblem.run() (parallel/sharded_problem.py) on gloo ranks: the
twins of tests/test_sharded.py's 2D slab runs, under the reference
tests' bounds: Taylor-Green on 2 and 4 slabs and the dual-mask cavity on
4, each held against the port's single-device run and the reference's
single-device run (``p.run()``), never the reference's ShardedNSProblem
(its shard_map programs take minutes to compile). The 3D twin is
tests/test_torch_sharded_channel3d.py. One spawn per world size,
started before the single-device runs, which overlap them."""

import numpy as np
import pytest
import torch

from pynama_tpu.cases.analytic import CustomFuncProblem as RefCustomFunc
from pynama_tpu.cases.cavity import CavityProblem as RefCavity
from pynama_tpu_torch.parallel import launch
from tests import torch_dist_cases as cases

# seconds the ranks may take: the 4-rank cavity (~7,000 Jacobi-CG
# iterations, 3 all-reduces and a halo exchange each) took 29 s on an
# idle 8-core host and 105 s beside 6 busy processes
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
    two = launch.start(cases.run_jobs, 2, args=([
        ("tg2", "sharded_run", ("taylor-green", tg, 2))],))
    four = launch.start(cases.run_jobs, 4, args=([
        ("tg4", "sharded_run", ("taylor-green", tg, 4)),
        ("cavity", "sharded_run", ("cavity", cav, 4, 4))],))
    out = {
        "port_tg": cases.single_run("taylor-green", tg),
        "port_cavity": cases.single_run("cavity", cav, 4),
        "ref_tg": ref_run(RefCustomFunc(tg, case="taylor-green")),
        "ref_cavity": ref_run(RefCavity(cav), 4),
    }
    out.update(two.join(DEADLINE)[0])
    out.update(four.join(DEADLINE)[0])
    return out


def rel(a, b, floor=0.0):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), floor)


@pytest.mark.parametrize("n_dev", [2, 4])
def test_sharded_taylor_green_matches_single(runs, n_dev):
    w, t, n = runs[f"tg{n_dev}"]
    for key in ("port_tg", "ref_tg"):
        w_ref, t_ref, n_ref = runs[key]
        assert n == n_ref
        assert abs(t - t_ref) < 1e-14
        assert rel(w, w_ref) < 1e-10, key


def test_sharded_cavity_matches_single(runs):
    """The dual-mask cavity on 4 slabs, Jacobi-CG as in the reference
    test; CG's reductions sum in another order over 4 ranks, and the
    corner-singular cavity amplifies it more than Taylor-Green."""
    w, t, n = runs["cavity"]
    for key in ("port_cavity", "ref_cavity"):
        w_ref, t_ref, n_ref = runs[key]
        assert n == n_ref
        assert rel(w, w_ref, 1.0) < 1e-8, key
