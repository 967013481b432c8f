"""The lid-driven cavity on a prime element count, 7x7 Q2, whose
multigrid hierarchy takes a padded (fictitious-domain) jump (7 -> 4 on
an 8x8 extension): CavityProblem(cfg).setup().run() for 2 steps in
float64 in both packages, with every KLE solve's CG iterations
(tests/test_torch_run_case_padded.py runs the port's command line on
the same mesh).

Most of this file's time is the reference compiling its BS5 step for
the 7x7 shapes."""

import jax
import numpy as np
import pytest
import torch

from pynama_tpu.cases.cavity import CavityProblem as RefCavity
from pynama_tpu_torch.cases.cavity import CavityProblem
from tests.test_torch_cavity import cavity_config

F64 = torch.float64
STEPS = 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def padded_config():
    return {**cavity_config(),
            "domain": {"ngl": 3, "box-mesh": {"nelem": [7, 7],
                                              "lower": [0, 0],
                                              "upper": [1, 1]}}}


def test_padded_cavity_run_matches_reference():
    cfg = padded_config()
    p = CavityProblem(cfg, dtype=F64, device="cpu").setup()
    q = RefCavity(cfg).setup()
    assert p.mg.ratios == q.mg.ratios == [2]
    assert p.mg.levels[0].ext_mesh.nelem == q.mg.levels[0].ext_mesh.nelem \
        == (8, 8)
    iters, solve = [], q.system.solve

    def recording(*args, **kw):
        res = solve(*args, **kw)
        jax.debug.callback(lambda i: iters.append(int(i)), res.iters,
                           ordered=True)
        return res

    q.system.solve = recording
    vort, t, n = p.run(max_steps=STEPS)
    vort_r, t_r, n_r = q.run(max_steps=STEPS)
    assert n == n_r == STEPS
    assert abs(t - t_r) <= 1e-12 * t_r
    vort, vort_r = vort.numpy(), np.asarray(vort_r)
    err = np.linalg.norm(vort - vort_r) / np.linalg.norm(vort_r)
    assert err < 1e-8, err
    assert p.cg_iters == iters and len(iters) > 0
