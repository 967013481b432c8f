"""The lid-driven cavity's setup in both packages, and its explicit
time-step limit: above it both packages blow up the same way, step by
step, so a blow-up of the port there is the time stepping, not a fault
of the port."""

import numpy as np
import pytest
import torch

from pynama_tpu.cases.cavity import CavityProblem as RefCavity
from pynama_tpu_torch.cases.cavity import CavityProblem
from tests.test_cases import make_config
from tests.test_torch_cavity import cavity_config


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_cavity_setup_matches_reference():
    cfg = cavity_config()
    p = CavityProblem(cfg, dtype=torch.float64, device="cpu").setup()
    q = RefCavity(cfg).setup()
    # same masks, same multigrid hierarchy
    for name in ("free_mask_b", "free_mask_fs_b", "_u_bc_b", "_fsfree_b"):
        assert np.array_equal(getattr(p, name).numpy(),
                              np.asarray(getattr(q, name)))
    assert p.mg.ratios == q.mg.ratios
    assert p._frees_boundary["free_mask_fs"]
    assert not p._frees_boundary["free_mask"]


def fixed_dt_config(nelem, dt, multigrid=False):
    """nelem x nelem Q2 cavity at mu 0.01 stepping at a fixed dt: max-dt
    holds it and atol = rtol = 1e12 accept every attempt. Jacobi-CG KLE
    solves keep the reference's compiled step small; the time-step limit
    does not depend on the KLE preconditioner."""
    cfg = make_config((nelem, nelem), 3, rho=1.0, mu=0.01, end=100.0,
                      max_steps=10)
    cfg["time-solver"].update({"dt0": dt, "max-dt": dt, "atol": 1e12,
                               "rtol": 1e12})
    cfg["boundary-conditions"] = {"no-slip": {"up": [1.0, 0.0]}}
    cfg["multigrid"] = multigrid
    return cfg


def max_vort_per_step(problem, to_numpy, steps=5):
    out = []
    problem.run(max_steps=steps, callback=lambda n, t, dt, vort, vel:
                out.append((t, float(np.abs(to_numpy(vort)).max()))))
    return out


def test_explicit_step_limit_matches_reference():
    """dt 0.6 lies above the 8x8 cavity's explicit limit (0.4 lies below
    it: tests/test_torch_cavity_dt_limit.py)."""
    cfg = fixed_dt_config(8, 0.6)
    got = max_vort_per_step(CavityProblem(
        cfg, dtype=torch.float64, device="cpu").setup(), lambda v: v.numpy())
    ref = max_vort_per_step(RefCavity(cfg).setup(), np.asarray)
    assert len(got) == len(ref) == 5
    for (t, w), (t_r, w_r) in zip(got, ref):
        assert abs(t - t_r) <= 1e-12 * t_r
        # the KLE solves stop at rtol 1e-10 and the growth amplifies
        # their differences: 1e-11 apart at step 5
        assert abs(w - w_r) <= 1e-9 * w_r, (t, w, w_r)
    # both blow up: max |vorticity| 23 after one step, ~1e162 after five
    assert got[-1][1] > 1e100 * got[0][1]
