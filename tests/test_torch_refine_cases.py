"""The refined problems (config 'kle-refine', float64) against the
reference: the 8x8 cavity's transient through solve_ir, and a free-slip
Taylor-Green KLE solve (FreeSlipProblem's refine branch). solve_ir
itself is tested in tests/test_torch_solve_ir.py.

The reference's time goes into tracing its jitted BS5 step with two
solve_ir loops per stage; its Jacobi-CG inner solves (multigrid off)
keep that program small."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pynama_tpu.cases.analytic import CustomFuncProblem as RefCustomFunc
from pynama_tpu.cases.cavity import CavityProblem as RefCavity
from pynama_tpu_torch.cases.analytic import CustomFuncProblem
from pynama_tpu_torch.cases.cavity import CavityProblem
from tests.test_cases import make_config
from tests.test_torch_cavity_setup import fixed_dt_config

F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_refined_cavity_transient_matches_reference():
    """3 steps at dt 0.1, below the 8x8 cavity's explicit limit (0.4 is
    below it too: tests/test_torch_cavity_dt_limit.py); every solve is
    refined to a true relative residual of 1e-10 (the default kle-rtol)."""
    cfg = {**fixed_dt_config(8, 0.1), "kle-refine": True}
    p = CavityProblem(cfg, dtype=F64, device="cpu").setup()
    q = RefCavity(cfg).setup()
    assert p._refine and q._refine
    vort, t, n = p.run(max_steps=3)
    vort_r, t_r, n_r = q.run(max_steps=3)
    assert n == n_r == 3 and abs(t - t_r) <= 1e-12 * t_r
    assert vort.dtype == F64 and p.ir_rounds
    vort, vort_r = vort.numpy(), np.asarray(vort_r)
    err = np.linalg.norm(vort - vort_r) / np.linalg.norm(vort_r)
    assert err < 1e-8, err
    vel, vel_r = p.vel.numpy(), np.asarray(q.vel)
    assert np.linalg.norm(vel - vel_r) / np.linalg.norm(vel_r) < 1e-8


def test_refined_free_slip_solve_matches_reference():
    """2D Taylor-Green on 4x4 Q2 elements, every boundary dof pinned:
    one refined solve_kle in each package at t = 0.3^2 / (4 nu)."""
    cfg = {**make_config((4, 4), 3, rho=1.0, mu=0.01), "kle-refine": True,
           "kle-rtol": 1e-10}
    p = CustomFuncProblem(cfg, case="taylor-green", dtype=F64,
                          device="cpu").setup()
    q = RefCustomFunc(cfg, case="taylor-green").setup()
    t = 0.3**2 / (4.0 * p.nu)
    _, w = p.exact_fields(t)
    w = w.reshape(p._gshape(1))
    u = p.solve_kle(t, w)
    u_r = np.asarray(jax.jit(lambda v: q.solve_kle(t, v))(
        jnp.asarray(w.numpy())))
    assert u.dtype == F64 and len(p.ir_rounds) == len(p.cg_iters) == 1
    err = np.abs(u.numpy() - u_r).max() / np.abs(u_r).max()
    assert err < 1e-10, err
    # the true float64 residual, formed anew with every correction
    wb, ub = p._blk(w), p._blk(u)
    b = p.system.rhs(wb, p._solver_bc(t), p.free_mask_b)
    r = b - p.system.apply_masked(ub, p.free_mask_b)
    rel = float(torch.linalg.norm(r) / torch.linalg.norm(b))
    assert rel <= 1e-8, rel
