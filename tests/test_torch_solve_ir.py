"""Mixed-precision iterative refinement (kle.solve_ir, config
'kle-refine'): float64 state and true float64 residuals, float32
multigrid-CG inner solves. The port's twins of tests/test_kle_solve.py's
two refinement tests, solve_ir against the reference's on the same
inputs, the float32 inner path pinned, and the config's semantics.
The refined transient and free-slip solves against the reference are
in tests/test_torch_refine_cases.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pynama_tpu.cases.cavity import CavityProblem as RefCavity
from pynama_tpu.kle import solve_ir as ref_solve_ir
from pynama_tpu_torch import kle
from pynama_tpu_torch.cases.cavity import CavityProblem
from pynama_tpu_torch.kle import solve_ir
from tests.test_cases import make_config

F32, F64 = torch.float32, torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def refine_config():
    """tests/test_kle_solve.py's refinement config: 8x8 Q2 cavity."""
    cfg = make_config((8, 8), 3, rho=1.0, mu=0.1, end=0.1, max_steps=3)
    cfg["boundary-conditions"] = {"no-slip": {"up": [1.0, 0.0]}}
    cfg["kle-refine"] = True
    return cfg


@pytest.fixture(scope="module")
def problem():
    return CavityProblem(refine_config(), dtype=F64, device="cpu").setup()


def ir(p, name, vort, **kw):
    """solve_ir of the port's problem ``p`` with its mask ``name``."""
    return solve_ir(p.system, p.system32, vort, p._solver_bc(0.0),
                    getattr(p, name + "_b"), getattr(p, name + "32_b"),
                    m_inv32=p._minv[name],
                    corrections=p._frees_boundary[name], **kw)


def true_rel(p, name, vort, x):
    """||b - K x|| / ||b|| in float64, with every correction applied."""
    mask = getattr(p, name + "_b")
    b = p.system.rhs(vort, p._solver_bc(0.0), mask)
    r = b - p.system.apply_masked(x, mask)
    return float(torch.linalg.norm(r) / torch.linalg.norm(b))


def test_mixed_precision_refinement_reaches_true_residual(problem):
    p = problem
    assert p._refine and p.system32 is not None
    w0 = p._blk(p.initial_vorticity())
    res = ir(p, "free_mask_fs", w0, rtol=1e-10)
    rel = true_rel(p, "free_mask_fs", w0, res.x)
    assert rel < 1e-10, rel
    assert res.x.dtype == F64
    # the refined dual-mask solve matches a tight plain-f64 solve
    u = p.solve_kle(0.0, p.initial_vorticity())
    cfg2 = {k: v for k, v in refine_config().items() if k != "kle-refine"}
    p2 = CavityProblem(cfg2, dtype=F64, device="cpu").setup()
    u_ref = p2.solve_kle(0.0, p2.initial_vorticity(), rtol=1e-12,
                         maxiter=30000, restarts=2)
    err = float(torch.linalg.norm(u - u_ref) / torch.linalg.norm(u_ref))
    assert err < 1e-8, err


def test_adaptive_inner_rtol_saves_warm_iterations(problem):
    """A warm start inside the adaptive band: the adaptive inner solve
    spends strictly fewer inner CG iterations, both reaching rtol."""
    p = problem
    name = "free_mask_fs"
    mask = p.free_mask_fs_b
    w0 = p._blk(p.initial_vorticity())
    cold = ir(p, name, w0, rtol=1e-8)
    # the next RK stage's system: nonzero vorticity, warm start
    w1 = p.operators.curl(cold.x) * 0.5
    x1 = ir(p, name, w1, rtol=1e-10).x
    # blend the exact w1 solution with the stale cold one so that the
    # start's relative residual lies where 0.3 sqrt(tol2 / rr) exceeds
    # inner_rtol 1e-4 (below ~3e-5) but above rtol
    x_ws = x1 + 1e-4 * (cold.x - x1)
    rel_ws = true_rel(p, name, w1, mask * x_ws + (1.0 - mask) * p._u_bc_b)
    assert 1e-7 < rel_ws < 3e-5, rel_ws
    iters = {}
    for ad in (False, True):
        res = ir(p, name, w1, rtol=1e-8, x0=x_ws, adaptive_inner=ad)
        rel = true_rel(p, name, w1, res.x)
        assert rel < 1e-8, (ad, rel)
        assert float(res.resnorm) <= 1e-8 * float(torch.linalg.norm(
            p.system.rhs(w1, p._u_bc_b, mask)))
        iters[ad] = res.iters
    assert iters[True] < iters[False], iters


def test_solve_ir_matches_reference(problem):
    """Same 8x8 cavity, same numpy vorticity, free-slip mask, rtol 1e-10:
    the same velocity and the same total of inner CG iterations."""
    p = problem
    q = RefCavity(refine_config()).setup()
    rng = np.random.default_rng(3)
    wg = rng.normal(size=tuple(reversed(p.mesh.npts)) + (1,))
    mq = q._m("free_mask_fs")
    res_q = jax.jit(lambda w: ref_solve_ir(
        q.system, q.system32, w, q._solver_bc(0.0), mq,
        mq.astype(jnp.float32), rtol=1e-10, m_inv32=q._minv_fs))(
            q._blk(jnp.asarray(wg)))
    res = ir(p, "free_mask_fs", p._blk(torch.as_tensor(wg)), rtol=1e-10)
    x_q = np.asarray(res_q.x)
    err = np.abs(res.x.numpy() - x_q).max() / np.abs(x_q).max()
    assert err < 1e-10, err
    assert res.iters == int(res_q.iters)
    assert abs(float(res.resnorm) / float(res_q.resnorm) - 1) < 1e-2


def test_refined_inner_solves_are_float32(problem, monkeypatch):
    """Under refinement every inner CG solve, its operator and its
    V-cycle run in float32; the outer state stays float64."""
    p = problem
    assert p.system32.K.A.dtype == p.system32.Rw.A.dtype == F32
    assert p.system32.diag_K.dtype == p.system32.diag_K_b.dtype == F32
    assert p.system.K.A.dtype == F64 and p.mg.dtype == F32
    for name in p._mask_names:
        assert getattr(p, name + "32_b").dtype == F32
        assert torch.equal(getattr(p, name + "32_b").double(),
                           getattr(p, name + "_b"))
    seen = []
    cg = kle.cg_solve

    def spy(apply_A, b, m_inv=None, **kw):
        def apply(v):
            y = apply_A(v)
            seen.append(("apply", v.dtype, y.dtype))
            return y

        def vcycle(r):
            z = m_inv(r)
            seen.append(("vcycle", r.dtype, z.dtype))
            return z

        seen.append(("rhs", b.dtype))
        return cg(apply, b, m_inv=vcycle, **kw)

    monkeypatch.setattr(kle, "cg_solve", spy)
    vort, t, n = p.run(max_steps=1)
    assert n == 1 and vort.dtype == F64 and p.vel.dtype == F64
    kinds = {s[0] for s in seen}
    assert kinds == {"rhs", "apply", "vcycle"}, kinds
    assert all(d == F32 for s in seen for d in s[1:]), set(seen)
    # the cold first solve needs a round; a warm one may need none
    assert p.ir_rounds[0] >= 1
    assert len(p.ir_rounds) == len(p.cg_iters)


def test_refine_config_semantics():
    """float32 ignores kle-refine (as the reference does); the key not
    ported still raises with it, and kle-ws-extrapolate is read."""
    cfg = {**refine_config(), "kle-rtol": 1e-5}
    plain = {k: v for k, v in cfg.items() if k != "kle-refine"}
    runs = []
    for c in (cfg, plain):
        p = CavityProblem(c, dtype=F32, device="cpu").setup()
        assert not p._refine and not hasattr(p, "system32")
        assert p.mg.dtype == F32
        runs.append(p.run(max_steps=1)[0])
        assert p.ir_rounds == []
    assert torch.equal(runs[0], runs[1])
    q = RefCavity(cfg, dtype=jnp.float32)
    assert not q._refine
    # kle-solver is ported; the cavity takes the key and ignores it
    assert CavityProblem({**cfg, "kle-solver": "gmres"},
                         device="cpu").kle_solver == "gmres"
    assert CavityProblem({**cfg, "kle-ws-extrapolate": True},
                         device="cpu").kle_ws_extrapolate
