"""The port's restarted GMRES (solvers/gmres.py) and the KLE's
``kle-solver: gmres`` on the CPU: the twins of tests/test_gmres.py, and
the same float64 inputs, made from a seed with numpy, through the
reference and the port on a 6x6 Taylor-Green problem: GMRES on its
Jacobi-preconditioned KLE system (the same iterations, the solution
within 1e-10), and its KLE solve under kle-solver: gmres (within 1e-10).
The reference's GMRES loop compiles once (~7 s): the two checks build
the same loop, so the second finds it in JAX's compilation cache."""

from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pynama_tpu.cases.analytic import CustomFuncProblem as RefCustomFunc
from pynama_tpu.solvers.gmres import gmres_solve as ref_gmres_solve
from pynama_tpu_torch.cases.analytic import CustomFuncProblem
from pynama_tpu_torch.cases.cavity import CavityProblem
from pynama_tpu_torch.cases.uniform import UniformFlowProblem
from pynama_tpu_torch.elements.spectral import SpectralElement
from pynama_tpu_torch.kle import build_kle_system
from pynama_tpu_torch.mesh.structured import BoxMesh
from pynama_tpu_torch.solvers import gmres as gmres_mod
from pynama_tpu_torch.solvers.cg import cg_solve
from pynama_tpu_torch.solvers.gmres import gmres_solve
from tests.test_cases import make_config

F64 = torch.float64
CROSS_TOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_gmres_nonsymmetric():
    rng = np.random.default_rng(3)
    n = 60
    A = np.eye(n) * 4 + rng.normal(size=(n, n)) * 0.3  # diagonally dominant
    x_true = rng.normal(size=n)
    b = A @ x_true
    At = torch.as_tensor(A)
    res = gmres_solve(lambda v: At @ v, torch.as_tensor(b), restart=20,
                      rtol=1e-12, maxiter=400)
    np.testing.assert_allclose(res.x.numpy(), x_true, atol=1e-8)


def test_gmres_preconditioned_kle():
    """GMRES solves the (SPD) KLE system too: against CG."""
    mesh = BoxMesh(nelem=(6, 6), lower=(0, 0), upper=(1, 1), ngl=3)
    sys_ = build_kle_system(mesh, SpectralElement(3, 2), F64, "cpu")
    mask = torch.ones(mesh.n_nodes * 2, dtype=F64)
    mask[mesh.node_dofs(mesh.boundary_nodes, 2)] = 0.0
    u_bc = torch.zeros(mesh.n_nodes * 2, dtype=F64)
    u_bc[0::2] = 1.0
    b = sys_.rhs(torch.zeros(mesh.n_nodes, dtype=F64), u_bc, mask)
    A = partial(sys_.apply_masked, free_mask=mask)
    xg = gmres_solve(A, b, m_inv=sys_.jacobi_inv(mask), restart=40,
                     rtol=1e-12, maxiter=2000).x
    xc = cg_solve(A, b, m_inv=sys_.jacobi_inv(mask), rtol=1e-12,
                  maxiter=5000).x
    np.testing.assert_allclose(xg.numpy(), xc.numpy(), atol=1e-7)


def test_kle_solver_gmres_config_matches_cg():
    """'kle-solver: gmres' routes FreeSlip KLE solves through restarted
    GMRES with the same masked system and preconditioning; uniform flow
    must still reproduce the exact constant field, and the solve's GMRES
    iterations are recorded."""
    cfg = make_config((8, 8), 3)
    cfg["kle-solver"] = "gmres"
    p = UniformFlowProblem(cfg, device="cpu").setup()
    assert p.kle_solver == "gmres"
    u = p.solve_kle(0.0, p.initial_vorticity(), rtol=1e-12, maxiter=2000)
    vel_e, _ = p.exact_fields(0.0)
    diff = u.reshape(-1) - vel_e.reshape(-1)
    assert float(torch.linalg.norm(diff)) < 1e-10
    assert len(p.cg_iters) == 1 and p.cg_iters[0] > 0


@pytest.fixture(scope="module")
def taylor_green_pair():
    """The reference's and the port's 6x6 Taylor-Green problem under
    kle-solver: gmres, Jacobi-preconditioned (multigrid: false), and a
    seeded grid vorticity. (At 4x4 the Krylov space is exhausted within
    the first restart: GMRES then continues from rounding noise, and its
    iteration count follows the operators' last bits.)"""
    cfg = make_config((6, 6), 3, rho=0.5, mu=0.01)
    cfg["kle-solver"] = "gmres"
    cfg["multigrid"] = False
    q = RefCustomFunc(cfg, case="taylor-green").setup()
    p = CustomFuncProblem(cfg, case="taylor-green", device="cpu").setup()
    vort = np.random.default_rng(11).normal(size=p._gshape(p.dim_w))
    return q, p, vort


def test_gmres_matches_reference_on_preconditioned_kle(taylor_green_pair):
    """GMRES on the Jacobi-preconditioned KLE system from a seeded
    vorticity: the reference's gmres_solve on the system its
    FreeSlipProblem._gmres_kle builds, against the port's _gmres_kle:
    equal iterations, solutions within 1e-10."""
    q, p, vort = taylor_green_pair
    t, rtol, maxiter = 0.3, 1e-11, 3000
    vort_b, _, _ = q._kle_layout(jnp.asarray(vort), None)
    mask, u_bc = q._m("free_mask"), q._solver_bc(t)
    b = q.system.rhs(vort_b, u_bc, mask)
    shape = b.shape
    jm = q.system.jacobi_inv(mask)
    ref = ref_gmres_solve(
        lambda v: q.system.apply_masked(v.reshape(shape), mask).ravel(),
        b.ravel(), x0=((1.0 - mask) * u_bc).ravel(),
        m_inv=lambda r: (jm * r.reshape(shape)).ravel(), rtol=rtol,
        maxiter=maxiter)
    vort_t, _, _ = p._kle_layout(torch.as_tensor(vort), None)
    res = p._gmres_kle("free_mask", vort_t, p._solver_bc(t), None, rtol,
                       maxiter)
    assert res.iters == int(ref.iters) > 30
    x_ref = np.asarray(ref.x)
    err = np.abs(res.x.numpy().ravel() - x_ref).max() / np.abs(x_ref).max()
    assert err < CROSS_TOL, err


def test_kle_solver_gmres_matches_reference_taylor_green(taylor_green_pair):
    """solve_kle under kle-solver: gmres, reference against port."""
    q, p, vort = taylor_green_pair
    ref = np.asarray(q.solve_kle(0.3, jnp.asarray(vort), rtol=1e-11,
                                 maxiter=3000))
    n = len(p.cg_iters)
    u = p.solve_kle(0.3, torch.as_tensor(vort), rtol=1e-11, maxiter=3000)
    assert len(p.cg_iters) == n + 1 and p.cg_iters[-1] > 0
    err = np.abs(u.numpy() - ref).max() / np.abs(ref).max()
    assert err < CROSS_TOL, err


def test_cavity_ignores_kle_solver(monkeypatch):
    """The dual-mask cavity never reads kle-solver (as the reference's
    cases/cavity.py): its solves stay CG."""
    def no_gmres(*args, **kw):
        raise AssertionError("the cavity reached GMRES")

    monkeypatch.setattr(gmres_mod, "gmres_solve", no_gmres)
    cfg = make_config((8, 8), 3, mu=0.1)
    cfg["boundary-conditions"] = {"no-slip": {"up": [1.0, 0.0]}}
    cfg["kle-solver"] = "gmres"
    p = CavityProblem(cfg, device="cpu").setup()
    u = p.solve_kle(0.0, p.initial_vorticity())
    assert bool(torch.isfinite(u).all()) and len(p.cg_iters) == 2
