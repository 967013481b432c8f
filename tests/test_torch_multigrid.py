"""Twins of tests/test_multigrid.py for the port's multigrid
preconditioner (port only, float64 on the CPU, the reference tests'
names, parameters and gates): symmetry, exact injection,
near-mesh-independent CG iteration counts, padded (fictitious-domain)
hierarchies for prime element counts, and the preconditioned solve
against Jacobi-CG."""

from functools import partial

import numpy as np
import pytest
import torch

from pynama_tpu_torch.elements.spectral import SpectralElement
from pynama_tpu_torch.kle import build_kle_system
from pynama_tpu_torch.mesh.structured import BoxMesh
from pynama_tpu_torch.solvers.cg import cg_solve
from pynama_tpu_torch.solvers.multigrid import MGPreconditioner

F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t64(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def setup(nelem, ngl=3):
    mesh = BoxMesh(nelem=(nelem, nelem), lower=(0, 0), upper=(1, 1), ngl=ngl)
    elem = SpectralElement(ngl, 2)
    sys_ = build_kle_system(mesh, elem, device="cpu")
    mask = np.ones(mesh.n_nodes * 2)
    mask[mesh.node_dofs(mesh.boundary_nodes, 2)] = 0.0
    gshape = (mesh.npts[1], mesh.npts[0], 2)
    return mesh, elem, sys_, t64(mask.reshape(gshape))


def mg_of(mesh, elem):
    return MGPreconditioner(mesh, elem, dtype=F64, device="cpu")


def tg_problem(mesh, sys_, mask):
    x = 2 * np.pi * mesh.coords[:, 0]
    y = 2 * np.pi * mesh.coords[:, 1]
    wg = (mesh.npts[1], mesh.npts[0], 1)
    vg = (mesh.npts[1], mesh.npts[0], 2)
    vort = t64((-4 * np.pi * np.cos(x) * np.cos(y)).reshape(wg))
    u_bc = t64(
        np.stack([np.cos(x) * np.sin(y), -np.sin(x) * np.cos(y)], 1).reshape(vg)
    )
    b = sys_.rhs(vort, u_bc, mask)
    return b, (1.0 - mask) * u_bc


def rel_norm(a, b):
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def test_injection_exact_and_adjoint():
    mesh, elem, sys_, mask = setup(8)
    mg = mg_of(mesh, elem)
    assert mg.usable and len(mg.levels) >= 2
    lvl, cm = mg.levels[0], mg.levels[1].mesh
    # a global biquadratic lies in the coarse space -> injection is exact
    f = lambda c: c[:, 0] ** 2 - 0.3 * c[:, 0] * c[:, 1] + 2 * c[:, 1] + 1  # noqa: E731
    cg_ = (cm.npts[1], cm.npts[0], 2)
    fg_ = (mesh.npts[1], mesh.npts[0], 2)
    xc = np.stack([f(cm.coords), -f(cm.coords)], 1).reshape(cg_)
    xf = mg._prolong(lvl, cm, t64(xc))
    xf_e = np.stack([f(mesh.coords), -f(mesh.coords)], 1).reshape(fg_)
    np.testing.assert_allclose(xf.numpy(), xf_e, atol=1e-12)
    # restriction is the exact adjoint
    rng = np.random.default_rng(0)
    a = t64(rng.normal(size=cg_))
    bb = t64(rng.normal(size=fg_))
    lhs = float(torch.sum(mg._prolong(lvl, cm, a) * bb))
    rhs = float(torch.sum(a * mg._restrict(lvl, cm, bb)))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-12)


def test_mg_iterations_nearly_mesh_independent():
    iters = {}
    for nelem in (16, 32, 64):
        mesh, elem, sys_, mask = setup(nelem)
        mg = mg_of(mesh, elem)
        minv = mg.build(mask)
        b, x0 = tg_problem(mesh, sys_, mask)
        res = cg_solve(partial(sys_.apply_masked, free_mask=mask), b, x0=x0,
                       m_inv=minv, rtol=1e-10, maxiter=1000)
        iters[nelem] = int(res.iters)
    assert iters[64] < 90, iters
    assert iters[64] < 3 * iters[16], iters  # near mesh-independence


def test_mg_solution_matches_jacobi():
    mesh, elem, sys_, mask = setup(32)
    mg = mg_of(mesh, elem)
    b, x0 = tg_problem(mesh, sys_, mask)
    A = partial(sys_.apply_masked, free_mask=mask)
    rj = cg_solve(A, b, x0=x0, m_inv=sys_.jacobi_inv(mask), rtol=1e-11,
                  maxiter=30000)
    rm = cg_solve(A, b, x0=x0, m_inv=mg.build(mask), rtol=1e-11, maxiter=1000)
    err = rel_norm(rm.x, rj.x)
    assert err < 1e-8, err


@pytest.mark.parametrize("nelem", [45, 50])
def test_mg_non_power_of_two_meshes(nelem):
    """Hierarchies with ratio-3 (45=3^2*5) and ratio-5 (50=2*5^2) jumps."""
    mesh, elem, sys_, mask = setup(nelem)
    mg = mg_of(mesh, elem)
    assert mg.usable, f"no hierarchy for nelem={nelem}"
    assert len(mg.levels) >= 2
    assert any(r in (3, 5) for r in mg.ratios), mg.ratios
    b, x0 = tg_problem(mesh, sys_, mask)
    res = cg_solve(partial(sys_.apply_masked, free_mask=mask), b, x0=x0,
                   m_inv=mg.build(mask), rtol=1e-10, maxiter=400)
    assert int(res.iters) < 150, int(res.iters)
    bnorm = float(torch.sqrt(torch.sum(b * b)))
    assert float(res.resnorm) <= 1.01e-10 * bnorm


@pytest.mark.parametrize("nelem", [7, 23])
def test_mg_prime_nelem_padded_hierarchy(nelem):
    """Prime element counts get a fictitious-domain (padded) hierarchy:
    the fine level is extended by a Dirichlet-masked ghost band to the
    next even count before each ratio-2 jump. The padded V-cycle must
    stay a symmetric SPD preconditioner and produce the same solution as
    Jacobi-CG."""
    mesh, elem, sys_, mask = setup(nelem)
    mg = mg_of(mesh, elem)
    assert mg.usable, f"no padded hierarchy for nelem={nelem}"
    assert any(lv.ext_mesh is not None for lv in mg.levels[:-1])
    b, x0 = tg_problem(mesh, sys_, mask)
    A = partial(sys_.apply_masked, free_mask=mask)
    minv = mg.build(mask)
    res = cg_solve(A, b, x0=x0, m_inv=minv, rtol=1e-10, maxiter=400)
    assert int(res.iters) < 120, int(res.iters)
    rj = cg_solve(A, b, x0=x0, m_inv=sys_.jacobi_inv(mask), rtol=1e-11,
                  maxiter=30000)
    err = rel_norm(res.x, rj.x)
    assert err < 1e-7, err


def test_mg_padded_transfer_adjointness():
    """Pad/crop transfers at a fictitious-domain jump must stay exact
    adjoints (V-cycle symmetry -> CG-safety)."""
    mesh, elem, sys_, mask = setup(7)
    mg = mg_of(mesh, elem)
    lvl, cm = mg.levels[0], mg.levels[1].mesh
    assert lvl.ext_mesh is not None
    rng = np.random.default_rng(1)
    cg_ = (cm.npts[1], cm.npts[0], 2)
    fg_ = (mesh.npts[1], mesh.npts[0], 2)
    a = t64(rng.normal(size=cg_))
    bb = t64(rng.normal(size=fg_))
    lhs = float(torch.sum(mg._prolong(lvl, cm, a) * bb))
    rhs = float(torch.sum(a * mg._restrict(lvl, cm, bb)))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-12)


def test_problem_uses_mg_and_stays_accurate():
    from pynama_tpu_torch.cases.uniform import UniformFlowProblem
    from tests.test_cases import make_config

    cfg = make_config((8, 8), 3)
    p = UniformFlowProblem(cfg, device="cpu").setup()
    assert p._minv  # MG active
    assert p.mg is not None and p.mg.usable
    u = p.solve_kle(0.0, p.initial_vorticity(), rtol=1e-14, maxiter=5000,
                    restarts=2)
    vel_e, _ = p.exact_fields(0.0)
    diff = u.reshape(-1) - vel_e.reshape(-1)
    assert float(torch.linalg.norm(diff)) < 1e-12
