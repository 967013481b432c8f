"""The port's immersed-boundary case on a Gmsh domain on the CPU, moving
body (LatticeIBMCoupling): the twin of
tests/test_ibm.py::test_moving_cylinder_on_gmsh_domain at its config,
and a 2-step float64 run against the reference's on the 12x12 Gmsh box
at the bounds of tests/test_torch_ibm_gmsh_static.py."""

import numpy as np
import pytest
import torch

from pynama_tpu_torch.cases import immersed
from pynama_tpu_torch.ibm.coupling import LatticeIBMCoupling
from tests.test_torch_ibm_cases import (STEPS, check_fields, check_forces,
                                        check_times, slip)
from tests.test_torch_ibm_gmsh_static import gmsh_config, run_both


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- twin of tests/test_ibm.py --------------------------------------------
def test_moving_cylinder_on_gmsh_domain(tmp_path):
    p = immersed.ImmersedBoundaryDynamicProblem(
        gmsh_config(tmp_path / "ibm-box.msh", "dynamic", 24, radius=0.3),
        device="cpu").setup()
    assert isinstance(p.coupling, LatticeIBMCoupling)
    vort, t, n = p.run(max_steps=2)
    assert torch.isfinite(vort).all()
    d0, _ = p.body.bodies[0].state_at(0.0)
    d1, _ = p.body.bodies[0].state_at(t)
    assert not np.allclose(d0, d1)  # the body actually moved
    # slip measured against the moving body's velocity
    assert slip(p, t) < 1e-6


# -- against the reference --------------------------------------------------
@pytest.fixture(scope="module")
def dynamic_runs(tmp_path_factory):
    return run_both("dynamic", tmp_path_factory.mktemp("gmsh") / "box.msh")


def test_dynamic_gmsh_run_matches_reference_times(dynamic_runs):
    q, _, _, p = dynamic_runs
    assert isinstance(p.coupling, LatticeIBMCoupling)
    np.testing.assert_array_equal(p.coupling._table.numpy(),
                                  np.asarray(q.coupling._table))
    np.testing.assert_array_equal(p.coupling.lower, q.coupling.lower)
    check_times(q, p)


def test_dynamic_gmsh_run_matches_reference_cg_iterations(dynamic_runs):
    q, iters, flux, p = dynamic_runs
    assert p.cg_iters == iters
    assert p.coupling.cg_iters == flux
    assert len(flux) == 1 + 2 * STEPS


def test_dynamic_gmsh_run_matches_reference_fields(dynamic_runs):
    q, _, _, p = dynamic_runs
    check_fields(q, p)
    t = p.t_history[-1]
    assert not np.allclose(p.body.coords_at(0.0), p.body.coords_at(t))
    assert slip(p, t) < 1e-6


def test_dynamic_gmsh_run_matches_reference_forces(dynamic_runs):
    q, _, _, p = dynamic_runs
    check_forces(q, p)
