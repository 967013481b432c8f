"""The port's immersed-boundary case on a Gmsh domain on the CPU, static
body (UnstructuredIBMCoupling): the twin of
tests/test_ibm.py::test_static_cylinder_on_gmsh_domain at its config,
the 'h-min' refusal of both packages, and a 2-step float64 run of the
port against the reference's on a 12x12 Gmsh box of [-3,3]^2, held to
tests/test_torch_ibm_cases.py's bounds: t and the accepted dts to 1e-12,
every KLE solve's CG iterations equal and every flux solve's too,
vorticity and velocity to 1e-8, the force histories to 1e-7.
tests/test_torch_ibm_gmsh_dynamic.py does the same for the moving body.

The reference's run (~10 s) is made once for the module; its flux-CG
iterations are recorded by an ordered callback around the coupling's
cg_solve, as its KLE iterations are around q.system.solve."""

import jax
import pytest
import torch

import pynama_tpu.ibm.coupling as ref_coupling
from pynama_tpu.cases import immersed as ref_immersed
from pynama_tpu_torch.cases import immersed
from pynama_tpu_torch.ibm.coupling import UnstructuredIBMCoupling
from tests.test_ibm import _write_box_msh, ibm_config
from tests.test_torch_ibm_cases import (CLASSES, STEPS, check_fields,
                                        check_forces, check_times, slip)

F64 = torch.float64
SMALL = 12  # the cross-package box: 12x12 Q2 on [-3, 3]^2, h-min 6/12


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def gmsh_config(path, kind, nelem, radius=None):
    """tests/test_ibm.py's ibm_config() on an nelem x nelem Gmsh box of
    [-3,3]^2 at 'h-min' 6/nelem; the body moving for ``kind``
    "dynamic"."""
    _write_box_msh(path, nelem, -3.0, 3.0)
    cfg = ibm_config()
    cfg["domain"] = {"ngl": 3, "gmsh-file": str(path),
                     "h-min": f"6/{nelem}"}
    if kind == "dynamic":
        cfg["bodies"][0]["vel"] = "dynamic"
    if radius is not None:
        cfg["bodies"][0]["radius"] = radius
    return cfg


def run_both(kind, path):
    """The reference's and the port's 2-step run on the SMALL Gmsh box:
    (reference problem, its KLE CG iterations, its flux CG iterations,
    port problem)."""
    ref_cls, port_cls = CLASSES[kind]
    cfg = gmsh_config(path, kind, SMALL)
    iters, flux = [], []
    solve, cg = None, ref_coupling.cg_solve

    def recording(into, fn):
        def call(*args, **kw):
            res = fn(*args, **kw)
            jax.debug.callback(lambda i: into.append(int(i)), res.iters,
                               ordered=True)
            return res
        return call

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_coupling, "cg_solve", recording(flux, cg))
        q = ref_cls(cfg).setup()
        solve = q.system.solve
        q.system.solve = recording(iters, solve)
        q.run(max_steps=STEPS)
    p = port_cls(cfg, dtype=F64, device="cpu").setup()
    p.run(max_steps=STEPS)
    return q, iters, flux, p


# -- twin of tests/test_ibm.py --------------------------------------------
def test_static_cylinder_on_gmsh_domain(tmp_path):
    p = immersed.ImmersedBoundaryProblem(
        gmsh_config(tmp_path / "ibm-box.msh", "static", 24),
        device="cpu").setup()
    vort, t, n = p.run(max_steps=2)
    assert torch.isfinite(vort).all()
    nodes, weights = p.coupling.windows(None)
    s = float(p.coupling.interp(p.vel, nodes, weights).abs().max())
    assert s < 1e-6, s
    assert p.cd_history and p.cd_history[-1][0] > 0


def test_gmsh_domain_without_h_min_raises_in_both(tmp_path):
    """The reference's ValueError, from setup, in both packages."""
    cfg = gmsh_config(tmp_path / "ibm-box.msh", "static", 4)
    del cfg["domain"]["h-min"]
    for make in (lambda: ref_immersed.ImmersedBoundaryProblem(cfg),
                 lambda: immersed.ImmersedBoundaryProblem(cfg,
                                                          device="cpu")):
        p = make()
        with pytest.raises(ValueError, match="h-min"):
            p.setup()


# -- against the reference --------------------------------------------------
@pytest.fixture(scope="module")
def static_runs(tmp_path_factory):
    return run_both("static", tmp_path_factory.mktemp("gmsh") / "box.msh")


def test_static_gmsh_run_matches_reference_times(static_runs):
    q, _, _, p = static_runs
    assert isinstance(p.coupling, UnstructuredIBMCoupling)
    check_times(q, p)


def test_static_gmsh_run_matches_reference_cg_iterations(static_runs):
    q, iters, flux, p = static_runs
    assert p.cg_iters == iters
    assert p.coupling.cg_iters == flux
    assert len(flux) == 1 + 2 * STEPS


def test_static_gmsh_run_matches_reference_fields(static_runs):
    q, _, _, p = static_runs
    check_fields(q, p)
    assert slip(p, p.t_history[-1]) < 1e-6


def test_static_gmsh_run_matches_reference_forces(static_runs):
    q, _, _, p = static_runs
    check_forces(q, p)
