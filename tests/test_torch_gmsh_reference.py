"""The port's Gmsh path against the reference on the CPU, float64, on
numpy-seeded distorted meshes: a 2D Gmsh cavity (5x5, 3 steps: the
vorticity within 1e-8, every CG iteration count equal), one 3D
transport_rhs and one solve_kle on a 2x2x2 Gmsh hex mesh (never the
reference's jitted 3D run, which compiles for over a minute), one
refined (kle-refine) solve on a Gmsh cavity; and the command line's
-gmsh on the CPU, with the Gmsh paths that still raise."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import pynama_tpu.cases.analytic as ref_analytic
import pynama_tpu.cases.cavity as ref_cavity
from pynama_tpu_torch import run_case
from pynama_tpu_torch.cases.analytic import CustomFuncProblem
from pynama_tpu_torch.cases.cavity import CavityProblem
from pynama_tpu_torch.cases.immersed import ImmersedBoundaryProblem
from pynama_tpu_torch.cases.uniform import UniformFlowProblem
from pynama_tpu_torch.io.checkpoint import load_checkpoint
from tests.blas_threads import blas_threads
from tests.test_torch_gmsh_cases import cavity_cfg, quad_msh
from tests.test_unstructured import _write_hex_msh

F64 = torch.float64
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread and one BLAS thread (the Schwarz setup's
    inverses): the suite runs files side by side on a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with blas_threads(1):
        yield
    torch.set_num_threads(n)


def record_iters(system, log):
    """Log the CG iterations of every reference system.solve, in order
    (an ordered debug callback: the reference's run is jitted)."""
    solve = system.solve

    def logged(*a, **k):
        res = solve(*a, **k)
        jax.debug.callback(lambda it: log.append(int(it)), res.iters,
                           ordered=True)
        return res

    system.solve = logged


def test_gmsh_cavity_matches_reference(tmp_path):
    cfg = cavity_cfg(quad_msh(tmp_path / "c.msh", 5, 0.03, seed=1))
    p = CavityProblem(cfg, device="cpu").setup()
    vort, t, n = p.run()
    q = ref_cavity.CavityProblem(cfg).setup()
    iters = []
    record_iters(q.system, iters)
    w, tq, nq = q.run()
    w = np.asarray(w)
    assert n == nq == 3 and abs(t - float(tq)) <= 1e-12 * t
    rel = np.linalg.norm(vort.numpy() - w) / np.linalg.norm(w)
    assert rel <= 1e-8, rel
    assert p.cg_iters == iters
    assert np.abs(p.vel.numpy() - np.asarray(q.vel)).max() <= \
        1e-8 * np.abs(np.asarray(q.vel)).max()


def test_gmsh_hex_rhs_and_solve_match_reference(tmp_path):
    """One solve_kle from the exact vorticity and one transport_rhs of the
    3D Taylor-Green case on a distorted 2x2x2 Gmsh hex mesh."""
    msh = tmp_path / "h.msh"
    _write_hex_msh(str(msh), 2, 2, 2, distort=0.04)
    cfg = {"name": "tg3d", "material-properties": {"rho": 1.0, "mu": 0.01},
           "domain": {"ngl": 3, "gmsh-file": str(msh)},
           "time-solver": {"start-time": 0.0, "end-time": 0.02},
           "kle-rtol": 1e-11}
    p = CustomFuncProblem(cfg, device="cpu").setup()
    q = ref_analytic.CustomFuncProblem(cfg).setup()
    assert p._minv["free_mask"].patches == "vertex"
    _, vort_e = p.exact_fields(0.01)
    w = vort_e.reshape(-1)
    vel = p.solve_kle(0.01, w)
    res = q.system.solve(
        q.vort_bc(0.01, jnp.asarray(w.numpy())), q.vel_bc(0.01),
        q.free_mask, rtol=q.kle_rtol, maxiter=q.kle_maxiter, restarts=1,
        m_inv=q._minv)
    ref_vel = np.asarray(res.x)
    assert np.linalg.norm(vel.numpy() - ref_vel) <= \
        1e-10 * np.linalg.norm(ref_vel)
    assert p.cg_iters == [int(res.iters)]
    f, aux = p.transport_rhs(0.01, w, p.zero_vel())
    fr, auxr = q.transport_rhs(0.01, jnp.asarray(w.numpy()), q.zero_vel())
    fr = np.asarray(fr)
    assert np.linalg.norm(f.numpy() - fr) <= 1e-8 * np.linalg.norm(fr)
    assert np.linalg.norm(aux.numpy() - np.asarray(auxr)) <= \
        1e-10 * np.linalg.norm(np.asarray(auxr))


def test_gmsh_refined_solve_matches_reference(tmp_path):
    """kle-refine on a Gmsh domain: float64 state, float32 inner CG with
    float32 Schwarz; one solve_kle from a seeded vorticity within 1e-8
    of the reference's and the same refinement rounds."""
    cfg = cavity_cfg(quad_msh(tmp_path / "c.msh", 4, 0.03, seed=2),
                     **{"kle-refine": True, "kle-rtol": 1e-8})
    p = CavityProblem(cfg, device="cpu").setup()
    q = ref_cavity.CavityProblem(cfg).setup()
    assert p._minv["free_mask"].op.A.dtype == torch.float32
    w = np.random.default_rng(9).normal(size=p.mesh.n_nodes)
    vel = p.solve_kle(0.0, torch.as_tensor(w, dtype=F64))
    ref = np.asarray(q.solve_kle(0.0, jnp.asarray(w)))
    assert vel.dtype == F64
    assert np.linalg.norm(vel.numpy() - ref) <= 1e-8 * np.linalg.norm(ref)
    assert len(p.ir_rounds) == 2 and all(r >= 1 for r in p.ir_rounds)


def test_run_case_gmsh_on_cpu(tmp_path, monkeypatch):
    """run_case -case channel3d -gmsh FILE -device cpu: the documented
    command on a named 3x3x3 hex mesh, 1 step. Its checkpoint holds the
    library run's velocity bit for bit; the uniform flow is the exact
    solution, so that velocity is (1, 0, 0) to the solves' tolerance
    (channel3d.yaml's kle-rtol 1e-8)."""
    monkeypatch.chdir(tmp_path)
    _write_hex_msh("channel.msh", 3, 3, 3, distort=0.02)
    out = tmp_path / "out"
    metrics = run_case.main([
        "-case", "channel3d", "-gmsh", "channel.msh", "-device", "cpu",
        "-max-steps", "1", "-log", "WARNING",
        "-opt", f"save-dir={out}", "-opt", "save-n-steps=1"])
    assert metrics["steps"] == 1
    with open(out / "channel3d-metrics.yaml") as f:
        assert yaml.safe_load(f)["steps"] == 1
    vel = load_checkpoint(str(out / "checkpoint.npz"))["vel"]
    with open(ROOT / "configs" / "channel3d.yaml") as f:
        cfg = yaml.safe_load(f)
    lib = UniformFlowProblem(cfg, gmsh_file="channel.msh",
                             device="cpu").setup()
    seen = []
    lib.run(max_steps=1, callback=lambda n, t, dt, w, v: seen.append(v))
    np.testing.assert_array_equal(vel, seen[0].numpy())
    assert np.abs(vel.reshape(-1, 3) - [1.0, 0.0, 0.0]).max() < 1e-6


def test_gmsh_paths_that_raise(tmp_path):
    """IBM on a Gmsh domain and -test modes on a Gmsh mesh raise, naming
    the queue item; -sharded still raises."""
    path = quad_msh(tmp_path / "c.msh", 3)
    with open(ROOT / "configs" / "ibm-static.yaml") as f:
        ibm = yaml.safe_load(f)
    ibm["domain"] = {"ngl": 3, "gmsh-file": path}
    with pytest.raises(NotImplementedError, match="queue 1 #9b"):
        ImmersedBoundaryProblem(ibm, device="cpu")
    base = ["-device", "cpu", "-log", "WARNING",
            "-opt", f"save-dir={tmp_path}"]
    for argv, item in ((["-case", "ibm-static", "-gmsh", path], "#9b"),
                       (["-case", "taylor-green", "-test", "kle", "-gmsh",
                         path], "#9b"),
                       (["-case", "uniform", "-gmsh", path, "-sharded",
                         "2"], "#10")):
        with pytest.raises(NotImplementedError, match=f"queue 1 {item}"):
            run_case.main(argv + base)
