"""The 3D hex channel (UniformFlowProblem on a 3D box, configs/
channel3d.yaml cut to a few elements) and the 3D cavity: masks and BC
values against the reference, the KLE solve reproducing the constant
field (the twin of tests/test_kle_solve.py::test_uniform_flow_3d), and a
short channel run through the multigrid-CG path."""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from pynama_tpu.cases.cavity import CavityProblem as RefCavity
from pynama_tpu.cases.uniform import UniformFlowProblem as RefUniform
from pynama_tpu.mesh.structured import BoxMesh as RefBoxMesh
from pynama_tpu_torch.cases.cavity import CavityProblem
from pynama_tpu_torch.cases.uniform import UniformFlowProblem
from pynama_tpu_torch.ops import stencil
from tests.test_cases import make_config

F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def channel_config(nelem, **ts):
    cfg = make_config(nelem, 3, rho=1.0, mu=0.01, upper=[1, 1, 2.5], **ts)
    cfg["name"] = "channel3d"
    return cfg


def test_uniform_flow_3d_masks_match_reference():
    cfg = {**channel_config((2, 2, 4)), "multigrid": False}
    p = UniformFlowProblem(cfg, dtype=F64, device="cpu").setup()
    q = RefUniform(cfg).setup()
    assert (p.dim_w, p.dim_s) == (q.dim_w, q.dim_s) == (3, 6)
    for name in ("free_mask", "bc_vort_mask", "_u_bc", "free_mask_b",
                 "bc_vort_mask_b", "_u_bc_b"):
        assert np.array_equal(getattr(p, name).numpy(),
                              np.asarray(getattr(q, name))), name
    vel, vort = p.exact_fields(0.0)
    vel_r, vort_r = q.exact_fields(0.0)
    assert np.array_equal(vel.numpy(), np.asarray(vel_r))
    assert np.array_equal(vort.numpy(), np.asarray(vort_r))


def test_uniform_flow_3d_kle_reproduces_constant_field():
    cfg = {**make_config((3, 3, 3), 3), "multigrid": False}
    p = UniformFlowProblem(cfg, dtype=F64, device="cpu").setup()
    n = p.mesh.n_nodes
    u = p.solve_kle(0.0, torch.zeros(n * 3, dtype=F64), rtol=1e-14,
                    maxiter=8000, restarts=2)
    exact = np.zeros(n * 3)
    exact[0::3] = 1.0
    err = np.linalg.norm(u.numpy() - exact)
    assert err < 2e-13, err


def test_channel_run_holds_the_uniform_flow():
    """channel3d's protocol (float32, KLE rtol 1e-5, fixed dt 1e-3, every
    attempt accepted), 3 steps on 2x2x4 elements with multigrid."""
    cfg = channel_config((2, 2, 4))
    cfg["time-solver"].update({"dt0": 1e-3, "max-dt": 1e-3, "atol": 1e12,
                               "rtol": 1e12})
    cfg.update({"kle-rtol": 1e-5, "kle-maxiter": 4000})
    p = UniformFlowProblem(cfg, device="cpu").setup()
    assert p.mg.ratios == [2]
    launches = stencil.KERNEL3D.launches
    vort, t, n = p.run(max_steps=3)
    assert n == 3 and abs(t - 3e-3) < 1e-12
    assert stencil.KERNEL3D.launches == launches  # CPU: the plain version
    assert bool(torch.isfinite(vort).all())
    dev = (p.vel.reshape(-1, 3) - torch.tensor([1.0, 0.0, 0.0])).abs().max()
    assert float(dev) < 1e-4, float(dev)
    assert float(vort.abs().max()) < 1e-3


def test_cavity_3d_masks_match_reference_and_solve():
    """NoSlipProblem is dimension-generic: a 3D lid-driven cavity."""
    cfg = {**make_config((2, 2, 2), 3, mu=0.1), "multigrid": False,
           "boundary-conditions": {"no-slip": {"up": [1.0, 0.0, 0.0]}}}
    p = CavityProblem(cfg, dtype=F64, device="cpu").setup()
    q = RefCavity(cfg)
    box = cfg["domain"]["box-mesh"]
    q.mesh = RefBoxMesh(nelem=box["nelem"], lower=box["lower"],
                        upper=box["upper"], ngl=3)
    q.setup_bc()
    for name in ("free_mask", "free_mask_fs", "_u_bc", "_fsfree"):
        assert np.array_equal(getattr(p, name).numpy(),
                              np.asarray(getattr(q, name))), name
    vel = p.solve_kle(0.0, torch.zeros(p.mesh.n_nodes * 3, dtype=F64),
                      rtol=1e-12, maxiter=4000)
    assert bool(torch.isfinite(vel).all())
    up = p.mesh.face_nodes["up"].astype(np.int64)
    assert np.allclose(vel.reshape(-1, 3).numpy()[up, 0], 1.0)
