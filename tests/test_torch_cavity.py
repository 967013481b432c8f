"""The lid-driven cavity end to end in both packages: CavityProblem(cfg)
.setup().run() on 8x8 Q2 elements in float64 with multigrid-CG KLE
solves, the config of tests/test_cases.py::test_cavity_smoke.

Most of this file's time is the reference compiling its BS5 step (the
same compile as test_cavity_smoke's), whatever the number of steps; the
setup checks live in tests/test_torch_cavity_setup.py."""

import numpy as np
import pytest
import torch

from pynama_tpu.cases.cavity import CavityProblem as RefCavity
from pynama_tpu_torch.cases.cavity import CavityProblem
from tests.test_cases import make_config


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cavity_config():
    cfg = make_config((8, 8), 3, rho=1.0, mu=0.1, end=0.5, max_steps=10)
    cfg["boundary-conditions"] = {"no-slip": {"up": [1.0, 0.0]}}
    return cfg


def test_cavity_run_matches_reference():
    cfg = cavity_config()
    p = CavityProblem(cfg, dtype=torch.float64, device="cpu").setup()
    q = RefCavity(cfg).setup()
    assert p.mg.ratios == q.mg.ratios
    vort, t, n = p.run(max_steps=5)
    vort_r, t_r, n_r = q.run(max_steps=5)
    assert n == n_r == 5
    assert abs(t - t_r) <= 1e-12 * t_r
    vort, vort_r = vort.numpy(), np.asarray(vort_r)
    # KLE solves stop at the config's rtol 1e-10; the two CG runs do the
    # same arithmetic in another order, so they agree far below it
    err = np.linalg.norm(vort - vort_r) / np.linalg.norm(vort_r)
    assert err < 1e-8, err
    vel, vel_r = p.vel.numpy(), np.asarray(q.vel)
    assert np.linalg.norm(vel - vel_r) / np.linalg.norm(vel_r) < 1e-8
    # lid velocity imposed, no blow-up
    up = p.mesh.face_nodes["up"].astype(np.int64)
    mid = up[len(up) // 2]
    assert abs(vel.reshape(-1, 2)[mid, 0] - 1.0) < 1e-8


def test_unported_configs_and_missing_cuda_raise():
    cfg = cavity_config()
    # kle-solver is ported: the cavity takes the key and ignores it, as
    # the reference's (tests/test_torch_gmres.py holds its solves to CG)
    assert CavityProblem({**cfg, "kle-solver": "gmres"},
                         device="cpu").kle_solver == "gmres"
    # 7x7 needs a padded (fictitious-domain) multigrid jump
    cfg7 = {**cfg, "domain": {"ngl": 3, "box-mesh": {"nelem": [7, 7]}}}
    with pytest.raises(NotImplementedError, match="padded"):
        CavityProblem(cfg7, device="cpu").setup()
    # a gmsh-file domain is ported: the constructor reads the file, so a
    # missing one raises FileNotFoundError (tests/test_torch_gmsh_*.py run
    # real ones; IBM on one still raises NotImplementedError)
    gm = {**cfg, "domain": {"ngl": 3, "gmsh-file": "x.msh"}}
    with pytest.raises(FileNotFoundError):
        CavityProblem(gm, device="cpu")
    if not torch.cuda.is_available():
        # entry points default to the card and never fall back quietly
        with pytest.raises(RuntimeError, match="CUDA"):
            CavityProblem(cfg)
