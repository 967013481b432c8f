"""The port's immersed-boundary cases on the CPU, moving body: the twin
of tests/test_ibm.py::test_dynamic_body_moves at its config, a 2-step
float64 run against the reference's at the limits of
tests/test_torch_ibm_cases.py, the two boundary-condition forms, what is
not ported (checkpoint arguments, the unstructured couplings) and
chip_smoke.py's copies of the shipped IBM configs."""

from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from pynama_tpu.cases import immersed as ref_immersed
from pynama_tpu_torch.cases import immersed
from pynama_tpu_torch.ibm import coupling
from tests.test_ibm import ibm_config
from tests.test_torch_ibm_cases import (check_fields, check_forces,
                                        check_times, config, run_both, slip)

F64 = torch.float64
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- twin of tests/test_ibm.py --------------------------------------------
def test_dynamic_body_moves():
    p = immersed.ImmersedBoundaryDynamicProblem(config("dynamic", 30),
                                                device="cpu").setup()
    vort, t, n = p.run(max_steps=2)
    assert torch.isfinite(vort).all()
    d0, v0 = p.body.bodies[0].state_at(0.0)
    d1, v1 = p.body.bodies[0].state_at(t)
    assert not np.allclose(d0, d1)  # the body actually moved
    # slip measured against the moving-body velocity
    assert slip(p, t) < 1e-6


# -- against the reference --------------------------------------------------
@pytest.fixture(scope="module")
def dynamic_runs():
    return run_both("dynamic")


def test_dynamic_run_matches_reference_times(dynamic_runs):
    q, _, p = dynamic_runs
    check_times(q, p)


def test_dynamic_run_matches_reference_cg_iterations(dynamic_runs):
    q, iters, p = dynamic_runs
    assert p.cg_iters == iters


def test_dynamic_run_matches_reference_fields(dynamic_runs):
    q, _, p = dynamic_runs
    check_fields(q, p)
    t = p.t_history[-1]
    assert not np.allclose(p.body.coords_at(0.0), p.body.coords_at(t))
    assert slip(p, t) < 1e-6


def test_dynamic_run_matches_reference_forces(dynamic_runs):
    check_forces(*dynamic_runs[::2])


@pytest.mark.parametrize("bc", [
    {"constant": {"re": 40, "direction": 30, "longRef": "2*pi"}},
    {"constant": {"vel": [1.5, 0.0]}},
], ids=["re", "vel"])
def test_boundary_condition_forms_match_reference(bc):
    cfg = {**ibm_config(), "boundary-conditions": bc}
    q = ref_immersed.ImmersedBoundaryProblem(cfg)
    p = immersed.ImmersedBoundaryProblem(cfg, device="cpu")
    assert p.u_ref == q.u_ref and p.re == q.re
    assert p.cte_value == q.cte_value


@pytest.mark.parametrize("kw", [{"checkpoint_path": "ck.npz",
                                 "checkpoint_every": 1},
                                {"resume_from": "ck.npz"}],
                         ids=["checkpoint", "resume"])
def test_checkpoint_arguments_raise(kw, tmp_path, monkeypatch):
    """Checkpoint and resume are ported: a checkpoint is written, and a
    resume raises only for a missing file (tests/test_torch_io.py runs a
    resume)."""
    from pynama_tpu_torch.io.checkpoint import load_checkpoint

    monkeypatch.chdir(tmp_path)
    p = immersed.ImmersedBoundaryProblem(ibm_config(8), device="cpu").setup()
    if "resume_from" in kw:
        with pytest.raises(FileNotFoundError):
            p.run(max_steps=1, **kw)
    else:
        p.run(max_steps=1, **kw)
        assert load_checkpoint("ck.npz")["step"] == 1


def test_non_box_couplings_raise():
    for cls in (coupling.UnstructuredIBMCoupling,
                coupling.LatticeIBMCoupling):
        with pytest.raises(NotImplementedError, match="unstructured"):
            cls(None, 0.1)
    with pytest.raises(NotImplementedError, match="unstructured"):
        coupling.IBMCoupling(object(), 0.1)


@pytest.mark.parametrize("name", ["ibm-static", "ibm-dynamic"])
def test_chip_smoke_configs_are_the_shipped_ones(name):
    import chip_smoke

    with open(ROOT / "configs" / f"{name}.yaml") as f:
        shipped = yaml.safe_load(f)
    assert chip_smoke.IBM_CONFIGS[name] == shipped
