"""The port's command line on a prime element count: ``run_case -case
cavity -nelem 7 7`` (configs/cavity.yaml, float64, on the CPU) takes the
padded (fictitious-domain) multigrid hierarchy and ends bit for bit
where the library's run of the same config does. Port only: the
reference's 7x7 run is compared in tests/test_torch_cavity_padded.py."""

import os

import numpy as np
import pytest
import torch

from pynama_tpu_torch import run_case
from pynama_tpu_torch.cases.cavity import CavityProblem
from pynama_tpu_torch.io.checkpoint import load_checkpoint

STEPS = 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_cli_padded_cavity_equals_library_run(tmp_path):
    """run_case -case cavity -nelem 7 7 (configs/cavity.yaml, float64)
    takes the padded hierarchy and ends bit for bit where the library's
    run of the same config does."""
    run_case.main(["-case", "cavity", "-nelem", "7", "7", "-device", "cpu",
                   "-max-steps", str(STEPS), "-log", "WARNING",
                   "-opt", f"save-dir={tmp_path}", "-opt", "save-n-steps=1"])
    ck = load_checkpoint(os.path.join(tmp_path, "checkpoint.npz"))
    cfg = run_case.load_config("cavity")
    cfg["domain"]["box-mesh"]["nelem"] = [7, 7]
    p = CavityProblem(cfg, device="cpu").setup()
    assert p.mg.levels[0].ext_mesh is not None
    vort, t, n = p.run(max_steps=STEPS)
    assert ck["step"] == n == STEPS and ck["t"] == t
    assert np.array_equal(ck["vort"], vort.numpy().reshape(ck["vort"].shape))
