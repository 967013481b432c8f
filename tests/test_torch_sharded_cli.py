"""The command line's ``-sharded N`` (run_case.time_solving_sharded) on
gloo ranks (``-device cpu``): N = 1 and 2 on a 4x4 cavity, each against
the single-device library run; owner.vtk byte for byte the reference
writer's file of the reference decomposition's owner_field(); the
metrics keys of the reference's sharded branch, in the metrics file and
the printed JSON line; and, with cards asked for, the refusal with
fewer cards than N."""

import json
import os

import numpy as np
import pytest
import torch
import yaml

from pynama_tpu.io.vtk import write_point_cloud as ref_write_point_cloud
from pynama_tpu.mesh.structured import BoxMesh as RefBoxMesh
from pynama_tpu.parallel.slab import GridDecomposition as RefGrid
from pynama_tpu_torch import run_case
from pynama_tpu_torch.cases.cavity import CavityProblem

# the keys of the reference's {case}-sharded{N}-metrics.yaml
METRICS = {"steps", "final_time", "elapsed_s", "devices", "n_dofs",
           "platform", "distributed_multigrid", "s_per_step_steady",
           "vort_norm"}
NELEM = (4, 4)
STEPS = 2
# against the single-device run (KLE rtol 1e-10, distributed V-cycle
# against the single-device one): the vorticity as the cavity twins'
# 1e-8; t as chip_smoke.py's IBM_T_LIMIT, since the adaptive dt follows
# wlte^(-1/5), the difference of two embedded solutions
VORT_RTOL = 1e-8
T_RTOL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def single():
    """The library's single-device run of the same cavity."""
    cfg = run_case.load_config("cavity")
    p = CavityProblem(cfg, device="cpu", nelem=NELEM).setup()
    w, t, n = p.run(max_steps=STEPS)
    return float(torch.linalg.norm(w)), t, n


@pytest.mark.parametrize("n_dev", [1, 2])
def test_sharded_cli_runs_and_writes(tmp_path, capfd, single, n_dev):
    out = tmp_path / "out"
    metrics = run_case.main([
        "-case", "cavity", "-nelem", *map(str, NELEM), "-sharded",
        str(n_dev), "-device", "cpu", "-max-steps", str(STEPS), "-log",
        "WARNING", "-opt", f"save-dir={out}"])
    assert set(metrics) == METRICS
    assert metrics["devices"] == n_dev and metrics["platform"] == "cpu"
    assert metrics["distributed_multigrid"] is True
    with open(out / f"cavity-sharded{n_dev}-metrics.yaml") as f:
        assert yaml.safe_load(f) == metrics
    lines = capfd.readouterr().out.strip().splitlines()  # rank 0 prints
    assert json.loads(lines[-1]) == metrics
    norm, t, n = single
    assert metrics["steps"] == n
    assert abs(metrics["final_time"] - t) < T_RTOL * t
    assert abs(metrics["vort_norm"] - norm) / norm < VORT_RTOL
    # owner.vtk: the reference writer's bytes for the reference's field
    mesh = RefBoxMesh(nelem=NELEM, lower=(0, 0), upper=(1, 1), ngl=3)
    ref_write_point_cloud(str(tmp_path / "ref.vtk"), np.asarray(mesh.coords),
                          fields={"owner": RefGrid(mesh, (n_dev,))
                                  .owner_field()})
    with open(out / "owner.vtk") as f, open(tmp_path / "ref.vtk") as g:
        assert f.read() == g.read()


def test_sharded_cli_needs_n_cards(monkeypatch, tmp_path):
    """With cards asked for (the default device), -sharded N exits with
    the reference's message when fewer than N are visible, and falls
    back to nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit,
                       match="-sharded 2: only 1 devices visible"):
        run_case.main(["-case", "cavity", "-sharded", "2", "-log", "WARNING",
                       "-opt", f"save-dir={tmp_path}"])
    assert not os.listdir(tmp_path)
