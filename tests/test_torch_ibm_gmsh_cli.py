"""The port's command line on Gmsh meshes, on the CPU, as the reference
behaves: ``-case ibm-static|ibm-dynamic -gmsh FILE`` runs through
time_solving (with the config's domain 'h-min') and refuses to run
without 'h-min' in both packages; the -test modes build their problem
from the config's domain and ignore -gmsh; on a Gmsh config ``-test
kle`` gives the reference's errors within 1e-6 relative (chip_smoke.py
13f's bound) and ``-test chartkle`` its last errors within 1e-6, while
``-test chart`` fails in both packages (the reference on ``mesh.npts``,
the port with a ValueError that says why).

The reference's runs (~25 s together) are its jitted KLE solves and BS5
step compiling."""

import json

import numpy as np
import pytest
import torch
import yaml

from pynama_tpu import run_case as ref_run_case
from pynama_tpu_torch import run_case
from pynama_tpu_torch.ibm.coupling import (LatticeIBMCoupling,
                                           UnstructuredIBMCoupling)
from tests.test_ibm import _write_box_msh
from tests.test_unstructured import _write_msh22_quads, box_corner_mesh

KLE_ERR_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ibm_argv(case, msh, save_dir, *more):
    return ["-case", case, "-gmsh", str(msh), "-max-steps", "1", "-log",
            "WARNING", "-opt", f"save-dir={save_dir}", *more]


@pytest.mark.parametrize("case,coupling", [
    ("ibm-static", UnstructuredIBMCoupling),
    ("ibm-dynamic", LatticeIBMCoupling)], ids=["static", "dynamic"])
def test_cli_ibm_case_on_gmsh_runs(case, coupling, tmp_path, monkeypatch):
    """The shipped IBM config on a 12x12 Gmsh box of [-3,3]^2 through
    -gmsh, 'h-min' from -opt: one step, the coupling of the body's kind,
    cd in the metrics file."""
    msh = tmp_path / "box.msh"
    _write_box_msh(msh, 12, -3.0, 3.0)
    made = []
    make = run_case.make_problem
    monkeypatch.setattr(run_case, "make_problem",
                        lambda *a, **k: made.append(make(*a, **k))
                        or made[-1])
    out = tmp_path / "run"
    metrics = run_case.main(ibm_argv(case, msh, out, "-device", "cpu",
                                     "-opt", "domain.h-min=6/12"))
    p, = made
    assert p.gmsh_file == str(msh) and isinstance(p.coupling, coupling)
    assert metrics["steps"] == 1 and np.isfinite(metrics["cd"]).all()
    with open(out / f"{case}-metrics.yaml") as f:
        assert yaml.safe_load(f)["cd"] == metrics["cd"]


def test_cli_gmsh_without_h_min_raises_in_both(tmp_path):
    msh = tmp_path / "box.msh"
    _write_box_msh(msh, 4, -3.0, 3.0)
    for main, more in ((run_case.main, ["-device", "cpu"]),
                       (ref_run_case.main, [])):
        with pytest.raises(ValueError, match="h-min"):
            main(ibm_argv("ibm-static", msh, tmp_path / "run", *more))


def tg_gmsh_config(tmp_path):
    """configs/taylor-green.yaml on a 4x4 Gmsh box of the unit square,
    2 steps."""
    msh = str(tmp_path / "tg4.msh")
    _write_msh22_quads(msh, *box_corner_mesh(4, 4))
    cfg = run_case.load_config("taylor-green")
    cfg["domain"] = {"ngl": 3, "gmsh-file": msh}
    cfg["time-solver"]["max-steps"] = 2
    path = tmp_path / "tg-gmsh.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def both(mode, cfg, tmp_path, capsys, max_ngl="3"):
    """The port's and the reference's -test ``mode`` on ``cfg``, each
    saving under its own directory: (port's JSON, reference's JSON)."""
    common = ["-case", "taylor-green", "-config", cfg, "-test", mode,
              "-log", "WARNING", "-max-ngl", max_ngl]
    port = run_case.main(common + ["-device", "cpu", "-opt",
                                   f"save-dir={tmp_path / 'port'}"])
    capsys.readouterr()
    ref_run_case.main(common + ["-opt", f"save-dir={tmp_path / 'ref'}"])
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return port, ref


def test_cli_test_kle_on_gmsh_matches_reference(tmp_path, capsys):
    port, ref = both("kle", tg_gmsh_config(tmp_path), tmp_path, capsys)
    assert port["viscous_times"] == ref["viscous_times"]
    np.testing.assert_allclose(port["errors"], ref["errors"],
                               rtol=KLE_ERR_RTOL)
    assert port["errors"][-1] < port["errors"][0]


def test_cli_test_chartkle_on_gmsh_matches_reference(tmp_path, capsys,
                                                     monkeypatch):
    monkeypatch.chdir(tmp_path)  # chartkle-<case>.yaml lands here
    port, ref = both("chartkle", tg_gmsh_config(tmp_path), tmp_path,
                     capsys)
    assert port["step"] == ref["step"] == 2
    for k in ("time", "error2", "errorInf"):
        assert port[k] == pytest.approx(ref[k], rel=KLE_ERR_RTOL), k


def test_cli_test_chart_on_gmsh_fails_in_both(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = tg_gmsh_config(tmp_path)
    argv = ["-case", "taylor-green", "-config", cfg, "-test", "chart",
            "-log", "WARNING", "-max-ngl", "3"]
    with pytest.raises(ValueError, match="Gmsh mesh has no per-axis"):
        run_case.main(argv + ["-device", "cpu"])
    with pytest.raises(AttributeError, match="npts"):
        ref_run_case.main(argv)


def test_test_modes_ignore_gmsh(tmp_path):
    """-test kle builds its problem from the config's domain: a -gmsh
    file (here one that does not exist) changes nothing."""
    argv = ["-case", "taylor-green", "-test", "kle", "-log", "WARNING",
            "-device", "cpu", "-nelem", "3", "3", "-opt",
            f"save-dir={tmp_path / 'kle'}"]
    a = run_case.main(argv)
    b = run_case.main(argv + ["-gmsh", str(tmp_path / "missing.msh")])
    assert a["errors"] == b["errors"]
