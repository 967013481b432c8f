"""The port's command line (run_case.py) on the CPU: the CLI twins of
tests/test_io_cli.py (the subprocess ones run the port's CLI with
-device cpu, and write under tmp_path), the CLI's refusals (no card
without -device cpu, -sharded, -gmsh for IBM cases), and the
reference's and the port's production run (time_solving) of
``-case taylor-green -nelem 3 3 -max-steps 2`` in float64, each in its
own directory: the metrics, the checkpoint, the XDMF index and the HDF5
fields; then each package resumes the other's checkpoint for one step.

The reference's two runs take ~25 s, most of it compiling its jitted
BS5 step; they are made once for the module."""

import json
import os
import re
import subprocess
import sys
import types

import h5py
import numpy as np
import pytest
import torch
import yaml

from pynama_tpu import run_case as ref_run_case
from pynama_tpu_torch import run_case

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CROSS_TOL = 1e-10
# t after adaptive steps: dt follows the error estimate, a difference of
# two embedded solutions, so the packages' t agree to ~1e-12, not bit for
# bit (tests/test_torch_ibm_cases.py holds the same)
T_RTOL = 1e-11


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_cli(*argv, cwd):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, "-m", "pynama_tpu_torch.run_case", *argv],
        capture_output=True, text=True, cwd=cwd, env=env, timeout=600,
    )


@pytest.mark.slow
def test_cli_uniform_run(tmp_path):
    r = run_cli("-case", "uniform", "-log", "WARNING", "-device", "cpu",
                cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    assert os.path.exists(tmp_path / "run-uniform/uniform-metrics.yaml")


def test_apply_opts_nested_and_scalars():
    """-opt passthrough: the analogue of the open PETSc options DB."""
    cfg = {"multigrid": True, "kle-rtol": 1e-10}
    run_case.apply_opts(cfg, ["multigrid.smoother=jacobi", "multigrid.pre=2",
                              "kle-solver=gmres", "kle-rtol=1e-7",
                              "kle-refine=true",
                              "time-solver.max-steps=3"])
    assert cfg["multigrid"] == {"smoother": "jacobi", "pre": 2}
    assert cfg["kle-solver"] == "gmres"
    assert cfg["kle-rtol"] == pytest.approx(1e-7)
    assert cfg["kle-refine"] is True
    assert cfg["time-solver"]["max-steps"] == 3
    with pytest.raises(SystemExit):
        run_case.apply_opts(cfg, ["no-equals-sign"])


def test_cli_opt_passthrough_reaches_solver(tmp_path):
    """-opt flags change solver behavior from the command line."""
    out = tmp_path / "run-uniform-opt"
    r = run_cli("-case", "uniform", "-log", "INFO", "-max-steps", "1",
                "-opt", "kle-solver=gmres", "-opt", "multigrid=false",
                "-opt", f"save-dir={out}", "-device", "cpu", cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    assert os.path.exists(out / "uniform-metrics.yaml")


@pytest.mark.slow
def test_cli_kle_chart(tmp_path):
    r = run_cli("-case", "taylor-green", "-test", "kle", "-max-ngl", "5",
                "-log", "WARNING", "-device", "cpu",
                "-opt", f"save-dir={tmp_path / 'kle'}", cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    data = json.loads(r.stdout.strip().splitlines()[-1])
    errs = data["errors"]
    # -test kle prints one error per viscous time (the reference's test
    # indexes errs[-1][0], which only -test chart's rows support)
    assert errs[-1] < errs[0]


def test_cli_without_a_card_exits_naming_cuda(monkeypatch):
    """No card and no -device cpu: the CLI exits non-zero, naming CUDA,
    before it reads a config."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        run_case.main(["-case", "uniform", "-max-steps", "1"])
    assert e.value.code != 0 and "CUDA" in str(e.value.code)


@pytest.mark.parametrize("argv", [["-sharded", "2"],
                                  ["-case", "ibm-static", "-gmsh", "x.msh"]],
                         ids=["sharded", "gmsh"])
def test_unported_flags_raise(argv, tmp_path):
    """-sharded raises; -gmsh is ported but for IBM cases (ROADMAP.md
    queue 1 #9b), which raise before the file is read."""
    with pytest.raises(NotImplementedError, match="queue 1 #(9|10)"):
        run_case.main(["-case", "uniform", "-device", "cpu", "-log",
                       "WARNING", "-opt", f"save-dir={tmp_path}", *argv])


def cli_args(device=None, **kw):
    """The argparse namespace time_solving reads, for taylor-green at
    3x3 (float64, the config's ngl)."""
    args = dict(case="taylor-green", ngl=None, nelem=(3, 3), dtype=None,
                gmsh=None, max_steps=2, kle_rtol=None, max_dt=None,
                resume=None)
    args.update(kw)
    if device is not None:
        args["device"] = device
    return types.SimpleNamespace(**args)


def config(save_dir):
    return run_case.apply_opts(run_case.load_config("taylor-green"),
                               [f"save-dir={save_dir}", "save-n-steps=1"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each package's 2-step production run in its own directory, then
    each resumes the other's step-2 checkpoint to step 3."""
    d = tmp_path_factory.mktemp("runs")
    cpu = torch.device("cpu")
    out = {"ref": str(d / "ref"), "port": str(d / "port")}
    out["ref_metrics"] = ref_run_case.time_solving(cli_args(),
                                                   config(out["ref"]))
    out["port_metrics"] = run_case.time_solving(cli_args(cpu),
                                                config(out["port"]))
    for pkg, args, other in (
            (run_case, cli_args(cpu), "ref"), (ref_run_case, cli_args(),
                                                "port")):
        args.max_steps, args.resume = 3, os.path.join(out[other],
                                                      "checkpoint.npz")
        key = f"{other}_resumed"
        out[key] = str(d / key)
        pkg.time_solving(args, config(out[key]))
    return out


def test_time_solving_matches_reference_metrics(runs):
    a, b = runs["port_metrics"], runs["ref_metrics"]
    assert a["steps"] == b["steps"] == 2
    assert a["final_time"] == pytest.approx(b["final_time"], rel=T_RTOL)
    with open(os.path.join(runs["port"], "taylor-green-metrics.yaml")) as f:
        assert yaml.safe_load(f)["steps"] == 2


def test_time_solving_matches_reference_checkpoint(runs):
    a, b = (np.load(os.path.join(runs[k], "checkpoint.npz"))
            for k in ("port", "ref"))
    assert sorted(a.files) == sorted(b.files)
    assert int(a["step"]) == int(b["step"]) == 2
    for k in ("t", "dt"):
        assert float(a[k]) == pytest.approx(float(b[k]), rel=T_RTOL)
    for k in ("vort", "vel", "f1"):
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        err = np.abs(a[k] - b[k]).max() / np.abs(b[k]).max()
        assert err < CROSS_TOL, (k, err)


def _xmf_without_times(path):
    """The XDMF index's text with each step's time value cut out, and
    the values."""
    txt = open(path).read()
    pat = r'<Time Value="([^"]*)" />'
    return re.sub(pat, "<Time />", txt), [float(v) for v in
                                          re.findall(pat, txt)]


def test_time_solving_matches_reference_xdmf(runs):
    """The XDMF index the same text, but for the steps' time values (to
    T_RTOL); every HDF5 dataset within 1e-10."""
    name = "TaylorGreen.xmf"
    a_txt, a_t = _xmf_without_times(os.path.join(runs["port"], name))
    b_txt, b_t = _xmf_without_times(os.path.join(runs["ref"], name))
    assert a_txt == b_txt and len(a_t) == len(b_t) == 2
    np.testing.assert_allclose(a_t, b_t, rtol=T_RTOL)
    files = sorted(f for f in os.listdir(runs["ref"]) if f.endswith(".h5"))
    assert files == ["mesh.h5", "vec-data-00001.h5", "vec-data-00002.h5"]
    assert files == sorted(f for f in os.listdir(runs["port"])
                           if f.endswith(".h5"))
    for f in files:
        with h5py.File(os.path.join(runs["port"], f)) as ha, \
                h5py.File(os.path.join(runs["ref"], f)) as hb:
            names = []
            hb.visititems(lambda n, o: names.append(n)
                          if isinstance(o, h5py.Dataset) else None)
            assert names
            for n in names:
                x, y = ha[n][()], hb[n][()]
                assert x.shape == y.shape
                err = np.abs(x - y).max() / max(np.abs(y).max(), 1e-300)
                assert err < CROSS_TOL, (f, n, err)


def test_checkpoint_resumes_across_packages(runs):
    """The port resumed from the reference's step-2 checkpoint and the
    reference resumed from the port's take the same step 3 (their
    step-3 checkpoints within 1e-10)."""
    a, b = (np.load(os.path.join(runs[k], "checkpoint.npz"))
            for k in ("ref_resumed", "port_resumed"))
    assert int(a["step"]) == int(b["step"]) == 3
    assert float(a["t"]) == pytest.approx(float(b["t"]), rel=T_RTOL)
    for k in ("vort", "vel", "f1"):
        err = np.abs(a[k] - b[k]).max() / np.abs(b[k]).max()
        assert err < CROSS_TOL, (k, err)
