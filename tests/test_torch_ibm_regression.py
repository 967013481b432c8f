"""The port's Re-40 drag protocol (pynama_tpu_torch/scripts/ibm_regression.py)
on the CPU: its plumbing on a tiny geometry (12x8 elements, 6 steps
checkpointed every 3, segments of 2 steps) through the command line,
with the module's protocol constants patched; and the slow twin of
tests/test_ibm_physics.py::test_static_cylinder_re40_drag at the
reference test's size and windows (not run in tier-1).

The plumbing run's gates fail (t stays short of 12), so the command exits
1; what it wrote to --out is checked: the resume from the step-6
checkpoint, the segments' fixed dts, the Richardson arithmetic against a
hand computation from the raw coefficients, and that
run-artifacts/ibm_regression.json is left as it was."""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from pynama_tpu_torch.scripts import ibm_regression as R

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(ROOT, "run-artifacts", "ibm_regression.json")
STEPS, SEG, EVERY = 6, 2, 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """(exit code, the JSON written to --out, its path, the artifact's
    digest before and after), the command's protocol cut to the tiny
    geometry and step counts."""
    out = tmp_path_factory.mktemp("ibm-reg") / "nested" / "re40.json"
    before = digest(ARTIFACT)
    mp = pytest.MonkeyPatch()
    for name, value in (("RE40_GEOM", {**R.RE40_GEOM, "nelem": (12, 8)}),
                        ("STEPS", STEPS), ("SEG_STEPS", SEG),
                        ("CKPT_EVERY", EVERY)):
        mp.setattr(R, name, value)
    try:
        rc = R.main(["re40", "--device", "cpu", "--out", str(out)])
    finally:
        mp.undo()
    with open(out) as f:
        res = json.load(f)
    return rc, res, out, before, digest(ARTIFACT)


def test_writes_out_where_told_and_leaves_run_artifacts(cli_run):
    rc, res, out, before, after = cli_run
    assert out.is_file() and out.parent.name == "nested"
    assert before == after
    assert res["device"] == "cpu" and res["card"] is None
    assert res["geom"]["nelem"] == [12, 8]


def test_short_run_fails_only_the_time_gate(cli_run):
    """A failed gate exits non-zero; of this run's gates only t > 12
    fails."""
    rc, res, *_ = cli_run
    assert rc == 1
    assert len(res["gate_failures"]) == 1
    assert res["gate_failures"][0].startswith("t ")
    assert res["main"]["t"] < R.T_MIN


def test_refined_and_checkpointed_run(cli_run):
    _, res, *_ = cli_run
    main = res["main"]
    assert main["refine"] and main["inner_dtype"] == "torch.float32"
    assert main["steps"] == STEPS == len(main["step_rows"])
    assert [r["step"] for r in main["step_rows"]] == list(range(1, 7))
    assert all(r["rounds"] > 0 and r["kle_solves"] >= 10
               for r in main["step_rows"])
    # the initial post-step, then the step's and the force floor's
    assert len(main["flux_cg_iters"]) == 1 + 2 * STEPS


def test_segments_resume_from_the_checkpoint(cli_run):
    """Each segment resumes at step 6 (the checkpoint's, with its cd
    history) from the run's t, and takes 2 steps at its fixed dt."""
    _, res, *_ = cli_run
    t_main = res["main"]["t"]
    for seg, dt in zip(res["segments"], R.SEG_DTS):
        assert seg["max_dt"] == dt
        assert seg["steps"] == STEPS + SEG
        assert [r["step"] for r in seg["step_rows"]] == [7, 8]
        assert seg["t_history_head"] == res["main_t_history"]
        assert seg["cd_history_len"] == STEPS + SEG
        assert len(seg["cd_raw"]) == len(seg["dt"]) == SEG
        assert seg["dt"] == pytest.approx([dt] * SEG, abs=R.DT_TOL)
        assert seg["t"] == pytest.approx(t_main + SEG * dt, rel=1e-12)


def test_richardson_by_hand(cli_run):
    _, res, *_ = cli_run
    a, b = res["segments"]
    ca, cb = np.mean(a["cd_raw"][-8:]), np.mean(b["cd_raw"][-8:])
    la, lb = np.mean(a["cl_raw"][-8:]), np.mean(b["cl_raw"][-8:])
    da, db = np.mean(a["dt"][-8:]), np.mean(b["dt"][-8:])
    assert (a["cd_raw_mean"], a["dt_mean"]) == (ca, da)
    assert (b["cl_raw_mean"], b["dt_mean"]) == (lb, db)
    assert res["cd_phys"] == pytest.approx((ca * da - cb * db) / (da - db),
                                           rel=1e-14)
    assert res["cl_phys"] == pytest.approx((la * da - lb * db) / (da - db),
                                           rel=1e-14)
    assert res["cd_phys_minus_ref"] == pytest.approx(
        res["cd_phys"] - 1.8572644338304616, abs=1e-15)


def test_gates():
    """gate_failures holds the reference test's windows."""
    def record(t=12.5, dts=(0.06, 0.03), cd=1.86, cl=2e-4):
        return {"main": {"u_ref": 1.0, "re": 40.0, "t": t, "steps": 180},
                "segments": [{"dt_mean": d, "max_dt": m}
                             for d, m in zip(dts, R.SEG_DTS)],
                "cd_phys": cd, "cl_phys": cl}

    assert R.gate_failures(record()) == []
    for bad in (record(t=12.0), record(dts=(0.0600011, 0.03)),
                record(dts=(0.06, 0.0299989)), record(cd=1.70),
                record(cd=2.0), record(cl=-0.1)):
        assert len(R.gate_failures(bad)) == 1


@pytest.mark.parametrize("protocol", ["big"])
def test_other_protocols_raise(protocol):
    with pytest.raises(NotImplementedError, match="queue 1 #8"):
        R.main([protocol, "--device", "cpu"])


def test_drag_protocol_needs_the_last_step_checkpointed(tmp_path):
    with pytest.raises(ValueError, match="multiple"):
        R.drag_protocol(R.RE40_GEOM, "cpu", str(tmp_path), steps=7,
                        ckpt_every=3)


def test_chip_smoke_refine_limit_source():
    """chip_smoke.IBM_REFINE_VORT_CPU (12f's limit against 12c, over
    100) is what ibm_refine_vort_cpu() gives: the port's refined vs
    unrefined 12x12 runs at kle-rtol 1e-8."""
    got = chip_smoke.ibm_refine_vort_cpu()
    assert got == pytest.approx(chip_smoke.IBM_REFINE_VORT_CPU, rel=1e-3)
    assert chip_smoke.IBM_REFINE_VORT_LIMIT == \
        100 * chip_smoke.IBM_REFINE_VORT_CPU


@pytest.mark.slow
def test_static_cylinder_re40_drag(tmp_path):
    """Twin of tests/test_ibm_physics.py::test_static_cylinder_re40_drag
    (slow: 208 steps at 144x96 on the CPU), under kle-refine."""
    res = R.drag_protocol(R.RE40_GEOM, "cpu", str(tmp_path))
    assert res["main"]["t"] > 12.0
    a, b = res["segments"]
    assert abs(a["dt_mean"] - 0.06) < 1e-6 and abs(b["dt_mean"] - 0.03) < 1e-6
    assert 1.70 < res["cd_phys"] < 2.0, res["cd_phys"]
    assert abs(res["cl_phys"]) < 0.1, res["cl_phys"]
