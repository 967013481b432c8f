"""The port's Re-40 drag protocols (pynama_tpu_torch/scripts/
ibm_regression.py ``re40`` and ``big``) on the CPU: their plumbing on
tiny geometries through the command line, with the module's protocol
constants patched; the command's handling of several protocols; and the
slow twins of tests/test_ibm_physics.py::test_static_cylinder_re40_drag
and ::test_static_cylinder_re40_drag_big_domain at the reference tests'
sizes and windows (not run in tier-1).

The plumbing runs' gates fail (t stays short of 12), so the command exits
1. For re40 (12x8 elements, 6 steps checkpointed every 3, segments of 2
steps) what it wrote to --out is checked: the resume from the step-6
checkpoint, the segments' fixed dts, the Richardson arithmetic against a
hand computation from the raw coefficients, and that
run-artifacts/ibm_regression.json is left as it was. For big, a tall cut
of its domain (12x16 elements of [-6,12]x[-12,12], 2 steps checkpointed
at 2, segments of 1 step) run without --out: its default record, tag,
checkpoint name, Richardson arithmetic beside both recorded drags, and
its gates' windows. The several-protocol runs replace run_protocol by a
stand-in that records the order and passes or fails on demand."""

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
BIG_NELEM = (12, 16)
BIG_STEPS, BIG_SEG, BIG_EVERY = 2, 1, 2


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


@pytest.fixture(scope="module")
def big_run(tmp_path_factory):
    """(exit code, the record big wrote to its default --out, the files
    under chiprun_out/, the artifact's digest before and after), run in
    a fresh directory on BIG_NELEM with the step counts cut."""
    cwd = tmp_path_factory.mktemp("ibm-big")
    before = digest(ARTIFACT)
    mp = pytest.MonkeyPatch()
    for name, value in (("BIG_GEOM", {**R.BIG_GEOM, "nelem": BIG_NELEM}),
                        ("STEPS", BIG_STEPS), ("SEG_STEPS", BIG_SEG),
                        ("CKPT_EVERY", BIG_EVERY)):
        mp.setattr(R, name, value)
    mp.chdir(cwd)
    try:
        rc = R.main(["big", "--device", "cpu"])
    finally:
        mp.undo()
    with open(cwd / "chiprun_out" / "ibm_regression_big.json") as f:
        res = json.load(f)
    return rc, res, os.listdir(cwd / "chiprun_out"), before, digest(ARTIFACT)


def test_big_record_tag_geometry_and_default_out(big_run):
    """big writes chiprun_out/ibm_regression_big.json by default and
    nothing else; its record names the reference's key, the tall box and
    the checkpoint the segments resumed from."""
    rc, res, files, before, after = big_run
    assert rc == 1 and files == ["ibm_regression_big.json"]
    assert before == after
    assert res["tag"] == "re40_blockage4.2"
    assert res["checkpoint"] == "cyl_ck_re40_blockage4.2.npz"
    assert res["geom"] == {"nelem": list(BIG_NELEM), "lower": [-6, -12],
                           "upper": [12, 12]}
    assert res["device"] == "cpu" and res["card"] is None
    assert res["main"]["refine"]
    assert res["main"]["velocity_dofs"] == 2 * 25 * 33
    assert res["main"]["steps"] == BIG_STEPS
    for seg, dt in zip(res["segments"], R.SEG_DTS):
        assert [r["step"] for r in seg["step_rows"]] == [BIG_STEPS + 1]
        assert seg["t_history_head"] == res["main_t_history"]
        assert seg["dt"] == pytest.approx([dt], abs=R.DT_TOL)


def test_big_richardson_beside_both_recorded_drags(big_run):
    _, res, *_ = big_run
    a, b = res["segments"]
    ca, cb = np.mean(a["cd_raw"][-8:]), np.mean(b["cd_raw"][-8:])
    la, lb = np.mean(a["cl_raw"][-8:]), np.mean(b["cl_raw"][-8:])
    da, db = np.mean(a["dt"][-8:]), np.mean(b["dt"][-8:])
    assert res["cd_phys"] == pytest.approx((ca * da - cb * db) / (da - db),
                                           rel=1e-14)
    assert res["cl_phys"] == pytest.approx((la * da - lb * db) / (da - db),
                                           rel=1e-14)
    assert res["ref_cd_phys"] == 1.7658329218670357
    assert res["cd_phys_minus_ref"] == res["cd_phys"] - 1.7658329218670357
    assert res["ref_cd_phys_blockage83"] == 1.8572644338304616
    assert res["blockage_drop"] == res["cd_phys"] - 1.8572644338304616
    assert res["ref_blockage_drop"] == pytest.approx(-0.0914315, abs=1e-7)


def test_big_run_gated_by_its_windows(big_run):
    """The record's failures are gate_failures' with big's windows; the
    short run fails t > 12 first."""
    _, res, *_ = big_run
    assert R.DRAG[res["tag"]][1:] == (R.BIG_CD_WINDOW, R.BIG_CD_BELOW)
    assert res["gate_failures"] == R.gate_failures(res, R.BIG_CD_WINDOW,
                                                   R.BIG_CD_BELOW)
    assert res["gate_failures"][0].startswith("t ")


def test_re40_record_tag_and_blockage_fields(cli_run):
    """re40's record names its key and checkpoint, and holds the blockage
    drop as big's does: its own difference from the 8.3% value."""
    _, res, *_ = cli_run
    assert res["tag"] == "re40_blockage8.3"
    assert res["checkpoint"] == "cyl_ck_re40_blockage8.3.npz"
    assert res["ref_cd_phys"] == res["ref_cd_phys_blockage83"] == \
        1.8572644338304616
    assert res["blockage_drop"] == res["cd_phys_minus_ref"]
    assert res["ref_blockage_drop"] == 0.0
    assert R.DRAG[res["tag"]][1:] == (R.CD_WINDOW, None)


@pytest.mark.parametrize("geom,tag", [
    (R.RE40_GEOM, "re40_blockage8.3"), (R.BIG_GEOM, "re40_blockage4.2"),
    ({**R.BIG_GEOM, "nelem": BIG_NELEM}, "re40_blockage4.2"),
    ({**R.RE40_GEOM, "nelem": (12, 8)}, "re40_blockage8.3"),
])
def test_blockage_tag_follows_the_box_height(geom, tag):
    """The record key, and with it the checkpoint name, recorded drag and
    windows, is the blockage D/H of the geometry's box, whatever its
    element counts."""
    assert R.blockage_tag(geom) == tag and tag in R.DRAG


def drag_record(cd, t=12.5, dts=(0.06, 0.03), cl=2e-4):
    return {"main": {"u_ref": 1.0, "re": 40.0, "t": t, "steps": 180},
            "segments": [{"dt_mean": d, "max_dt": m}
                         for d, m in zip(dts, R.SEG_DTS)],
            "cd_phys": cd, "cl_phys": cl}


@pytest.mark.parametrize("cd,failed", [
    (1.7658, []), (1.46, []), (1.849, []),
    (1.86, ["below"]),             # inside the window: only < 1.85 refuses
    (1.85, ["below"]), (1.45, ["outside"]), (1.90, ["below", "outside"]),
])
def test_big_gates(cd, failed):
    """test_static_cylinder_re40_drag_big_domain's windows: cd_phys < 1.85
    and 1.45 < cd_phys < 1.90, beside re40's other gates."""
    got = R.gate_failures(drag_record(cd), R.BIG_CD_WINDOW, R.BIG_CD_BELOW)
    assert ["below" if "not below" in m else "outside" if "outside" in m
            else m for m in got] == failed
    if cd == 1.86:
        assert R.gate_failures(drag_record(cd)) == []   # re40's windows


class StandIn:
    """run_protocol's stand-in: records the names it is called with and
    fails the gates of those in ``failing``."""

    def __init__(self, failing=()):
        self.calls, self.failing = [], failing

    def __call__(self, name, device):
        self.calls.append(name)
        bad = ["stand-in gate"] if name in self.failing else []
        return {"name": name, "device": str(device)}, bad, lambda res: None


@pytest.mark.parametrize("argv,order", [
    ([], ["re40", "big", "st"]),
    (["st", "re40"], ["re40", "st"]),
    (["big", "st", "big"], ["big", "st"]),
])
def test_protocols_run_in_the_tpu_scripts_order(tmp_path, monkeypatch,
                                                 argv, order):
    """With no protocol named all three run; named ones run in the order
    of scripts/run_ibm_regression_tpu.py, each writing its own default
    record."""
    monkeypatch.chdir(tmp_path)
    stand_in = StandIn()
    monkeypatch.setattr(R, "run_protocol", stand_in)
    assert R.main(argv + ["--device", "cpu"]) == 0
    assert stand_in.calls == order
    assert sorted(os.listdir(tmp_path / "chiprun_out")) == \
        sorted(R.DEFAULT_OUT[n] for n in order)
    for n in order:
        with open(tmp_path / "chiprun_out" / R.DEFAULT_OUT[n]) as f:
            res = json.load(f)
        assert res["name"] == n and res["gate_failures"] == []
        assert res["card"] is None and res["seconds"] >= 0


def test_run_stops_at_the_first_failing_protocol(tmp_path, monkeypatch):
    """big fails its gates: its record is written, the command exits 1
    and st does not run."""
    monkeypatch.chdir(tmp_path)
    stand_in = StandIn(failing=("big",))
    monkeypatch.setattr(R, "run_protocol", stand_in)
    assert R.main(["--device", "cpu"]) == 1
    assert stand_in.calls == ["re40", "big"]
    assert sorted(os.listdir(tmp_path / "chiprun_out")) == \
        ["ibm_regression.json", "ibm_regression_big.json"]


@pytest.mark.parametrize("argv", [
    ["re40", "big", "--out", "x.json"], ["--out", "x.json"]])
def test_out_takes_a_single_protocol(tmp_path, monkeypatch, argv):
    monkeypatch.chdir(tmp_path)
    stand_in = StandIn()
    monkeypatch.setattr(R, "run_protocol", stand_in)
    with pytest.raises(SystemExit) as e:
        R.main(argv + ["--device", "cpu"])
    assert e.value.code == 2
    assert stand_in.calls == [] and os.listdir(tmp_path) == []


def test_no_card_raises_before_any_protocol(monkeypatch):
    """Without --device cpu the command needs a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    stand_in = StandIn()
    monkeypatch.setattr(R, "run_protocol", stand_in)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        R.main(["big"])
    assert stand_in.calls == []


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


@pytest.mark.slow
def test_static_cylinder_re40_drag_big_domain(tmp_path):
    """Twin of tests/test_ibm_physics.py::
    test_static_cylinder_re40_drag_big_domain (slow: 208 steps at 144x192
    on the CPU), under kle-refine."""
    res = R.drag_protocol(R.BIG_GEOM, "cpu", str(tmp_path))
    assert res["main"]["t"] > 12.0
    a, b = res["segments"]
    assert abs(a["dt_mean"] - 0.06) < 1e-6 and abs(b["dt_mean"] - 0.03) < 1e-6
    assert res["cd_phys"] < 1.85  # strictly below the 8.3%-blockage value
    assert 1.45 < res["cd_phys"] < 1.90, res["cd_phys"]
    assert abs(res["cl_phys"]) < 0.1, res["cl_phys"]
