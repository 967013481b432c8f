"""The port's Re-100 Strouhal protocol (pynama_tpu_torch/scripts/
ibm_regression.py ``st``) on the CPU, against the reference where the
reference has the function:

- the kicked initial vorticity (KickedCylinder) against a copy of
  tests/test_ibm_physics.py's class on the protocol's box cut to 24x16
  elements, float64, within 1e-15 relative;
- the initial condition's post-step (KLE solve, velocity correction,
  curl) under kle-refine on that geometry against the reference's jitted
  _post_step_fn on the same inputs: velocity and vorticity within 1e-8
  relative, the flux q within 1e-7;
- strouhal against the reference test's arithmetic (copied) on a seeded
  synthetic lift on an adaptive time grid: equal;
- the command line on a tiny geometry (12x8 elements, 4 steps, the
  lift window from t = 0) with the module's constants patched: its exit
  code, what it wrote to --out (and where, by default), and that
  run-artifacts/ibm_regression.json is left as it was;

and the slow twin of test_cylinder_re100_strouhal at the reference test's
size and windows (not run in tier-1). The reference's setup and post-step
take ~15 s with a cold JAX cache; one of each is shared by the module."""

import hashlib
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pynama_tpu.cases.immersed import ImmersedBoundaryProblem as RefProblem
from pynama_tpu_torch.scripts import ibm_regression as R

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(ROOT, "run-artifacts", "ibm_regression.json")
SMALL = {**R.ST_GEOM, "nelem": (24, 16)}
CLI_NELEM, CLI_STEPS = (12, 8), 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class RefKickedCylinder(RefProblem):
    """tests/test_ibm_physics.py:145-157 (the class is local to its test),
    copied."""

    def initial_vorticity(self):
        c = np.asarray(self.mesh.coords)
        x, y = c[:, 0], c[:, 1]

        def blob(x0, y0, s):
            return np.exp(-(((x - x0) ** 2 + (y - y0) ** 2) / s**2))

        w = 3.0 * blob(1.2, 0.45, 0.35) - 3.0 * blob(1.6, -0.4, 0.35)
        return jnp.asarray(w.reshape(self._gshape(self.dim_w)),
                           dtype=self.dtype)


def ref_strouhal(t_history, cl_raw_history, u_ref):
    """tests/test_ibm_physics.py:175-186, copied (p.t_history,
    p.cl_raw_history and p.u_ref as arguments)."""
    ts = np.asarray(t_history)
    cls = np.asarray([c[0] for c in cl_raw_history])
    sel = ts > 30.0
    tu = np.linspace(ts[sel][0], ts[sel][-1], sel.sum())
    yu = np.interp(tu, ts[sel], cls[sel])
    yu -= yu.mean()
    freqs = np.fft.rfftfreq(len(tu), d=tu[1] - tu[0])
    amp = np.abs(np.fft.rfft(yu))
    i = int(np.argmax(amp[1:]) + 1)
    st = float(freqs[i]) * 1.0 / u_ref
    prominence = float(amp[i] / np.median(amp[1:]))
    return st, prominence


def rel(a, b):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.fixture(scope="module")
def problems():
    """(reference problem, port problem), both set up on SMALL."""
    cfg = R.st_config(**SMALL)
    q = RefKickedCylinder(cfg).setup()
    p = R.KickedCylinder(cfg, dtype=torch.float64, device="cpu").setup()
    return q, p


def test_kick_matches_reference(problems):
    q, p = problems
    a, b = p.initial_vorticity(), np.asarray(q.initial_vorticity())
    assert a.dtype == torch.float64 and a.device.type == "cpu"
    assert tuple(a.shape) == b.shape == (33, 49, 1)
    assert rel(a.numpy(), b) <= 1e-15
    # one formula: the problem's kick is kick() of its nodes, bit for bit
    assert torch.equal(a.reshape(-1), torch.as_tensor(R.kick(p.mesh.coords)))
    # the dipole: +3 near (1.2, 0.45), -3 near (1.6, -0.4)
    assert float(a.max()) > 2.5 and float(a.min()) < -2.5


def test_initial_post_step_matches_reference(problems):
    """run()'s initial condition: the post-step from the kick and a zero
    velocity at t = 0, in each package's own layout."""
    q, p = problems
    assert p._refine and q._refine
    Xb, Ub = p._body_state(p.t_start)
    vort, vel, qf = p._post_step(p.t_start, p._blk(p.initial_vorticity()),
                                 p._blk(p.zero_vel()), Xb, Ub)
    rv, rvel, rq = q._post_step_fn()(
        jnp.asarray(q.t_start, dtype=q.dtype), q.initial_vorticity(),
        q.zero_vel(), jnp.asarray(q.body.coords_at(0.0), dtype=q.dtype),
        jnp.asarray(q.body.velocity_at(0.0), dtype=q.dtype))
    assert rel(p._unblk(vel).numpy(), rvel) <= 1e-8
    assert rel(p._unblk(vort).numpy(), rv) <= 1e-8
    assert rel(qf.numpy(), rq) <= 1e-7
    assert len(p.ir_rounds) == 1 and p.ir_rounds[0] >= 1


def test_strouhal_matches_reference_arithmetic():
    """A seeded lift near St 1/6 with noise and drift, on an adaptive
    grid of ~1,000 steps to t = 60 (dt 0.01 at first, then near 0.06)."""
    rng = np.random.default_rng(23)
    dts = np.concatenate([[0.01], 0.054 + 0.006 * rng.random(1100)])
    ts = np.cumsum(dts)
    ts = ts[ts <= 60.0]
    cl = (0.3 * np.sin(2 * np.pi * ts / 6.0 + 0.4) + 0.01 * ts
          + 0.02 * rng.standard_normal(ts.size))
    history = [[c] for c in cl]
    u_ref = 1.0 + 1e-13
    want = ref_strouhal(list(ts), history, u_ref)
    assert R.strouhal(list(ts), [c[0] for c in history], u_ref) == want
    assert 0.15 < want[0] < 0.19 and want[1] > 10


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """(exit code, the JSON written to --out, its path, the artifact's
    digest before and after), the command's protocol cut to CLI_NELEM
    and CLI_STEPS, the lift window from t = 0."""
    out = tmp_path_factory.mktemp("ibm-st") / "nested" / "st.json"
    before = digest(ARTIFACT)
    mp = pytest.MonkeyPatch()
    for name, value in (("ST_GEOM", {**R.ST_GEOM, "nelem": CLI_NELEM}),
                        ("ST_MAX_STEPS", CLI_STEPS), ("ST_T_MIN", 0.0)):
        mp.setattr(R, name, value)
    try:
        rc = R.main(["st", "--device", "cpu", "--out", str(out)])
    finally:
        mp.undo()
    with open(out) as f:
        res = json.load(f)
    return rc, res, out, before, digest(ARTIFACT)


def test_st_command_writes_its_record(cli_run):
    """A short run fails the end-time gate, so the command exits 1; its
    record holds the step rows, the histories, St and the failures."""
    rc, res, out, before, after = cli_run
    assert rc == 1 and out.is_file() and out.parent.name == "nested"
    assert before == after
    assert res["device"] == "cpu" and res["card"] is None
    assert res["geom"]["nelem"] == list(CLI_NELEM)
    assert res["refine"] and res["inner_dtype"] == "torch.float32"
    assert res["steps"] == CLI_STEPS == res["max_steps"]
    assert [r["step"] for r in res["step_rows"]] == [1, 2, 3, 4]
    assert all(r["rounds"] > 0 and r["kle_solves"] >= 10
               for r in res["step_rows"])
    # save_forces_every=1: one entry a step in every history
    assert len(res["t_history"]) == len(res["cl_raw_history"]) == \
        len(res["dt_history"]) == CLI_STEPS
    assert [r["t"] for r in res["step_rows"]] == res["t_history"]
    assert len(res["flux_cg_iters"]) == 1 + 2 * CLI_STEPS
    assert res["gate_failures"] == R.st_gate_failures(res)
    assert res["gate_failures"][0].startswith("t ")
    st, prominence = R.strouhal(res["t_history"], res["cl_raw_history"],
                                res["u_ref"], 0.0)
    assert (res["st"], res["prominence"]) == (st, prominence)
    assert res["st_minus_ref"] == st - R.REF_ST
    assert res["seconds"] >= res["run_s"] > 0


def test_st_command_default_out(tmp_path, monkeypatch):
    """Without --out, st writes chiprun_out/ibm_regression_st.json under
    the working directory (re40 keeps chiprun_out/ibm_regression.json);
    one step leaves no lift past t = 30, a failure of its own."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(R, "ST_GEOM", {**R.ST_GEOM, "nelem": CLI_NELEM})
    monkeypatch.setattr(R, "ST_MAX_STEPS", 1)
    assert R.main(["st", "--device", "cpu"]) == 1
    assert os.listdir(tmp_path / "chiprun_out") == ["ibm_regression_st.json"]
    with open(tmp_path / "chiprun_out" / "ibm_regression_st.json") as f:
        res = json.load(f)
    assert res["st"] is None and res["steps"] == 1
    assert res["gate_failures"][-1].startswith("fewer than two")


def test_st_gates():
    """st_gate_failures holds the reference test's windows."""
    def record(t=60.0, steps=1001, st=0.166, prominence=186.0):
        return {"t": t, "steps": steps, "end_time": 60.0,
                "max_steps": 1400, "t_min": 30.0, "st": st,
                "prominence": prominence}

    assert R.st_gate_failures(record()) == []
    assert R.st_gate_failures(record(t=60.0 - 5e-10)) == []
    for bad in (record(t=59.99), record(steps=1401), record(st=0.15),
                record(st=0.19), record(prominence=10.0),
                record(st=None, prominence=None)):
        assert len(R.st_gate_failures(bad)) == 1


@pytest.mark.slow
def test_cylinder_re100_strouhal():
    """Twin of tests/test_ibm_physics.py::test_cylinder_re100_strouhal
    (slow: up to 1,400 steps at 96x64 on the CPU), under kle-refine."""
    res = R.st_protocol(device="cpu")
    assert res["t"] >= 60.0 - 1e-9
    assert res["prominence"] > 10.0, res["prominence"]
    assert 0.15 < res["st"] < 0.19, res["st"]
