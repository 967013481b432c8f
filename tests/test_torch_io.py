"""The port's IO (io/checkpoint.py, io/xdmf.py, io/vtk.py), allocation
report (utils/report.py) and checkpoint/resume in the problems' run on
the CPU: the IO and report twins of tests/test_io_cli.py; the numpy
writers against the reference's on the same seeded input (the same
bytes); a dual-mask cavity resuming with both solves warm-started from
the checkpoint's one velocity, as the reference's does; and an
immersed-boundary run resumed with its force histories."""

import os
import zipfile

import numpy as np
import pytest
import torch

from pynama_tpu.io import checkpoint as ref_checkpoint
from pynama_tpu.io import vtk as ref_vtk
from pynama_tpu_torch.cases.analytic import CustomFuncProblem
from pynama_tpu_torch.cases.cavity import CavityProblem
from pynama_tpu_torch.cases.immersed import ImmersedBoundaryProblem
from pynama_tpu_torch.io import vtk
from pynama_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from pynama_tpu_torch.io.xdmf import XdmfWriter
from tests.test_cases import make_config
from tests.test_ibm import ibm_config


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_checkpoint_round_trip(tmp_path):
    pth = str(tmp_path / "ck.npz")
    vort = np.random.default_rng(0).normal(size=100)
    save_checkpoint(pth, step=7, t=1.25, dt=0.01, vort=vort, vel=vort * 2,
                    f1=vort * 3, extra={"case": "x"})
    ck = load_checkpoint(pth)
    assert ck["step"] == 7 and ck["t"] == 1.25 and ck["dt"] == 0.01
    np.testing.assert_allclose(ck["vort"], vort)
    np.testing.assert_allclose(ck["vel"], vort * 2)
    assert ck["extra"]["case"] == "x"


def test_resume_matches_uninterrupted(tmp_path):
    """Run 4 steps straight vs 2 + checkpoint + resume 2: identical (a
    single-mask problem resumes bit for bit)."""
    cfg = make_config((3, 3), 3, rho=0.5, mu=0.01, end=0.5, max_steps=10)
    p1 = CustomFuncProblem(cfg, case="taylor-green", device="cpu").setup()
    w1, t1, n1 = p1.run(max_steps=4)

    ck = str(tmp_path / "ck.npz")
    p2 = CustomFuncProblem(cfg, case="taylor-green", device="cpu").setup()
    p2.run(max_steps=2, checkpoint_path=ck, checkpoint_every=1)
    w2, t2, n2 = p2.run(max_steps=4, resume_from=ck)

    assert n2 == n1
    assert abs(t1 - t2) < 1e-14
    np.testing.assert_allclose(w1.numpy(), w2.numpy(), atol=1e-12)
    assert torch.equal(w1, w2)


def test_xdmf_writer(tmp_path):
    import h5py

    w = XdmfWriter(str(tmp_path), dim=2)
    coords = np.random.default_rng(1).normal(size=(20, 2))
    w.save_mesh(coords)
    w.save_fields(0, 0.0, velocity=np.zeros(40), vorticity=np.ones(20))
    w.save_fields(5, 0.5, velocity=np.ones(40), vorticity=np.ones(20))
    out = w.write_xmf("case")
    assert os.path.exists(out)
    with h5py.File(tmp_path / "vec-data-00005.h5") as f:
        assert f["fields/velocity"].shape == (40,)
    txt = open(out).read()
    assert "Polyvertex" in txt and "HyperSlab" in txt and "velocity_x" in txt


def test_vtk_writers(tmp_path):
    coords = np.random.default_rng(0).normal(size=(12, 2))
    p1 = vtk.write_point_cloud(
        str(tmp_path / "cloud.vtk"), coords,
        fields={"vorticity": np.arange(12.0), "velocity": np.ones((12, 2))},
    )
    txt = open(p1).read()
    assert "POINTS 12 double" in txt and "SCALARS vorticity" in txt
    assert "VECTORS velocity" in txt
    p2 = vtk.write_body_polyline(str(tmp_path / "body.vtk"), coords)
    assert "LINES 1 14" in open(p2).read()


def _members(path):
    """An npz's members as {name: bytes}; the zip's own headers carry the
    time of writing."""
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def test_writers_match_reference_bytes(tmp_path):
    """The same seeded input through both packages' numpy writers: the
    VTK files byte for byte, the checkpoints member for member, and each
    package loads the other's checkpoint."""
    rng = np.random.default_rng(5)
    coords = rng.normal(size=(15, 2))
    fields = {"vorticity": rng.normal(size=15),
              "velocity": rng.normal(size=(15, 2))}
    for fn in ("write_point_cloud", "write_body_polyline"):
        args = (coords, fields) if fn == "write_point_cloud" else (coords,)
        a = getattr(vtk, fn)(str(tmp_path / f"port-{fn}.vtk"), *args)
        b = getattr(ref_vtk, fn)(str(tmp_path / f"ref-{fn}.vtk"), *args)
        assert open(a, "rb").read() == open(b, "rb").read()

    state = dict(step=3, t=0.125, dt=1e-3, vort=rng.normal(size=30),
                 vel=rng.normal(size=60), f1=rng.normal(size=30),
                 extra={"cd": [[1.5]], "times": [0.125]})
    save_checkpoint(str(tmp_path / "port.npz"), **state)
    ref_checkpoint.save_checkpoint(str(tmp_path / "ref.npz"), **state)
    assert _members(tmp_path / "port.npz") == _members(tmp_path / "ref.npz")
    for load, other in ((load_checkpoint, "ref.npz"),
                        (ref_checkpoint.load_checkpoint, "port.npz")):
        ck = load(str(tmp_path / other))
        assert (ck["step"], ck["t"], ck["dt"]) == (3, 0.125, 1e-3)
        assert ck["extra"] == state["extra"]
        for k in ("vort", "vel", "f1"):
            assert np.array_equal(ck[k], state[k])


def cavity_config(nelem):
    cfg = make_config((nelem, nelem), 3, rho=1.0, mu=0.1, end=1.0,
                      max_steps=10)
    cfg["boundary-conditions"] = {"no-slip": {"up": [1.0, 0.0]}}
    return cfg


def test_device_report_lists_allocations():
    """Every major allocation (MG kernels, coarse inverse, masks,
    elemental matrices) shows up with a path and byte count."""
    from pynama_tpu_torch.utils.report import collect_arrays, device_report

    p = CavityProblem(cavity_config(8), device="cpu").setup()
    p.solve_kle(0.0, p.initial_vorticity())  # populate lazy conv kernels
    rows = collect_arrays(p, "p")
    paths = [r[0] for r in rows]
    assert any(".system.K.A" in s for s in paths), paths[:5]
    assert any(".mg.coarse_inv" in s for s in paths)
    assert any("free_mask" in s for s in paths)
    # on the CPU every tensor is host memory: the card's bytes are 0
    assert sum(r[3] for r in rows if not r[4]) > 0
    assert sum(r[3] for r in rows if r[4]) == 0
    rep = device_report(p, top=10)
    assert "allocation report" in rep and "MB" in rep
    assert len(rep.splitlines()) <= 13


def test_device_report_counts_each_storage_once():
    from pynama_tpu_torch.utils.report import collect_arrays

    class Holder:
        pass

    Holder.__module__ = "pynama_tpu_torch.test"
    h = Holder()
    h.a = torch.zeros(10, 4, dtype=torch.float64)
    h.b = h.a[2:5]                  # a view: same storage
    h.c = [h.a, np.zeros(3)]        # the same tensor again, and numpy
    rows = {r[0]: r for r in collect_arrays(h, "h")}
    assert rows["h.a"][3] == 320 and rows["h.b"][3] == 0
    assert rows["h.c[0]"][3] == 0 and rows["h.c[1]"][3] == 24


class _Stop(Exception):
    pass


def test_cavity_resume_warm_starts_both_solves_from_vel(tmp_path):
    """A checkpoint keeps one velocity (the aux pair's last member): on
    resume the dual-mask cavity's first free-slip and final solves both
    start from it, as in the reference (cases/cavity.py: a non-pair
    warm start becomes (vel, vel)); without a checkpoint they start
    from their own previous solutions."""
    p = CavityProblem(cavity_config(8), device="cpu").setup()
    rng = np.random.default_rng(2)
    n = p.mesh.n_nodes
    ck = str(tmp_path / "ck.npz")
    save_checkpoint(ck, step=3, t=0.3, dt=0.01, vort=rng.normal(size=n),
                    vel=rng.normal(size=2 * n), f1=rng.normal(size=n))
    seen, solve = [], p._solve

    def spy(name, vort, u_bc, x0, *args):
        seen.append((name, x0))
        if len(seen) == 2:
            raise _Stop
        return solve(name, vort, u_bc, x0, *args)

    p._solve = spy
    with pytest.raises(_Stop):
        p.run(max_steps=4, resume_from=ck)
    vel = p._blk(torch.as_tensor(load_checkpoint(ck)["vel"]).reshape(
        p._gshape(2)))
    assert [s[0] for s in seen] == ["free_mask_fs", "free_mask"]
    assert torch.equal(seen[0][1], vel) and torch.equal(seen[1][1], vel)


def test_ibm_resume_carries_force_history(tmp_path):
    """An immersed-boundary run of 3 steps against 2 + checkpoint +
    resume 1: the histories come back from the checkpoint's extra, and
    the resumed step (warm-started from the corrected velocity, as the
    reference's) agrees to the KLE and flux tolerances."""
    cfg = ibm_config(8)
    ck = str(tmp_path / "ck.npz")
    p = ImmersedBoundaryProblem(cfg, device="cpu").setup()
    p.run(max_steps=3, checkpoint_path=ck, checkpoint_every=2)
    extra = load_checkpoint(ck)["extra"]
    assert extra["cd"] == p.cd_history[:2] and extra["times"] == \
        p.t_history[:2]
    q = ImmersedBoundaryProblem(cfg, device="cpu").setup()
    _, t, n = q.run(max_steps=3, resume_from=ck)
    assert n == 3 and q.cd_history[:2] == p.cd_history[:2]
    np.testing.assert_allclose(q.t_history, p.t_history, rtol=1e-10)
    np.testing.assert_allclose(q.cd_history, p.cd_history, rtol=1e-8)
    rel = float(torch.linalg.norm(q.vort - p.vort) / torch.linalg.norm(
        p.vort))
    assert rel < 1e-8, rel
