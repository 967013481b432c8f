"""The port's case layer on Gmsh meshes (cases/base.py's flat solver
layout with the Schwarz preconditioner) on the CPU in float64: the
twins of tests/test_unstructured.py's case tests, and the flat layout
through transport_rhs, ws extrapolation and checkpoint/resume."""

import numpy as np
import pytest
import torch

from pynama_tpu_torch.cases.analytic import CustomFuncProblem
from pynama_tpu_torch.cases.cavity import CavityProblem
from tests.blas_threads import blas_threads
from tests.test_unstructured import (_write_hex_msh, _write_msh22_quads,
                                     box_corner_mesh)

F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread and one BLAS thread (the Schwarz setup's
    inverses): the suite runs files side by side on a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with blas_threads(1):
        yield
    torch.set_num_threads(n)


def quad_msh(path, n, distort=0.0, seed=0):
    """An unnamed Gmsh v2.2 quad mesh of the unit box."""
    pts, quads = box_corner_mesh(n, n, distort=distort, seed=seed)
    _write_msh22_quads(str(path), pts, quads)
    return str(path)


def cavity_cfg(path, **extra):
    return {
        "name": "gmsh-cavity",
        "material-properties": {"rho": 1.0, "mu": 0.1},
        "domain": {"ngl": 3, "gmsh-file": path},
        "boundary-conditions": {"no-slip": {"up": [1.0, 0.0]}},
        "time-solver": {"start-time": 0, "end-time": 0.2, "max-steps": 3},
        "kle-rtol": 1e-10, **extra,
    }


def tg2d_cfg(path):
    return {
        "name": "tg2d-gmsh",
        "material-properties": {"rho": 1.0, "mu": 0.01},
        "domain": {"ngl": 4, "gmsh-file": path},
        "time-solver": {"start-time": 0.0, "end-time": 0.05,
                        "max-steps": 30},
        "kle-rtol": 1e-11,
    }


# ----------------------------------------------------------------------
# twins of tests/test_unstructured.py
# ----------------------------------------------------------------------
def test_gmsh_hex_case_transient(tmp_path):
    """Full NS transient through the case layer on a distorted Gmsh hex
    mesh: the generic ElementOp path end to end."""
    msh = tmp_path / "tg3d.msh"
    _write_hex_msh(str(msh), 3, 3, 3, distort=0.03)
    cfg = {
        "name": "tg3d-gmsh",
        "material-properties": {"rho": 1.0, "mu": 0.01},
        "domain": {"ngl": 4, "gmsh-file": str(msh)},
        "time-solver": {"start-time": 0.0, "end-time": 0.02,
                        "max-steps": 20},
        "kle-rtol": 1e-11,
    }
    p = CustomFuncProblem(cfg, case="taylor-green", device="cpu").setup()
    assert p.dim == 3 and not p._blocked
    assert "left" in p.mesh.face_nodes and len(p.mesh.face_nodes["left"])
    w, t, n = p.run()
    vel_e, _ = p.exact_fields(t)
    ev = float(torch.linalg.norm(p.vel - vel_e.reshape(-1))
               / torch.linalg.norm(vel_e))
    assert abs(t - 0.02) < 1e-12
    assert ev < 0.05, ev


def test_gmsh_quad_case_transient(tmp_path):
    """2D NS transient on a distorted unstructured quad mesh through the
    case layer."""
    pts, quads = box_corner_mesh(4, 4, distort=0.03)
    msh = tmp_path / "tg2d.msh"
    with open(msh, "w") as f:
        f.write("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n")
        f.write(f"$Nodes\n{len(pts)}\n")
        for i, p in enumerate(pts):
            f.write(f"{i+1} {p[0]:.17g} {p[1]:.17g} 0\n")
        f.write("$EndNodes\n")
        f.write(f"$Elements\n{len(quads)}\n")
        for i, q in enumerate(quads):
            f.write(f"{i+1} 3 2 1 1 " + " ".join(str(v + 1) for v in q)
                    + "\n")
        f.write("$EndElements\n")
    p = CustomFuncProblem(tg2d_cfg(str(msh)), case="taylor-green",
                          device="cpu").setup()
    assert p.dim == 2 and not p._blocked
    w, t, n = p.run()
    vel_e, _ = p.exact_fields(t)
    ev = float(torch.linalg.norm(p.vel - vel_e.reshape(-1))
               / torch.linalg.norm(vel_e))
    assert abs(t - 0.05) < 1e-12
    assert ev < 0.02, ev


def test_cavity_on_gmsh_box_mesh(tmp_path):
    """Named-wall cavity runs on an unnamed gmsh box mesh end to end."""
    p = CavityProblem(cavity_cfg(quad_msh(tmp_path / "cavity.msh", 5)),
                      device="cpu").setup()
    vort, t, n = p.run()
    assert n >= 1 and bool(torch.isfinite(p.vel).all())
    assert float(p.vel.abs().max()) > 1e-3


# ----------------------------------------------------------------------
# the flat solver layout
# ----------------------------------------------------------------------
def test_flat_layout_and_schwarz_setup(tmp_path):
    """On a Gmsh mesh the state is flat: masks and their "_b" names are
    one tensor, each mask has its Schwarz preconditioner (two-level on a
    small mesh), the converters are identities, and transport_rhs
    answers in the caller's layout (flat, or (n_nodes, k))."""
    p = CavityProblem(cavity_cfg(quad_msh(tmp_path / "c.msh", 4, 0.03)),
                      device="cpu").setup()
    n = p.mesh.n_nodes
    assert p._gshape(2) == (2 * n,) and p._bshape(1) == (n,)
    assert p.free_mask_b is p.free_mask and p.free_mask.shape == (2 * n,)
    assert sorted(p._minv) == ["free_mask", "free_mask_fs"]
    assert all(pc.patches == "vertex" and pc.coarse_dofs > 0
               for pc in p._minv.values())
    assert set(p.setup_s) == {"mesh", "system", "bc", "preconditioner"}
    w = torch.as_tensor(np.random.default_rng(8).normal(size=n), dtype=F64)
    f, aux = p.transport_rhs(0.0, w, p.zero_vel())
    assert f.shape == (n,) and aux[1].shape == (2 * n,)
    f2, aux2 = p.transport_rhs(0.0, w.reshape(n, 1),
                               p.zero_vel().reshape(n, 2))
    assert f2.shape == (n, 1) and aux2[1].shape == (n, 2)
    assert torch.equal(f2.reshape(-1), f)
    # a Jacobi-CG configuration keeps the flat layout
    q = CavityProblem(cavity_cfg(p.gmsh_file, **{"unstructured-pc":
                                                 "jacobi"}),
                      device="cpu").setup()
    assert q._minv == {}
    vel = q.solve_kle(0.0, w)
    assert torch.linalg.norm(vel - p.solve_kle(0.0, w)) <= \
        1e-8 * torch.linalg.norm(vel)


def test_ws_extrapolation_on_gmsh(tmp_path):
    """kle-ws-extrapolate changes only warm starts: the same steps, the
    same t within 1e-6 (the adaptive dt follows wlte) and a vorticity
    within 1e-6 of the ws-off run (kle-rtol 1e-10), the bound of
    tests/test_torch_ws_cases.py's box-mesh twin."""
    path = quad_msh(tmp_path / "c.msh", 5, 0.03, seed=1)
    runs = []
    for ws in (False, True):
        p = CavityProblem(cavity_cfg(path, **{"kle-ws-extrapolate": ws}),
                          device="cpu").setup()
        runs.append(p.run(max_steps=3))
    (v0, t0, n0), (v1, t1, n1) = runs
    assert n0 == n1 == 3 and abs(t0 - t1) <= 1e-6 * t0
    rel = float(torch.linalg.norm(v1 - v0) / torch.linalg.norm(v0))
    assert rel < 1e-6, rel


def test_checkpoint_resume_on_gmsh(tmp_path):
    """A Taylor-Green run on a Gmsh mesh checkpointed at step 1 and
    resumed to step 2 equals the uninterrupted run bit for bit (a
    single-mask problem's aux is the checkpoint's velocity)."""
    path = tmp_path / "tg.msh"
    pts, quads = box_corner_mesh(4, 4, distort=0.03)
    _write_msh22_quads(str(path), pts, quads)
    cfg = tg2d_cfg(str(path))
    ck = str(tmp_path / "ck.npz")
    full = CustomFuncProblem(cfg, device="cpu").setup()
    v_full, t_full, _ = full.run(max_steps=2, checkpoint_path=ck,
                                 checkpoint_every=1)
    first = CustomFuncProblem(cfg, device="cpu").setup()
    first.run(max_steps=1, checkpoint_path=ck, checkpoint_every=1)
    resumed = CustomFuncProblem(cfg, device="cpu").setup()
    v_res, t_res, n = resumed.run(max_steps=2, resume_from=ck)
    assert n == 2 and t_res == t_full
    assert torch.equal(v_res, v_full)
