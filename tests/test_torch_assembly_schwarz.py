"""The port's element operators and Schwarz preconditioner
(pynama_tpu_torch/ops/assembly.py, kle.py's unstructured branch,
solvers/schwarz.py) on the CPU in float64: the twins of
tests/test_unstructured.py's solver tests, and each piece against the
reference on the same numpy-seeded inputs: the ElementOp apply and
diagonal from the reference's own fields (convert.element_op, 1e-13
relative), the KLE system and projection operators of a distorted mesh
(1e-13), and the Schwarz patch tables and blocks (bit for bit) and one
M^-1 apply with vertex and element patches, with and without the coarse
level (1e-12)."""

import json
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pynama_tpu.elements.spectral import SpectralElement as RefElement
from pynama_tpu.kle import build_kle_system as ref_build_kle_system
from pynama_tpu.kle import build_operators as ref_build_operators
from pynama_tpu.mesh.unstructured import (
    UnstructuredHexMesh as RefHexMesh,
    UnstructuredQuadMesh as RefQuadMesh,
)
from pynama_tpu.ops.assembly import make_element_op as ref_make_element_op
from pynama_tpu.solvers import schwarz as ref_schwarz
from pynama_tpu_torch import convert
from pynama_tpu_torch.cases.analytic_fields import (taylor_green_vel_3d,
                                                    taylor_green_vort_3d)
from pynama_tpu_torch.elements.spectral import SpectralElement
from pynama_tpu_torch.kle import build_kle_system, build_operators
from pynama_tpu_torch.mesh.unstructured import (UnstructuredHexMesh,
                                                UnstructuredQuadMesh)
from pynama_tpu_torch.ops.assembly import ElementOp, make_element_op
from pynama_tpu_torch.solvers import schwarz
from pynama_tpu_torch.solvers.schwarz import build_element_schwarz
from tests.blas_threads import blas_threads
from tests.test_kle_solve import taylor_green_2d
from tests.test_unstructured import box_corner_mesh, box_hex_mesh

F64 = torch.float64
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread and one BLAS thread (the Schwarz setup's
    inverses): the suite runs files side by side on a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with blas_threads(1):
        yield
    torch.set_num_threads(n)


def T(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def dirichlet_mask(m, dim):
    mask = np.ones(m.n_nodes * dim)
    mask[m.node_dofs(m.boundary_nodes, dim)] = 0.0
    return mask


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


# ----------------------------------------------------------------------
# twins of tests/test_unstructured.py
# ----------------------------------------------------------------------
def test_uniform_flow_on_distorted_mesh():
    """Patch test: constant velocity is exact on any (bilinear) quad mesh."""
    pts, quads = box_corner_mesh(5, 5, distort=0.04)
    m = UnstructuredQuadMesh(pts, quads, ngl=3)
    sys_ = build_kle_system(m, SpectralElement(3, 2), F64, CPU)
    assert not m.uniform and sys_.K.A.dim() == 3  # per-element matrices
    mask = dirichlet_mask(m, 2)
    u_bc = np.zeros(m.n_nodes * 2)
    u_bc[0::2] = 1.0
    res = sys_.solve(torch.zeros(m.n_nodes, dtype=F64), T(u_bc), T(mask),
                     rtol=1e-14, maxiter=20000)
    err = np.linalg.norm(res.x.numpy() - u_bc)
    assert err < 1e-11, err


def test_taylor_green_converges_on_distorted_mesh():
    errs = []
    for ngl in (3, 6):
        pts, quads = box_corner_mesh(3, 3, distort=0.02)
        m = UnstructuredQuadMesh(pts, quads, ngl=ngl)
        sys_ = build_kle_system(m, SpectralElement(ngl, 2), F64, CPU)
        mask = dirichlet_mask(m, 2)
        vel_e, vort_e = taylor_green_2d(m.coords, nu=0.02, t=0.0)
        res = sys_.solve(T(vort_e), T(vel_e.reshape(-1)), T(mask),
                         rtol=1e-13, maxiter=30000)
        errs.append(np.linalg.norm(res.x.numpy() - vel_e.reshape(-1)))
    assert errs[1] < 1e-2 * errs[0], errs


def test_hex_patch_test_distorted():
    """Constant velocity is exact on any (trilinear) hex mesh."""
    pts, hexes = box_hex_mesh(3, 3, 2, distort=0.04)
    m = UnstructuredHexMesh(pts, hexes, ngl=3)
    sys_ = build_kle_system(m, SpectralElement(3, 3), F64, CPU)
    assert not m.uniform and sys_.K.A.dim() == 3
    mask = dirichlet_mask(m, 3)
    u_bc = np.zeros(m.n_nodes * 3)
    u_bc[0::3] = 1.0
    u_bc[1::3] = -0.5
    res = sys_.solve(torch.zeros(m.n_nodes * 3, dtype=F64), T(u_bc),
                     T(mask), rtol=1e-13, maxiter=20000)
    err = np.abs(res.x.numpy() - u_bc).max()
    assert err < 1e-9, err


def test_tg3d_converges_on_distorted_hex():
    errs = []
    for ngl in (3, 5):
        pts, hexes = box_hex_mesh(2, 2, 2, distort=0.02)
        m = UnstructuredHexMesh(pts, hexes, ngl=ngl)
        sys_ = build_kle_system(m, SpectralElement(ngl, 3), F64, CPU)
        mask = dirichlet_mask(m, 3)
        c = T(m.coords)
        vel_e = taylor_green_vel_3d(c, 0.02, 0.0).reshape(-1)
        vort_e = taylor_green_vort_3d(c, 0.02, 0.0).reshape(-1)
        res = sys_.solve(vort_e, vel_e, T(mask), rtol=1e-12, maxiter=30000)
        errs.append(float(torch.linalg.norm(res.x - vel_e)
                          / torch.linalg.norm(vel_e)))
    # the reference measured 1.1e-1 (ngl 3) -> 2.7e-3 (ngl 5)
    assert errs[1] < 0.05 * errs[0], errs


def test_schwarz_preconditioner_unstructured(tmp_path):
    """Two-level vertex-star Schwarz: >= 3x fewer CG iterations than
    Jacobi at 16x16 and 32x32, and slower growth under refinement. The
    record goes under tmp_path (the reference test's goes to
    run-artifacts/unstructured_pc.json)."""
    record = {}
    iters = {}
    for n in (16, 32):
        pts, quads = box_corner_mesh(n, n, distort=0.15 / n, seed=1)
        m = UnstructuredQuadMesh(pts, quads, ngl=3)
        sys_ = build_kle_system(m, SpectralElement(3, 2), F64, CPU)
        mask = dirichlet_mask(m, 2)
        vel_e, vort_e = taylor_green_2d(m.coords, nu=0.02, t=0.0)
        t0 = time.perf_counter()
        minv = build_element_schwarz(m, sys_.K.A.numpy(), mask, F64,
                                     device=CPU)
        setup_s = time.perf_counter() - t0
        for tag, pc in (("jacobi", None), ("schwarz", minv)):
            res = sys_.solve(T(vort_e), T(vel_e.reshape(-1)), T(mask),
                             rtol=1e-10, maxiter=20000, m_inv=pc,
                             restarts=1)
            err = float(np.linalg.norm(res.x.numpy() - vel_e.reshape(-1)))
            iters[(tag, n)] = int(res.iters)
            record[f"{tag}_n{n}"] = {"iters": int(res.iters), "err": err}
        record[f"schwarz_n{n}"]["setup_s"] = round(setup_s, 2)
        assert abs(record[f"jacobi_n{n}"]["err"]
                   - record[f"schwarz_n{n}"]["err"]) < 1e-6
    for n in (16, 32):
        assert iters[("schwarz", n)] * 3 <= iters[("jacobi", n)], iters
    growth_j = iters[("jacobi", 32)] / iters[("jacobi", 16)]
    growth_s = iters[("schwarz", 32)] / iters[("schwarz", 16)]
    assert growth_s < growth_j, (growth_s, growth_j)
    path = tmp_path / "unstructured_pc.json"
    json.dump({"taylor_green_ngl3_rtol1e-10": record}, open(path, "w"),
              indent=1, sort_keys=True)
    assert json.load(open(path))["taylor_green_ngl3_rtol1e-10"] == record


# ----------------------------------------------------------------------
# against the reference
# ----------------------------------------------------------------------
def quad_meshes(nx=4, ny=3, ngl=3, distort=0.05, seed=4):
    pts, quads = box_corner_mesh(nx, ny, distort=distort, seed=seed)
    return (UnstructuredQuadMesh(pts, quads, ngl),
            RefQuadMesh(pts, quads, ngl))


def hex_meshes(n=2, ngl=3, distort=0.04, seed=4):
    pts, hexes = box_hex_mesh(n, n, n, distort=distort, seed=seed)
    return (UnstructuredHexMesh(pts, hexes, ngl),
            RefHexMesh(pts, hexes, ngl))


@pytest.mark.parametrize("shared", [False, True], ids=["batched", "shared"])
def test_element_op_matches_reference(shared):
    """Apply and diagonal of an ElementOp built from the reference's own
    fields; an output table with collisions (every interior node is
    shared) and a rectangular Curl-shaped op."""
    m, r = quad_meshes()
    K_el, Rw_el, _ = RefElement(3, 2).kle_matrices(r.cell_corners)
    rng = np.random.default_rng(5)
    for A, kin, kout in ((K_el, 2, 2), (Rw_el, 1, 2)):
        A = np.asarray(A)[0] if shared else np.asarray(A)
        ref = ref_make_element_op(A, r.cell_dofs(kin), r.cell_dofs(kout),
                                  r.n_nodes * kout)
        op = convert.element_op(ref.A, ref.in_dofs, ref.out_dofs,
                                ref.out_size, device=CPU)
        assert isinstance(op, ElementOp) and op.shared == shared
        x = rng.normal(size=r.n_nodes * kin)
        assert rel(op(T(x)).numpy(), ref(jnp.asarray(x))) <= 1e-13
        if kin == kout:
            assert rel(op.diagonal().numpy(), ref.diagonal()) <= 1e-13


@pytest.mark.parametrize("dim", [2, 3])
def test_kle_system_and_operators_match_reference(dim):
    m, r = quad_meshes() if dim == 2 else hex_meshes()
    ngl = m.ngl
    sys_ = build_kle_system(m, SpectralElement(ngl, dim), F64, CPU)
    ops = build_operators(m, SpectralElement(ngl, dim), F64, CPU)
    rsys = ref_build_kle_system(r, RefElement(ngl, dim))
    rops = ref_build_operators(r, RefElement(ngl, dim))
    assert ops.wb_curl is None and sys_.diag_K_b is None
    rng = np.random.default_rng(6)
    n = m.n_nodes
    for mine, theirs, k in ((sys_.K, rsys.K, dim), (sys_.Rw, rsys.Rw, m.dim_w),
                            (ops.Curl, rops.Curl, dim),
                            (ops.SrT, rops.SrT, dim),
                            (ops.DivSrT, rops.DivSrT, m.dim_s)):
        x = rng.normal(size=n * k)
        assert rel(mine(T(x)).numpy(), theirs(jnp.asarray(x))) <= 1e-13
    assert rel(sys_.diag_K.numpy(), rsys.diag_K) <= 1e-13
    for a, b in ((ops.w_curl, rops.w_curl), (ops.w_srt, rops.w_srt),
                 (ops.w_div, rops.w_div)):
        assert rel(a.numpy(), b) <= 1e-14


def _ref_schwarz_parts(m_inv):
    """The reference closure's ElementOp (blocks) and coarse callable."""
    cells = {type(c.cell_contents).__name__: c.cell_contents
             for c in m_inv.__closure__}
    return cells["ElementOp"], cells.get("function")


@pytest.mark.parametrize("coarse", [True, False], ids=["two-level",
                                                        "one-level"])
@pytest.mark.parametrize("patches", ["vertex", "element"])
@pytest.mark.parametrize("dim", [2, 3])
def test_schwarz_matches_reference(dim, patches, coarse, monkeypatch):
    if not coarse:
        monkeypatch.setattr(schwarz, "_MAX_COARSE_DOFS", 0)
        monkeypatch.setattr(ref_schwarz, "_MAX_COARSE_DOFS", 0)
    m, r = quad_meshes(5, 4) if dim == 2 else hex_meshes()
    K_el, _, _ = RefElement(m.ngl, dim).kle_matrices(r.cell_corners)
    K_el = np.asarray(K_el)
    mask = dirichlet_mask(m, dim)
    mask[1:len(mask):7] = 0.0  # an irregular mask as well
    pc = build_element_schwarz(m, K_el, mask, F64, patches=patches,
                               device=CPU)
    ref = ref_schwarz.build_element_schwarz(r, K_el, mask,
                                            patches=patches)
    rop, rcoarse = _ref_schwarz_parts(ref)
    assert pc.patches == patches and (pc.coarse is not None) == coarse
    assert (rcoarse is not None) == coarse
    # the vectorised patch tables and block lookups replace the
    # reference's per-patch loop with the same arithmetic: equal bits
    np.testing.assert_array_equal(pc.op.in_dofs.numpy(), rop.in_dofs)
    np.testing.assert_array_equal(pc.op.A.numpy(), rop.A)
    x = np.random.default_rng(7).normal(size=m.n_nodes * dim)
    assert rel(pc(T(x)).numpy(), ref(jnp.asarray(x))) <= 1e-12
    # the reference's blocks through convert.element_op: the same apply
    ext = np.concatenate([x, [0.0]])
    op = convert.element_op(rop.A, rop.in_dofs, rop.out_dofs, rop.out_size,
                            device=CPU)
    assert rel(op(T(ext)).numpy()[:-1], rop(jnp.asarray(ext))[:-1]) <= 1e-13


def test_schwarz_guards_match_reference(monkeypatch):
    """Vertex stars over the block guard retry as element blocks, and
    element blocks over it give None (Jacobi), in both packages."""
    m, r = hex_meshes()
    K_el = np.asarray(RefElement(3, 3).kle_matrices(r.cell_corners)[0])
    mask = dirichlet_mask(m, 3)
    P, L = m.n_cells, 81
    for mod in (schwarz, ref_schwarz):
        monkeypatch.setattr(mod, "_MAX_BLOCK_ENTRIES", P * L * L)
    pc = build_element_schwarz(m, K_el, mask, F64, device=CPU)
    rop, _ = _ref_schwarz_parts(ref_schwarz.build_element_schwarz(r, K_el,
                                                                  mask))
    assert pc.patches == "element" and pc.block_dofs == L
    np.testing.assert_array_equal(pc.op.in_dofs.numpy(), rop.in_dofs)
    for mod in (schwarz, ref_schwarz):
        monkeypatch.setattr(mod, "_MAX_BLOCK_ENTRIES", P * L * L - 1)
    assert build_element_schwarz(m, K_el, mask, F64, device=CPU) is None
    assert ref_schwarz.build_element_schwarz(r, K_el, mask) is None


def test_make_element_op_devices_and_tables():
    """Index tables are int64 on the op's device; an out-of-range output
    dof is dropped, as the reference's mode="drop"."""
    A = np.arange(4.0).reshape(2, 2)
    op = make_element_op(A, [[0, 1], [1, 2]], [[0, 1], [1, 3]], 3,
                         device=CPU)
    assert op.in_dofs.dtype == torch.int64 and op.table.dtype == torch.int64
    y = op(torch.tensor([1.0, 2.0, 3.0], dtype=F64))
    # cell 0: A @ [1, 2] = [2, 8]; cell 1: A @ [2, 3] = [3, 13], dof 3 dropped
    np.testing.assert_array_equal(y.numpy(), [2.0, 11.0, 0.0])
