"""The port's Gmsh-domain IBM couplings (ibm/coupling.py
UnstructuredIBMCoupling and LatticeIBMCoupling) on the CPU: the twins of
tests/test_ibm.py's four coupling tests at their configs, then each
coupling against the reference's on the same mesh and Lagrange points in
float64: the static windows' ids equal and their weights within 1e-15,
the lattice table equal, the lattice windows equal at 5 seeded body
times (ids exactly, weights within 1e-15) on a graded mesh and on one
whose lattice has sites without a node, both packages raising the same
ValueErrors, and the flux solve on those windows within 1e-12 (both
solved to rtol 1e-14: at the default 1e-10 the two CG runs stop an
iteration apart, since the spread sums in another order, and differ by
~1e-10)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import graded_axis, tensor_quad_mesh
from pynama_tpu.ibm import bodies as ref_bodies
from pynama_tpu.ibm import coupling as ref_coupling
from pynama_tpu.mesh.unstructured import \
    UnstructuredQuadMesh as RefUnstructuredQuadMesh
from pynama_tpu_torch.ibm.bodies import Circle
from pynama_tpu_torch.ibm.coupling import (IBMCoupling, LatticeIBMCoupling,
                                           UnstructuredIBMCoupling)
from pynama_tpu_torch.mesh.structured import BoxMesh
from pynama_tpu_torch.mesh.unstructured import UnstructuredQuadMesh
from tests.test_unstructured import box_corner_mesh

F64 = torch.float64
NGL = 3
H = 2.0 / 16 / (NGL - 1)  # the 16x16 Q2 grid on [-1, 1]^2
CROSS_W = 1e-15           # weights, both packages, same inputs
CROSS_SOLVE = 1e-12       # the flux solve's velocity and q
SOLVE_RTOL = 1e-14


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def uniform_mesh(cls=UnstructuredQuadMesh, distort=0.0, seed=0):
    """tests/test_ibm.py's 16x16 quads on [-1, 1]^2 as an unstructured
    mesh (ngl 3)."""
    pts, quads = box_corner_mesh(16, 16, distort=distort, seed=seed)
    return cls(pts * 2.0 - 1.0, quads, ngl=NGL)


def field(coords):
    return np.stack([np.sin(coords[:, 0]) * np.cos(coords[:, 1]),
                     coords[:, 0] * coords[:, 1]], axis=1)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def _box():
    return BoxMesh(nelem=(16, 16), lower=(-1, -1), upper=(1, 1), ngl=NGL)


# -- twins of tests/test_ibm.py --------------------------------------------
def test_unstructured_coupling_matches_box():
    box, um = _box(), uniform_mesh()
    body = Circle(center=np.zeros(2), radius=0.45).generate(H)
    X = np.asarray(body.coords_at(0.0))
    cb = IBMCoupling(box, body.dl)
    cu = UnstructuredIBMCoupling(um, body.dl, h_min=H, device="cpu")
    nb, wb = cb.windows(_t(X))
    nu_, wu = cu.windows_host(X)
    np.testing.assert_allclose(wu.sum(dim=1).numpy(), 1.0, atol=1e-10)
    ub = _t(field(np.asarray(box.coords)).reshape(-1))
    uu = _t(field(np.asarray(um.coords)[:, :2]).reshape(-1))
    np.testing.assert_allclose(cu.interp(uu, nu_, wu).numpy(),
                               cb.interp(ub, nb, wb).numpy(), atol=1e-10)
    Ub = torch.zeros((body.n_nodes, 2), dtype=F64)
    _, qb = cb.solve_correction(ub, Ub, nb, wb, rtol=1e-12, maxiter=2000)
    _, qu = cu.solve_correction(uu, Ub, nu_, wu, rtol=1e-12, maxiter=2000)
    np.testing.assert_allclose(qu.numpy(), qb.numpy(), atol=1e-7)


def test_unstructured_coupling_rejects_nonuniform():
    um = uniform_mesh(distort=0.25, seed=1)
    body = Circle(center=np.zeros(2), radius=0.45).generate(H)
    cu = UnstructuredIBMCoupling(um, body.dl, h_min=H, device="cpu")
    with pytest.raises(ValueError, match="locally uniform"):
        cu.windows_host(np.asarray(body.coords_at(0.0)))


def box_to_unstructured(box, um):
    """box node id -> the unstructured mesh's id of the same point."""
    bc = np.asarray(box.coords)
    uc = np.asarray(um.coords)[:, :2]
    key_b = np.round((bc - bc.min(axis=0)) / H).astype(np.int64)
    key_u = np.round((uc - uc.min(axis=0)) / H).astype(np.int64)
    npx = key_b[:, 0].max() + 1
    order_b = np.argsort(key_b[:, 1] * npx + key_b[:, 0])
    order_u = np.argsort(key_u[:, 1] * npx + key_u[:, 0])
    u_of_b = np.empty(len(bc), dtype=np.int64)
    u_of_b[order_b] = order_u
    return u_of_b


def test_lattice_coupling_matches_box_moving():
    box, um = _box(), uniform_mesh()
    body = Circle(center=np.zeros(2), radius=0.3).generate(H)
    body.is_moving = True
    ts = np.linspace(0.0, 1.0, 33)
    env = np.concatenate([body.coords_at(float(t)) for t in ts])
    cb = IBMCoupling(box, body.dl)
    cl = LatticeIBMCoupling(um, body.dl, h_min=H,
                            envelope=(env.min(axis=0), env.max(axis=0)),
                            device="cpu")
    u_of_b = box_to_unstructured(box, um)
    ub = _t(field(np.asarray(box.coords)).reshape(-1))
    uu = _t(field(np.asarray(um.coords)[:, :2]).reshape(-1))
    for t in (0.0, 0.07, 0.31):
        X = _t(body.coords_at(t))
        nb, wb = cb.windows(X)
        nl, wl = cl.windows(X)
        np.testing.assert_allclose(wl.sum(dim=1).numpy(), 1.0, atol=1e-10)
        # the same physical nodes wherever the weight is nonzero
        live = wb.numpy() != 0.0
        np.testing.assert_array_equal(u_of_b[nb.numpy()][live],
                                      nl.numpy()[live])
        np.testing.assert_allclose(wl.numpy()[live], wb.numpy()[live],
                                   atol=1e-12)
        np.testing.assert_allclose(cl.interp(uu, nl, wl).numpy(),
                                   cb.interp(ub, nb, wb).numpy(), atol=1e-10)
    Ub = _t(body.velocity_at(0.31))
    X = _t(body.coords_at(0.31))
    nb, wb = cb.windows(X)
    nl, wl = cl.windows(X)
    _, qb = cb.solve_correction(ub, Ub, nb, wb, rtol=1e-12, maxiter=2000)
    _, ql = cl.solve_correction(uu, Ub, nl, wl, rtol=1e-12, maxiter=2000)
    np.testing.assert_allclose(ql.numpy(), qb.numpy(), atol=1e-7)


def test_lattice_coupling_rejects_uncovered_envelope():
    um = uniform_mesh()
    body = Circle(center=np.zeros(2), radius=0.3).generate(H)
    with pytest.raises(ValueError, match="lattice sites"):
        LatticeIBMCoupling(um, body.dl, h_min=H,
                           envelope=((-0.4, -0.4), (0.4, 1.2)), device="cpu")


# -- against the reference --------------------------------------------------
@pytest.fixture(scope="module")
def meshes():
    """The port's and the reference's 16x16 unstructured mesh, whose
    node numbering must agree for window ids to compare."""
    um, rm = uniform_mesh(), uniform_mesh(RefUnstructuredQuadMesh)
    np.testing.assert_array_equal(np.asarray(um.coords),
                                  np.asarray(rm.coords))
    return um, rm


def static_pair(meshes, radius=0.45):
    um, rm = meshes
    body = ref_bodies.Circle(center=np.zeros(2), radius=radius).generate(H)
    X = np.asarray(body.coords_at(0.0))
    return (UnstructuredIBMCoupling(um, body.dl, h_min=H, device="cpu"),
            ref_coupling.UnstructuredIBMCoupling(rm, body.dl, h_min=H), X)


def test_windows_host_matches_reference(meshes):
    """Ids element for element (ascending candidates, node-0 padding, the
    same drop threshold), weights within 1e-15; the cached windows are
    what windows(None) returns, int64 ids."""
    # an off-centre body: Lagrange points at every offset to the grid
    for center, radius in (((0.0, 0.0), 0.45), ((0.013, -0.021), 0.33)):
        um, rm = meshes
        body = ref_bodies.Circle(center=np.asarray(center),
                                 radius=radius).generate(H)
        X = np.asarray(body.coords_at(0.0))
        cu = UnstructuredIBMCoupling(um, body.dl, h_min=H, device="cpu")
        cr = ref_coupling.UnstructuredIBMCoupling(rm, body.dl, h_min=H)
        nu_, wu = cu.windows_host(X)
        nr, wr = cr.windows_host(X)
        assert nu_.dtype == torch.int64 and wu.dtype == F64
        assert nu_.shape == nr.shape
        np.testing.assert_array_equal(nu_.numpy(), np.asarray(nr))
        np.testing.assert_allclose(wu.numpy(), np.asarray(wr), rtol=0,
                                   atol=CROSS_W)
        n2, w2 = cu.windows(None)
        assert n2 is nu_ and w2 is wu


def test_windows_before_windows_host_raise(meshes):
    cu, cr, _ = static_pair(meshes)
    for c in (cu, cr):
        with pytest.raises(RuntimeError, match="windows_host"):
            c.windows(None)


def lattice_mesh_points(kind):
    """Corner points and quads of the lattice tests' meshes: "graded",
    uniform at H from the lower left to x = 0.375, y = 0.75 and graded
    (x1.1 at most) to 1.5 beyond; "holes", the 16x16 grid of [-1, 1]^2
    with the interior corners above x = 0.3 and y = 0.3 jittered by
    +-0.3 of an element (seeded), so that the lattice around the body
    holds sites without a node (-1), beyond the kernel's reach."""
    if kind == "graded":
        w = 2 * H
        return tensor_quad_mesh(graded_axis(-1.0, 1.5, -1.0, 0.375, w),
                                graded_axis(-1.0, 1.5, -1.0, 0.75, w))
    pts, quads = box_corner_mesh(16, 16)
    pts = pts * 2.0 - 1.0
    inner = (np.abs(pts) < 1.0).all(axis=1) & (pts > 0.3).all(axis=1)
    pts[inner] += np.random.default_rng(3).uniform(
        -0.3, 0.3, (int(inner.sum()), 2)) * 2 * H
    return pts, quads


@pytest.fixture(scope="module", params=["graded", "holes"])
def lattice_meshes(request):
    """Both packages' mesh of lattice_mesh_points(kind), and kind."""
    pts, quads = lattice_mesh_points(request.param)
    um = UnstructuredQuadMesh(pts, quads, ngl=NGL)
    rm = RefUnstructuredQuadMesh(pts, quads, ngl=NGL)
    np.testing.assert_array_equal(np.asarray(um.coords),
                                  np.asarray(rm.coords))
    return um, rm, request.param


def lattice_pair(meshes):
    """Both packages' lattice coupling of a circle (radius 0.24) moving
    over t in [0, 1], from the lower left of the uniform region."""
    um, rm, kind = meshes
    center = (0.02, 0.0) if kind == "graded" else (-0.1, -0.1)
    body = ref_bodies.Circle(center=np.asarray(center),
                             radius=0.24).generate(H)
    body.is_moving = True
    ts = np.linspace(0.0, 1.0, 33)
    env = np.concatenate([body.coords_at(float(t)) for t in ts])
    envelope = (env.min(axis=0), env.max(axis=0))
    return (LatticeIBMCoupling(um, body.dl, h_min=H, envelope=envelope,
                               device="cpu"),
            ref_coupling.LatticeIBMCoupling(rm, body.dl, h_min=H,
                                            envelope=envelope), body)


def test_lattice_table_matches_reference(lattice_meshes):
    cl, cr, _ = lattice_pair(lattice_meshes)
    assert cl._table.dtype == torch.int64
    np.testing.assert_array_equal(cl._table.numpy(), np.asarray(cr._table))
    np.testing.assert_array_equal(cl.lower, cr.lower)
    assert (cl.npx, cl.npy, cl.h) == (cr.npx, cr.npy, cr.h)
    if lattice_meshes[2] == "holes":
        assert int((cl._table < 0).sum()) > 0  # sites without a node


def test_lattice_windows_match_reference(lattice_meshes):
    """At 5 seeded body times: ids equal, weights within 1e-15; a window
    that reads a site without a node gets id 0 and weight 0 there."""
    cl, cr, body = lattice_pair(lattice_meshes)
    missing = 0
    for t in np.random.default_rng(15).uniform(0.0, 1.0, 5):
        X = body.coords_at(float(t))
        nl, wl = cl.windows(_t(X))
        nr, wr = cr.windows(jnp.asarray(X))
        assert nl.dtype == torch.int64 and int(nl.min()) >= 0
        np.testing.assert_array_equal(nl.numpy(), np.asarray(nr))
        np.testing.assert_allclose(wl.numpy(), np.asarray(wr), rtol=0,
                                   atol=CROSS_W)
        hole = cl._table[IBMCoupling.windows(cl, _t(X))[0]] < 0
        assert bool((nl[hole] == 0).all()) and bool((wl[hole] == 0).all())
        missing += int(hole.sum())
    if lattice_meshes[2] == "holes":
        assert missing > 0


def test_nonuniform_mesh_raises_in_both_packages():
    """A distorted mesh: both packages refuse it with the same message
    (a small body, so the reference's per-point loop stays short)."""
    um = uniform_mesh(distort=0.25, seed=1)
    rm = uniform_mesh(RefUnstructuredQuadMesh, distort=0.25, seed=1)
    body = ref_bodies.Circle(center=np.zeros(2), radius=0.1).generate(H)
    X = np.asarray(body.coords_at(0.0))
    msgs = []
    for c in (UnstructuredIBMCoupling(um, body.dl, h_min=H, device="cpu"),
              ref_coupling.UnstructuredIBMCoupling(rm, body.dl, h_min=H)):
        with pytest.raises(ValueError, match="locally uniform") as e:
            c.windows_host(X)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_uncovered_envelope_raises_in_both_packages(meshes):
    um, rm = meshes
    envelope = ((-0.4, -0.4), (0.4, 1.2))
    msgs = []
    for make in (lambda: LatticeIBMCoupling(um, 0.1, h_min=H,
                                            envelope=envelope, device="cpu"),
                 lambda: ref_coupling.LatticeIBMCoupling(
                     rm, 0.1, h_min=H, envelope=envelope)):
        with pytest.raises(ValueError, match="lattice sites") as e:
            make()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def check_solves(um, cp, cr, windows_p, windows_r, Ub):
    """Each package's flux solve on its own (equal) windows, from the
    same velocity and body velocity: corrected velocity and q within
    1e-12."""
    u = field(np.asarray(um.coords)[:, :2]).reshape(-1)
    vp, qp = cp.solve_correction(_t(u), _t(Ub), *windows_p,
                                 rtol=SOLVE_RTOL, maxiter=2000)
    vr, qr = cr.solve_correction(jnp.asarray(u), jnp.asarray(Ub),
                                 *windows_r, rtol=SOLVE_RTOL, maxiter=2000)
    for a, b in ((vp, vr), (qp, qr)):
        b = np.asarray(b)
        err = np.abs(a.numpy() - b).max() / np.abs(b).max()
        assert err <= CROSS_SOLVE, err
    assert len(cp.cg_iters) == 1 and 0 < cp.cg_iters[0] < 2000


def test_static_solve_correction_matches_reference(meshes):
    cp, cr, X = static_pair(meshes)
    check_solves(meshes[0], cp, cr, cp.windows_host(X), cr.windows_host(X),
                 np.zeros((len(X), 2)))


def test_lattice_solve_correction_matches_reference(lattice_meshes):
    cp, cr, body = lattice_pair(lattice_meshes)
    X = body.coords_at(0.31)
    check_solves(lattice_meshes[0], cp, cr, cp.windows(_t(X)),
                 cr.windows(jnp.asarray(X)), body.velocity_at(0.31))
