"""The immersed-boundary coupling of the port (ibm/diracs.py, ibm/bodies.py,
ibm/coupling.py IBMCoupling) on the CPU: the twins of tests/test_ibm.py's
box-mesh coupling tests, and each piece against the reference on the
same numpy inputs in float64 (dirac kernels to 1e-15, bodies bit for
bit, windows to 1e-14, interp and spread on the reference's own windows
to 1e-13, the flux solve's corrected velocity and q to 1e-10)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pynama_tpu.ibm import bodies as ref_bodies
from pynama_tpu.ibm import diracs as ref_diracs
from pynama_tpu.ibm.coupling import IBMCoupling as RefCoupling
from pynama_tpu.mesh.structured import BoxMesh as RefBoxMesh
from pynama_tpu_torch import convert
from pynama_tpu_torch.ibm.bodies import BodiesContainer, Circle
from pynama_tpu_torch.ibm.coupling import IBMCoupling
from pynama_tpu_torch.ibm.diracs import KERNELS, SUPPORT
from pynama_tpu_torch.mesh.structured import BoxMesh

F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_coupling(nelem=24, ngl=3, half=3.0):
    mesh = BoxMesh(nelem=(nelem, nelem), lower=(-half, -half),
                   upper=(half, half), ngl=ngl)
    h = 2 * half / nelem / (ngl - 1)
    return mesh, IBMCoupling(mesh, dl=h, kernel="fourGrid"), h


def make_pair(nelem=24, half=3.0, kernel="fourGrid"):
    """The port's and the reference's coupling of one box mesh."""
    box = dict(nelem=(nelem, nelem), lower=(-half, -half), upper=(half, half),
               ngl=3)
    h = 2 * half / nelem / 2
    return (IBMCoupling(BoxMesh(**box), dl=h, kernel=kernel),
            RefCoupling(RefBoxMesh(**box), dl=h, kernel=kernel), h)


def lagrange_points(h, center=(0.0, 0.0), radius=0.5):
    return Circle(center=np.asarray(center), radius=radius).generate(
        h).coords_at(0.0)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


# -- twins of tests/test_ibm.py ------------------------------------------
@pytest.mark.parametrize("name", ["fourGrid", "threeGrid", "linear"])
def test_kernel_1d_conditions(name):
    phi = KERNELS[name]
    # shifted samples on the integer grid: sum phi(x - i) == 1, moment == 0
    for shift in (0.0, 0.3, 0.5, 0.77):
        pts = torch.arange(-4, 5, dtype=F64) - shift
        w = phi(pts)
        np.testing.assert_allclose(float(w.sum()), 1.0, atol=1e-10)
        if name != "linear":  # linear hat satisfies moment only at nodes
            mom = float((w * pts).sum())
            np.testing.assert_allclose(mom, 0.0, atol=1e-10)


def test_window_rows_sum_to_one_and_moment_zero():
    mesh, cpl, h = make_coupling()
    X = _t(lagrange_points(h))
    nodes, weights = cpl.windows(X)
    np.testing.assert_allclose(weights.sum(dim=1).numpy(), 1.0, atol=1e-10)
    # first moment: sum_e w_le (x_e - X_l) == 0
    coords = _t(mesh.coords)[nodes]      # (L, K, 2)
    mom = (weights[:, :, None] * (coords - X[:, None, :])).sum(dim=1)
    np.testing.assert_allclose(mom.numpy(), 0.0, atol=1e-10)


def test_interp_exact_on_linear_field():
    mesh, cpl, h = make_coupling()
    X = lagrange_points(h)
    nodes, weights = cpl.windows(_t(X))
    coords = mesh.coords
    u = np.stack([2.0 + 3.0 * coords[:, 0], -1.0 + 0.5 * coords[:, 1]], axis=1)
    vals = cpl.interp(_t(u.reshape(-1)), nodes, weights)
    exact = np.stack([2.0 + 3.0 * X[:, 0], -1.0 + 0.5 * X[:, 1]], axis=1)
    np.testing.assert_allclose(vals.numpy(), exact, atol=1e-10)


def test_correction_enforces_body_velocity():
    """After the flux solve, interpolated fluid velocity == body velocity."""
    mesh, cpl, h = make_coupling()
    X = lagrange_points(h)
    nodes, weights = cpl.windows(_t(X))
    u = _t(np.tile([1.0, 0.0], mesh.n_nodes))  # free stream
    Ub = torch.zeros((len(X), 2), dtype=F64)   # static body
    u2, q = cpl.solve_correction(u, Ub, nodes, weights, rtol=1e-12,
                                 maxiter=2000)
    slip = cpl.interp(u2, nodes, weights).numpy()
    assert np.abs(slip).max() < 1e-8, np.abs(slip).max()


# -- against the reference -----------------------------------------------
@pytest.mark.parametrize("name", ["fourGrid", "threeGrid", "linear"])
def test_dirac_kernels_match_reference(name):
    """Both branches and the support edges (r = 0.5, 1, 1.5, 2 exactly)."""
    rng = np.random.default_rng(3)
    r = np.concatenate([rng.uniform(-2.5, 2.5, 2000),
                        [0.0, 0.5, -0.5, 1.0, -1.0, 1.5, -1.5, 2.0, -2.0]])
    got = KERNELS[name](_t(r)).numpy()
    ref = np.asarray(ref_diracs.KERNELS[name](jnp.asarray(r)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-15)
    assert SUPPORT[name] == ref_diracs.SUPPORT[name]


BODY_CONFIGS = {
    "circle": [{"type": "circle", "vel": "static", "radius": 0.45,
                "center": [0.1, -0.2]}],
    "line": [{"type": "line", "center": [-1.0, 0.3]}],
    "box": [{"type": "box", "center": [0.2, 0.1]}],
    "all, moving": [
        {"type": "circle", "vel": "dynamic", "radius": 0.5,
         "center": [0, 0]},
        {"type": "line", "vel": "dynamic", "center": [1.0, 1.0]},
        {"type": "box", "center": [-1.0, -1.0]}],
}


@pytest.mark.parametrize("name", list(BODY_CONFIGS))
def test_bodies_match_reference_bit_for_bit(name):
    cfg = BODY_CONFIGS[name]
    port = BodiesContainer(cfg).create(0.0625)
    ref = ref_bodies.BodiesContainer(cfg).create(0.0625)
    port.set_vel_ref(2.8)
    ref.set_vel_ref(2.8)
    assert port.n_nodes == ref.n_nodes and port.dl == ref.dl
    assert port.is_moving == ref.is_moving
    for b, rb in zip(port.bodies, ref.bodies):
        assert type(b).__name__ == type(rb).__name__
        assert b.char_length() == rb.char_length()
    for t in (0.0, 0.013, 0.37, 1.9):
        np.testing.assert_array_equal(port.coords_at(t), ref.coords_at(t))
        np.testing.assert_array_equal(port.velocity_at(t),
                                      ref.velocity_at(t))
    q = np.random.default_rng(4).normal(size=(port.n_nodes, 2))
    assert port.split_forces(q, -0.37) == ref.split_forces(q, -0.37)


@pytest.mark.parametrize("center", [(0.0, 0.0), (0.37, -0.21), (2.7, -2.75)],
                         ids=["centered", "off-grid", "clipped at a corner"])
def test_windows_match_reference(center):
    port, ref, h = make_pair()
    X = lagrange_points(h, center)
    nodes, weights = port.windows(_t(X))
    rn, rw = ref.windows(jnp.asarray(X))
    np.testing.assert_array_equal(nodes.numpy(), np.asarray(rn))
    np.testing.assert_allclose(weights.numpy(), np.asarray(rw), rtol=0,
                               atol=1e-14)
    assert nodes.dtype == torch.int64


def test_moving_windows_match_reference():
    """The oscillating body's windows at several t (the dynamic case
    recomputes them every step)."""
    port, ref, h = make_pair(nelem=20, half=4.0)
    cont = BodiesContainer([{"type": "circle", "vel": "dynamic",
                             "radius": 0.5, "center": [0, 0]}]).create(h)
    cont.set_vel_ref(2.8)
    for t in (0.0, 0.21, 0.55, 1.3):
        X = cont.coords_at(t)
        nodes, weights = port.windows(_t(X))
        rn, rw = ref.windows(jnp.asarray(X))
        np.testing.assert_array_equal(nodes.numpy(), np.asarray(rn))
        np.testing.assert_allclose(weights.numpy(), np.asarray(rw), rtol=0,
                                   atol=1e-14)


def field(coords):
    return np.stack([np.sin(coords[:, 0]) * np.cos(coords[:, 1]),
                     coords[:, 0] * coords[:, 1]], axis=1).reshape(-1)


def test_interp_and_spread_match_reference_on_its_windows():
    port, ref, h = make_pair()
    X = lagrange_points(h, (0.37, -0.21))
    rn, rw = ref.windows(jnp.asarray(X))
    nodes, weights = convert.ibm_windows(rn, rw, device="cpu")
    u = field(port.mesh.coords)
    np.testing.assert_allclose(
        port.interp(_t(u), nodes, weights).numpy(),
        np.asarray(ref.interp(jnp.asarray(u), rn, rw)), rtol=0, atol=1e-13)
    q = np.random.default_rng(5).normal(size=(len(X), 2))
    n = port.mesh.n_nodes
    np.testing.assert_allclose(
        port.spread(_t(q), nodes, weights, n).numpy(),
        np.asarray(ref.spread(jnp.asarray(q), rn, rw, n)), rtol=0,
        atol=1e-13)
    np.testing.assert_allclose(port.flux_diag(weights).numpy(),
                               np.asarray(ref.flux_diag(rw)), rtol=0,
                               atol=1e-13)


@pytest.mark.parametrize("moving", [False, True], ids=["static", "moving"])
def test_solve_correction_matches_reference(moving):
    port, ref, h = make_pair()
    X = lagrange_points(h, (0.37, -0.21))
    rn, rw = ref.windows(jnp.asarray(X))
    nodes, weights = convert.ibm_windows(rn, rw, device="cpu")
    u = field(port.mesh.coords) + np.tile([1.0, 0.0], port.mesh.n_nodes)
    Ub = np.zeros((len(X), 2))
    if moving:
        Ub[:, 1] = 0.4
    u2, q = port.solve_correction(_t(u), _t(Ub), nodes, weights)
    ru2, rq = ref.solve_correction(jnp.asarray(u), jnp.asarray(Ub), rn, rw)
    for got, want in ((u2, ru2), (q, rq)):
        want = np.asarray(want)
        err = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
        assert err <= 1e-10, err
    assert port.cg_iters and port.cg_iters[-1] > 0
