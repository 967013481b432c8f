"""The port's numpy modules (quadrature, Lagrange basis, spectral element,
box mesh, wall BCs) equal the reference's bit for bit."""

import numpy as np
import pytest

from pynama_tpu import bc as ref_bc
from pynama_tpu.elements import lagrange as ref_lag
from pynama_tpu.elements import quadrature as ref_quad
from pynama_tpu.elements.spectral import SpectralElement as RefElement
from pynama_tpu.mesh.structured import BoxMesh as RefBoxMesh
from pynama_tpu_torch import bc
from pynama_tpu_torch.elements import lagrange, quadrature
from pynama_tpu_torch.elements.spectral import SpectralElement
from pynama_tpu_torch.mesh.structured import BoxMesh


def assert_same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert np.array_equal(a, b)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8])
def test_quadrature_rules_identical(n):
    assert_same(quadrature.gauss_points(n)[0], ref_quad.gauss_points(n)[0])
    assert_same(quadrature.gauss_points(n)[1], ref_quad.gauss_points(n)[1])
    if n >= 2:
        for a, b in zip(quadrature.lobatto_points(n),
                        ref_quad.lobatto_points(n)):
            assert_same(a, b)


def test_lagrange_basis_identical():
    rng = np.random.default_rng(0)
    nodes = np.sort(rng.uniform(-1, 1, 6))
    pts = rng.uniform(-1, 1, 9)
    for a, b in zip(lagrange.lagrange_basis(nodes, pts),
                    ref_lag.lagrange_basis(nodes, pts)):
        assert_same(a, b)


@pytest.mark.parametrize("ngl,dim", [(2, 2), (3, 2), (5, 2), (3, 3)])
def test_kle_matrices_and_operators_identical(ngl, dim):
    rng = np.random.default_rng(ngl * 10 + dim)
    # a distorted element batch: exercises the Jacobian path
    corners = np.array(list(np.ndindex(*(2,) * dim)), float)[:, ::-1]
    corners = corners[None] + 0.1 * rng.normal(size=(3,) + corners.shape)
    e, r = SpectralElement(ngl, dim), RefElement(ngl, dim)
    for a, b in zip(e.kle_matrices(corners), r.kle_matrices(corners)):
        assert_same(a, b)
    for a, b in zip(e.kle_operators(corners), r.kle_operators(corners)):
        assert_same(a, b)
    assert_same(e.nodal_points, r.nodal_points)


@pytest.mark.parametrize("nelem,ngl", [((4, 3), 3), ((2, 3, 2), 4)])
def test_box_mesh_identical(nelem, ngl):
    dim = len(nelem)
    lower, upper = (0.0,) * dim, tuple(1.0 + 0.5 * a for a in range(dim))
    m, r = BoxMesh(nelem, lower, upper, ngl), RefBoxMesh(nelem, lower,
                                                         upper, ngl)
    assert m.npts == r.npts and m.n_nodes == r.n_nodes
    for name in ("cell2node", "coords", "cell_corners", "boundary_nodes"):
        assert_same(getattr(m, name), getattr(r, name))
    assert m.face_nodes.keys() == r.face_nodes.keys()
    for k in m.face_nodes:
        assert_same(m.face_nodes[k], r.face_nodes[k])
    assert_same(m.cell_dofs(dim), r.cell_dofs(dim))


def test_no_slip_walls_identical():
    w, r = bc.NoSlipWalls(2, exclude=["left"]), ref_bc.NoSlipWalls(
        2, exclude=["left"])
    w.set_wall_velocity("up", [1.0, 0.0])
    r.set_wall_velocity("up", [1.0, 0.0])
    assert w.names() == r.names()
    for name in w.names():
        a, b = w[name], r[name]
        assert (a.normal_axis, a.tangential_dofs, a.moving_dofs,
                a.static_dofs) == (b.normal_axis, b.tangential_dofs,
                                   b.moving_dofs, b.static_dofs)
