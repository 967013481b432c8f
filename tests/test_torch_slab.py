"""The port's slab and pencil decompositions (parallel/slab.py) against
the reference's numpy, bit for bit; the twins of tests/test_sharded.py's
test_slab_round_trip and test_owner_field_partition; convert's
stacked_to_rank; every halo sum, the owned-weight dot and norm and
local_element_apply on 4 gloo ranks; and cg_solve's default dot."""

import math

import numpy as np
import pytest
import torch

from pynama_tpu.mesh.structured import BoxMesh as RefBoxMesh
from pynama_tpu.parallel import slab as ref_slab
from pynama_tpu_torch.convert import stacked_to_rank
from pynama_tpu_torch.mesh.structured import BoxMesh
from pynama_tpu_torch.parallel import launch, slab
from pynama_tpu_torch.solvers.cg import cg_solve, sumdot
from tests import torch_dist_cases

# slab (an int) and pencil (a tuple) partitions, 2D and 3D, ngl 3 and 4
LAYOUTS = [((3, 8), 3, 4), ((2, 3, 4), 3, 2), ((4, 8), 3, (2, 2)),
           ((2, 4, 6), 4, (3, 2)), ((2, 2, 2), 3, (2, 2, 2))]


def meshes(nelem, ngl):
    dim = len(nelem)
    box = dict(nelem=nelem, lower=(0,) * dim, upper=(1,) * dim, ngl=ngl)
    return BoxMesh(**box), RefBoxMesh(**box)


@pytest.mark.parametrize("nelem,ngl,parts", LAYOUTS,
                         ids=["slab2d", "slab3d", "pencil2d", "pencil3d",
                              "pencil3d-3axes"])
def test_decompositions_match_reference(nelem, ngl, parts):
    m, rm = meshes(nelem, ngl)
    pgrid = (parts,) if isinstance(parts, int) else parts
    x = np.random.default_rng(0).normal(size=m.n_nodes * 3)
    dec = slab.GridDecomposition(m, pgrid)
    ref = ref_slab.GridDecomposition(rm, pgrid)
    for name in ("ne_loc", "rows_loc", "local_npts", "local_nelem"):
        assert getattr(dec, name) == getattr(ref, name), name
    for a, b in zip(dec.row0, ref.row0):
        np.testing.assert_array_equal(a, b)
    pairs = [(dec.owner_field(), ref.owner_field())]
    for k in (1, 3):
        loc = dec.to_local_grid(x[:m.n_nodes * k], k)
        pairs += [(loc, ref.to_local_grid(x[:m.n_nodes * k], k)),
                  (dec.from_local_grid(loc), ref.from_local_grid(loc)),
                  (dec.owned_grid_weights(k), ref.owned_grid_weights(k))]
        assert dec.local_grid_shape(k) == ref.local_grid_shape(k)
    if len(pgrid) == 1:
        sd, rs = slab.SlabDecomposition(m, parts), \
            ref_slab.SlabDecomposition(rm, parts)
        assert (sd.ne_loc, sd.plane, sd.rows_loc, sd.n_loc, sd.cells_loc,
                sd.local_npts) == (rs.ne_loc, rs.plane, rs.rows_loc,
                                   rs.n_loc, rs.cells_loc, rs.local_npts)
        for k in (1, 2):
            loc = sd.to_local(x[:m.n_nodes * k], k)
            grid = sd.to_local_grid(x[:m.n_nodes * k], k)
            pairs += [(sd.node_slices(k)[0], rs.node_slices(k)[0]),
                      (loc, rs.to_local(x[:m.n_nodes * k], k)),
                      (sd.from_local(loc, k), rs.from_local(loc, k)),
                      (sd.local_cell_dofs(k), rs.local_cell_dofs(k)),
                      (sd.owned_weights(k), rs.owned_weights(k)),
                      (grid, rs.to_local_grid(x[:m.n_nodes * k], k)),
                      (sd.from_local_grid(grid), rs.from_local_grid(grid)),
                      (sd.owned_grid_weights(k), rs.owned_grid_weights(k))]
        pairs.append((sd.owner_field(), rs.owner_field()))
    for a, b in pairs:
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))


def test_slab_round_trip():
    m = BoxMesh(nelem=(3, 8), lower=(0, 0), upper=(1, 1), ngl=3)
    sl = slab.SlabDecomposition(m, 4)
    x = np.random.default_rng(0).normal(size=m.n_nodes * 2)
    loc = sl.to_local(x, 2)
    assert loc.shape == (4, sl.n_loc * 2)
    np.testing.assert_allclose(sl.from_local(loc, 2), x)
    # overlap consistency: device d's last plane == device d+1's first plane
    pk = sl.plane * 2
    for d in range(3):
        np.testing.assert_allclose(loc[d][-pk:], loc[d + 1][:pk])


def test_owner_field_partition():
    """createNumProcVec analogue: per-node owning device indices."""
    m = BoxMesh(nelem=(4, 8), lower=(0, 0), upper=(1, 1), ngl=3)
    sd = slab.SlabDecomposition(m, 4)
    f = sd.owner_field()
    assert f.shape == (m.n_nodes,)
    # 8 elements / 4 devs -> 2 element planes (4 node rows) each + shared
    g = f.reshape(m.npts[1], m.npts[0])
    assert set(np.unique(f)) == {0.0, 1.0, 2.0, 3.0}
    assert np.all(g[0:5] == 0)        # rows 0-4: device 0 (row 4 shared)
    assert np.all(g[5:9] == 1)
    assert np.all(g[13:] == 3)
    # pencil: 2x2 devices over a square mesh
    gd = slab.GridDecomposition(m, (2, 2))
    fo = gd.owner_field().reshape(m.npts[1], m.npts[0])
    assert fo[0, 0] == 0 and fo[-1, -1] == 3
    assert fo[-1, 0] == 2 and fo[0, -1] == 1
    assert set(np.unique(fo)) == {0.0, 1.0, 2.0, 3.0}


@pytest.mark.parametrize("pgrid", [(6,), (2, 2), (3, 2)])
def test_stacked_to_rank(pgrid):
    """The reference's stacked local grids (and a pytree of them) give
    each rank its block at np.unravel_index(rank, pgrid)."""
    m, rm = meshes((4, 6), 3)
    x = np.random.default_rng(2).normal(size=m.n_nodes * 2)
    stacked = ref_slab.GridDecomposition(rm, pgrid).to_local_grid(x, 2)
    dec = slab.GridDecomposition(m, pgrid)
    tree = {"a": stacked, "b": [stacked, (stacked * 2,)]}
    for rank in range(math.prod(pgrid)):
        here = np.unravel_index(rank, pgrid)
        mine = dec.to_local_grid(x, 2)[here]
        got = stacked_to_rank(tree, pgrid, rank, device="cpu")
        assert got["a"].dtype == torch.float64
        np.testing.assert_array_equal(got["a"].numpy(), mine)
        np.testing.assert_array_equal(got["b"][0].numpy(), mine)
        np.testing.assert_array_equal(got["b"][1][0].numpy(), 2 * mine)


@pytest.fixture(scope="module")
def halo_results():
    return launch.spawn(torch_dist_cases.halo_checks, 4)


@pytest.mark.parametrize("layout", ["slab2d", "pencil2d", "slab3d",
                                    "pencil3d"])
def test_halo_sums_complete_interface_planes(halo_results, layout):
    """On 4 gloo ranks: each halo sum restores the global field's block
    on every rank bit for bit (the shares are exact powers of two); the
    owned-weight dot and RMS norm equal the global ones to rounding; the
    slab's local ElementOp + halo_sum equals the global apply."""
    for res in halo_results:
        checks = {k.split(" ")[1]: v for k, v in res.items()
                  if k.startswith(layout + " ")}
        for name in ("halo_sum_grid_axis", "halo_sum_blocked_axis"):
            assert checks[name] is True, name
        assert checks["make_pdot"] < 1e-13
        assert checks["make_pnorm_mean"] < 1e-13
        if layout.startswith("slab"):
            for name in ("halo_sum_grid", "halo_sum_blocked", "halo_sum"):
                assert checks[name] is True, name
            assert checks["local_element_apply"] < 1e-13
            # one exchange per halo sum (six), one all-reduce each for
            # the dot and the norm
            assert checks["counts"] == {"halo": 6, "all_reduce": 2}


def _cg_parent(apply_A, b, x0=None, m_inv=None, rtol=1e-12, atol=0.0,
               maxiter=10000):
    """cg_solve as it was before its ``dot`` argument (a verbatim copy of
    the loop)."""
    x = torch.zeros_like(b) if x0 is None else x0
    if m_inv is None:
        apply_M = lambda r: r  # noqa: E731
    elif callable(m_inv):
        apply_M = m_inv
    else:
        apply_M = lambda r: m_inv * r  # noqa: E731
    tol = max(rtol * math.sqrt(float(sumdot(b, b))), atol)
    tol2 = tol * tol
    r = b - apply_A(x)
    rr = sumdot(r, r)
    rr_host = float(rr)
    z = apply_M(r) if rr_host > tol2 else torch.zeros_like(r)
    rz = sumdot(r, z)
    p = z
    k = 0
    while rr_host > tol2 and k < maxiter:
        Ap = apply_A(p)
        pAp = sumdot(p, Ap)
        alpha = rz / torch.where(pAp == 0, 1.0, pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        z = apply_M(r)
        rz_new = sumdot(r, z)
        beta = rz_new / torch.where(rz == 0, 1.0, rz)
        p = z + beta * p
        rz = rz_new
        rr = sumdot(r, r)
        k += 1
        rr_host = float(rr)
    return x, k, torch.sqrt(rr)


@pytest.mark.parametrize("precond", ["none", "jacobi", "callable"])
def test_cg_default_dot_is_bitwise(precond):
    """cg_solve with its default dot is bitwise the loop before the
    argument existed, on a seeded SPD system in float64 and float32."""
    rng = np.random.default_rng(5)
    for dtype in (torch.float64, torch.float32):
        Q = rng.normal(size=(40, 40))
        A = torch.tensor(Q @ Q.T + 40 * np.eye(40), dtype=dtype)
        b = torch.tensor(rng.normal(size=(8, 5)), dtype=dtype)
        d = torch.diagonal(A).reshape(8, 5)
        m_inv = {"none": None, "jacobi": 1.0 / d,
                 "callable": lambda r: r / d}[precond]

        def apply_A(v):
            return (A @ v.reshape(-1)).reshape(v.shape)

        res = cg_solve(apply_A, b, m_inv=m_inv, rtol=1e-6)
        x, k, rn = _cg_parent(apply_A, b, m_inv=m_inv, rtol=1e-6)
        assert res.iters == k > 0
        assert torch.equal(res.x, x) and torch.equal(res.resnorm, rn)
