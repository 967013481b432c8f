"""KLE operators, the multigrid V-cycle and a KLE solve of the port
against the reference, in float64 on small meshes."""

from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pynama_tpu.elements.spectral import SpectralElement as RefElement
from pynama_tpu.kle import build_kle_system as ref_build_kle_system
from pynama_tpu.kle import build_operators as ref_build_operators
from pynama_tpu.kle import ns_rhs as ref_ns_rhs
from pynama_tpu.mesh.structured import BoxMesh as RefBoxMesh
from pynama_tpu.solvers.multigrid import MGPreconditioner as RefMG
from pynama_tpu_torch import convert
from pynama_tpu_torch.elements.spectral import SpectralElement
from pynama_tpu_torch.kle import build_kle_system, build_operators, ns_rhs
from pynama_tpu_torch.mesh.structured import BoxMesh
from pynama_tpu_torch.solvers.cg import cg_solve
from pynama_tpu_torch.solvers.multigrid import (MGPreconditioner,
                                                coarsening_ratios)

F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t64(a):
    return torch.as_tensor(np.array(a), dtype=F64)


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def meshes(nelem, ngl=3):
    args = dict(nelem=nelem, lower=(0, 0), upper=(1, 1), ngl=ngl)
    return (BoxMesh(**args), SpectralElement(ngl, 2), RefBoxMesh(**args),
            RefElement(ngl, 2))


@pytest.mark.parametrize("nelem", [(8, 8), (6, 4)])
def test_kle_system_and_operators_match(nelem):
    """K/Rw applies, diagonals, projection operators and the transport
    RHS, blocked layout (super-blocked where pick_super_factor says so)."""
    mesh, elem, rmesh, relem = meshes(nelem)
    sys_ = build_kle_system(mesh, elem, device="cpu")
    ref = ref_build_kle_system(rmesh, relem)
    ops = build_operators(mesh, elem, device="cpu")
    rops = ref_build_operators(rmesh, relem)
    assert sys_.K.sb == ref.K.sb and sys_.K.blocked_shape_in == \
        ref.K.blocked_shape_in
    assert rel(sys_.diag_K.numpy(), ref.diag_K) < 1e-14
    assert rel(sys_.diag_K_b.numpy(), ref.diag_K_b) < 1e-14
    for name in ("wb_curl", "wb_srt", "wb_div", "w_curl"):
        assert np.array_equal(getattr(ops, name).numpy(),
                              np.asarray(getattr(rops, name)))
    rng = np.random.default_rng(3)
    npg = tuple(reversed(mesh.npts))
    vel = ref.K.to_blocked(jnp.asarray(rng.normal(size=npg + (2,))))
    vort = ref.K.to_blocked(jnp.asarray(rng.normal(size=npg + (1,))))
    for op, rop, x in ((sys_.K, ref.K, vel), (sys_.Rw, ref.Rw, vort),
                       (ops.Curl, rops.Curl, vel)):
        assert rel(op(t64(x)).numpy(), rop(x)) < 1e-12
    f = ns_rhs(ops, t64(vel), 0.01, 1.0, 2).numpy()
    assert rel(f, ref_ns_rhs(rops, vel, 0.01, 1.0, 2)) < 1e-12


def test_converted_operator_matches_reference():
    """convert.structured_op carries a reference operator across."""
    _, _, rmesh, relem = meshes((8, 4))
    ref = ref_build_operators(rmesh, relem).SrT
    op = convert.structured_op(np.asarray(ref.A), ref.ngl, ref.nelem,
                               ref.npts, ref.k_in, ref.k_out, ref.sb,
                               device="cpu")
    assert op.blocked_shape_in == ref.blocked_shape_in
    rng = np.random.default_rng(9)
    xb = ref.to_blocked(jnp.asarray(
        rng.normal(size=tuple(reversed(ref.npts)) + (ref.k_in,))))
    assert rel(op(t64(xb)).numpy(), ref(xb)) < 1e-12


def test_builders_default_to_the_card():
    mesh, elem, _, _ = meshes((4, 4))
    if torch.cuda.is_available():
        assert build_kle_system(mesh, elem).K.A.is_cuda
        return
    for build in (build_kle_system, build_operators, MGPreconditioner):
        with pytest.raises(RuntimeError, match="CUDA"):
            build(mesh, elem)


def test_coarsening_ratios():
    """The reference's hierarchy rule: 2/3/5 first, a padded jump (to
    the next even count, halved) where none divides, the 5-level cap
    merging pad-free jumps from the coarse end."""
    def jumps(*nelem):
        dim = len(nelem)
        return coarsening_ratios(BoxMesh(nelem, (0,) * dim, (1,) * dim, 3))

    def ratios(n):
        return [r for r, _ in jumps(n, n)]

    assert ratios(384) == [2, 2, 2, 4]
    assert ratios(16) == [2] and ratios(8) == [2]
    assert ratios(45) == [3, 3] and ratios(50) == [2, 5]
    # padded jumps: ne_ext is the extended fine count of each jump
    assert jumps(7, 7) == [(2, (8, 8))]
    assert jumps(23, 23) == [(2, (24, 24))]
    assert jumps(383, 383) == [(2, (384, 384)), (2, (192, 192)),
                               (2, (96, 96)), (4, (48, 48))]
    assert jumps(384, 384) == jumps(383, 383)
    assert jumps(31, 31, 79) == [(2, (32, 32, 80)), (2, (16, 16, 40)),
                                 (2, (8, 8, 20)), (2, (4, 4, 10))]
    # the levels they give: only the first jump is padded
    def levels(*nelem):
        out = [tuple(nelem)]
        for r, ne_ext in jumps(*nelem):
            out.append(tuple(n // r for n in ne_ext))
        return out

    assert levels(383, 383) == [(383, 383), (192, 192), (96, 96),
                                (48, 48), (12, 12)]
    assert levels(31, 31, 79) == [(31, 31, 79), (16, 16, 40), (8, 8, 20),
                                  (4, 4, 10), (2, 2, 5)]
    assert BoxMesh((383, 383), (0, 0), (1, 1), 3).n_nodes * 2 == 1176578
    assert BoxMesh((31, 31, 79), (0, 0, 0), (1, 1, 2.5), 3).n_nodes * 3 \
        == 1893213


@pytest.fixture(scope="module")
def mg_pair():
    mesh, elem, rmesh, relem = meshes((16, 16))
    return (MGPreconditioner(mesh, elem, dtype=F64, device="cpu"),
            RefMG(rmesh, relem, dtype=jnp.float64))


def test_hierarchy_and_lam_max_match(mg_pair):
    mg, ref = mg_pair
    assert mg.usable and ref.usable and mg.ratios == ref.ratios
    assert len(mg.levels) == len(ref.levels)
    for lv, rl in zip(mg.levels, ref.levels):
        assert lv.mesh.nelem == rl.mesh.nelem and lv.K.sb == rl.K.sb
        assert np.array_equal(lv.mask_b.numpy(), np.asarray(rl.mask_b))
        assert rel(lv.diag_b.numpy(), rl.diag_b) < 1e-13
    for a, b in zip(mg.lam_max, ref.lam_max):
        assert abs(a - b) <= 1e-10 * abs(b)
    assert rel(mg.coarse_inv.numpy(), ref.coarse_inv) < 1e-12
    for pw, rpw in zip(mg.patch_Wb, ref.patch_Wb):
        assert rel(pw.numpy(), rpw) < 1e-13


@pytest.mark.parametrize("free_tangential", [False, True])
def test_vcycle_matches(mg_pair, free_tangential):
    """One V-cycle on a Dirichlet mask and on a cavity-like mask that
    frees boundary tangentials (blocked transfers with corrections)."""
    mg, ref = mg_pair
    lvl = ref.levels[0]
    m = np.asarray(lvl.mask).copy()
    if free_tangential:
        for idx in ((0,), (-1,), (slice(None), 0), (slice(None), -1)):
            m[idx + (0,)] = 1.0
    mb = np.asarray(lvl.K.to_blocked(jnp.asarray(m)))
    minv_ref = ref.build(jnp.asarray(mb))
    minv = mg.build(t64(mb))
    assert mg.last_tk_levels == ref.last_tk_levels
    assert mg.last_tk_levels[0] == (0, free_tangential)
    rng = np.random.default_rng(4)
    r = rng.normal(size=mb.shape) * mb
    assert rel(minv(t64(r)).numpy(), minv_ref(jnp.asarray(r))) < 1e-12


def test_uniform_flow_kle_solve_2d():
    """The reference's uniform-flow gate (||u - u_exact|| < 1e-12) with
    the port's CG on 8x8 Q2, flat layout."""
    mesh, elem, _, _ = meshes((8, 8))
    sys_ = build_kle_system(mesh, elem, device="cpu")
    mask = np.ones(mesh.n_nodes * 2)
    mask[mesh.node_dofs(mesh.boundary_nodes, 2)] = 0.0
    u_bc = np.zeros(mesh.n_nodes * 2)
    u_bc[0::2] = 1.0
    res = sys_.solve(torch.zeros(mesh.n_nodes, dtype=F64), t64(u_bc),
                     t64(mask), rtol=1e-14, maxiter=5000)
    assert np.linalg.norm(res.x.numpy() - u_bc) < 1e-12, res.iters


def test_mg_cg_matches_reference_solution(mg_pair):
    """MG-preconditioned CG, port vs reference, to the same tolerance."""
    from pynama_tpu.solvers.cg import cg_solve as ref_cg

    mg, ref = mg_pair
    mesh, elem, rmesh, relem = meshes((16, 16))
    sys_ = build_kle_system(mesh, elem, device="cpu")
    rsys = ref_build_kle_system(rmesh, relem)
    mb = ref.levels[0].mask_b
    rng = np.random.default_rng(6)
    w = np.asarray(rsys.K.to_blocked(jnp.asarray(
        rng.normal(size=tuple(reversed(mesh.npts)) + (1,)))))
    bref = rsys.rhs(jnp.asarray(w), jnp.zeros_like(mb), mb)
    rr = ref_cg(partial(rsys.apply_masked, free_mask=mb), bref,
                m_inv=ref.build(mb), rtol=1e-10, maxiter=200)
    mt = t64(mb)
    b = sys_.rhs(t64(w), torch.zeros_like(mt), mt)
    rp = cg_solve(partial(sys_.apply_masked, free_mask=mt,
                          corrections=False),
                  b, m_inv=mg.build(mt, frees_boundary=False), rtol=1e-10,
                  maxiter=200)
    assert rp.iters == int(rr.iters)
    assert rel(rp.x.numpy(), rr.x) < 1e-9
