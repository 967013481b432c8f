"""Padded (fictitious-domain) multigrid jumps, the port against the
reference in float64: the hierarchy, masks, Galerkin levels, transfers,
one V-cycle and MG-CG on a 7x7 Q2 mesh (7 -> 4 on an 8x8 extension) and
on 3x3x7 Q2 hexes (3x3x7 -> 2x2x4 on a 4x4x8 extension). Each package's
preconditioner is built once per mesh (the reference's build takes
~15 s, most of it compiling)."""

from functools import lru_cache, partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pynama_tpu.elements.spectral import SpectralElement as RefElement
from pynama_tpu.mesh.structured import BoxMesh as RefBoxMesh
from pynama_tpu.solvers.cg import cg_solve as ref_cg
from pynama_tpu.solvers.multigrid import MGPreconditioner as RefMG
from pynama_tpu_torch.elements.spectral import SpectralElement
from pynama_tpu_torch.kle import build_kle_system
from pynama_tpu_torch.mesh.structured import BoxMesh
from pynama_tpu_torch.solvers.cg import cg_solve
from pynama_tpu_torch.solvers.multigrid import MGPreconditioner
from tests.test_multigrid import setup as ref_setup
from tests.test_multigrid import tg_problem as ref_tg_problem

F64 = torch.float64
NELEM = {2: (7, 7), 3: (3, 3, 7)}


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


def mesh_args(dim):
    return dict(nelem=NELEM[dim], lower=(0,) * dim, upper=(1,) * dim, ngl=3)


@lru_cache(maxsize=None)
def build_pair(dim):
    mesh = BoxMesh(**mesh_args(dim))
    rmesh = RefBoxMesh(**mesh_args(dim))
    mg = MGPreconditioner(mesh, SpectralElement(3, dim), dtype=F64,
                          device="cpu")
    ref = RefMG(rmesh, RefElement(3, dim), dtype=jnp.float64)
    return dim, mg, ref


@pytest.fixture(scope="module", params=[2, 3], ids=["7x7", "3x3x7"])
def pair(request):
    return build_pair(request.param)


def test_padded_hierarchy_matches(pair):
    dim, mg, ref = pair
    assert mg.usable and ref.usable and mg.ratios == ref.ratios == [2]
    assert len(mg.levels) == len(ref.levels) == 2
    assert mg.levels[1].mesh.nelem == ref.levels[1].mesh.nelem == \
        tuple((n + 1) // 2 for n in NELEM[dim])
    for lv, rl in zip(mg.levels, ref.levels):
        assert tuple(lv.mesh.upper) == tuple(rl.mesh.upper)
        assert lv.K.sb == rl.K.sb
        if rl.ext_mesh is None:
            assert lv.ext_mesh is None
        else:
            assert lv.ext_mesh.nelem == rl.ext_mesh.nelem
            assert tuple(lv.ext_mesh.upper) == tuple(rl.ext_mesh.upper)
    ext = mg.levels[0].ext_mesh
    assert ext.nelem == tuple(n + n % 2 for n in NELEM[dim])
    # the ghost band beyond the original domain is Dirichlet on level 1
    coarse = mg.levels[1]
    band = np.any(coarse.mesh.coords > 1.0 + 1e-9, axis=1)
    assert band.any()
    assert not coarse.mask_np.reshape(-1, dim)[band].any()


def test_padded_level_data_match(pair):
    _, mg, ref = pair
    for lv, rl in zip(mg.levels, ref.levels):
        assert np.array_equal(lv.mask.numpy(), np.asarray(rl.mask))
        assert np.array_equal(lv.mask_b.numpy(), np.asarray(rl.mask_b))
        assert rel(lv.diag_b.numpy(), rl.diag_b) < 1e-13
        if rl.mult_inv is not None:
            assert np.array_equal(lv.mult_inv.numpy(),
                                  np.asarray(rl.mult_inv))
    for a, b in zip(mg.lam_max, ref.lam_max):
        assert abs(a - b) <= 1e-10 * abs(b)
    assert rel(mg.coarse_inv.numpy(), ref.coarse_inv) < 1e-12
    for pw, rpw in zip(mg.patch_Wb, ref.patch_Wb):
        assert rel(pw.numpy(), rpw) < 1e-13


def test_padded_transfers_match(pair):
    """_prolong / _restrict at the padded jump against the reference's,
    and exact adjoints of each other."""
    dim, mg, ref = pair
    lvl, rlvl = mg.levels[0], ref.levels[0]
    cm, rcm = mg.levels[1].mesh, ref.levels[1].mesh
    rng = np.random.default_rng(5)
    a = rng.normal(size=tuple(reversed(cm.npts)) + (dim,))
    b = rng.normal(size=tuple(reversed(lvl.mesh.npts)) + (dim,))
    pa = mg._prolong(lvl, cm, t64(a)).numpy()
    rb = mg._restrict(lvl, cm, t64(b)).numpy()
    assert pa.shape == b.shape and rb.shape == a.shape
    assert rel(pa, ref._prolong(rlvl, rcm, jnp.asarray(a))) < 1e-13
    assert rel(rb, ref._restrict(rlvl, rcm, jnp.asarray(b))) < 1e-13
    np.testing.assert_allclose(np.sum(pa * b), np.sum(a * rb), rtol=1e-12)


def free_tangential_mask(m):
    """A cavity-like mask: component 0 freed on every boundary face."""
    m = m.copy()
    dim = m.ndim - 1
    for a in range(dim):
        for side in (0, -1):
            idx = [slice(None)] * dim
            idx[a] = side
            m[tuple(idx) + (0,)] = 1.0
    return m


@pytest.mark.parametrize("layout", ["blocked", "grid"])
@pytest.mark.parametrize("free_tangential", [False, True])
def test_padded_vcycle_matches(pair, free_tangential, layout):
    """One V-cycle, blocked and grid layout, Dirichlet and cavity-like
    masks; the padded jump takes no blocked-native transfer."""
    _, mg, ref = pair
    lvl = ref.levels[0]
    m = np.asarray(lvl.mask)
    if free_tangential:
        m = free_tangential_mask(m)
    if layout == "blocked":
        m = np.asarray(lvl.K.to_blocked(jnp.asarray(m)))
    minv_ref = ref.build(jnp.asarray(m))
    minv = mg.build(t64(m))
    assert mg.last_tk_levels == ref.last_tk_levels == []
    rng = np.random.default_rng(4)
    r = rng.normal(size=m.shape) * m
    z = minv(t64(r)).numpy()
    assert rel(z, minv_ref(jnp.asarray(r))) < 1e-12
    # the V-cycle stays symmetric through the pad/crop transfers
    s = rng.normal(size=m.shape) * m
    zs = minv(t64(s)).numpy()
    np.testing.assert_allclose(np.sum(s * z), np.sum(r * zs), rtol=1e-11)


def test_padded_mg_cg_matches_reference():
    """MG-CG on tests/test_multigrid.py's Taylor-Green problem, 7x7, rtol
    1e-10: the reference's iteration count and solution."""
    _, mg, rmg = build_pair(2)
    rmesh, _, rsys, rmask = ref_setup(7)
    rb, rx0 = ref_tg_problem(rmesh, rsys, rmask)
    rr = ref_cg(partial(rsys.apply_masked, free_mask=rmask), rb, x0=rx0,
                m_inv=rmg.build(rmask), rtol=1e-10, maxiter=400)
    mesh = mg.levels[0].mesh
    sys_ = build_kle_system(mesh, SpectralElement(3, 2), device="cpu")
    mask = t64(rmask)
    vort, u_bc = tg_fields(mesh)
    b = sys_.rhs(vort, u_bc, mask)
    assert rel(b.numpy(), rb) < 1e-13
    res = cg_solve(partial(sys_.apply_masked, free_mask=mask), b,
                   x0=(1.0 - mask) * u_bc, m_inv=mg.build(mask), rtol=1e-10,
                   maxiter=400)
    assert res.iters == int(rr.iters) == 8
    assert rel(res.x.numpy(), rr.x) < 1e-9


def tg_fields(mesh):
    """tests/test_multigrid.py tg_problem's vorticity and boundary values
    on the port's mesh."""
    x = 2 * np.pi * mesh.coords[:, 0]
    y = 2 * np.pi * mesh.coords[:, 1]
    ny, nx = mesh.npts[1], mesh.npts[0]
    vort = (-4 * np.pi * np.cos(x) * np.cos(y)).reshape(ny, nx, 1)
    u_bc = np.stack([np.cos(x) * np.sin(y), -np.sin(x) * np.cos(y)],
                    1).reshape(ny, nx, 2)
    return t64(vort), t64(u_bc)
