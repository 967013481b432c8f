"""The stencil contraction of the port against the reference: the plain
version against the reference's tap loop and its Pallas kernel (interpret
mode), the blocked apply with phantom corrections and super-block rebase,
and the wrapper's dispatch on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pynama_tpu.ops import conv as ref_conv
from pynama_tpu.ops import pallas_stencil as ps
from pynama_tpu.ops.structured import StructuredElementOp as RefOp
from pynama_tpu_torch.ops import conv, stencil
from pynama_tpu_torch.ops.structured import StructuredElementOp


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t64(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


@pytest.mark.parametrize("xs,ws", [
    ((9, 7, 8), (3, 3, 8, 16)),
    ((6, 11, 8), (5, 5, 8, 8)),
    ((5, 4, 24), (3, 3, 24, 12)),
    ((4, 3, 5, 6), (3, 3, 3, 6, 6)),
], ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_reference_taps_f64(xs, ws):
    rng = np.random.default_rng(1)
    x, W = rng.normal(size=xs), rng.normal(size=ws)
    ref = np.asarray(ref_conv.conv_blocked(jnp.asarray(x), jnp.asarray(W),
                                           None))
    got = stencil.conv_blocked(t64(x), t64(W)).numpy()
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


@pytest.fixture
def _interpret(monkeypatch):
    monkeypatch.setenv("PYNAMA_PALLAS_INTERPRET", "1")
    ps._backend_is_tpu.cache_clear()
    ps._plan.cache_clear()
    yield
    ps._backend_is_tpu.cache_clear()
    ps._plan.cache_clear()


# the 2D cases of tests/test_pallas_interpret.py
PALLAS_CASES = [
    ((21, 13, 64), (3, 3, 64, 64)),
    ((17, 9, 64), (5, 5, 64, 64)),
    ((33, 11, 64), (3, 3, 64, 128)),
]


@pytest.mark.parametrize("case", PALLAS_CASES,
                         ids=lambda c: "x".join(map(str, c[0])))
def test_plain_matches_pallas_kernel_f32(_interpret, case):
    if ps.pl is None:
        pytest.skip("pallas unavailable")
    xs, ws = case
    rng = np.random.default_rng(5)
    x = rng.normal(size=xs).astype(np.float32)
    W = rng.normal(size=ws).astype(np.float32)
    assert ps.pallas_ok(xs, jnp.float32, ws)
    ref = np.asarray(ps.conv_blocked_pallas(jnp.asarray(x), jnp.asarray(W)))
    got = stencil.conv_blocked(torch.from_numpy(x),
                               torch.from_numpy(W)).numpy()
    # f32 sums taken in another order: a few ulps of the largest value
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-5


@pytest.mark.parametrize("ngl,k_in,k_out,nelem,sb", [
    (3, 2, 2, (4, 8), 1),
    (3, 2, 2, (4, 8), 4),
    (3, 2, 3, (6, 3), 3),
    (3, 1, 2, (8, 4), 2),
    (4, 3, 2, (4, 2), 2),
])
def test_blocked_apply_matches_reference(ngl, k_in, k_out, nelem, sb):
    """Blocked apply with phantom corrections (and without), grid apply,
    on the parity and the super-blocked lattice."""
    rng = np.random.default_rng(sum(nelem) + sb)
    nnode = ngl**2
    A = rng.normal(size=(nnode * k_out, nnode * k_in))
    npts = tuple(n * (ngl - 1) + 1 for n in nelem)
    ref = RefOp(A=jnp.asarray(A), ngl=ngl, nelem=nelem, npts=npts,
                k_in=k_in, k_out=k_out, sb=sb)
    op = StructuredElementOp(A=t64(A), ngl=ngl, nelem=nelem, npts=npts,
                             k_in=k_in, k_out=k_out, sb=sb)
    xg = rng.normal(size=tuple(reversed(npts)) + (k_in,))
    xb = np.asarray(ref.to_blocked(jnp.asarray(xg)))
    assert np.array_equal(op.to_blocked(t64(xg)).numpy(), xb)
    for corr in (True, False):
        y_ref = np.asarray(ref.apply_blocked(jnp.asarray(xb),
                                             corrections=corr))
        y = op.apply_blocked(t64(xb), corrections=corr).numpy()
        assert np.abs(y - y_ref).max() <= 1e-12 * np.abs(y_ref).max()
    y_ref = np.asarray(ref(jnp.asarray(xg)))
    y = op(t64(xg)).numpy()
    assert np.abs(y - y_ref).max() <= 1e-12 * np.abs(y_ref).max()
    assert np.array_equal(op.from_blocked(t64(xb)).numpy(), xg)


def test_patch_kernel_rebase_matches_reference():
    rng = np.random.default_rng(11)
    dim, ngl, k, f = 2, 3, 2, 4
    npatch = (2 * (ngl - 1) + 1) ** dim * k
    B = rng.normal(size=(npatch, npatch))
    B = B + B.T
    Wp = conv.build_patch_kernel(B, ngl, dim, k, np.float64)
    Ws = conv.rebase_conv_kernel(Wp, f, dim, k, k, ngl)
    assert np.array_equal(Wp, ref_conv.build_patch_kernel(B, ngl, dim, k,
                                                          np.float64))
    assert np.array_equal(Ws, ref_conv.rebase_conv_kernel(Wp, f, dim, k, k,
                                                          ngl))
    npg = (17, 33)
    s = f * (ngl - 1) + 1
    xb = conv.to_blocked_np(rng.normal(size=npg + (k,)), s)
    ref = np.asarray(ref_conv.conv_stencil_apply_blocked(
        jnp.asarray(xb), Ws, (), s, npg, k))
    got = conv.conv_stencil_apply_blocked(t64(xb), t64(Ws), (), s, npg,
                                          k).numpy()
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


def test_mask_frees_boundary_matches_reference():
    npg = (9, 17)
    m = np.ones(npg + (2,))
    for ngl in (3, 9):
        mb = conv.to_blocked_np(m, ngl)
        inner = m.copy()
        inner[0], inner[-1], inner[:, 0], inner[:, -1] = 0, 0, 0, 0
        ib = conv.to_blocked_np(inner, ngl)
        for arr in (m, mb, inner, ib):
            assert conv.mask_frees_boundary(arr, ngl, npg) == \
                ref_conv.mask_frees_boundary(arr, ngl, npg)
        assert conv.mask_frees_boundary(mb, ngl, npg)
        assert not conv.mask_frees_boundary(ib, ngl, npg)


def test_cpu_wrapper_takes_plain_path_and_kernel_needs_cuda():
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.normal(size=(5, 6, 8)), dtype=torch.float32)
    W = torch.as_tensor(rng.normal(size=(3, 3, 8, 4)), dtype=torch.float32)
    before = stencil.KERNEL.launches
    y = stencil.conv_blocked(x, W)
    assert stencil.KERNEL.launches == before  # the plain version ran
    assert torch.equal(y, stencil.conv_blocked_plain(x, W))
    # the kernel itself takes only CUDA tensors
    with pytest.raises(ValueError, match="CUDA"):
        stencil.KERNEL(x, W)
    # contract violations raise on every device
    with pytest.raises(ValueError):
        stencil.conv_blocked(x.transpose(0, 1), W)
    with pytest.raises(TypeError):
        stencil.conv_blocked(x.double(), W)
    with pytest.raises(ValueError):
        stencil.conv_blocked(x, W[:2, :2])
