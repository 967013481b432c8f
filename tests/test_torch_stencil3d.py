"""The 3D stencil contraction of the port against the reference: the plain
version against the reference's Pallas kernel ``_conv3d_pallas``
(interpret mode) and its tap loop, the 3D operator apply with phantom
corrections, and the wrapper's 3D contract on CPU tensors."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pynama_tpu.ops import conv as ref_conv
from pynama_tpu.ops import pallas_stencil as ps
from pynama_tpu.ops.structured import StructuredElementOp as RefOp
from pynama_tpu_torch import convert
from pynama_tpu_torch.ops import stencil
from pynama_tpu_torch.ops.structured import StructuredElementOp


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t64(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


@pytest.fixture
def _interpret(monkeypatch):
    monkeypatch.setenv("PYNAMA_PALLAS_INTERPRET", "1")
    ps._backend_is_tpu.cache_clear()
    ps._plan.cache_clear()
    yield
    ps._backend_is_tpu.cache_clear()
    ps._plan.cache_clear()


# the 3D cases of tests/test_pallas_interpret.py
PALLAS_CASES_3D = [
    ((7, 5, 9, 64), (3, 3, 3, 64, 64)),
    ((6, 4, 11, 64), (3, 3, 3, 64, 128)),
]


@pytest.mark.parametrize("case", PALLAS_CASES_3D,
                         ids=lambda c: "x".join(map(str, c[0])))
def test_plain_matches_pallas_kernel3d_f32(_interpret, case):
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
    # f32 sums of 27 * 64 products taken in another order
    assert np.abs(got - ref).max() / np.abs(ref).max() <= 1e-5


def test_plain_matches_reference_taps_f5_f64():
    rng = np.random.default_rng(3)
    x, W = rng.normal(size=(6, 3, 5, 24)), rng.normal(size=(5, 5, 5, 24, 24))
    ref = np.asarray(ref_conv.conv_blocked(jnp.asarray(x), jnp.asarray(W),
                                           None))
    got = stencil.conv_blocked(t64(x), t64(W)).numpy()
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


@pytest.mark.parametrize("k_in,k_out,nelem,sb,layout", [
    (3, 3, (2, 2, 4), 2, "blocked"),
    (3, 6, (3, 2, 2), 1, "grid"),
])
def test_apply_3d_matches_reference(k_in, k_out, nelem, sb, layout):
    """3D operator apply with the face, edge and corner phantom
    corrections: blocked in and out on the super-blocked lattice (the
    solver's path; the operator carried across by convert.structured_op),
    and on the node grid (the lam_max setup's path)."""
    ngl = 3
    rng = np.random.default_rng(sum(nelem) + sb)
    A = rng.normal(size=(ngl**3 * k_out, ngl**3 * k_in))
    npts = tuple(n * (ngl - 1) + 1 for n in nelem)
    ref = RefOp(A=jnp.asarray(A), ngl=ngl, nelem=nelem, npts=npts,
                k_in=k_in, k_out=k_out, sb=sb)
    op = StructuredElementOp(A=t64(A), ngl=ngl, nelem=nelem, npts=npts,
                             k_in=k_in, k_out=k_out, sb=sb)
    x = rng.normal(size=tuple(reversed(npts)) + (k_in,))
    if layout == "blocked":
        op = convert.structured_op(np.asarray(ref.A), ref.ngl, ref.nelem,
                                   ref.npts, ref.k_in, ref.k_out, sb=ref.sb,
                                   device="cpu")
        x = np.asarray(ref.to_blocked(jnp.asarray(x)))
        y_ref = np.asarray(ref.apply_blocked(jnp.asarray(x)))
        y = op.apply_blocked(t64(x)).numpy()
    else:
        y_ref = np.asarray(ref(jnp.asarray(x)))
        y = op(t64(x)).numpy()
    assert np.abs(y - y_ref).max() <= 1e-12 * np.abs(y_ref).max()


def test_cpu_wrapper_holds_the_3d_contract():
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.normal(size=(3, 4, 5, 8)), dtype=torch.float32)
    W = torch.as_tensor(rng.normal(size=(3, 3, 3, 8, 6)),
                        dtype=torch.float32)
    before = (stencil.KERNEL.launches, stencil.KERNEL3D.launches)
    y = stencil.conv_blocked(x, W)
    assert (stencil.KERNEL.launches, stencil.KERNEL3D.launches) == before
    assert torch.equal(y, stencil.conv_blocked_plain(x, W))
    assert tuple(y.shape) == (3, 4, 5, 6)
    # the 3D kernel itself takes only CUDA tensors, and only 3D kernels
    with pytest.raises(ValueError, match="CUDA"):
        stencil.KERNEL3D(x, W)
    with pytest.raises(ValueError, match="3D"):
        stencil.KERNEL3D(x[0], W[0])
    # contract violations raise on every device
    bad = [
        (x[None], W),                              # a leading batch axis
        (x.transpose(1, 2), W),                    # not contiguous
        (x, W[:, :, :2]),                          # footprint (3, 3, 2)
        (x, torch.zeros((7, 7, 7, 8, 6))),         # F = 7
        (x[..., :4], W),                           # channels
    ]
    for xb, Wb in bad:
        with pytest.raises(ValueError):
            stencil.conv_blocked(xb, Wb)
    with pytest.raises(TypeError):
        stencil.conv_blocked(x.double(), W)
    with pytest.raises(TypeError):
        stencil.conv_blocked(x.half(), W.half())
    with pytest.raises(ValueError, match="on"):
        stencil.conv_blocked(x, W.to("meta"))
