"""transport_rhs and CustomFuncProblem.vort_bc in every layout: grid
and flat vorticity (with the warm start in the same layout) against the
reference, which converts at the same boundary, and blocked vorticity
giving the same numbers. The 4x4 cavity carries a (vel_fs, vel) pair as
its aux; the 4x4 2D Taylor-Green case clamps its boundary vorticity to
the exact field in vort_bc."""

import numpy as np
import pytest
import torch

from pynama_tpu.cases.analytic import CustomFuncProblem as RefCustomFunc
from pynama_tpu.cases.cavity import CavityProblem as RefCavity
from pynama_tpu_torch.cases.analytic import CustomFuncProblem
from pynama_tpu_torch.cases.cavity import CavityProblem
from tests.test_cases import make_config

F64 = torch.float64
TOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cavity_pair():
    cfg = make_config((4, 4), 3, rho=1.0, mu=0.1)
    cfg["boundary-conditions"] = {"no-slip": {"up": [1.0, 0.0]}}
    cfg["multigrid"] = False  # the reference's eager V-cycles compile slowly
    return (CavityProblem(cfg, dtype=F64, device="cpu").setup(),
            RefCavity(cfg).setup())


def taylor_green_pair():
    cfg = make_config((4, 4), 3, rho=1.0, mu=0.01)
    return (CustomFuncProblem(cfg, case="taylor-green", dtype=F64,
                              device="cpu").setup(),
            RefCustomFunc(cfg, case="taylor-green").setup())


def leaves(x):
    if isinstance(x, tuple):
        return [v for part in x for v in leaves(part)]
    return [x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)]


def assert_close(port, reference):
    lp, lr = leaves(port), leaves(reference)
    assert len(lp) == len(lr)
    for a, b in zip(lp, lr):
        assert a.shape == b.shape, (a.shape, b.shape)
        err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)
        assert err <= TOL, err


def seeded(p, seed):
    """A grid vorticity and a grid warm-start velocity."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=p._gshape(p.dim_w)),
            rng.normal(size=p._gshape(p.dim)))


def to_layout(a, layout, p):
    """A grid numpy array as a port tensor in ``layout``."""
    x = torch.as_tensor(a, dtype=F64)
    if layout == "flat":
        return x.reshape(-1)
    return p._blk(x) if layout == "blocked" else x


@pytest.mark.parametrize("make", [cavity_pair, taylor_green_pair],
                         ids=["cavity", "taylor-green"])
def test_transport_rhs_keeps_the_callers_layout(make):
    """Grid and flat: the reference's RHS and aux, in the caller's
    layout (the cavity's grid call again with the pair it gave back);
    blocked: the same numbers, blocked."""
    p, q = make()
    w, u = seeded(p, 1)
    t = 0.05
    out = {}
    for layout in ("grid", "flat"):
        shape = (-1,) if layout == "flat" else p._gshape(p.dim_w)
        f, aux = p.transport_rhs(t, to_layout(w, layout, p),
                                 to_layout(u, layout, p))
        f_r, aux_r = q.transport_rhs(t, np.reshape(w, shape),
                                     np.reshape(u, (-1,) if layout == "flat"
                                                else p._gshape(p.dim)))
        assert f.shape == tuple(np.shape(f_r)) == \
            np.reshape(w, shape).shape
        assert_close((f, aux), (f_r, aux_r))
        if isinstance(aux, tuple) and layout == "grid":
            f2, aux2 = p.transport_rhs(t, to_layout(w, layout, p), aux)
            f2_r, aux2_r = q.transport_rhs(t, np.reshape(w, shape), aux_r)
            assert_close((f2, aux2), (f2_r, aux2_r))
        out[layout] = f, aux
    fb, auxb = p.transport_rhs(t, to_layout(w, "blocked", p),
                               to_layout(u, "blocked", p))
    assert fb.shape == p._bshape(p.dim_w)
    f, aux = out["grid"]
    assert_close((p._unblk(fb),
                  tuple(p._unblk(a) for a in auxb) if isinstance(auxb, tuple)
                  else p._unblk(auxb)), (f, aux))


def test_vort_bc_grid_and_blocked():
    """Taylor-Green's boundary clamp on grid vorticity is the
    reference's, and on blocked vorticity the same numbers blocked."""
    p, q = taylor_green_pair()
    w, _ = seeded(p, 2)
    t = 0.3
    v = p.vort_bc(t, torch.as_tensor(w, dtype=F64))
    v_r = q.vort_bc(t, np.asarray(w))
    assert v.shape == w.shape
    assert_close(v, v_r)
    assert np.abs(v.numpy() - w).max() > 0.1  # the boundary moved
    vb = p.vort_bc(t, p._blk(torch.as_tensor(w, dtype=F64)))
    assert_close(p._unblk(vb), v_r)
