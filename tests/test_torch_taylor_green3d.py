"""The 3D slice against the reference: the transport right-hand side of
CustomFuncProblem("taylor-green") on 4x4x4 Q2 elements in float64 with
the multigrid-CG KLE solve (one evaluation: the boundary-vorticity clamp,
the KLE solve and the transport chain), and the exact fields of every
analytic case."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pynama_tpu.cases import analytic_fields as ref_fields
from pynama_tpu.cases.analytic import CustomFuncProblem as RefCustomFunc
from pynama_tpu_torch.cases import analytic_fields as fields
from pynama_tpu_torch.cases.analytic import CustomFuncProblem
from tests.test_cases import make_config


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def test_transport_rhs_matches_reference_f64():
    cfg = make_config((4, 4, 4), 3, rho=0.5, mu=0.01)
    p = CustomFuncProblem(cfg, dtype=torch.float64, device="cpu").setup()
    q = RefCustomFunc(cfg).setup()
    assert p.mg.ratios == q.mg.ratios == [2]
    assert p._bshape(3) == q._bshape(3) == (3, 3, 3, 192)
    for name in ("free_mask_b", "bc_vort_mask_b"):
        assert np.array_equal(getattr(p, name).numpy(),
                              np.asarray(getattr(q, name)))
    # the exact initial vorticity, evaluated at t > 0: the clamp (vort_bc)
    # writes the decayed exact values on the boundary
    t = 0.25
    w = np.array(q._blk(q.initial_vorticity()))
    v0 = np.array(q._blk(q.zero_vel()))
    f, vel = p.transport_rhs(t, torch.from_numpy(w), torch.from_numpy(v0))
    f_r, vel_r = q.transport_rhs(jnp.asarray(t), jnp.asarray(w),
                                 jnp.asarray(v0))
    # KLE rtol 1e-10 in both; the two CG runs do the same arithmetic in
    # another order, so they agree far below it
    assert rel(vel.numpy(), vel_r) <= 1e-12
    assert rel(f.numpy(), f_r) <= 1e-12


CASES = [(2, "taylor-green"), (2, "senoidal"), (2, "flat-plate"),
         (3, "taylor-green"), (3, "taylor-green2d-3d")]


@pytest.mark.parametrize("dim,case", CASES)
def test_exact_fields_match_reference(dim, case):
    coords = np.random.default_rng(dim).uniform(0.05, 1.0, size=(50, dim))
    table = fields.CASES_2D if dim == 2 else fields.CASES_3D
    rtable = ref_fields.CASES_2D if dim == 2 else ref_fields.CASES_3D
    for fn, rfn in zip(table[case], rtable[case]):
        if fn is None:
            assert rfn is None
            continue
        got = fn(torch.from_numpy(coords), 0.02, 0.7).numpy()
        ref = np.asarray(rfn(jnp.asarray(coords), 0.02, 0.7))
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= 1e-13 * max(np.abs(ref).max(), 1)
