"""One BS5(4) step of the lid-driven cavity in both packages, started
from the same state: the reference's state and blocked masks are carried
into the port through pynama_tpu_torch.convert."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pynama_tpu.cases.cavity import CavityProblem as RefCavity
from pynama_tpu.solvers.rk import make_bs5_stepper as ref_stepper
from pynama_tpu_torch import convert
from pynama_tpu_torch.cases.cavity import CavityProblem
from pynama_tpu_torch.solvers.rk import make_bs5_stepper


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def config(multigrid):
    return {
        "name": "cavity-step",
        "material-properties": {"rho": 1.0, "mu": 0.1},
        "domain": {"ngl": 3, "box-mesh": {"nelem": [8, 8], "lower": [0, 0],
                                          "upper": [1, 1]}},
        "time-solver": {"start-time": 0.0, "end-time": 0.5,
                        "max-steps": 10},
        "boundary-conditions": {"no-slip": {"up": [1.0, 0.0]}},
        "multigrid": multigrid,
    }


def smooth_state(q, rng):
    """A smooth blocked state (vort, (vel_fs, vel), f1) on q's mesh."""
    c = q.mesh.coords
    npg = tuple(reversed(q.mesh.npts))

    def field(k, scale):
        a = rng.uniform(0.5, 1.5, size=(k, 2))
        vals = np.stack([np.sin(2 * np.pi * a[i, 0] * c[:, 0])
                         * np.cos(np.pi * a[i, 1] * c[:, 1])
                         for i in range(k)], axis=1)
        return np.asarray(q._blk(jnp.asarray(scale * vals.reshape(
            npg + (k,)))))

    return field(1, 2.0), (field(2, 0.5), field(2, 0.5)), field(1, 0.1)


def test_one_bs5_step_from_the_same_state():
    """Jacobi-CG KLE solves keep the reference's compiled step small; the
    multigrid path is held in tests/test_torch_cavity.py."""
    cfg = config(multigrid=False)
    q = RefCavity(cfg).setup()
    p = CavityProblem(cfg, dtype=torch.float64, device="cpu").setup()
    names = ("free_mask_b", "free_mask_fs_b", "_u_bc_b", "_fsfree_b")
    convert.blocked_masks(p, {n: np.asarray(getattr(q, n)) for n in names})
    vort, vel_pair, f1 = smooth_state(q, np.random.default_rng(8))
    t, dt = 0.05, 2e-3

    step = jax.jit(ref_stepper(q.transport_rhs, atol=q.ts_atol,
                               rtol=q.ts_rtol, wlte_norm=q._wlte_norm()))
    ref = step(jnp.asarray(vort), jnp.asarray(t), jnp.asarray(dt),
               tuple(map(jnp.asarray, vel_pair)), jnp.asarray(f1),
               jnp.asarray(q.t_end))

    vort_t, pair_t, f1_t, t_t, dt_t = convert.run_state(
        vort, vel_pair, f1, t, dt, device="cpu")
    got = make_bs5_stepper(p.transport_rhs, atol=p.ts_atol, rtol=p.ts_rtol,
                           wlte_norm=p._wlte_norm())(
        vort_t, t_t, dt_t, pair_t, f1_t, p.t_end)

    assert got.attempts == int(ref.attempts)
    assert abs(got.t - float(ref.t)) <= 1e-15
    assert abs(got.dt_next - float(ref.dt_next)) <= 1e-12 * float(
        ref.dt_next)
    assert abs(got.wlte - float(ref.wlte)) <= 1e-8 * float(ref.wlte)

    def rel(a, b):
        a, b = a.numpy(), np.asarray(b)
        return np.linalg.norm(a - b) / np.linalg.norm(b)

    # KLE solves stop at rtol 1e-10: the two CG runs agree far below that
    assert rel(got.y, ref.y) < 1e-10
    assert rel(got.f_new, ref.f_new) < 1e-8
    for a, b in zip(got.aux, ref.aux):
        assert rel(a, b) < 1e-10
