"""Analytic-solution verification cases (Taylor-Green, senoidal, flat
plate).

Port of pynama_tpu/cases/analytic.py: the exact velocity, vorticity,
convective and diffusive fields drive the boundary conditions, the
initial condition, KLE convergence checks and operator-error tests.
"""

import torch

from pynama_tpu_torch.cases.analytic_fields import CASES_2D, CASES_3D
from pynama_tpu_torch.cases.base import FreeSlipProblem
from pynama_tpu_torch.kle import v_tens_v


class CustomFuncProblem(FreeSlipProblem):
    def __init__(self, config, case="taylor-green", dtype=torch.float64,
                 device=None, **overrides):
        super().__init__(config, dtype=dtype, device=device, **overrides)
        self.case = case
        table = CASES_2D if self.dim == 2 else CASES_3D
        if case not in table:
            raise ValueError(f"case '{case}' not defined for dim {self.dim}")
        self.vel_fn, self.vort_fn, self.conv_fn, self.diff_fn = table[case]

    def setup_bc(self):
        super().setup_bc()
        self._coords = self._tensor(self.mesh.coords)

    # -- BC / IC ----------------------------------------------------------
    def vel_bc(self, t):
        """Exact velocity (only boundary dofs are read through the mask)."""
        return self.vel_fn(self._coords, self.nu, t).reshape(
            self._gshape(self.dim))

    def vort_bc(self, t, vort):
        """Clamp boundary vorticity (grid or blocked layout) to the exact
        field."""
        exact = self.vort_fn(self._coords, self.nu, t).reshape(
            self._gshape(self.dim_w))
        if vort.dim() > 1 and vort.shape != exact.shape:  # blocked layout
            exact, m = self._blk(exact), self.bc_vort_mask_b
        else:
            m = self.bc_vort_mask
        return vort * (1.0 - m) + exact * m

    def initial_vorticity(self):
        return self.vort_fn(self._coords, self.nu, self.t_start).reshape(
            self._gshape(self.dim_w))

    def exact_fields(self, t):
        return (self.vel_fn(self._coords, self.nu, t),
                self.vort_fn(self._coords, self.nu, t))

    # -- verification ------------------------------------------------------
    def kle_error(self, viscous_times):
        return super().kle_error(viscous_times, self.exact_fields)

    def operators_test(self, viscous_time=1.0):
        """Weighted L2 errors sqrt(sum_i w_i err_i^2) of the convective,
        diffusive and curl operators, w the lumped node weights."""
        t = viscous_time**2 / (4.0 * self.nu)
        ops = self.operators
        vel_e = self.vel_fn(self._coords, self.nu, t).reshape(-1)
        vort_e = self.vort_fn(self._coords, self.nu, t).reshape(-1)
        conv_e = self.conv_fn(self._coords, self.nu, t).reshape(-1)
        diff_e = self.diff_fn(self._coords, self.nu, t).reshape(-1)

        # convective = Curl(DivSrT(u (x) u))
        convective = ops.curl(ops.div_srt(v_tens_v(vel_e, self.dim)))
        # diffusive = Curl(DivSrT(2 mu SrT(u)) / rho)
        aux = ops.div_srt(2.0 * self.mu * ops.strain_rate(vel_e))
        diffusive = ops.curl(aux / self.rho)
        curl = ops.curl(vel_e)

        w = ops.w_curl

        def werr(a, b):
            e = a - b
            return float(torch.sqrt(torch.sum(e * e * w)))

        return (werr(convective, conv_e), werr(diffusive, diff_e),
                werr(curl, vort_e))
