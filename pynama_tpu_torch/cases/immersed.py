"""Immersed-boundary flow cases: static and moving bodies in a free stream.

Port of pynama_tpu/cases/immersed.py on uniform 2D box meshes. The far
field is a uniform flow from Re or an explicit velocity; the
regularized-delta coupling (ibm/coupling.py) enforces the body velocity
after every accepted step; drag and lift coefficients integrate the
virtual flux.

The state (vorticity, KLE velocity and warm starts) stays in the blocked
layout between steps, as BaseProblem.run keeps it; only the coupling
reads and writes the flat interleaved grid layout, converted at the
post-step. Checkpoint and resume, and gmsh domains, are not ported yet.
"""

from math import cos, radians, sin

from pynama_tpu_torch.cases.base import _eval_scalar
from pynama_tpu_torch.cases.uniform import UniformFlowProblem
from pynama_tpu_torch.ibm.bodies import BodiesContainer
from pynama_tpu_torch.ibm.coupling import IBMCoupling
from pynama_tpu_torch.solvers.rk import make_bs5_stepper


class ImmersedBoundaryProblem(UniformFlowProblem):
    """Static bodies in UniformFlowProblem's uniform far field, whose
    velocity read_boundary_condition sets. The CG iterations of every
    post-step's flux solve are ``coupling.cg_iters``, beside the KLE
    solves' ``cg_iters``."""

    def read_boundary_condition(self, bc):
        """Free-stream velocity from Re, direction and longRef, or from
        an explicit vel."""
        if "constant" in bc and "re" in bc["constant"]:
            c = bc["constant"]
            re = float(c["re"])
            angle = radians(float(c.get("direction", 0)))
            L = _eval_scalar(c.get("longRef", 1.0))
            u_ref = re * (self.mu / self.rho) / L
            self.u_ref = u_ref
            self.cte_value = [cos(angle) * u_ref, sin(angle) * u_ref]
            self.re = re
        else:
            vel = bc["constant"]["vel"]
            self.u_ref = float(vel[0])
            self.cte_value = [self.u_ref, 0.0]
            self.re = self.u_ref / self.nu

    def setup(self):
        super().setup()
        # the fine-grid spacing h: the smallest over the axes
        spacing = min((self.upper[i] - self.lower[i]) / self.nelem[i]
                      for i in range(self.dim))
        self.h = spacing / (self.ngl - 1)
        bodies_cfg = self.config.get("bodies")
        if not bodies_cfg:
            raise ValueError("IBM case needs a 'bodies' config section")
        self.body = BodiesContainer(bodies_cfg).create(self.h)
        self.body.set_vel_ref(self.u_ref)
        self.coupling = IBMCoupling(self.mesh, self.body.dl)
        self.cd_history = []
        self.cl_history = []
        self.t_history = []
        # raw (uncorrected) force coefficients and the step dt they used:
        # cd_raw(dt) = cd_phys + floor/dt (see run)
        self.cd_raw_history = []
        self.cl_raw_history = []
        self.dt_history = []
        return self

    def vort_bc(self, t, vort):
        """Far-field vorticity clamped to zero (grid or blocked
        layout)."""
        m = self.bc_vort_mask
        if vort.dim() > 1 and vort.shape != m.shape:  # blocked layout
            m = self.bc_vort_mask_b
        return vort * (1.0 - m)

    # ------------------------------------------------------------------
    def _body_state(self, t):
        """The Lagrange points and their prescribed velocity at t, on the
        device."""
        return (self._tensor(self.body.coords_at(float(t))),
                self._tensor(self.body.velocity_at(float(t))))

    def _post_step(self, t, vort, vel_ws, Xb, Ub):
        """(t, vort, vel_ws, Xb, Ub) -> (vort', vel', q), blocked in and
        out: KLE solve -> velocity correction -> vort = Curl(vel)."""
        vel = self.solve_kle(t, vort, x0=vel_ws)
        nodes, weights = self.coupling.windows(Xb)
        vel_f, q = self.coupling.solve_correction(
            self._unblk(vel).reshape(-1), Ub, nodes, weights)
        vel = self._blk(vel_f.reshape(self._gshape(self.dim)))
        return self.operators.curl(vel), vel, q

    def run(self, callback=None, max_steps=None, save_forces_every=1,
            checkpoint_path=None, checkpoint_every=0, resume_from=None):
        """Transport, then the velocity correction, every accepted step.

        callback(n, t, dt, vort_grid, vel_grid) runs after each accepted
        step with the corrected velocity. Returns (vort flat, t, steps);
        sets self.vort and self.vel (flat, the corrected velocity).
        """
        if checkpoint_path or checkpoint_every or resume_from:
            raise NotImplementedError(
                "checkpoint and resume are not ported yet (ROADMAP.md "
                "queue 1, IO and the CLI)")
        if not self._setup_done:
            raise RuntimeError("call setup() before run()")
        step = make_bs5_stepper(self.transport_rhs, atol=self.ts_atol,
                                rtol=self.ts_rtol,
                                wlte_norm=self._wlte_norm(),
                                max_dt=self.ts_max_dt)
        vort = self._blk(self.initial_vorticity())
        vel = self._blk(self.zero_vel())
        t = self.t_start
        dt = self.dt0
        # initial condition: zero vorticity, KLE solve + correction
        Xb, Ub = self._body_state(t)
        vort, vel, _ = self._post_step(t, vort, vel, Xb, Ub)
        f1, _ = self.transport_rhs(t, vort, vel)
        n = 0
        vel_ws = vel
        steps = max_steps if max_steps is not None else self.max_steps
        while t < self.t_end - 1e-14 and n < steps:
            t_before = t
            res = step(vort, t, dt, vel_ws, f1, self.t_end)
            t, dt = res.t, res.dt_next
            # the step actually taken (dt_next is the next proposal)
            used_dt = t - t_before
            if self.body.is_moving:
                Xb, Ub = self._body_state(t)
            vort, vel, q = self._post_step(t, res.y, res.aux, Xb, Ub)
            # the FSAL derivative is invalid once the correction replaced
            # the solution: re-evaluate the RHS from the corrected state.
            # vel stays the corrected field; the KLE velocity seeds the
            # next step's warm start
            f1, vel_ws = self.transport_rhs(t, vort, vel)
            n += 1
            if n % save_forces_every == 0:
                self._record_forces(t, used_dt, q, vort, vel_ws, Xb, Ub)
            if callback is not None:
                callback(n, t, dt, self._unblk(vort), self._unblk(vel))
        # public attributes stay flat (interleaved dofs) at the API boundary
        self.vort = self._unblk(vort).reshape(-1)
        self.vel = self._unblk(vel).reshape(-1)
        return self.vort, float(t), n

    def _record_forces(self, t, used_dt, q, vort, vel_ws, Xb, Ub):
        """Force coefficients from the virtual flux:
        F = -rho * sum_l q_l * dl * h / dt, cd = F / (0.5 rho U^2 D).

        The raw flux also holds a dt-independent part, the curl -> KLE
        round trip's reconstruction floor at the body: it is measured as
        the flux of a zero-dt round trip (the post-step on the corrected
        state) and subtracted; the raw coefficients are kept beside."""
        _, _, q_floor = self._post_step(t, vort, vel_ws, Xb, Ub)
        D = self.body.bodies[0].char_length()
        dlh = self.body.dl * self.h
        denom = -0.5 * self.u_ref**2 * D * max(used_dt, 1e-30) / dlh
        forces = self.body.split_forces((q - q_floor).cpu().numpy(), denom)
        raw = self.body.split_forces(q.cpu().numpy(), denom)
        self.cd_history.append([f[0] for f in forces])
        self.cl_history.append([f[1] for f in forces])
        self.cd_raw_history.append([f[0] for f in raw])
        self.cl_raw_history.append([f[1] for f in raw])
        self.dt_history.append(used_dt)
        self.t_history.append(float(t))


class ImmersedBoundaryDynamicProblem(ImmersedBoundaryProblem):
    """Moving bodies: the same machinery; the windows follow the body
    every step with fixed shapes, so nothing is rebuilt."""

    def setup(self):
        super().setup()
        for b in self.body.bodies:
            b.is_moving = True
        return self
