"""Immersed-boundary flow cases: static and moving bodies in a free stream.

Port of pynama_tpu/cases/immersed.py on uniform 2D box meshes and on
Gmsh domains that are uniform around the body. The far field is a
uniform flow from Re or an explicit velocity; the regularized-delta
coupling (ibm/coupling.py) enforces the body velocity after every
accepted step; drag and lift coefficients integrate the virtual flux.

The state (vorticity, KLE velocity and warm starts) stays in the blocked
layout between steps, as BaseProblem.run keeps it; only the coupling
reads and writes the flat interleaved grid layout, converted at the
post-step. On a Gmsh domain the state is flat throughout (the layout
converters are identities), the IBM spacing is the domain's 'h-min' /
(ngl - 1), and the coupling is UnstructuredIBMCoupling for static
bodies or LatticeIBMCoupling for moving ones.
"""

import time
from math import cos, radians, sin

import numpy as np

from pynama_tpu_torch.cases.base import _eval_scalar
from pynama_tpu_torch.cases.uniform import UniformFlowProblem
from pynama_tpu_torch.ibm.bodies import BodiesContainer
from pynama_tpu_torch.ibm.coupling import (IBMCoupling, LatticeIBMCoupling,
                                           UnstructuredIBMCoupling)
from pynama_tpu_torch.solvers.rk import make_bs5_stepper


class ImmersedBoundaryProblem(UniformFlowProblem):
    """Static bodies in UniformFlowProblem's uniform far field, whose
    velocity read_boundary_condition sets. The CG iterations of every
    post-step's flux solve are ``coupling.cg_iters``, beside the KLE
    solves' ``cg_iters``. ``coupling_s`` is the seconds of the
    coupling's host build (windows or lattice), beside ``setup_s``."""

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
        if self.gmsh_file:
            hmin = self.config["domain"].get("h-min")
            if hmin is None:
                raise ValueError("IBM on a gmsh-file domain needs 'h-min'")
        super().setup()
        # the fine-grid spacing h: on a Gmsh domain 'h-min' / (ngl - 1),
        # else the smallest over the box's axes
        if self.gmsh_file:
            self.h = _eval_scalar(hmin) / (self.ngl - 1)
        else:
            spacing = min((self.upper[i] - self.lower[i]) / self.nelem[i]
                          for i in range(self.dim))
            self.h = spacing / (self.ngl - 1)
        bodies_cfg = self.config.get("bodies")
        if not bodies_cfg:
            raise ValueError("IBM case needs a 'bodies' config section")
        self.body = BodiesContainer(bodies_cfg).create(self.h)
        self.body.set_vel_ref(self.u_ref)
        t0 = time.perf_counter()
        self.coupling = self._make_coupling()
        self.coupling_s = time.perf_counter() - t0
        self.cd_history = []
        self.cl_history = []
        self.t_history = []
        # raw (uncorrected) force coefficients and the step dt they used:
        # cd_raw(dt) = cd_phys + floor/dt (see run)
        self.cd_raw_history = []
        self.cl_raw_history = []
        self.dt_history = []
        return self

    def _make_coupling(self):
        """The box coupling, or on a Gmsh domain the host-built static
        windows (a static body) or lattice (a moving body; its envelope
        is the box of the body's points at 257 times over the run and
        257 over the first period of its oscillation, Te = 5 / u_ref,
        which can be much shorter than the run)."""
        if not self.gmsh_file:
            return IBMCoupling(self.mesh, self.body.dl)
        if not self.body.is_moving:
            c = UnstructuredIBMCoupling(self.mesh, self.body.dl,
                                        h_min=self.h, dtype=self.dtype,
                                        device=self.device)
            c.windows_host(self.body.coords_at(0.0))
            return c
        ts = np.linspace(self.t_start, self.t_end, 257)
        Te = 5.0 / max(abs(self.u_ref), 1e-30)
        ts = np.concatenate([ts, self.t_start
                             + Te * np.linspace(0.0, 1.0, 257)])
        pts = np.concatenate([self.body.coords_at(float(tt)) for tt in ts])
        return LatticeIBMCoupling(self.mesh, self.body.dl, h_min=self.h,
                                  envelope=(pts.min(axis=0),
                                            pts.max(axis=0)),
                                  device=self.device)

    def vort_bc(self, t, vort):
        """Far-field vorticity clamped to zero (grid, blocked or, on a
        Gmsh domain, flat layout)."""
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
        """(t, vort, vel_ws, Xb, Ub) -> (vort', vel', q), in the solver
        layout (blocked, or flat on a Gmsh domain) in and out: KLE solve
        -> velocity correction -> vort = Curl(vel)."""
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
        Checkpoints as BaseProblem.run's, with the corrected velocity and
        the cd, cl and time histories; a resumed run warm-starts its
        first step from the corrected velocity, as the reference's does.
        """
        if not self._setup_done:
            raise RuntimeError("call setup() before run()")
        step = make_bs5_stepper(self.transport_rhs, atol=self.ts_atol,
                                rtol=self.ts_rtol,
                                wlte_norm=self._wlte_norm(),
                                max_dt=self.ts_max_dt)
        if resume_from:
            ck, t, dt, n = self._load_state(resume_from)
            vort, vel, f1 = (self._blk(ck[k]) for k in ("vort", "vel", "f1"))
            hist = ck.get("extra", {})
            self.cd_history = hist.get("cd", [])
            self.cl_history = hist.get("cl", [])
            self.t_history = hist.get("times", [])
            Xb, Ub = self._body_state(t)
        else:
            vort = self._blk(self.initial_vorticity())
            vel = self._blk(self.zero_vel())
            t = self.t_start
            dt = self.dt0
            # initial condition: the initial vorticity (zero unless a
            # subclass gives one), KLE solve + correction
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
            save = bool(checkpoint_path and checkpoint_every
                        and n % checkpoint_every == 0)
            if callback is None and not save:
                continue
            vort_g, vel_g = self._unblk(vort), self._unblk(vel)
            if callback is not None:
                callback(n, t, dt, vort_g, vel_g)
            if save:
                self._save_state(checkpoint_path, n, t, dt, vort_g, vel_g,
                                 self._unblk(f1),
                                 extra={"cd": self.cd_history,
                                        "cl": self.cl_history,
                                        "times": self.t_history})
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
