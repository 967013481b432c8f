"""Lid-driven cavity: mixed no-slip / free-slip walls with a dual KLE solve.

Port of pynama_tpu/cases/cavity.py. One matrix-free K with two masks:

  free_mask_fs : free at the free-slip stage — interior dofs + tangential
                 dofs of no-slip wall nodes,
  free_mask    : free at the final stage — interior dofs only.

A KLE solve is
  velFS = solve(K; mask_fs)(Rw w, u_bc)
  velFS[fsfree] = u_bc[fsfree]                 # no-slip wall velocities
  w2   = Curl(velFS)                           # wall vorticity generation
  vel  = solve(K; mask)(Rw w2, u_bc)
"""

import numpy as np

from pynama_tpu_torch.bc import NoSlipWalls
from pynama_tpu_torch.cases.base import BaseProblem


class NoSlipProblem(BaseProblem):
    """Dual-stage free-slip -> no-slip KLE solve."""

    _mask_names = ("free_mask", "free_mask_fs")

    def read_boundary_condition(self, bc):
        exclude = list(bc.get("free-slip", {}).keys()) if "free-slip" in bc \
            else []
        self.free_slip_faces = exclude
        self.walls = NoSlipWalls(self.dim, exclude=exclude)
        for wall_name, wall_vel in bc.get("no-slip", {}).items():
            self.walls.set_wall_velocity(wall_name, wall_vel)

    def setup_bc(self):
        """The two masks + BC velocity, numpy grid layout."""
        mesh, dim = self.mesh, self.dim
        nvd = mesh.n_nodes * dim
        set_fs = np.zeros(nvd, dtype=bool)   # pinned in BOTH solves
        fs_free = np.zeros(nvd, dtype=bool)  # free at FS stage only
        u_bc = np.zeros(nvd)
        for wall in self.walls.walls.values():
            nodes = mesh.face_nodes[wall.name].astype(np.int64)
            set_fs[nodes * dim + wall.normal_axis] = True
            for d in wall.tangential_dofs:
                fs_free[nodes * dim + d] = True
            if wall.velocity is not None:
                for d in wall.moving_dofs:
                    u_bc[nodes * dim + d] = wall.velocity[d]
        # fully-Dirichlet (free-slip-labeled) faces pin every dof
        for name in self.free_slip_faces:
            nodes = mesh.face_nodes[name].astype(np.int64)
            for d in range(dim):
                set_fs[nodes * dim + d] = True
        # wall corners: the normal dof of one wall is tangential of the
        # other -> pinned in both
        fs_free &= ~set_fs

        gshape = self._gshape(dim)
        free_mask = (~(set_fs | fs_free)).astype(np.float64).reshape(gshape)
        free_mask_fs = (~set_fs).astype(np.float64).reshape(gshape)
        self._bc_arrays = {
            "free_mask": free_mask,
            "free_mask_fs": free_mask_fs,
            "_u_bc": u_bc.reshape(gshape),
            # dofs free at the FS stage but pinned at the final stage
            "_fsfree": free_mask_fs - free_mask,
        }

    def _solver_bc(self, t):
        return self._u_bc_b

    def solve_kle(self, t, vort, x0=None, rtol=None, maxiter=None,
                  restarts=1):
        """Velocity of a vorticity field (blocked, grid or flat layout)."""
        vort, x0, restore = self._kle_layout(vort, x0)
        vel, _ = self._solve_kle_pair(t, vort, (x0, None), rtol=rtol,
                                      maxiter=maxiter, restarts=restarts)
        return restore(vel)

    def _kle_solve_aux(self, t, vort, vel_ws):
        """Stage solve with per-system warm starts: aux carries the
        (vel_fs, vel) pair so each system starts from its own previous
        solution."""
        pair = vel_ws if isinstance(vel_ws, tuple) else (vel_ws, vel_ws)
        vel, vel_fs = self._solve_kle_pair(t, vort, pair)
        return vel, (vel_fs, vel)

    def _solve_kle_pair(self, t, vort, x0_pair, rtol=None, maxiter=None,
                        restarts=1):
        """(vel, vel_fs) dual-mask solve; blocked layout in and out."""
        rtol = rtol if rtol is not None else self.kle_rtol
        maxiter = maxiter if maxiter is not None else self.kle_maxiter
        x0, x0_fin = x0_pair
        u_bc = self._solver_bc(t)
        res_fs = self._solve("free_mask_fs", vort, u_bc, x0, rtol, maxiter,
                             restarts)
        # overwrite no-slip wall velocities before the wall vorticity
        fsfree = self._fsfree_b
        vel_fs = res_fs.x * (1.0 - fsfree) + u_bc * fsfree
        vort2 = self.operators.curl(vel_fs)
        x0f = x0_fin if x0_fin is not None else res_fs.x
        res = self._solve("free_mask", vort2, u_bc, x0f, rtol, maxiter,
                          restarts)
        return res.x, res_fs.x


class CavityProblem(NoSlipProblem):
    """Lid-driven cavity; initial vorticity zero."""
