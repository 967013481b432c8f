"""Uniform far-field flow: constant-velocity Dirichlet everywhere.

Port of pynama_tpu/cases/uniform.py; channel3d (configs/channel3d.yaml)
is this case on a 3D box. The exact solution is the constant field, so
the KLE solve reproduces it to machine precision.
"""

import numpy as np
import torch

from pynama_tpu_torch.cases.base import FreeSlipProblem


class UniformFlowProblem(FreeSlipProblem):
    # the far-field velocity; a subclass's read_boundary_condition may set
    # it, else it is the unit velocity along x
    cte_value = None

    def __init__(self, config, dtype=torch.float64, device=None,
                 **overrides):
        super().__init__(config, dtype=dtype, device=device, **overrides)
        if self.cte_value is None:
            self.cte_value = (1.0, 0.0) if self.dim == 2 else (1.0, 0.0, 0.0)

    def setup_bc(self):
        super().setup_bc()
        u = np.tile(np.asarray(self.cte_value), self.mesh.n_nodes)
        self._bc_arrays["_u_bc"] = u.reshape(self._gshape(self.dim))

    def vel_bc(self, t):
        return self._u_bc

    def _solver_bc(self, t):
        return self._u_bc_b

    def exact_fields(self, t):
        vel = self._u_bc.reshape(-1, self.dim)
        vort = torch.zeros((self.mesh.n_nodes, self.dim_w), dtype=self.dtype,
                           device=self.device)
        return vel, vort
