"""Euler-Lagrange delta-function coupling, fixed-window and matrix-free.

Port of pynama_tpu/ibm/coupling.py, the box-mesh ``IBMCoupling``. Every
Lagrange point owns a fixed 6x6 window of fine-grid nodes (the 4-point
kernel's support is 4x4; 6 covers the floor() jitter), so

  * interpolation (H u) = a windowed gather and a weighted sum,
  * spreading     (S q) = a weighted scatter-add,
  * the flux system A q = rhs (A = H S, SPD) is solved matrix-free by
    Jacobi-CG (solvers/cg.py),

all with fixed shapes: a moving body changes only the values of the
window ids and weights. The windows are computed on the device from the
Lagrange points. H entries are the dimensionless kernel products, S
entries carry dl/h. The velocity is the flat interleaved grid layout
(dof 2*node + c, node = iy*npx + ix). The fine grid must be uniform with
square cells (ngl <= 3 box meshes).

The gather, weighted sums and scatter-add are plain torch, as they are
plain jnp outside any Pallas kernel in the reference. The scatter-add is
``index_put_(accumulate=True)``: on CUDA it sorts the ids (stably) and
sums each node's contributions in their order, so it is deterministic,
where ``index_add_``'s atomics may sum in any order.

The unstructured-mesh couplings (``UnstructuredIBMCoupling``,
``LatticeIBMCoupling``) are not ported yet: they raise.
"""

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from pynama_tpu_torch.ibm.diracs import KERNELS
from pynama_tpu_torch.mesh.structured import BoxMesh
from pynama_tpu_torch.solvers.cg import cg_solve

WIN = 6  # window size per axis

_UNSTRUCTURED = ("IBM on unstructured (gmsh) meshes is not ported yet "
                 "(ROADMAP.md queue 1 #9b, IBM on Gmsh domains)")


@dataclass
class IBMCoupling:
    """The coupling of a uniform 2D box mesh. Its tensors take the
    device and dtype of the Lagrange points and velocities passed in.

    ``cg_iters`` records the CG iterations of every flux solve, in
    order (host integers)."""

    mesh: BoxMesh
    dl: float
    kernel: str = "fourGrid"

    def __post_init__(self):
        m = self.mesh
        if not isinstance(m, BoxMesh):
            raise NotImplementedError(_UNSTRUCTURED)
        if m.dim != 2:
            raise NotImplementedError("IBM coupling is 2D (like the "
                                      "reference)")
        ax = m.axis_coords
        dx = np.diff(ax[0])
        dy = np.diff(ax[1])
        if not (np.allclose(dx, dx[0], rtol=1e-10)
                and np.allclose(dy, dy[0], rtol=1e-10)):
            raise ValueError(
                "IBM needs a uniform fine grid: use ngl<=3 box meshes "
                "(GLL spacing is non-uniform inside ngl>3 elements)")
        if not np.isclose(dx[0], dy[0]):
            raise ValueError("IBM needs square grid cells")
        self.h = float(dx[0])
        self.lower = np.asarray(m.lower)
        self.npx, self.npy = m.npts
        self.phi = KERNELS[self.kernel]
        self.cg_iters: List[int] = []

    # ------------------------------------------------------------------
    def windows(self, X):
        """Window node ids and kernel weights of Lagrange points X (L, 2).

        Returns (nodes (L, WIN*WIN) int64, weights (L, WIN*WIN)); the
        weights are the products phi(dx/h) phi(dy/h), each row summing
        to 1 (the discrete mass condition). Ids outside the domain are
        clipped to it and their weights set to 0.
        """
        # the origin as Python floats: no host-to-device copy per call
        s = torch.stack([X[:, 0] - float(self.lower[0]),
                         X[:, 1] - float(self.lower[1])], dim=1) / self.h
        base = torch.floor(s).to(torch.int64) - (WIN // 2 - 1)
        offs = torch.arange(WIN, dtype=torch.int64, device=X.device)
        ix = base[:, 0:1] + offs[None, :]              # (L, WIN)
        iy = base[:, 1:2] + offs[None, :]
        wx = self.phi(s[:, 0:1] - ix.to(X.dtype))     # (L, WIN)
        wy = self.phi(s[:, 1:2] - iy.to(X.dtype))
        zero = torch.zeros((), dtype=X.dtype, device=X.device)
        wx = torch.where((ix >= 0) & (ix < self.npx), wx, zero)
        wy = torch.where((iy >= 0) & (iy < self.npy), wy, zero)
        ix = torch.clamp(ix, 0, self.npx - 1)
        iy = torch.clamp(iy, 0, self.npy - 1)
        n = X.shape[0]
        nodes = (iy[:, :, None] * self.npx + ix[:, None, :]).reshape(n, -1)
        weights = (wy[:, :, None] * wx[:, None, :]).reshape(n, -1)
        return nodes, weights

    # -- operator applies (velocity dof layout: node*2 + c) --------------
    def interp(self, u, nodes, weights):
        """(H u): the fluid velocity at the Lagrange points, (L, 2)."""
        ue = u.reshape(-1, 2)[nodes]                   # (L, K, 2)
        return torch.einsum("lk,lkc->lc", weights, ue)

    def spread(self, q, nodes, weights, n_nodes):
        """(S q): the Lagrange flux spread to the fluid dofs, scaled
        dl/h (flat interleaved)."""
        vals = weights[:, :, None] * q[:, None, :] * (self.dl / self.h)
        out = torch.zeros((n_nodes, 2), dtype=q.dtype, device=q.device)
        out.index_put_((nodes.reshape(-1),), vals.reshape(-1, 2),
                       accumulate=True)
        return out.reshape(-1)

    def flux_diag(self, weights):
        """diag(A) = dl/h * sum_k w^2 (the Jacobi preconditioner)."""
        return (weights * weights).sum(dim=1) * (self.dl / self.h)

    def solve_correction(self, vel, body_vel, nodes, weights, rtol=1e-10,
                         maxiter=500):
        """Velocity correction u += S q with A q = -(H u - U_body), by
        matrix-free Jacobi-CG.

        ``vel`` is flat interleaved, ``body_vel`` (L, 2). Returns (the
        corrected velocity, the virtual flux q (L, 2)); the solve's CG
        iterations go to ``cg_iters``.
        """
        n_nodes = vel.shape[0] // 2
        rhs = body_vel - self.interp(vel, nodes, weights)  # -(Hu - Ub)

        def A(qf):
            q = qf.reshape(-1, 2)
            return self.interp(self.spread(q, nodes, weights, n_nodes),
                               nodes, weights).reshape(-1)

        d = self.flux_diag(weights)
        m_inv = 1.0 / torch.repeat_interleave(torch.clamp(d, min=1e-30), 2)
        res = cg_solve(A, rhs.reshape(-1), m_inv=m_inv, rtol=rtol,
                       maxiter=maxiter)
        self.cg_iters.append(res.iters)
        q = res.x.reshape(-1, 2)
        vel = vel + self.spread(q, nodes, weights, n_nodes)
        return vel, q


class UnstructuredIBMCoupling(IBMCoupling):
    """Static bodies on a locally uniform unstructured region: not
    ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_UNSTRUCTURED)


class LatticeIBMCoupling(IBMCoupling):
    """Moving bodies on a locally uniform unstructured region: not
    ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_UNSTRUCTURED)
