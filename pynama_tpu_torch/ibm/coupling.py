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

On a Gmsh domain the fine grid is a locally uniform region of an
unstructured mesh at the spacing h = 'h-min' / (ngl - 1): for a static
body ``UnstructuredIBMCoupling`` finds each Lagrange point's window once
on the host; for a moving body ``LatticeIBMCoupling`` snaps the region
the body moves through onto a lattice once on the host, after which the
box-mesh window math runs on the device every step through a lattice ->
node table. Both inherit the operator applies.
"""

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from pynama_tpu_torch.device import resolve_device
from pynama_tpu_torch.ibm.diracs import KERNELS
from pynama_tpu_torch.mesh.structured import BoxMesh
from pynama_tpu_torch.solvers.cg import cg_solve

WIN = 6  # window size per axis


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
            raise NotImplementedError(
                "IBM coupling needs a structured box mesh for the "
                "on-device window computation; on unstructured gmsh "
                "domains use UnstructuredIBMCoupling (static) / "
                "LatticeIBMCoupling (moving)")
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


@dataclass
class UnstructuredIBMCoupling(IBMCoupling):
    """Static bodies on a locally uniform region of an unstructured
    (gmsh) mesh, at the kernel-support spacing ``h_min`` ('h-min' /
    (ngl - 1)).

    The discrete-delta identities (sum phi = 1, linear reproduction)
    hold only where the mesh is uniform at spacing h inside each Lagrange
    point's 4h x 4h support: windows_host checks that every window's
    weights sum to 1 within 1%. The windows are found once on the host
    (the node set has no grid to index on the device), so the body must
    not move; they are kept on ``device`` in ``dtype``.
    """

    h_min: float = None
    dtype: torch.dtype = torch.float64
    device: object = None

    def __post_init__(self):
        if self.mesh.dim != 2:
            raise NotImplementedError("IBM coupling is 2D (like the "
                                      "reference)")
        if self.h_min is None:
            raise ValueError("UnstructuredIBMCoupling needs h_min")
        self.h = float(self.h_min)
        self.phi = KERNELS[self.kernel]
        self.device = resolve_device(self.device)
        self.cg_iters: List[int] = []
        self._cache = None

    def windows_host(self, X):
        """The windows of the static Lagrange points X (L, 2), found on
        the host and cached.

        Every node inside the kernel's open 4h x 4h box around a point,
        in ascending id order, contributes phi(dx/h) phi(dy/h); weights
        of magnitude <= 1e-14 are dropped, and rows are padded to the
        longest with node 0 at weight 0. Returns (nodes (L, cap) int64,
        weights (L, cap)) on the coupling's device.
        """
        X = np.asarray(X, dtype=np.float64)
        coords = np.asarray(self.mesh.coords, dtype=np.float64)[:, :2]
        h = self.h
        sels, ds = [], []
        for x in X:
            d = (coords - x[None, :]) / h
            sel = np.flatnonzero((np.abs(d[:, 0]) < 2.0)
                                 & (np.abs(d[:, 1]) < 2.0))
            sels.append(sel)
            ds.append(d[sel])
        # one kernel evaluation of every (point, node) pair, split by row
        d = torch.as_tensor(np.concatenate(ds), dtype=torch.float64)
        w_all = (self.phi(d[:, 0]) * self.phi(d[:, 1])).numpy()
        nodes_l, weights_l = [], []
        for sel, w in zip(sels, np.split(w_all, np.cumsum(
                [len(s) for s in sels])[:-1])):
            keep = np.abs(w) > 1e-14
            nodes_l.append(sel[keep])
            weights_l.append(w[keep])
        rowsums = np.array([w.sum() for w in weights_l])
        bad = np.abs(rowsums - 1.0) > 1e-2
        if bad.any():
            raise ValueError(
                f"mesh is not locally uniform at spacing h={h:g} around "
                f"{int(bad.sum())}/{len(X)} Lagrange points (window "
                f"weight sums {rowsums[bad][:4]} != 1): refine the gmsh "
                f"region around the body uniformly or fix 'h-min'")
        cap = max(len(n) for n in nodes_l)
        nodes = np.zeros((len(nodes_l), cap), dtype=np.int64)
        weights = np.zeros((len(nodes_l), cap))
        for i, (n, w) in enumerate(zip(nodes_l, weights_l)):
            nodes[i, :len(n)] = n
            weights[i, :len(w)] = w
        self._cache = (
            torch.as_tensor(nodes, device=self.device),
            torch.as_tensor(weights, dtype=self.dtype, device=self.device))
        return self._cache

    def windows(self, X):
        """The cached windows (X is ignored: the body is static);
        windows_host must have run at setup."""
        if self._cache is None:
            raise RuntimeError(
                "UnstructuredIBMCoupling.windows_host(X) must run at "
                "setup (static bodies only on gmsh domains)")
        return self._cache


@dataclass
class LatticeIBMCoupling(IBMCoupling):
    """Moving bodies on a locally uniform region of an unstructured
    (gmsh) mesh.

    The uniform region the body moves through is snapped once, on the
    host, onto a virtual lattice of spacing h = ``h_min``; a dense
    lattice -> node id table (-1 where no node sits) on ``device`` then
    lets the box-mesh window math run on the device for any body
    position inside ``envelope``, the (lo, hi) box of every Lagrange
    point over the run. A moving body changes only values: the shapes
    stay fixed and nothing is read back to the host. Construction checks
    that every lattice site within the kernel's reach (2h) of the
    envelope holds a mesh node, so no window reads a missing site at a
    nonzero weight.
    """

    h_min: float = None
    envelope: tuple = None  # (lo (2,), hi (2,)) box the body stays inside
    device: object = None

    def __post_init__(self):
        if self.mesh.dim != 2:
            raise NotImplementedError("IBM coupling is 2D (like the "
                                      "reference)")
        if self.h_min is None or self.envelope is None:
            raise ValueError("LatticeIBMCoupling needs h_min and envelope")
        h = self.h = float(self.h_min)
        self.phi = KERNELS[self.kernel]
        self.device = resolve_device(self.device)
        self.cg_iters: List[int] = []
        lo = np.asarray(self.envelope[0], dtype=np.float64)
        hi = np.asarray(self.envelope[1], dtype=np.float64)
        # the lattice covers the kernel support (2h) around the envelope
        # and the window's slack ring (one more cell for floor() jitter)
        pad = (WIN // 2 + 1) * h
        coords = np.asarray(self.mesh.coords, dtype=np.float64)[:, :2]
        sel = np.flatnonzero(
            (coords[:, 0] >= lo[0] - pad) & (coords[:, 0] <= hi[0] + pad)
            & (coords[:, 1] >= lo[1] - pad) & (coords[:, 1] <= hi[1] + pad))
        if sel.size == 0:
            raise ValueError("no mesh nodes inside the IBM envelope")
        sub = coords[sel]
        origin = sub.min(axis=0)
        idx = np.rint((sub - origin[None, :]) / h).astype(np.int64)
        on_lattice = (np.abs(sub - (origin[None, :] + idx * h))
                      < 0.05 * h).all(axis=1)
        idx, lat_nodes = idx[on_lattice], sel[on_lattice]
        nx = int(idx[:, 0].max()) + 1
        ny = int(idx[:, 1].max()) + 1
        table = np.full((ny, nx), -1, dtype=np.int64)
        flat = idx[:, 1] * nx + idx[:, 0]
        if len(np.unique(flat)) != len(flat):
            raise ValueError(
                "two mesh nodes snapped to the same lattice site: the "
                "region around the body is not uniform at spacing "
                f"h={h:g} — fix 'h-min' or refine the gmsh region")
        table.reshape(-1)[flat] = lat_nodes
        # every site within 2h of the envelope (where kernel weights can
        # be nonzero) must hold a mesh node
        i_lo = np.floor((lo - 2 * h - origin) / h + 0.5).astype(int)
        i_hi = np.ceil((hi + 2 * h - origin) / h - 0.5).astype(int)
        out_of_table = int(np.maximum(-i_lo, 0).sum()
                           + np.maximum(i_hi - [nx - 1, ny - 1], 0).sum())
        i_lo = np.maximum(i_lo, 0)
        i_hi = np.minimum(i_hi, [nx - 1, ny - 1])
        core = table[i_lo[1]:i_hi[1] + 1, i_lo[0]:i_hi[0] + 1]
        n_missing = int((core < 0).sum()) + out_of_table
        if n_missing:
            raise ValueError(
                f"{n_missing} lattice sites within kernel "
                f"reach of the body envelope have no mesh node at "
                f"spacing h={h:g}: refine the gmsh region uniformly "
                "over the whole motion envelope (+2h) or fix 'h-min'")
        self.lower = origin
        self.npx, self.npy = nx, ny
        self._table = torch.as_tensor(table.reshape(-1), device=self.device)

    def windows(self, X):
        """The box windows on the lattice, mapped to global node ids on
        the device: a site without a node gets weight 0 and id 0."""
        lat_nodes, weights = IBMCoupling.windows(self, X)
        g = self._table[lat_nodes]
        weights = torch.where(g >= 0, weights, torch.zeros_like(weights))
        return torch.clamp(g, min=0), weights
