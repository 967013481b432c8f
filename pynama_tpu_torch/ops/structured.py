"""Elemental operators on uniform structured grids.

Port of pynama_tpu/ops/structured.py (conv path). An operator with one
shared elemental matrix A on a uniform box mesh is applied as a blocked
stencil contraction (ops/conv.py); ``grid_gather`` / ``grid_scatter_add``
give the element-wise view used by ``diagonal()`` and the grid-path
multigrid transfers, here as plain indexing and a scatter-add through
a contributor table (ops/assembly.py): cells share their boundary nodes,
and on CUDA ``index_add_``'s atomics summed those in a different order
from call to call (tests/test_torch_cuda.py), where the table sums each
node's values in one fixed order, on every call and device alike.
"""

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from pynama_tpu_torch.ops import conv
from pynama_tpu_torch.ops.assembly import contributor_table, scatter_add


def pick_super_factor(nelem, ngl, dim):
    """Super-blocking factor f: the contraction runs on a lattice of
    f^dim-element cells, (f*P)^dim*k channels (128 for Q2 2D velocity at
    f=4) instead of the parity layout's P^dim*k. Exact re-indexing of the
    same operator (ops/conv.py rebase_conv_kernel). f=1 when parity
    channels already reach 64 or no admissible divisor of nelem exists.
    """
    P = ngl - 1
    if P**dim >= 64:
        return 1
    cands = [f for f in range(2, 9)
             if all(n % f == 0 for n in nelem) and (f * P)**dim <= 256]
    if not cands:
        return 1
    good = [f for f in cands if (f * P)**dim >= 64]
    return min(good) if good else max(cands)


@lru_cache(maxsize=64)
def _cell_node_index(N, ncells, step, offset, grid_pts):
    """(n_cells, N**dim) flat node ids of each cell's local nodes.

    Cell c = lexicographic over ``ncells`` (x fastest); local node
    lexicographic (x fastest); node (axis a) = offset[a] + l_a + c_a*step
    on a node grid of shape ``grid_pts`` (slowest axis first).
    """
    dim = len(ncells)
    nc_rev = tuple(reversed(ncells))
    off_rev = np.asarray(tuple(reversed(offset)), dtype=np.int64)
    cells = np.stack(np.meshgrid(*[np.arange(n) for n in nc_rev],
                                 indexing="ij"), -1).reshape(-1, dim)
    loc = np.stack(np.meshgrid(*([np.arange(N)] * dim), indexing="ij"),
                   -1).reshape(-1, dim)
    pos = off_rev + cells[:, None, :] * step + loc[None, :, :]
    return np.ravel_multi_index(tuple(pos[..., a] for a in range(dim)),
                                grid_pts)


def _index(grid, N, ncells, step, offset):
    idx = _cell_node_index(N, tuple(ncells), step, tuple(offset),
                           tuple(grid.shape[:-1]))
    return torch.as_tensor(idx, device=grid.device)


@lru_cache(maxsize=64)
def _cell_node_table(N, ncells, step, offset, grid_pts):
    """The contributor table of _cell_node_index's ids."""
    return contributor_table(
        _cell_node_index(N, ncells, step, offset, grid_pts),
        int(np.prod(grid_pts)))


def grid_gather(grid, N, ncells, step, offset):
    """Element-local nodal values (n_cells, N**dim * k) from a node grid
    (..., k) whose axes are slowest-first; local node lexicographic (x
    fastest), dof node-major."""
    k = grid.shape[-1]
    idx = _index(grid, N, ncells, step, offset)
    return grid.reshape(-1, k)[idx].reshape(idx.shape[0], -1)


def grid_scatter_add(out_grid, vals, N, ncells, step, offset):
    """Adjoint of grid_gather: out_grid + assembled (n_cells, N**dim*k)."""
    k = out_grid.shape[-1]
    table = _cell_node_table(N, tuple(ncells), step, tuple(offset),
                             tuple(out_grid.shape[:-1]))
    out = scatter_add(vals.reshape(-1, k),
                      torch.as_tensor(table, device=out_grid.device))
    return out_grid + out.reshape(out_grid.shape)


class StructuredElementOp:
    """y = scatter(A @ gather(x)) on a uniform box mesh.

    A: (nnode*k_out, nnode*k_in) elemental matrix, a tensor whose device
    and dtype the apply uses. sb: super-blocking factor of the blocked
    layout (nelem % sb == 0 on every axis); A stays the ELEMENT matrix.
    """

    def __init__(self, A, ngl: int, nelem: Tuple[int, ...],
                 npts: Tuple[int, ...], k_in: int, k_out: int, sb: int = 1):
        self.A = A
        self.ngl = ngl
        self.nelem = tuple(nelem)
        self.npts = tuple(npts)
        self.k_in = k_in
        self.k_out = k_out
        self.sb = sb
        self._kern = None

    def _grid_shape(self, k):
        return tuple(reversed(self.npts)) + (k,)

    def __call__(self, x):
        """Layout-polymorphic apply: blocked, grid or flat in, same out."""
        flat = x.dim() == 1
        if not flat and tuple(x.shape) == self.blocked_shape_in:
            return self.apply_blocked(x)
        grid = x.reshape(self._grid_shape(self.k_in)) if flat else x
        W, corr = self._kernels()
        out = conv.conv_stencil_apply(grid, W, corr, self.eff_ngl,
                                      self.npts_grid, self.k_out)
        return out.reshape(-1) if flat else out

    def _kernels(self):
        """(W, corrections) as tensors on A's device, built once."""
        if self._kern is None:
            np_dtype = torch.empty((), dtype=self.A.dtype).numpy().dtype
            A = self.A.detach().cpu().numpy()
            W, corr = conv.build_conv_kernels(A, self.ngl, len(self.nelem),
                                              self.k_out, self.k_in, np_dtype)
            if self.sb > 1:
                W, corr = conv.rebase_kernels(W, corr, self.sb,
                                              len(self.nelem), self.k_in,
                                              self.k_out, self.ngl)
            self._kern = conv.kernels_to(W, corr, self.A.device, self.A.dtype)
        return self._kern

    # -- blocked layout (hot-loop) interface ----------------------------
    @property
    def npts_grid(self):
        return tuple(reversed(self.npts))

    @property
    def eff_ngl(self):
        """Blocked-layout period + 1: ngl for sb=1, sb*(ngl-1)+1 super."""
        return self.sb * (self.ngl - 1) + 1

    @property
    def blocked_shape_in(self):
        return conv.blocked_shape(self.eff_ngl, self.npts_grid, self.k_in)

    def to_blocked(self, grid):
        return conv.to_blocked(grid, self.eff_ngl)

    def from_blocked(self, xb):
        return conv.from_blocked(xb, self.eff_ngl, self.npts_grid)

    def apply_blocked(self, xb, corrections=True):
        """Blocked-in/blocked-out apply (pad slots zeroed on output).

        corrections=False skips the phantom-cell boundary corrections —
        valid when the caller masks out every boundary row and column.
        """
        W, corr = self._kernels()
        return conv.conv_stencil_apply_blocked(
            xb, W, corr if corrections else (), self.eff_ngl,
            self.npts_grid, self.k_out,
        )

    def diagonal(self):
        """Assembled diagonal, flat (n_nodes*k_out,)."""
        N = self.ngl
        d = torch.diagonal(self.A)
        nE = int(np.prod(self.nelem))
        de = d.expand(nE, d.shape[0])
        out = torch.zeros(self._grid_shape(self.k_out), dtype=self.A.dtype,
                          device=self.A.device)
        out = grid_scatter_add(out, de, N, self.nelem, N - 1,
                               (0,) * len(self.nelem))
        return out.reshape(-1)
