"""Slab and pencil decomposition of a box mesh with explicit halo sums.

Port of pynama_tpu/parallel/slab.py on torch.distributed: one process
per rank (gloo on the CPU, NCCL on the card) instead of one device per
shard of a shard_map. The box mesh is split into equal element slabs
along its last axis (or pencils over its slowest grid axes). Each rank
owns a contiguous block of node planes per partitioned axis, and
overlaps each neighbour by exactly one plane, the shared
element-interface nodes:

  * element applies are rank-local (the local box is itself a box);
  * after an apply the interface planes hold partial sums, completed by
    a two-way neighbour exchange per partitioned axis (the halo sums,
    ``dist.batch_isend_irecv`` to the global neighbour ranks);
  * reductions (CG dots, RK error norms) weight each interface plane on
    one owner, device d-1, and all-reduce.

The decompositions are numpy and copied from the reference bit for bit.
A rank's place is ``np.unravel_index(rank, pgrid)`` (C order over pgrid,
the reference's ``device_mesh``); ``RankGrid`` carries it, its
neighbours and the counts of the collectives it ran.
"""

from collections import Counter
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from pynama_tpu_torch.mesh.structured import BoxMesh
from pynama_tpu_torch.solvers.cg import sumdot


def _plane_owner(row0, rows):
    """Owning device of each global node plane.

    Shared interface planes (first plane of device d > 0) belong to
    device d-1 — the owned_weights/owned_grid_weights convention.
    """
    row0 = np.asarray(row0)
    owner = np.searchsorted(row0, rows, side="right") - 1
    shared = (owner > 0) & (rows == row0[owner])
    return np.where(shared, owner - 1, owner)


@dataclass
class SlabDecomposition:
    """Element-slab partition of a BoxMesh over n_dev devices."""

    mesh: BoxMesh
    n_dev: int

    def __post_init__(self):
        m = self.mesh
        last = m.nelem[-1]
        if last % self.n_dev != 0:
            raise ValueError(
                f"nelem[-1]={last} must divide evenly over {self.n_dev} devices"
            )
        self.ne_loc = last // self.n_dev  # element planes per device
        N = m.ngl
        # nodes per fine-grid plane (all axes but the last)
        self.plane = int(np.prod(m.npts[:-1]))
        self.rows_loc = self.ne_loc * (N - 1) + 1  # node planes per device
        self.n_loc = self.plane * self.rows_loc
        # global node-plane start of each device block
        self.row0 = np.arange(self.n_dev) * self.ne_loc * (N - 1)
        # elements per device (contiguous: last axis is slowest in cell id)
        self.cells_loc = m.n_cells // self.n_dev

    # -- distribution of vectors ----------------------------------------
    def node_slices(self, k: int):
        """Global dof index block of each device for k dofs/node."""
        starts = self.row0 * self.plane * k
        length = self.n_loc * k
        return starts, length

    def to_local(self, x_global, k: int):
        """(n_nodes*k,) -> (P, n_loc*k) stacked overlapping blocks (host)."""
        x = np.asarray(x_global)
        starts, length = self.node_slices(k)
        return np.stack([x[s : s + length] for s in starts])

    def from_local(self, x_stacked, k: int):
        """(P, n_loc*k) -> (n_nodes*k,): drop the duplicated first plane."""
        xs = np.asarray(x_stacked)
        pk = self.plane * k
        parts = [xs[0]] + [xs[d][pk:] for d in range(1, self.n_dev)]
        return np.concatenate(parts)

    def local_cell_dofs(self, k: int):
        """(P, cells_loc, nnode*k) int32, device-local dof numbering."""
        g = np.asarray(self.mesh.cell_dofs(k))
        out = []
        for d in range(self.n_dev):
            cells = slice(d * self.cells_loc, (d + 1) * self.cells_loc)
            off = self.row0[d] * self.plane * k
            out.append(g[cells] - off)
        return np.stack(out).astype(np.int32)

    def owned_weights(self, k: int):
        """(P, n_loc*k): 1 on owned dofs, 0 on the duplicated first plane."""
        w = np.ones((self.n_dev, self.n_loc * k))
        w[1:, : self.plane * k] = 0.0
        return w

    # -- grid-shaped distribution ---------------------------------------
    @property
    def local_npts(self):
        """Local node counts, MESH-axis order (last axis = sliced)."""
        return tuple(self.mesh.npts[:-1]) + (self.rows_loc,)

    def local_grid_shape(self, k: int):
        """Local grid shape, GRID order (sliced axis slowest/first)."""
        return (self.rows_loc,) + tuple(reversed(self.mesh.npts[:-1])) + (k,)

    def to_local_grid(self, x_global, k: int):
        """(n_nodes*k,) -> (P, rows_loc, ..., k) stacked local grids."""
        g = np.asarray(x_global).reshape(
            tuple(reversed(self.mesh.npts)) + (k,)
        )
        return np.stack(
            [g[r0 : r0 + self.rows_loc] for r0 in self.row0]
        )

    def from_local_grid(self, x_stacked):
        """(P, rows_loc, ..., k) -> flat (n_nodes*k,), dedup first planes."""
        xs = np.asarray(x_stacked)
        parts = [xs[0]] + [xs[d][1:] for d in range(1, self.n_dev)]
        return np.concatenate(parts).reshape(-1)

    def owned_grid_weights(self, k: int):
        """(P, rows_loc, ..., k): 1 on owned planes, 0 on duplicated."""
        w = np.ones((self.n_dev,) + self.local_grid_shape(k))
        w[1:, 0] = 0.0
        return w

    def owner_field(self):
        """(n_nodes,) float: owning device index of every node.

        The analogue of the reference's createNumProcVec rank-ownership
        debug field — write it with io/vtk.py to inspect the partition
        visually. Shared interface planes belong to the lower device
        (owned_weights convention).
        """
        rows = np.arange(self.mesh.npts[-1])
        return np.repeat(_plane_owner(self.row0, rows).astype(np.float64),
                         self.plane)


@dataclass
class GridDecomposition:
    """N-D pencil partition of a BoxMesh over a device grid.

    pgrid[j] devices partition GRID axis j (slowest-first, i.e. grid axis
    0 = the LAST mesh axis); pgrid=(n,) reproduces the slab. Each device
    owns a contiguous block of node planes per partitioned axis with a
    one-plane overlap, so interface sums complete by one exchange per
    axis (halo_sum_blocked_axis) — sequential exchanges carry the
    edge/corner coupling.
    """

    mesh: BoxMesh
    pgrid: tuple

    def __post_init__(self):
        m = self.mesh
        self.naxes = len(self.pgrid)
        if self.naxes > m.dim:
            raise ValueError("more partitioned axes than mesh dimensions")
        N = m.ngl
        self.ne_loc = []
        self.rows_loc = []
        self.row0 = []
        for j, p in enumerate(self.pgrid):
            nel = m.nelem[m.dim - 1 - j]  # grid axis j = mesh axis dim-1-j
            if nel % p != 0:
                raise ValueError(
                    f"nelem[{m.dim - 1 - j}]={nel} must divide evenly "
                    f"over {p} devices (grid axis {j})"
                )
            ne = nel // p
            self.ne_loc.append(ne)
            self.rows_loc.append(ne * (N - 1) + 1)
            self.row0.append(np.arange(p) * ne * (N - 1))

    @property
    def local_npts(self):
        """Local node counts, MESH-axis order."""
        npts = list(self.mesh.npts)
        for j in range(self.naxes):
            npts[self.mesh.dim - 1 - j] = self.rows_loc[j]
        return tuple(npts)

    @property
    def local_nelem(self):
        nel = list(self.mesh.nelem)
        for j in range(self.naxes):
            nel[self.mesh.dim - 1 - j] = self.ne_loc[j]
        return tuple(nel)

    def local_grid_shape(self, k: int):
        return tuple(reversed(self.local_npts)) + (k,)

    def owner_field(self):
        """(n_nodes,) float: linear owning-device index of every node.

        Pencil analogue of SlabDecomposition.owner_field: per partitioned
        grid axis the plane owner is computed with the
        shared-plane-to-lower convention, then axis owners combine
        row-major in pgrid order (matching np.ndindex(*pgrid) device
        linearization).
        """
        gshape = tuple(reversed(self.mesh.npts))
        lin = np.zeros(gshape, dtype=np.int64)
        for j, p in enumerate(self.pgrid):
            rows = np.arange(gshape[j])
            own = _plane_owner(self.row0[j], rows)
            bshape = [1] * len(gshape)
            bshape[j] = gshape[j]
            lin = lin * p + own.reshape(bshape)
        return lin.reshape(-1).astype(np.float64)

    def to_local_grid(self, x_global, k: int):
        """flat global -> (pgrid..., local_grid...) stacked local grids."""
        g = np.asarray(x_global).reshape(
            tuple(reversed(self.mesh.npts)) + (k,)
        )
        out = np.empty(tuple(self.pgrid) + self.local_grid_shape(k),
                       dtype=g.dtype)
        for didx in np.ndindex(*self.pgrid):
            sl = [slice(None)] * g.ndim
            for j, d in enumerate(didx):
                sl[j] = slice(self.row0[j][d],
                              self.row0[j][d] + self.rows_loc[j])
            out[didx] = g[tuple(sl)]
        return out

    def from_local_grid(self, x_stacked):
        """Inverse of to_local_grid (drops duplicated first planes)."""
        xs = np.asarray(x_stacked)
        gshape = tuple(reversed(self.mesh.npts)) + xs.shape[-1:]
        g = np.empty(gshape, dtype=xs.dtype)
        for didx in np.ndindex(*self.pgrid):
            src = [slice(None)] * (len(gshape))
            dst = [slice(None)] * (len(gshape))
            for j, d in enumerate(didx):
                lo = 0 if d == 0 else 1
                src[j] = slice(lo, self.rows_loc[j])
                dst[j] = slice(self.row0[j][d] + lo,
                               self.row0[j][d] + self.rows_loc[j])
            g[tuple(dst)] = xs[didx][tuple(src)]
        return g.reshape(-1)

    def owned_grid_weights(self, k: int):
        """(pgrid..., local_grid...): 1 on owned planes, 0 on duplicated."""
        w = np.ones(tuple(self.pgrid) + self.local_grid_shape(k))
        for j, p in enumerate(self.pgrid):
            if p == 1:
                continue
            idx = [slice(None)] * w.ndim
            idx[j] = slice(1, None)            # devices > 0 on this axis
            idx[self.naxes + j] = 0            # their first local plane
            w[tuple(idx)] = 0.0
        return w


class RankGrid:
    """This process's place in a C-ordered grid of ranks over ``pgrid``.

    ``group``: the process group (None: the default group), whose size
    must be prod(pgrid). ``coords`` is np.unravel_index(rank, pgrid);
    ``counts`` counts the collectives this rank ran through the
    functions below ("all_reduce", "all_gather", and "halo", one a
    neighbour exchange along one axis).
    """

    def __init__(self, pgrid, group=None):
        self.pgrid = tuple(int(p) for p in pgrid)
        self.group = group
        self.rank = dist.get_rank(group)
        size = dist.get_world_size(group)
        if size != int(np.prod(self.pgrid)):
            raise ValueError(f"process group of {size} ranks for a "
                             f"{self.pgrid} device grid")
        self.coords = tuple(int(c) for c in
                            np.unravel_index(self.rank, self.pgrid))
        self.counts = Counter()

    def _global(self, coords):
        r = int(np.ravel_multi_index(coords, self.pgrid))
        return r if self.group is None else dist.get_global_rank(
            self.group, r)

    def neighbours(self, axis):
        """Global ranks (below, above) along ``axis``; None at an end."""
        c = self.coords[axis]
        out = []
        for step in (-1, 1):
            if 0 <= c + step < self.pgrid[axis]:
                nb = list(self.coords)
                nb[axis] = c + step
                out.append(self._global(tuple(nb)))
            else:
                out.append(None)
        return tuple(out)

    def all_reduce(self, s):
        """Sum a tensor over the ranks, in place; returns it."""
        dist.all_reduce(s, group=self.group)
        self.counts["all_reduce"] += 1
        return s

    def all_gather(self, x):
        """Every rank's ``x``, in rank order."""
        parts = [torch.empty_like(x) for _ in range(
            dist.get_world_size(self.group))]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        self.counts["all_gather"] += 1
        return parts


def exchange(lo, hi, ranks: RankGrid, axis):
    """(from_above, from_below): ``lo`` goes to the rank below along
    ``axis``, ``hi`` to the rank above; what each neighbour sent back,
    None where there is no neighbour. The send buffers are read before
    this returns, so the caller may then write into them."""
    below, above = ranks.neighbours(axis)
    ops, from_above, from_below = [], None, None
    if below is not None:
        from_below = hi.new_empty(hi.shape)
        ops += [dist.P2POp(dist.isend, lo.contiguous(), below, ranks.group),
                dist.P2POp(dist.irecv, from_below, below, ranks.group)]
    if above is not None:
        from_above = lo.new_empty(lo.shape)
        ops += [dist.P2POp(dist.isend, hi.contiguous(), above, ranks.group),
                dist.P2POp(dist.irecv, from_above, above, ranks.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    ranks.counts["halo"] += 1
    return from_above, from_below


def _add_planes(x, lo_idx, hi_idx, ranks, axis):
    """x[hi] += from_above, then x[lo] += from_below, in place (each
    absent neighbour adds nothing); returns x."""
    from_above, from_below = exchange(x[lo_idx], x[hi_idx], ranks, axis)
    if from_above is not None:
        x[hi_idx] += from_above
    if from_below is not None:
        x[lo_idx] += from_below
    return x


# ----------------------------------------------------------------------
# the halo sums: each completes the interface-plane partial sums of a
# freshly applied local tensor IN PLACE (pass a tensor you own) and
# returns it
# ----------------------------------------------------------------------
def halo_sum(x_loc, plane_k: int, ranks: RankGrid):
    """Complete interface-plane partial sums with both neighbours.

    x_loc: (n_loc*k,) local post-scatter vector. The first plane_k
    entries duplicate the lower neighbour's last plane; symmetric for
    the last.
    """
    if ranks.pgrid[0] == 1:
        return x_loc
    n = x_loc.shape[0]
    return _add_planes(x_loc, slice(0, plane_k), slice(n - plane_k, n),
                       ranks, 0)


def local_element_apply(op, x_loc, plane_k, ranks: RankGrid):
    """Distributed ElementOp apply: the rank's local ElementOp (its
    elements, local dof numbering: ``SlabDecomposition.local_cell_dofs``;
    a contributor-table scatter, ops/assembly.py) + halo_sum."""
    return halo_sum(op(x_loc), plane_k, ranks)


def halo_sum_grid(x, ranks: RankGrid):
    """halo_sum for GRID-shaped local state (rows_loc, ..., k): the
    first/last node planes along grid axis 0 are the interface planes."""
    return halo_sum_grid_axis(x, 0, ranks)


def halo_sum_grid_axis(x, grid_axis: int, ranks: RankGrid):
    """halo_sum for GRID-shaped local state along one partitioned axis."""
    if ranks.pgrid[grid_axis] == 1:
        return x

    def plane(block):
        idx = [slice(None)] * x.dim()
        idx[grid_axis] = block
        return tuple(idx)

    return _add_planes(x, plane(0), plane(x.shape[grid_axis] - 1), ranks,
                       grid_axis)


def halo_sum_blocked_axis(xb, P: int, dim: int, grid_axis: int,
                          ranks: RankGrid):
    """Complete interface partial sums along ONE partitioned grid axis of
    a parity-blocked tensor (B0..Bd-1, P^dim*k).

    Grid plane r on axis a lives at (block r//P, sub r%P); the interface
    planes are (block 0, sub 0) and (block B_a-1, sub 0), strided slots
    of the edge blocks. On a multi-axis rank grid apply once per
    partitioned axis in sequence: the second exchange carries the
    first's corner contributions.
    """
    if ranks.pgrid[grid_axis] == 1:
        return xb
    B = tuple(xb.shape[:dim])
    k = xb.shape[-1] // P**dim
    xr = xb.view(B + (P,) * dim + (k,))

    def plane_idx(block):
        idx = [slice(None)] * xr.dim()
        idx[grid_axis] = block
        idx[dim + grid_axis] = 0
        return tuple(idx)

    _add_planes(xr, plane_idx(0), plane_idx(B[grid_axis] - 1), ranks,
                grid_axis)
    return xb


def halo_sum_blocked(xb, plane_c: int, ranks: RankGrid):
    """halo_sum for parity-BLOCKED slab state (B0, ..., P^dim*k): the
    interface planes are the first ``plane_c = P^(dim-1)*k`` channels of
    blocks 0 and B0-1 (pad slots sit at sub > 0 and are untouched)."""
    if ranks.pgrid[0] == 1:
        return xb
    return _add_planes(xb, (0, Ellipsis, slice(0, plane_c)),
                       (xb.shape[0] - 1, Ellipsis, slice(0, plane_c)),
                       ranks, 0)


def make_pdot(w_owned, ranks: RankGrid):
    """Distributed dot: interface planes counted once, summed over ranks.
    The local sum is cg.sumdot's (torch.dot) of a and w_owned * b, so on
    one rank, where w_owned is 1 on every real dof, it is bitwise the
    single-device dot."""

    def pdot(a, b):
        return ranks.all_reduce(sumdot(a, b * w_owned))

    return pdot


def make_pnorm_mean(w_owned, n_global, ranks: RankGrid):
    """Distributed RMS norm over owned dofs (for RK error control)."""

    def norm_mean(e2):
        s = ranks.all_reduce(torch.sum(e2 * w_owned))
        return torch.sqrt(s / n_global)

    return norm_mean
