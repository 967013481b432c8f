"""Structured box mesh with closed-form GLL node numbering.

TPU-native replacement for PETSc DMPlex box meshes + Section-based FEM/SEM
indexing (upstream Pynama src/domain/dmplex.py:8-61,
upstream Pynama src/domain/indices.py:22-58). Instead of mesh-topology
queries at runtime, everything is precomputed into int32 connectivity
arrays at setup: cell->node tables, per-face boundary node sets, and node
coordinates — all device-ready.

Global node numbering is lexicographic over the fine GLL grid (x fastest):
a 2D box with nelem=(nx, ny) and ngl=N has (nx(N-1)+1) x (ny(N-1)+1) nodes,
node id = gy*Wx + gx. Local element nodes are lexicographic too, matching
pynama_tpu_torch.elements.spectral.

Face naming follows the reference convention (dmplex.py:37-40 and
common/nswalls.py:22-25): 2D ["down","right","up","left"],
3D adds "back" (z=lower) and "front" (z=upper); left/right = x, down/up = y.
"""

from dataclasses import dataclass, field
from functools import cached_property

import numpy as np

from pynama_tpu_torch.elements.quadrature import lobatto_points

FACE_NORMAL_AXIS_2D = {"left": 0, "right": 0, "down": 1, "up": 1}
FACE_NORMAL_AXIS_3D = {
    "left": 0, "right": 0, "down": 1, "up": 1, "back": 2, "front": 2,
}


@dataclass
class BoxMesh:
    """Uniform structured quad/hex mesh of GLL spectral elements."""

    nelem: tuple
    lower: tuple
    upper: tuple
    ngl: int

    def __post_init__(self):
        self.nelem = tuple(int(n) for n in self.nelem)
        self.lower = tuple(float(v) for v in self.lower)
        self.upper = tuple(float(v) for v in self.upper)
        self.dim = len(self.nelem)
        if self.dim not in (2, 3):
            raise ValueError("BoxMesh supports dim 2 or 3")
        if len(self.lower) != self.dim or len(self.upper) != self.dim:
            raise ValueError("lower/upper must match nelem dimension")
        self.dim_w = 1 if self.dim == 2 else 3
        self.dim_s = 3 if self.dim == 2 else 6
        N = self.ngl
        # nodes per axis on the fine GLL grid
        self.npts = tuple(n * (N - 1) + 1 for n in self.nelem)
        self.n_nodes = int(np.prod(self.npts))
        self.n_cells = int(np.prod(self.nelem))
        self.uniform = True
        self.face_names = (
            ["down", "right", "up", "left"]
            if self.dim == 2
            else ["back", "front", "down", "up", "right", "left"]
        )

    # ------------------------------------------------------------------
    @cached_property
    def cell2node(self):
        """(n_cells, ngl**dim) int32 global node ids, lexicographic."""
        N = self.ngl
        if self.dim == 2:
            nx, ny = self.nelem
            Wx = self.npts[0]
            ex, ey = np.meshgrid(np.arange(nx), np.arange(ny), indexing="xy")
            e_origin = (ey * (N - 1) * Wx + ex * (N - 1)).reshape(-1)  # e = ey*nx+ex
            lx, ly = np.meshgrid(np.arange(N), np.arange(N), indexing="xy")
            l_off = (ly * Wx + lx).reshape(-1)  # n = ly*N+lx
        else:
            nx, ny, nz = self.nelem
            Wx, Wy = self.npts[0], self.npts[1]
            ez, ey, ex = np.meshgrid(
                np.arange(nz), np.arange(ny), np.arange(nx), indexing="ij"
            )
            e_origin = (
                (ez * (N - 1) * Wy + ey * (N - 1)) * Wx + ex * (N - 1)
            ).reshape(-1)  # e = (ez*ny+ey)*nx+ex
            lz, ly, lx = np.meshgrid(
                np.arange(N), np.arange(N), np.arange(N), indexing="ij"
            )
            l_off = ((lz * Wy + ly) * Wx + lx).reshape(-1)
        return (e_origin[:, None] + l_off[None, :]).astype(np.int32)

    @cached_property
    def axis_coords(self):
        """Per-axis 1D fine-grid coordinates (tuple of arrays)."""
        gll, _ = lobatto_points(self.ngl)
        out = []
        for ax in range(self.dim):
            n_el = self.nelem[ax]
            h = (self.upper[ax] - self.lower[ax]) / n_el
            # element-local GLL points mapped to [0, h], drop duplicate ends
            loc = (gll + 1.0) * 0.5 * h
            xs = (self.lower[ax] + np.arange(n_el)[:, None] * h + loc[None, :-1]).reshape(-1)
            xs = np.append(xs, self.upper[ax])
            out.append(xs)
        return tuple(out)

    @cached_property
    def coords(self):
        """(n_nodes, dim) float64 node coordinates."""
        axes = self.axis_coords
        if self.dim == 2:
            X, Y = np.meshgrid(axes[0], axes[1], indexing="xy")
            return np.stack([X.reshape(-1), Y.reshape(-1)], axis=1)
        Z, Y, X = np.meshgrid(axes[2], axes[1], axes[0], indexing="ij")
        return np.stack([X.reshape(-1), Y.reshape(-1), Z.reshape(-1)], axis=1)

    @cached_property
    def cell_corners(self):
        """(n_cells, 2**dim, dim) corner coordinates (lexicographic corners)."""
        N = self.ngl
        corner_local = []
        if self.dim == 2:
            for cy in (0, N - 1):
                for cx in (0, N - 1):
                    corner_local.append(cy * N + cx)
        else:
            for cz in (0, N - 1):
                for cy in (0, N - 1):
                    for cx in (0, N - 1):
                        corner_local.append((cz * N + cy) * N + cx)
        return self.coords[self.cell2node[:, corner_local]]

    # ------------------------------------------------------------------
    # boundary topology
    # ------------------------------------------------------------------
    def _grid_index(self):
        """Per-axis integer grid coordinates of every node."""
        if self.dim == 2:
            Wx = self.npts[0]
            ids = np.arange(self.n_nodes)
            return ids % Wx, ids // Wx
        Wx, Wy = self.npts[0], self.npts[1]
        ids = np.arange(self.n_nodes)
        return ids % Wx, (ids // Wx) % Wy, ids // (Wx * Wy)

    @cached_property
    def face_nodes(self):
        """dict face-name -> sorted int32 array of node ids on that face."""
        g = self._grid_index()
        sel = {
            "left": g[0] == 0,
            "right": g[0] == self.npts[0] - 1,
            "down": g[1] == 0,
            "up": g[1] == self.npts[1] - 1,
        }
        if self.dim == 3:
            sel["back"] = g[2] == 0
            sel["front"] = g[2] == self.npts[2] - 1
        return {
            name: np.nonzero(mask)[0].astype(np.int32)
            for name, mask in sel.items()
        }

    @cached_property
    def boundary_nodes(self):
        """All boundary node ids, sorted int32.

        Parity: 'External Boundary' label, reference dmplex.py:27-28.
        """
        mask = np.zeros(self.n_nodes, dtype=bool)
        for nodes in self.face_nodes.values():
            mask[nodes] = True
        return np.nonzero(mask)[0].astype(np.int32)

    @property
    def face_normal_axis(self):
        return FACE_NORMAL_AXIS_2D if self.dim == 2 else FACE_NORMAL_AXIS_3D

    # ------------------------------------------------------------------
    # dof index tables (interleaved, node-major: dof = node*k + c)
    # ------------------------------------------------------------------
    def cell_dofs(self, k: int):
        """(n_cells, nnode*k) int32: interleaved dof ids for k comps/node."""
        c2n = self.cell2node.astype(np.int64)
        dofs = c2n[:, :, None] * k + np.arange(k)[None, None, :]
        return dofs.reshape(self.n_cells, -1).astype(np.int32)

    def node_dofs(self, nodes, k: int):
        """(len(nodes)*k,) int32 interleaved dof ids for the given nodes."""
        nodes = np.asarray(nodes, dtype=np.int64)
        dofs = nodes[:, None] * k + np.arange(k)[None, :]
        return dofs.reshape(-1).astype(np.int32)

    def nodes_over_line(self, axis: str, value: float):
        """Node ids (and their transverse coordinate) on the line axis=value.

        Parity: reference dmplex.py:335-345 (getNodesOverline), 2D only.
        """
        assert self.dim == 2 and axis in ("x", "y")
        dof, other = (0, 1) if axis == "x" else (1, 0)
        mask = np.isclose(self.coords[:, dof], value)
        nodes = np.nonzero(mask)[0]
        order = np.argsort(self.coords[nodes, other])
        nodes = nodes[order]
        return nodes.astype(np.int32), self.coords[nodes, other]
