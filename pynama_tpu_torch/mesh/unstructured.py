"""Unstructured 2D quad and 3D hex GLL meshes (the Gmsh import path).

Port of pynama_tpu/mesh/unstructured.py (numpy, host side). Upstream
Pynama's DMPlexDom with a gmsh file (src/domain/dmplex.py:22-23, 66-95
computeFullCoordinates) + Section-based high-order numbering
(indices.py). Numbering comes from the meshcore library (or its Python
mirror, mesh/native.py); high-order node coordinates come from the
bilinear (trilinear) corner map evaluated at GLL points, like upstream's
HCoo interpolation.
"""

from functools import cached_property
from typing import Dict

import numpy as np

from pynama_tpu_torch.elements.quadrature import lobatto_points
from pynama_tpu_torch.mesh.native import (
    hex_highorder_numbering,
    quad_highorder_numbering,
)


def _box_wall_groups(points, boundary_elems, named, walls, nodes_of):
    """Geometric wall classification for unnamed boundaries.

    When a gmsh file carries no standard wall names, boundary elements
    whose corners all lie on one face of the axis-aligned bounding box
    (within 1e-9 of the extent) are grouped into that wall's standard
    name (left/right/down/up[/back/front], same convention as
    BoxMesh.face_nodes) so named-wall cases run unchanged. No-op when
    any standard name is already present (physical groups win).
    """
    if not len(boundary_elems):
        return {}
    std = {w[0] for w in walls}
    if std & set(named):
        return {}
    pts = np.asarray(points)
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    tol = 1e-9 * float(np.max(hi - lo) or 1.0)
    corners = pts[np.asarray(boundary_elems)]      # (nb, nc, dim)
    out = {}
    for name, ax, side in walls:
        val = (lo if side == 0 else hi)[ax]
        on = np.all(np.abs(corners[..., ax] - val) <= tol, axis=1)
        if on.any():
            out[name] = nodes_of(np.asarray(boundary_elems)[on])
    return out


class UnstructuredQuadMesh:
    """2D quad spectral-element mesh from corner connectivity."""

    def __init__(self, points, quads_ccw, ngl, boundary_lines=None):
        """points (nv,2); quads_ccw (nc,4) gmsh counterclockwise corners;
        boundary_lines: dict name -> (nl,2) corner-id pairs."""
        self.dim = 2
        self.dim_w = 1
        self.dim_s = 3
        self.ngl = int(ngl)
        self.uniform = False
        points = np.asarray(points, dtype=np.float64)
        quads_ccw = np.asarray(quads_ccw, dtype=np.int64)
        # gmsh ccw (v0,v1,v2,v3) -> lexicographic (v0,v1,v3,v2)
        self._corners_lex = quads_ccw[:, [0, 1, 3, 2]]
        self._corner_coords = points
        self.n_cells = len(quads_ccw)

        c2n, n_nodes, edge_pairs = quad_highorder_numbering(
            self._corners_lex, len(points), self.ngl)
        self.cell2node = c2n.astype(np.int32)
        self.n_nodes = n_nodes
        self._edge_pairs = edge_pairs
        self._boundary_lines = boundary_lines or {}

    @classmethod
    def from_gmsh(cls, path, ngl):
        from pynama_tpu_torch.mesh.gmsh import read_msh

        data = read_msh(path)
        return cls(data.points, data.quads, ngl,
                   boundary_lines=data.boundary_lines)

    # ------------------------------------------------------------------
    @cached_property
    def coords(self):
        """(n_nodes, 2): corners, straight-edge GLL nodes, bilinear interior.

        Parity: computeFullCoordinates (dmplex.py:66-95) — corner-based
        (bilinear) geometry interpolated at GLL points.
        """
        N = self.ngl
        gll, _ = lobatto_points(N)
        t = (gll[1:-1] + 1.0) / 2.0  # edge parameters in (0,1)
        nv = len(self._corner_coords)
        ni = N - 2
        n_edges = len(self._edge_pairs)
        out = np.empty((self.n_nodes, 2))
        out[:nv] = self._corner_coords
        if n_edges:
            lo = self._corner_coords[self._edge_pairs[:, 0]]  # (ne,2)
            hi = self._corner_coords[self._edge_pairs[:, 1]]
            edge_nodes = (lo[:, None, :]
                          + t[None, :, None] * (hi - lo)[:, None, :])
            out[nv : nv + n_edges * ni] = edge_nodes.reshape(-1, 2)
        if ni > 0:
            # interior: bilinear map at (tx, ty)
            tx, ty = np.meshgrid(t, t, indexing="xy")  # (ni, ni), x fastest
            w00 = ((1 - tx) * (1 - ty)).reshape(-1)
            w10 = (tx * (1 - ty)).reshape(-1)
            w01 = ((1 - tx) * ty).reshape(-1)
            w11 = (tx * ty).reshape(-1)
            c = self._corner_coords[self._corners_lex]  # (nc, 4, 2)
            interior = (
                w00[None, :, None] * c[:, 0, None, :]
                + w10[None, :, None] * c[:, 1, None, :]
                + w01[None, :, None] * c[:, 2, None, :]
                + w11[None, :, None] * c[:, 3, None, :]
            )  # (nc, ni*ni, 2)
            out[nv + n_edges * ni :] = interior.reshape(-1, 2)
        return out

    @cached_property
    def cell_corners(self):
        return self._corner_coords[self._corners_lex]

    # -- boundary topology -------------------------------------------------
    @cached_property
    def _edge_lookup(self):
        nv = len(self._corner_coords)
        return {
            (int(lo), int(hi)): k
            for k, (lo, hi) in enumerate(self._edge_pairs)
        }

    def _line_nodes(self, pairs):
        """All GLL node ids on the given corner-pair boundary lines."""
        N, ni = self.ngl, self.ngl - 2
        nv = len(self._corner_coords)
        nodes = set()
        for a, b in pairs:
            a, b = int(a), int(b)
            nodes.add(a)
            nodes.add(b)
            lo, hi = (a, b) if a < b else (b, a)
            eid = self._edge_lookup.get((lo, hi))
            if eid is not None:
                base = nv + eid * ni
                nodes.update(range(base, base + ni))
        return np.asarray(sorted(nodes), dtype=np.int32)

    @cached_property
    def _boundary_pairs(self):
        """(nb, 2) corner pairs of edges referenced by exactly one cell."""
        counts = {}
        for cell in self._corners_lex:
            for ia, ib in ((0, 1), (2, 3), (0, 2), (1, 3)):
                a, b = int(cell[ia]), int(cell[ib])
                key = (a, b) if a < b else (b, a)
                counts[key] = counts.get(key, 0) + 1
        pairs = [k for k, v in counts.items() if v == 1]
        return np.asarray(pairs, dtype=np.int64)

    @cached_property
    def face_nodes(self) -> Dict[str, np.ndarray]:
        """Named boundary node groups.

        Primary: Gmsh physical-group names (mesh/gmsh.py), the analogue
        of upstream's per-border labels from mesh metadata
        (dmplex.py:113-131). Fallback when the file ships no standard
        wall names: boundary edges lying on the axis-aligned bounding
        box are classified geometrically into left/right/down/up so
        named-wall cases (cavity) run on unnamed gmsh box meshes; edges
        off the box (curved boundaries) keep their original group.
        """
        named = {
            name: self._line_nodes(pairs)
            for name, pairs in self._boundary_lines.items()
        }
        named.update(_box_wall_groups(
            self._corner_coords, self._boundary_pairs, named,
            (("left", 0, 0), ("right", 0, 1), ("down", 1, 0), ("up", 1, 1)),
            self._line_nodes,
        ))
        return named

    @cached_property
    def boundary_nodes(self):
        """All boundary nodes: edges referenced by exactly one cell.

        Parity: markBoundaryFaces 'External Boundary' (dmplex.py:27-28).
        """
        return self._line_nodes(self._boundary_pairs)

    @cached_property
    def corner_interp(self):
        """(cols, wts): per-GLL-node corner interpolation, <=4 entries.

        The bilinear corner->node geometry map (same weights as coords)
        as an explicit table — the Q1 coarse space for the two-level
        Schwarz preconditioner (solvers/schwarz.py). Unused slots carry
        weight 0 on corner 0.
        """
        N = self.ngl
        ni = N - 2
        gll, _ = lobatto_points(N)
        t = (gll[1:-1] + 1.0) / 2.0
        nv = len(self._corner_coords)
        ne = len(self._edge_pairs)
        cols = np.zeros((self.n_nodes, 4), dtype=np.int64)
        wts = np.zeros((self.n_nodes, 4))
        cols[:nv, 0] = np.arange(nv)
        wts[:nv, 0] = 1.0
        if ni and ne:
            rows = nv + np.arange(ne * ni).reshape(ne, ni)
            cols[rows, 0] = self._edge_pairs[:, :1]
            cols[rows, 1] = self._edge_pairs[:, 1:]
            wts[rows, 0] = 1.0 - t
            wts[rows, 1] = t
        if ni:
            i0 = nv + ne * ni
            tx, ty = np.meshgrid(t, t, indexing="xy")  # x fastest
            tx, ty = tx.reshape(-1), ty.reshape(-1)
            w = np.stack([(1 - tx) * (1 - ty), tx * (1 - ty),
                          (1 - tx) * ty, tx * ty], axis=1)  # lex corners
            rows = i0 + np.arange(self.n_cells * ni * ni)
            cols[rows] = np.repeat(self._corners_lex, ni * ni, axis=0)
            wts[rows] = np.tile(w, (self.n_cells, 1))
        return cols, wts

    def nodes_over_line(self, axis: str, value: float):
        """Node ids (and transverse coordinate) on the line axis=value.

        Parity: getNodesOverline works on any DMPlex mesh
        (upstream dmplex.py:335-345); coordinate-based, so it needs no
        grid structure — nodes within 1e-8 of the line, sorted by the
        transverse coordinate (line probes for profiles/plots).
        """
        assert axis in ("x", "y")
        dof, other = (0, 1) if axis == "x" else (1, 0)
        mask = np.isclose(self.coords[:, dof], value)
        nodes = np.nonzero(mask)[0]
        order = np.argsort(self.coords[nodes, other])
        nodes = nodes[order]
        return nodes.astype(np.int32), self.coords[nodes, other]

    # -- dof helpers (same layout as BoxMesh) ------------------------------
    def cell_dofs(self, k: int):
        c2n = self.cell2node.astype(np.int64)
        dofs = c2n[:, :, None] * k + np.arange(k)[None, None, :]
        return dofs.reshape(self.n_cells, -1).astype(np.int32)

    def node_dofs(self, nodes, k: int):
        nodes = np.asarray(nodes, dtype=np.int64)
        dofs = nodes[:, None] * k + np.arange(k)[None, :]
        return dofs.reshape(-1).astype(np.int32)


class UnstructuredHexMesh:
    """3D hexahedral spectral-element mesh from corner connectivity.

    Parity: upstream accepts any Gmsh mesh through DMPlex
    (upstream src/domain/dmplex.py:16-23) with dimension-generic
    high-order numbering (indices.py:22-122). Shared edges and faces are
    deduplicated with orientation canonicalization in
    hex_highorder_numbering; geometry is trilinear (corner-based), like
    upstream's HCoo corner interpolation (dmplex.py:66-95).
    """

    def __init__(self, points, hexes_gmsh, ngl, boundary_quads=None):
        """points (nv,3); hexes_gmsh (nc,8) gmsh corner order (bottom quad
        ccw 0-3, top quad ccw 4-7); boundary_quads: dict name -> (nq,4)
        ccw corner-id quads on the boundary surfaces."""
        self.dim = 3
        self.dim_w = 3
        self.dim_s = 6
        self.ngl = int(ngl)
        self.uniform = False
        points = np.asarray(points, dtype=np.float64)
        hexes = np.asarray(hexes_gmsh, dtype=np.int64)
        # gmsh (v0..v7) -> lexicographic (x fastest, then y, then z)
        self._corners_lex = hexes[:, [0, 1, 3, 2, 4, 5, 7, 6]]
        self._corner_coords = points
        self.n_cells = len(hexes)

        c2n, n_nodes, edge_pairs, face_quads = hex_highorder_numbering(
            self._corners_lex, len(points), self.ngl
        )
        self.cell2node = c2n.astype(np.int32)
        self.n_nodes = n_nodes
        self._edge_pairs = edge_pairs
        self._face_quads = face_quads  # rows [anchor, u, v, diag]
        self._boundary_quads = boundary_quads or {}

    @classmethod
    def from_gmsh(cls, path, ngl):
        from pynama_tpu_torch.mesh.gmsh import read_msh

        data = read_msh(path)
        if data.hexes is None or not len(data.hexes):
            raise ValueError(f"{path} contains no hexahedra")
        return cls(data.points, data.hexes, ngl,
                   boundary_quads=data.boundary_quads)

    # ------------------------------------------------------------------
    @cached_property
    def coords(self):
        """(n_nodes, 3): corners, linear edges, bilinear faces, trilinear
        interior — GLL points of the corner (trilinear) geometry map."""
        N = self.ngl
        gll, _ = lobatto_points(N)
        t = (gll[1:-1] + 1.0) / 2.0  # interior edge parameters in (0,1)
        nv = len(self._corner_coords)
        ni = N - 2
        ne = len(self._edge_pairs)
        nf = len(self._face_quads)
        out = np.empty((self.n_nodes, 3))
        out[:nv] = self._corner_coords
        if ni > 0 and ne:
            lo = self._corner_coords[self._edge_pairs[:, 0]]
            hi = self._corner_coords[self._edge_pairs[:, 1]]
            edge_nodes = (lo[:, None, :]
                          + t[None, :, None] * (hi - lo)[:, None, :])
            out[nv : nv + ne * ni] = edge_nodes.reshape(-1, 3)
        if ni > 0 and nf:
            # face interiors: bilinear in the canonical (u, v) frame,
            # storage (j-1)*ni + (i-1) with i (u) fastest
            A = self._corner_coords[self._face_quads[:, 0]]
            U = self._corner_coords[self._face_quads[:, 1]]
            V = self._corner_coords[self._face_quads[:, 2]]
            D = self._corner_coords[self._face_quads[:, 3]]
            ti, tj = np.meshgrid(t, t, indexing="xy")  # (ni, ni), i fastest
            s = ti.reshape(-1)[None, :, None]
            r = tj.reshape(-1)[None, :, None]
            face_nodes = ((1 - s) * (1 - r) * A[:, None, :]
                          + s * (1 - r) * U[:, None, :]
                          + (1 - s) * r * V[:, None, :]
                          + s * r * D[:, None, :])
            f0 = nv + ne * ni
            out[f0 : f0 + nf * ni * ni] = face_nodes.reshape(-1, 3)
        if ni > 0:
            # interior: trilinear at (tx, ty, tz), x fastest / z slowest
            tx = np.tile(t, ni * ni)
            ty = np.tile(np.repeat(t, ni), ni)
            tz = np.repeat(t, ni * ni)
            w = np.empty((8, ni**3))
            for k in range(8):
                bx, by, bz = k & 1, (k >> 1) & 1, (k >> 2) & 1
                w[k] = ((tx if bx else 1 - tx) * (ty if by else 1 - ty)
                        * (tz if bz else 1 - tz))
            c = self._corner_coords[self._corners_lex]  # (nc, 8, 3)
            interior = np.einsum("kp,ckd->cpd", w, c)   # (nc, ni^3, 3)
            i0 = nv + ne * ni + nf * ni * ni
            out[i0:] = interior.reshape(-1, 3)
        return out

    @cached_property
    def corner_interp(self):
        """(cols, wts): per-GLL-node corner interpolation, <=8 entries.

        Trilinear analogue of UnstructuredQuadMesh.corner_interp (same
        weight structure as coords: linear edges, bilinear faces,
        trilinear interiors) — the coarse space for two-level Schwarz.
        """
        N = self.ngl
        ni = N - 2
        gll, _ = lobatto_points(N)
        t = (gll[1:-1] + 1.0) / 2.0
        nv = len(self._corner_coords)
        ne = len(self._edge_pairs)
        nf = len(self._face_quads)
        cols = np.zeros((self.n_nodes, 8), dtype=np.int64)
        wts = np.zeros((self.n_nodes, 8))
        cols[:nv, 0] = np.arange(nv)
        wts[:nv, 0] = 1.0
        if ni and ne:
            rows = nv + np.arange(ne * ni).reshape(ne, ni)
            cols[rows, 0] = self._edge_pairs[:, :1]
            cols[rows, 1] = self._edge_pairs[:, 1:]
            wts[rows, 0] = 1.0 - t
            wts[rows, 1] = t
        if ni and nf:
            ti, tj = np.meshgrid(t, t, indexing="xy")  # u (i) fastest
            s, r = ti.reshape(-1), tj.reshape(-1)
            w = np.stack([(1 - s) * (1 - r), s * (1 - r),
                          (1 - s) * r, s * r], axis=1)
            f0 = nv + ne * ni
            rows = f0 + np.arange(nf * ni * ni)
            cols[rows, :4] = np.repeat(self._face_quads, ni * ni, axis=0)
            wts[rows, :4] = np.tile(w, (nf, 1))
        if ni:
            tx = np.tile(t, ni * ni)
            ty = np.tile(np.repeat(t, ni), ni)
            tz = np.repeat(t, ni * ni)
            w = np.empty((ni**3, 8))
            for k in range(8):
                bx, by, bz = k & 1, (k >> 1) & 1, (k >> 2) & 1
                w[:, k] = ((tx if bx else 1 - tx) * (ty if by else 1 - ty)
                           * (tz if bz else 1 - tz))
            i0 = nv + ne * ni + nf * ni * ni
            rows = i0 + np.arange(self.n_cells * ni**3)
            cols[rows] = np.repeat(self._corners_lex, ni**3, axis=0)
            wts[rows] = np.tile(w, (self.n_cells, 1))
        return cols, wts

    @cached_property
    def cell_corners(self):
        return self._corner_coords[self._corners_lex]

    # -- boundary topology -------------------------------------------------
    @cached_property
    def _edge_lookup(self):
        return {
            (int(lo), int(hi)): k
            for k, (lo, hi) in enumerate(self._edge_pairs)
        }

    @cached_property
    def _face_lookup(self):
        return {
            tuple(sorted(int(v) for v in row)): k
            for k, row in enumerate(self._face_quads)
        }

    def _quad_nodes(self, quads):
        """All GLL node ids on the given ccw corner-id boundary quads."""
        N, ni = self.ngl, self.ngl - 2
        nv = len(self._corner_coords)
        f0 = nv + len(self._edge_pairs) * ni
        nodes = set()
        for q in quads:
            q = [int(v) for v in q]
            nodes.update(q)
            for a, b in ((q[0], q[1]), (q[1], q[2]), (q[2], q[3]),
                         (q[3], q[0])):
                lo, hi = (a, b) if a < b else (b, a)
                eid = self._edge_lookup.get((lo, hi))
                if eid is not None:
                    base = nv + eid * ni
                    nodes.update(range(base, base + ni))
            fid = self._face_lookup.get(tuple(sorted(q)))
            if fid is not None and ni > 0:
                base = f0 + fid * ni * ni
                nodes.update(range(base, base + ni * ni))
        return np.asarray(sorted(nodes), dtype=np.int32)

    @cached_property
    def _boundary_face_quads(self):
        """(nb, 4) ccw corner quads of faces referenced by exactly one cell."""
        counts = {}
        reps = {}
        # local faces as ccw corner cycles (orientation irrelevant here)
        loc_faces = (
            (0, 1, 3, 2), (4, 5, 7, 6),   # z = 0, 1
            (0, 1, 5, 4), (2, 3, 7, 6),   # y = 0, 1
            (0, 2, 6, 4), (1, 3, 7, 5),   # x = 0, 1
        )
        for cell in self._corners_lex:
            for lf in loc_faces:
                q = tuple(int(cell[k]) for k in lf)
                key = tuple(sorted(q))
                counts[key] = counts.get(key, 0) + 1
                reps[key] = q
        return np.asarray([reps[k] for k, v in counts.items() if v == 1],
                          dtype=np.int64)

    @cached_property
    def face_nodes(self) -> Dict[str, np.ndarray]:
        """Named boundary node groups: physical names + box-wall fallback
        (see UnstructuredQuadMesh.face_nodes)."""
        named = {
            name: self._quad_nodes(quads)
            for name, quads in self._boundary_quads.items()
        }
        named.update(_box_wall_groups(
            self._corner_coords, self._boundary_face_quads, named,
            (("left", 0, 0), ("right", 0, 1), ("down", 1, 0), ("up", 1, 1),
             ("back", 2, 0), ("front", 2, 1)),
            self._quad_nodes,
        ))
        return named

    @cached_property
    def boundary_nodes(self):
        """All boundary nodes: faces referenced by exactly one cell.

        Parity: markBoundaryFaces 'External Boundary' (dmplex.py:27-28).
        """
        return self._quad_nodes(self._boundary_face_quads)

    # -- dof helpers (same layout as BoxMesh) ------------------------------
    def cell_dofs(self, k: int):
        c2n = self.cell2node.astype(np.int64)
        dofs = c2n[:, :, None] * k + np.arange(k)[None, None, :]
        return dofs.reshape(self.n_cells, -1).astype(np.int32)

    def node_dofs(self, nodes, k: int):
        nodes = np.asarray(nodes, dtype=np.int64)
        dofs = nodes[:, None] * k + np.arange(k)[None, :]
        return dofs.reshape(-1).astype(np.int32)
