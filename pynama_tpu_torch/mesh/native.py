"""ctypes loader for the meshcore library, with its pure-Python mirror.

Port of pynama_tpu/mesh/native.py. The library (csrc/meshcore.cpp, a copy
of the JAX package's native/meshcore.cpp) plays the role PETSc's
DMPlex/Section C code plays upstream: high-order GLL node numbering over
unstructured quad and hex meshes. It is host code, built at first use
with ``g++ -O3 -fPIC -std=c++17 -shared`` into pynama_tpu_torch/_build/
(the file name carries a hash of the source and the flags). Without g++
the pure-Python numbering runs instead, with the same semantics (the
tests hold the two equal); ``have_native()`` says which one runs. A
source that g++ rejects raises.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "meshcore.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]

_LIB = None
_TRIED = False

_I64 = ctypes.c_int64


def _arr():
    return np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")


def _so_path():
    tag = hashlib.sha1(SOURCE.read_bytes()
                       + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libmeshcore-{tag[:16]}.so"


def _load():
    """The loaded library, built first if needed; None without g++."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    so = _so_path()
    if not so.exists():
        cxx = shutil.which("g++")
        if cxx is None:
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE}:\n{proc.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.quad_highorder_numbering.restype = _I64
    lib.quad_highorder_numbering.argtypes = [
        _I64, _I64, _arr(), _I64, _arr(), _arr(), _arr()]
    lib.hex_highorder_numbering.restype = _I64
    lib.hex_highorder_numbering.argtypes = [
        _I64, _I64, _arr(), _I64, _arr(), _arr(), _arr(), _arr()]
    _LIB = lib
    return _LIB


def have_native():
    return _load() is not None


def _corner_ids(cells, nverts, width):
    """cells as C-contiguous int64 (ncells, width) corner ids, checked to
    lie in [0, nverts): the native code indexes with them unchecked."""
    cells = np.ascontiguousarray(cells, dtype=np.int64)
    if cells.ndim != 2 or cells.shape[1] != width:
        raise ValueError(f"cells must be (ncells, {width}), got "
                         f"{cells.shape}")
    if cells.size and (cells.min() < 0 or cells.max() >= nverts):
        raise ValueError(f"corner ids outside [0, {nverts})")
    return cells


def quad_highorder_numbering(cells, nverts, ngl, force_python=False):
    """GLL node numbering for a 2D quad mesh.

    cells: (ncells, 4) int corner ids in lexicographic corner order.
    Returns (cell2node (ncells, ngl*ngl) int64, n_nodes, edge_pairs
    (n_edges, 2)).
    """
    cells = _corner_ids(cells, nverts, 4)
    ncells = cells.shape[0]
    N = int(ngl)
    lib = None if force_python else _load()
    if lib is not None:
        c2n = np.empty((ncells, N * N), dtype=np.int64)
        pairs = np.empty((4 * ncells, 2), dtype=np.int64)
        n_edges = np.zeros(1, dtype=np.int64)
        total = lib.quad_highorder_numbering(
            ncells, int(nverts), cells, N, c2n, pairs, n_edges)
        if total < 0:
            raise ValueError("quad_highorder_numbering failed")
        return c2n, int(total), pairs[: int(n_edges[0])].copy()
    return _quad_numbering_py(cells, int(nverts), N)


def hex_highorder_numbering(cells, nverts, ngl, force_python=False):
    """GLL node numbering for a 3D hex mesh.

    cells: (ncells, 8) int corner ids in LEXICOGRAPHIC corner order
    (x fastest: (0,0,0),(1,0,0),(0,1,0),(1,1,0),(0,0,1),...). Numbering
    layout (upstream's entity-ordered Section numbering,
    src/domain/indices.py:22-30): corners [0, nverts) | edge interiors |
    face interiors | cell interiors.

    Shared-edge orientation follows the 2D convention (nodes run from the
    smaller to the larger global corner id). Shared-face interiors are
    stored in a canonical frame fixed by the face's corner ids: the
    anchor is the smallest-id corner, the canonical u axis points to the
    smaller of its two in-face neighbors; every incident cell maps its
    local face coordinates onto that frame, so neighbors agree node by
    node regardless of local orientation.

    Returns (cell2node (ncells, ngl^3) int64, n_nodes,
             edge_pairs (n_edges, 2), face_quads (n_faces, 4)) where
    face_quads rows are [anchor, u-neighbor, v-neighbor, diagonal].
    """
    cells = _corner_ids(cells, nverts, 8)
    N = int(ngl)
    lib = None if force_python else _load()
    if lib is not None:
        ncells = cells.shape[0]
        c2n = np.empty((ncells, N * N * N), dtype=np.int64)
        pairs = np.empty((12 * ncells, 2), dtype=np.int64)
        quads = np.empty((6 * ncells, 4), dtype=np.int64)
        counts = np.zeros(2, dtype=np.int64)
        total = lib.hex_highorder_numbering(
            ncells, int(nverts), cells, N, c2n, pairs, quads, counts)
        if total < 0:
            raise ValueError("hex_highorder_numbering failed")
        return (c2n, int(total), pairs[: int(counts[0])].copy(),
                quads[: int(counts[1])].copy())
    return _hex_numbering_py(cells, int(nverts), N)


# local node index (x fastest) of the node at local (lx, ly, lz)
def _hex_local_id(lx, ly, lz, N):
    return (lz * N + ly) * N + lx


# the 12 hex edges: (corner_a, corner_b, axis) with a < b along the axis;
# corners are lex ids 0..7 (bit 0 = x, bit 1 = y, bit 2 = z)
_HEX_EDGES = (
    (0, 1, 0), (2, 3, 0), (4, 5, 0), (6, 7, 0),
    (0, 2, 1), (1, 3, 1), (4, 6, 1), (5, 7, 1),
    (0, 4, 2), (1, 5, 2), (2, 6, 2), (3, 7, 2),
)

# the 6 hex faces: (fixed_axis, fixed_side); tangent axes are the other
# two in increasing order
_HEX_FACES = ((0, 0), (0, 1), (1, 0), (1, 1), (2, 0), (2, 1))


def _hex_numbering_py(cells, nverts, N):
    """Pure-Python mirror of the native hex numbering."""
    ni = N - 2
    ncells = cells.shape[0]
    c2n = np.empty((ncells, N * N * N), dtype=np.int64)
    edge_ids, edge_pairs = {}, []
    face_ids, face_quads = {}, []
    cbits = [(k & 1, (k >> 1) & 1, (k >> 2) & 1) for k in range(8)]

    for e in range(ncells):
        c = cells[e]
        out = c2n[e]
        for k, (bx, by, bz) in enumerate(cbits):
            out[_hex_local_id(bx * (N - 1), by * (N - 1), bz * (N - 1),
                              N)] = c[k]
        if ni <= 0:
            continue
        for (ka, kb, ax) in _HEX_EDGES:
            a, b = int(c[ka]), int(c[kb])
            lo, hi = (a, b) if a < b else (b, a)
            eid = edge_ids.get((lo, hi))
            if eid is None:
                eid = len(edge_pairs)
                edge_ids[(lo, hi)] = eid
                edge_pairs.append((lo, hi))
            base = nverts + eid * ni
            forward = a == lo
            sx, sy, sz = cbits[ka]
            pos = [sx * (N - 1), sy * (N - 1), sz * (N - 1)]
            for k in range(ni):
                pos[ax] = k + 1
                g = base + k if forward else base + (ni - 1 - k)
                out[_hex_local_id(pos[0], pos[1], pos[2], N)] = g
        # face interiors, in the canonical frame of each shared face
        for (fax, side) in _HEX_FACES:
            tu, tv = [ax for ax in range(3) if ax != fax]

            def corner_at(su, sv):
                bits = [0, 0, 0]
                bits[fax] = side
                bits[tu] = su
                bits[tv] = sv
                return bits[0] + 2 * bits[1] + 4 * bits[2]

            ids = {(su, sv): int(c[corner_at(su, sv)])
                   for su in (0, 1) for sv in (0, 1)}
            key = tuple(sorted(ids.values()))
            fid = face_ids.get(key)
            if fid is None:
                fid = len(face_quads)
                face_ids[key] = fid
                (au, av) = min(ids, key=ids.get)
                id_u = ids[(1 - au, av)]
                id_v = ids[(au, 1 - av)]
                if id_u > id_v:
                    id_u, id_v = id_v, id_u
                face_quads.append((ids[(au, av)], id_u, id_v,
                                   ids[(1 - au, 1 - av)]))
            anchor_id, u_id, _, _ = face_quads[fid]
            # the canonical frame in THIS cell's local coordinates
            (au, av) = next(k for k, v in ids.items() if v == anchor_id)
            swap = ids[(1 - au, av)] != u_id  # u runs along sv instead
            fbase = fid * ni * ni
            for j in range(1, N - 1):
                for i in range(1, N - 1):
                    ii, jj = (j, i) if swap else (i, j)
                    pu = ii if au == 0 else N - 1 - ii
                    pv = jj if av == 0 else N - 1 - jj
                    pos = [0, 0, 0]
                    pos[fax] = side * (N - 1)
                    pos[tu] = pu
                    pos[tv] = pv
                    # provisional face-interior ids (rebased below)
                    out[_hex_local_id(pos[0], pos[1], pos[2], N)] = (
                        -(fbase + (j - 1) * ni + (i - 1)) - 1)
        # cell interior: provisional ids in a second negative band
        for lz in range(1, N - 1):
            for ly in range(1, N - 1):
                for lx in range(1, N - 1):
                    out[_hex_local_id(lx, ly, lz, N)] = (
                        -(e * ni**3 + ((lz - 1) * ni + (ly - 1)) * ni
                          + (lx - 1)) - 1 - (1 << 60))

    edge0 = nverts
    face0 = edge0 + len(edge_pairs) * ni
    int0 = face0 + len(face_quads) * ni * ni
    big = c2n <= -(1 << 60)  # cell-interior band
    c2n[big] = int0 + (-(c2n[big] + (1 << 60)) - 1)
    neg = c2n < 0  # face-interior band
    c2n[neg] = face0 + (-c2n[neg] - 1)
    total = int0 + ncells * ni**3
    return (c2n, int(total),
            np.asarray(edge_pairs, dtype=np.int64).reshape(-1, 2),
            np.asarray(face_quads, dtype=np.int64).reshape(-1, 4))


def _quad_numbering_py(cells, nverts, N):
    """Pure-Python mirror of the native quad numbering."""
    ni = N - 2
    ncells = cells.shape[0]
    c2n = np.empty((ncells, N * N), dtype=np.int64)
    edge_ids = {}
    pairs = []
    locals_ = (
        (0, 1, 1, 0, 1, 0),
        (2, 3, 1, N - 1, 1, 0),
        (0, 2, 0, 1, 0, 1),
        (1, 3, N - 1, 1, 0, 1),
    )
    for e in range(ncells):
        c = cells[e]
        out = c2n[e]
        out[0] = c[0]
        out[N - 1] = c[1]
        out[(N - 1) * N] = c[2]
        out[(N - 1) * N + N - 1] = c[3]
        for (ia, ib, lx0, ly0, dx, dy) in locals_:
            a, b = int(c[ia]), int(c[ib])
            lo, hi = (a, b) if a < b else (b, a)
            eid = edge_ids.get((lo, hi))
            if eid is None:
                eid = len(pairs)
                edge_ids[(lo, hi)] = eid
                pairs.append((lo, hi))
            base = nverts + eid * ni
            forward = a == lo
            for k in range(ni):
                lx, ly = lx0 + k * dx, ly0 + k * dy
                g = base + k if forward else base + (ni - 1 - k)
                out[ly * N + lx] = g
        # interior: provisional negative ids, rebased below
        for ly in range(1, N - 1):
            for lx in range(1, N - 1):
                out[ly * N + lx] = -(e * ni * ni + (ly - 1) * ni
                                     + (lx - 1)) - 1
    interior0 = nverts + len(pairs) * ni
    neg = c2n < 0
    c2n[neg] = interior0 + (-c2n[neg] - 1)
    total = interior0 + ncells * ni * ni
    return c2n, int(total), np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
