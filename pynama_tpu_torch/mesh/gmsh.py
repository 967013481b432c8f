"""Gmsh .msh reader (ASCII v2.2 and v4.1) for quad and hex meshes.

A copy of pynama_tpu/mesh/gmsh.py (numpy only; the port imports nothing
of the JAX package). Upstream Pynama creates DMPlex meshes from Gmsh
files (src/domain/dmplex.py:22-23 createFromFile) and relies on PETSc's
parser. This is the framework-native equivalent: it extracts node
coordinates, cell connectivity (4-node quads, gmsh type 3, for 2D meshes;
8-node hexahedra, type 5, for 3D) and boundary elements (2-node lines,
type 1, in 2D; 4-node quads in 3D) grouped by physical name.

A file containing hexahedra is a 3D mesh: its type-3 quads are boundary
surface elements, not cells.
"""

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np


@dataclass
class GmshData:
    points: np.ndarray                     # (nv, 2) for 2D, (nv, 3) for 3D
    quads: Optional[np.ndarray]            # 2D cells (nc, 4), ccw; None in 3D
    boundary_lines: Dict[str, np.ndarray]  # 2D: name -> (nl, 2) corner pairs
    hexes: Optional[np.ndarray] = None     # 3D cells (nc, 8), gmsh order
    boundary_quads: Dict[str, np.ndarray] = field(default_factory=dict)
    # 3D: name -> (nq, 4) ccw corner quads


def read_msh(path: str) -> GmshData:
    with open(path) as f:
        lines = [ln.strip() for ln in f]
    sections = {}
    i = 0
    while i < len(lines):
        ln = lines[i]
        if ln.startswith("$") and not ln.startswith("$End"):
            name = ln[1:]
            j = i + 1
            while j < len(lines) and not lines[j].startswith("$End"):
                j += 1
            sections[name] = lines[i + 1 : j]
            i = j + 1
        else:
            i += 1
    if "MeshFormat" not in sections:
        raise ValueError("not a Gmsh .msh file")
    version = float(sections["MeshFormat"][0].split()[0])

    phys = {}
    for ln in sections.get("PhysicalNames", [])[1:]:
        parts = ln.split(maxsplit=2)
        if len(parts) == 3:
            phys[int(parts[1])] = parts[2].strip().strip('"')

    if version < 4.0:
        pts, elems = _read_v2(sections, phys)
    else:
        pts, elems = _read_v4(sections, phys)
    return _classify(pts, elems)


def _classify(pts, elems):
    """elems: list of (etype, physical_name, node_ids)."""
    hexes = [nodes for et, _, nodes in elems if et == 5]
    if hexes:
        bquads: Dict[str, list] = {}
        for et, pname, nodes in elems:
            if et == 3:
                bquads.setdefault(pname or "boundary", []).append(nodes)
        return GmshData(
            points=pts,
            quads=None,
            boundary_lines={},
            hexes=np.asarray(hexes, dtype=np.int64),
            boundary_quads={k: np.asarray(v, dtype=np.int64)
                            for k, v in bquads.items()},
        )
    quads = [nodes for et, _, nodes in elems if et == 3]
    blines: Dict[str, list] = {}
    for et, pname, nodes in elems:
        if et == 1:
            blines.setdefault(pname or "boundary", []).append(nodes)
    return GmshData(
        points=pts[:, :2],
        quads=np.asarray(quads, dtype=np.int64),
        boundary_lines={k: np.asarray(v, dtype=np.int64)
                        for k, v in blines.items()},
    )


def _read_v2(sections, phys):
    node_lines = sections["Nodes"]
    n = int(node_lines[0])
    ids = np.empty(n, dtype=np.int64)
    pts = np.empty((n, 3))
    for k in range(n):
        parts = node_lines[1 + k].split()
        ids[k] = int(parts[0])
        pts[k] = [float(parts[1]), float(parts[2]), float(parts[3])]
    remap = {int(g): k for k, g in enumerate(ids)}

    elem_lines = sections["Elements"]
    ne = int(elem_lines[0])
    elems = []
    for k in range(ne):
        parts = [int(x) for x in elem_lines[1 + k].split()]
        etype, ntags = parts[1], parts[2]
        tags = parts[3 : 3 + ntags]
        nodes = parts[3 + ntags :]
        pname = phys.get(tags[0], str(tags[0])) if tags else None
        elems.append((etype, pname, [remap[v] for v in nodes]))
    return pts, elems


def _read_v4(sections, phys):
    # $Entities maps (dim, entityTag) -> physical tag
    ent_phys = {}
    ent = sections.get("Entities")
    if ent:
        np_, nc_, ns_, nv_ = (int(x) for x in ent[0].split())
        row = 1
        for dim, count, ncoord in ((0, np_, 3), (1, nc_, 6), (2, ns_, 6),
                                   (3, nv_, 6)):
            for _ in range(count):
                parts = ent[row].split()
                row += 1
                tag = int(parts[0])
                nphys = int(parts[1 + ncoord])
                if nphys > 0:
                    ent_phys[(dim, tag)] = int(parts[2 + ncoord])

    node_lines = sections["Nodes"]
    nblocks, ntotal = (int(x) for x in node_lines[0].split()[:2])
    pts = np.empty((ntotal, 3))
    remap = {}
    row, count = 1, 0
    for _ in range(nblocks):
        hdr = node_lines[row].split()
        row += 1
        nb = int(hdr[3])
        tags = [int(node_lines[row + k]) for k in range(nb)]
        row += nb
        for k in range(nb):
            parts = node_lines[row + k].split()
            pts[count] = [float(parts[0]), float(parts[1]), float(parts[2])]
            remap[tags[k]] = count
            count += 1
        row += nb

    elem_lines = sections["Elements"]
    nblocks = int(elem_lines[0].split()[0])
    elems = []
    row = 1
    for _ in range(nblocks):
        hdr = elem_lines[row].split()
        row += 1
        edim, etag, etype, nb = (int(x) for x in hdr)
        pname = phys.get(ent_phys.get((edim, etag)), None)
        for k in range(nb):
            parts = [int(x) for x in elem_lines[row + k].split()]
            elems.append((etype, pname, [remap[v] for v in parts[1:]]))
        row += nb
    return pts, elems
