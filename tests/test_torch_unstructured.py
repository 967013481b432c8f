"""The port's Gmsh reader, meshcore numbering and unstructured meshes
(pynama_tpu_torch/mesh/gmsh.py, native.py, unstructured.py) on the CPU:
the twins of tests/test_unstructured.py's mesh tests, and each piece
against the reference on the same numpy-seeded inputs: read_msh on the
same v2.2 and v4.1 files (arrays equal), the native and Python numbering
(bitwise equal to the reference's Python numbering), and the meshes'
coords, cell_dofs, face_nodes, boundary_nodes and corner_interp (equal)."""

import numpy as np
import pytest

from pynama_tpu.mesh import gmsh as ref_gmsh
from pynama_tpu.mesh import native as ref_native
from pynama_tpu.mesh import unstructured as ref_unstructured
from pynama_tpu_torch.elements.quadrature import lobatto_points
from pynama_tpu_torch.mesh import native
from pynama_tpu_torch.mesh.gmsh import read_msh
from pynama_tpu_torch.mesh.native import (have_native,
                                          hex_highorder_numbering,
                                          quad_highorder_numbering)
from pynama_tpu_torch.mesh.structured import BoxMesh
from pynama_tpu_torch.mesh.unstructured import (UnstructuredHexMesh,
                                                UnstructuredQuadMesh)
from tests.test_unstructured import (MSH22, _write_hex_msh,
                                     _write_msh22_quads, box_corner_mesh,
                                     box_hex_mesh)

# MSH22's two quads and the "inlet" lines as Gmsh v4.1: one surface
# entity (physical 20) and one curve entity (physical 10)
MSH41 = """$MeshFormat
4.1 0 8
$EndMeshFormat
$PhysicalNames
2
1 10 "inlet"
2 20 "fluid"
$EndPhysicalNames
$Entities
0 1 1 0
1 0 0 0 1 1 0 1 10 0
1 0 0 0 2 1 0 1 20 0
$EndEntities
$Nodes
1 6 1 6
2 1 0 6
1
2
3
4
5
6
0 0 0
1 0 0
2 0 0
0 1 0
1 1 0
2 1 0
$EndNodes
$Elements
2 4 1 4
2 1 3 2
1 1 2 5 4
2 2 3 6 5
1 1 1 2
3 1 4
4 4 5
$EndElements
"""


# ----------------------------------------------------------------------
# twins of tests/test_unstructured.py
# ----------------------------------------------------------------------
def test_native_matches_python_numbering():
    pts, quads = box_corner_mesh(4, 3)
    lex = quads[:, [0, 1, 3, 2]]
    c1, n1, p1 = quad_highorder_numbering(lex, len(pts), 4, force_python=True)
    if not have_native():
        pytest.skip("native meshcore not built")
    c2, n2, p2 = quad_highorder_numbering(lex, len(pts), 4, force_python=False)
    assert n1 == n2
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_array_equal(p1, p2)


def test_matches_structured_counts():
    pts, quads = box_corner_mesh(3, 2)
    m = UnstructuredQuadMesh(pts, quads, ngl=4)
    b = BoxMesh(nelem=(3, 2), lower=(0, 0), upper=(1, 1), ngl=4)
    assert m.n_nodes == b.n_nodes
    assert m.n_cells == b.n_cells
    assert len(m.boundary_nodes) == len(b.boundary_nodes)
    counts = np.zeros(m.n_nodes, dtype=int)
    for cell in m.cell2node:
        counts[cell] += 1
    assert counts.max() <= 4 and counts.min() == 1


def test_gmsh_v22_parse_and_mesh(tmp_path):
    p = tmp_path / "two-quads.msh"
    p.write_text(MSH22)
    m = UnstructuredQuadMesh.from_gmsh(str(p), ngl=3)
    assert m.n_cells == 2
    assert m.n_nodes == 15
    assert "inlet" in m.face_nodes
    inlet = set(m.face_nodes["inlet"].tolist())
    assert {0, 3} <= inlet
    assert len(m.boundary_nodes) == 12


def test_native_matches_python_hex_numbering():
    pts, hexes = box_hex_mesh(3, 2, 4)
    lex = hexes[:, [0, 1, 3, 2, 4, 5, 7, 6]]
    c1, n1, p1, q1 = hex_highorder_numbering(lex, len(pts), 4,
                                             force_python=True)
    if not have_native():
        pytest.skip("native meshcore not built")
    c2, n2, p2, q2 = hex_highorder_numbering(lex, len(pts), 4,
                                             force_python=False)
    assert n1 == n2
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_array_equal(p1, p2)
    np.testing.assert_array_equal(q1, q2)


@pytest.mark.parametrize("ngl", [2, 3, 4])
def test_hex_matches_structured(ngl):
    pts, hexes = box_hex_mesh(3, 2, 2)
    m = UnstructuredHexMesh(pts, hexes, ngl=ngl)
    b = BoxMesh(nelem=(3, 2, 2), lower=(0, 0, 0), upper=(1, 1, 1), ngl=ngl)
    assert m.n_nodes == b.n_nodes
    assert m.n_cells == b.n_cells
    assert len(m.boundary_nodes) == len(b.boundary_nodes)
    ca = np.sort(np.round(m.coords, 12).view("f8,f8,f8"), axis=0)
    cb = np.sort(np.round(np.asarray(b.coords), 12).view("f8,f8,f8"), axis=0)
    np.testing.assert_array_equal(ca, cb)


def test_hex_cell_geometry_consistency():
    """coords[cell2node] equals each cell's own trilinear GLL map."""
    ngl = 4
    pts, hexes = box_hex_mesh(3, 3, 2, distort=0.05)
    m = UnstructuredHexMesh(pts, hexes, ngl=ngl)
    gll, _ = lobatto_points(ngl)
    t = (gll + 1) / 2
    N = ngl
    tx = np.tile(t, N * N)
    ty = np.tile(np.repeat(t, N), N)
    tz = np.repeat(t, N * N)
    w = np.empty((8, N**3))
    for k in range(8):
        bx, by, bz = k & 1, (k >> 1) & 1, (k >> 2) & 1
        w[k] = ((tx if bx else 1 - tx) * (ty if by else 1 - ty)
                * (tz if bz else 1 - tz))
    expected = np.einsum("kp,ckd->cpd", w, m.cell_corners)
    np.testing.assert_allclose(m.coords[m.cell2node], expected, atol=1e-13)


def test_geometric_wall_fallback_unnamed_box(tmp_path):
    pts, quads = box_corner_mesh(3, 2)
    path = str(tmp_path / "box.msh")
    _write_msh22_quads(path, pts, quads)
    m = UnstructuredQuadMesh.from_gmsh(path, ngl=3)
    b = BoxMesh(nelem=(3, 2), lower=(0, 0), upper=(1, 1), ngl=3)
    for wall in ("left", "right", "down", "up"):
        assert wall in m.face_nodes, m.face_nodes.keys()
        assert len(m.face_nodes[wall]) == len(b.face_nodes[wall])
        got = np.sort(m.coords[m.face_nodes[wall]], axis=0)
        want = np.sort(b.coords[b.face_nodes[wall]], axis=0)
        np.testing.assert_allclose(got, want, atol=1e-12)


def test_physical_names_win_over_geometry(tmp_path):
    pts, quads = box_corner_mesh(2, 2)
    top = [(i, i + 1) for i in range(6, 8)]
    path = str(tmp_path / "named.msh")
    _write_msh22_quads(path, pts, quads, blines={7: top},
                       phys={7: (1, "up")})
    m = UnstructuredQuadMesh.from_gmsh(path, ngl=3)
    assert "up" in m.face_nodes
    assert "left" not in m.face_nodes


# ----------------------------------------------------------------------
# against the reference
# ----------------------------------------------------------------------
def _same_gmsh(a, b):
    np.testing.assert_array_equal(a.points, b.points)
    for name in ("quads", "hexes"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None)
        if x is not None:
            np.testing.assert_array_equal(x, y)
    for name in ("boundary_lines", "boundary_quads"):
        x, y = getattr(a, name), getattr(b, name)
        assert sorted(x) == sorted(y)
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])


@pytest.mark.parametrize("kind", ["v22", "v41", "hex"])
def test_read_msh_matches_reference(kind, tmp_path):
    path = tmp_path / f"{kind}.msh"
    if kind == "v22":
        path.write_text(MSH22)
    elif kind == "v41":
        path.write_text(MSH41)
    else:
        _write_hex_msh(str(path), 2, 3, 2, distort=0.05)
    got = read_msh(str(path))
    _same_gmsh(got, ref_gmsh.read_msh(str(path)))
    if kind == "v41":  # the same mesh as the v2.2 file
        v22 = tmp_path / "same.msh"
        v22.write_text(MSH22)
        _same_gmsh(got, read_msh(str(v22)))


@pytest.mark.parametrize("ngl", [2, 3, 5])
def test_numbering_matches_reference(ngl):
    """Native and Python numbering, 2D and 3D, bitwise the reference's
    Python numbering on a distorted mesh (the numbering is topological:
    the distortion only moves the corners)."""
    pts, quads = box_corner_mesh(5, 4, distort=0.05, seed=3)
    lex = quads[:, [0, 1, 3, 2]]
    want = ref_native.quad_highorder_numbering(lex, len(pts), ngl,
                                               force_python=True)
    for force in (True, False):
        got = quad_highorder_numbering(lex, len(pts), ngl,
                                       force_python=force)
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[2], want[2])
    pts, hexes = box_hex_mesh(3, 2, 3, distort=0.05, seed=3)
    lex = hexes[:, [0, 1, 3, 2, 4, 5, 7, 6]]
    want = ref_native.hex_highorder_numbering(lex, len(pts), ngl,
                                              force_python=True)
    for force in (True, False):
        got = hex_highorder_numbering(lex, len(pts), ngl, force_python=force)
        assert got[1] == want[1]
        for g, w in zip((got[0], got[2], got[3]), (want[0], want[2], want[3])):
            np.testing.assert_array_equal(g, w)
    assert native.have_native()  # g++ is in this image: the library built


def test_numbering_rejects_corner_ids_out_of_range():
    """Corner ids reach the native code unchecked: outside [0, nverts)
    they raise here first, as does a table of the wrong width."""
    pts, quads = box_corner_mesh(2, 2)
    lex = quads[:, [0, 1, 3, 2]]
    for bad in (lex - 1, lex + 1):
        with pytest.raises(ValueError, match="outside"):
            quad_highorder_numbering(bad, len(pts), 3)
    with pytest.raises(ValueError, match="ncells, 8"):
        hex_highorder_numbering(lex, len(pts), 3)


def _same_mesh(m, r, dim):
    for name in ("n_nodes", "n_cells", "ngl", "dim", "dim_w", "dim_s",
                 "uniform"):
        assert getattr(m, name) == getattr(r, name), name
    for name in ("coords", "cell2node", "cell_corners", "boundary_nodes",
                 "_corners_lex"):
        np.testing.assert_array_equal(getattr(m, name), getattr(r, name))
    for k in (1, dim, 3 if dim == 2 else 6):
        np.testing.assert_array_equal(m.cell_dofs(k), r.cell_dofs(k))
    nodes = np.arange(0, m.n_nodes, 3)
    np.testing.assert_array_equal(m.node_dofs(nodes, dim),
                                  r.node_dofs(nodes, dim))
    assert sorted(m.face_nodes) == sorted(r.face_nodes)
    for k in m.face_nodes:
        np.testing.assert_array_equal(m.face_nodes[k], r.face_nodes[k])
    for g, w in zip(m.corner_interp, r.corner_interp):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("named", [False, True], ids=["unnamed", "named"])
def test_quad_mesh_matches_reference(named, tmp_path):
    pts, quads = box_corner_mesh(6, 5, distort=0.03, seed=2)
    path = str(tmp_path / "q.msh")
    if named:
        _write_msh22_quads(path, pts, quads,
                           blines={7: [(i, i + 1) for i in range(35, 41)]},
                           phys={7: (1, "up")})
    else:
        _write_msh22_quads(path, pts, quads)
    m = UnstructuredQuadMesh.from_gmsh(path, ngl=4)
    r = ref_unstructured.UnstructuredQuadMesh.from_gmsh(path, ngl=4)
    _same_mesh(m, r, 2)
    for axis, value in (("x", 0.0), ("y", 1.0)):
        for g, w in zip(m.nodes_over_line(axis, value),
                        r.nodes_over_line(axis, value)):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("named", [False, True], ids=["unnamed", "named"])
def test_hex_mesh_matches_reference(named, tmp_path):
    path = str(tmp_path / "h.msh")
    if named:
        _write_hex_msh(path, 3, 2, 2, distort=0.04)
    else:
        pts, hexes = box_hex_mesh(3, 2, 2, distort=0.04)
        with open(path, "w") as f:
            f.write("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n")
            f.write(f"$Nodes\n{len(pts)}\n")
            for i, p in enumerate(pts):
                f.write(f"{i+1} {p[0]:.17g} {p[1]:.17g} {p[2]:.17g}\n")
            f.write(f"$EndNodes\n$Elements\n{len(hexes)}\n")
            for i, h in enumerate(hexes):
                f.write(f"{i+1} 5 2 1 1 " + " ".join(str(v + 1) for v in h)
                        + "\n")
            f.write("$EndElements\n")
    m = UnstructuredHexMesh.from_gmsh(path, ngl=3)
    r = ref_unstructured.UnstructuredHexMesh.from_gmsh(path, ngl=3)
    _same_mesh(m, r, 3)
    assert ("left" in m.face_nodes) and (named or "front" in m.face_nodes)
