"""Legacy-VTK writers (ASCII), dependency-free.

A copy of pynama_tpu/io/vtk.py (numpy only; the same bytes for the same
input): node clouds with point fields and a Lagrangian body as a
polyline, for quick ParaView inspection without HDF5.
"""

import os

import numpy as np


def write_point_cloud(path, coords, fields=None):
    """Nodes + per-node fields as VTK POLYDATA points."""
    coords = np.asarray(coords)
    n, dim = coords.shape
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 3.0\npynama_tpu point cloud\n")
        f.write("ASCII\nDATASET POLYDATA\n")
        f.write(f"POINTS {n} double\n")
        for p in coords:
            x, y = p[0], p[1]
            z = p[2] if dim == 3 else 0.0
            f.write(f"{x} {y} {z}\n")
        if fields:
            f.write(f"POINT_DATA {n}\n")
            for name, arr in fields.items():
                arr = np.asarray(arr).reshape(n, -1)
                k = arr.shape[1]
                if k == 1:
                    f.write(f"SCALARS {name} double 1\nLOOKUP_TABLE default\n")
                    for v in arr[:, 0]:
                        f.write(f"{v}\n")
                else:
                    f.write(f"VECTORS {name} double\n")
                    for row in arr:
                        x, y = row[0], row[1]
                        z = row[2] if k == 3 else 0.0
                        f.write(f"{x} {y} {z}\n")
    return path


def write_body_polyline(path, coords, closed=True):
    """Lagrangian body as a VTK polyline (parity: immersed_body saveVTK)."""
    coords = np.asarray(coords)
    n = len(coords)
    ids = list(range(n)) + ([0] if closed else [])
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 3.0\npynama_tpu body\n")
        f.write("ASCII\nDATASET POLYDATA\n")
        f.write(f"POINTS {n} double\n")
        for p in coords:
            f.write(f"{p[0]} {p[1]} 0.0\n")
        f.write(f"LINES 1 {len(ids) + 1}\n")
        f.write(" ".join([str(len(ids))] + [str(i) for i in ids]) + "\n")
    return path
