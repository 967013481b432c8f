"""XDMF + HDF5 field output for ParaView.

Port of pynama_tpu/io/xdmf.py; the files are the same: node coordinates
go to <save-dir>/mesh.h5, per-step fields to <save-dir>/vec-data-NNNNN.h5
under a /fields group, and an Xdmf 2.0 XML index with a temporal grid
collection and Polyvertex topology points ParaView at them. Vector
components are HyperSlab extractions of the interleaved dof vectors.
Fields arrive as numpy arrays (``tensor.cpu().numpy()``).

Needs h5py: importing this module without it raises ImportError, so a
caller that can run without XDMF output checks for the package first
(run_case.py).
"""

import os
import xml.etree.ElementTree as ET

import h5py
import numpy as np


class XdmfWriter:
    def __init__(self, save_dir: str, dim: int):
        self.save_dir = save_dir
        self.dim = dim
        self.steps = []  # (step, time, field names/lengths)
        os.makedirs(save_dir, exist_ok=True)
        self.n_nodes = None

    def save_mesh(self, coords):
        """coords (n_nodes, dim) -> mesh.h5 (parity: saveMesh)."""
        coords = np.asarray(coords)
        self.n_nodes = coords.shape[0]
        with h5py.File(os.path.join(self.save_dir, "mesh.h5"), "w") as f:
            f.create_dataset("coordinates", data=coords)

    def save_fields(self, step: int, time: float, **fields):
        """Interleaved dof vectors -> vec-data-%05d.h5 (parity: saveData)."""
        fname = os.path.join(self.save_dir, f"vec-data-{step:05d}.h5")
        meta = {}
        with h5py.File(fname, "w") as f:
            g = f.create_group("fields")
            for name, vec in fields.items():
                arr = np.asarray(vec)
                g.create_dataset(name, data=arr)
                meta[name] = arr.size
        self.steps.append((step, float(time), meta))

    def write_xmf(self, name: str):
        """Temporal collection XDMF index (parity: writeXmf + XmlGenerator)."""
        assert self.n_nodes is not None, "save_mesh first"
        root = ET.Element("Xdmf", Version="2.0")
        dom = ET.SubElement(root, "Domain")
        coll = ET.SubElement(
            dom, "Grid", Name="Collection", GridType="Collection",
            CollectionType="Temporal",
        )
        nn = self.n_nodes
        for step, time, meta in self.steps:
            grid = ET.SubElement(coll, "Grid", Name=f"Grid{step}",
                                 GridType="Uniform")
            ET.SubElement(grid, "Time", Value=repr(time))
            topo = ET.SubElement(
                grid, "Topology", TopologyType="Polyvertex",
                NumberOfElements=str(nn),
            )
            geom = ET.SubElement(grid, "Geometry",
                                 GeometryType="XY" if self.dim == 2 else "XYZ")
            d = ET.SubElement(geom, "DataItem",
                              Dimensions=f"{nn} {self.dim}", Format="HDF")
            d.text = "mesh.h5:/coordinates"
            h5 = f"vec-data-{step:05d}.h5"
            for fname_, size in meta.items():
                k = size // nn
                if k == 1:
                    att = ET.SubElement(grid, "Attribute", Name=fname_,
                                        AttributeType="Scalar", Center="Node")
                    di = ET.SubElement(att, "DataItem", Dimensions=str(nn),
                                       Format="HDF")
                    di.text = f"{h5}:/fields/{fname_}"
                else:
                    # per-component HyperSlab of the interleaved vector
                    for c in range(k):
                        att = ET.SubElement(
                            grid, "Attribute", Name=f"{fname_}_{'xyz'[c]}",
                            AttributeType="Scalar", Center="Node",
                        )
                        sl = ET.SubElement(
                            att, "DataItem", ItemType="HyperSlab",
                            Dimensions=str(nn),
                        )
                        sel = ET.SubElement(sl, "DataItem",
                                            Dimensions="3 1", Format="XML")
                        sel.text = f"{c} {k} {nn}"
                        di = ET.SubElement(sl, "DataItem",
                                           Dimensions=str(size), Format="HDF")
                        di.text = f"{h5}:/fields/{fname_}"
        tree = ET.ElementTree(root)
        ET.indent(tree)
        out = os.path.join(self.save_dir, f"{name}.xmf")
        tree.write(out, xml_declaration=True)
        return out
