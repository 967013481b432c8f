"""Run output: checkpoints (io/checkpoint.py), XDMF + HDF5 fields
(io/xdmf.py, needs h5py), legacy VTK (io/vtk.py) and charts
(io/plots.py, needs matplotlib). Only the numpy modules are imported
here."""

from pynama_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint

__all__ = ["save_checkpoint", "load_checkpoint"]
