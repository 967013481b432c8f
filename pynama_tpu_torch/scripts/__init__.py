"""Measurement scripts of the port, run as ``python -m
pynama_tpu_torch.scripts.<name>``."""
