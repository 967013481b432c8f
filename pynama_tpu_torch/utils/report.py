"""Allocation introspection: what a problem keeps on the device and host.

Port of pynama_tpu/utils/report.py. In the matrix-free design the large
allocations are stencil kernels, multigrid level operators and patch
kernels, coarse dense inverses, masks and weight vectors. The walker
follows pynama_tpu_torch-owned objects (dataclasses, plain objects,
containers) and records every tensor and numpy array with its attribute
path. A tensor's bytes are its storage's, counted the first time the
storage is reached: a view, or an attribute shared by two objects,
appears with 0 bytes after that.
"""

from dataclasses import fields, is_dataclass

import numpy as np
import torch


def _is_ours(obj):
    return type(obj).__module__.startswith("pynama_tpu_torch")


def collect_arrays(obj, name="", _seen=None, _depth=0, _storages=None):
    """[(path, shape, dtype, nbytes, on_device)] for all reachable
    tensors (on_device: ``is_cuda``) and numpy arrays."""
    out = []
    if _seen is None:
        _seen, _storages = set(), set()
    if _depth > 8 or id(obj) in _seen:
        return out
    if isinstance(obj, torch.Tensor):
        st = obj.untyped_storage()
        key = (str(obj.device), st.data_ptr())
        nbytes = 0 if key in _storages else st.nbytes()
        _storages.add(key)
        out.append((name, tuple(obj.shape),
                    str(obj.dtype).replace("torch.", ""), nbytes,
                    obj.is_cuda))
        return out
    if isinstance(obj, np.ndarray):
        out.append((name, tuple(obj.shape), str(obj.dtype),
                    obj.nbytes, False))
        return out

    def walk(items):
        _seen.add(id(obj))
        for path, v in items:
            out.extend(collect_arrays(v, path, _seen, _depth + 1, _storages))
        return out

    if isinstance(obj, (list, tuple)):
        return walk((f"{name}[{i}]", v) for i, v in enumerate(obj))
    if isinstance(obj, dict):
        return walk((f"{name}[{k!r}]", v) for k, v in obj.items())
    if is_dataclass(obj) and not isinstance(obj, type):
        names = [f.name for f in fields(obj)]
        # lazily cached attributes live outside the dataclass fields
        names += sorted(set(vars(obj)) - set(names))
        return walk((f"{name}.{k}", getattr(obj, k, None)) for k in names)
    if _is_ours(obj) and hasattr(obj, "__dict__"):
        return walk((f"{name}.{k}", v) for k, v in sorted(vars(obj).items()))
    return out


def device_report(problem, top=40):
    """Human-readable allocation report for a set-up problem: the `top`
    largest arrays (path, shape, dtype, MB, device/host) and the
    totals."""
    rows = collect_arrays(problem, problem.__class__.__name__)
    rows.sort(key=lambda r: -r[3])
    dev = sum(r[3] for r in rows if r[4])
    host = sum(r[3] for r in rows if not r[4])
    lines = [f"allocation report: {len(rows)} arrays, "
             f"device {dev / 1e6:.1f} MB, host {host / 1e6:.1f} MB"]
    for path, shape, dtype, nbytes, on_dev in rows[:top]:
        where = "dev " if on_dev else "host"
        lines.append(f"  {nbytes / 1e6:9.2f} MB  {where}  {dtype:<8s} "
                     f"{str(shape):<24s} {path}")
    rest = rows[top:]
    if rest:
        lines.append(f"  ... {len(rest)} smaller arrays, "
                     f"{sum(r[3] for r in rest) / 1e6:.1f} MB total")
    return "\n".join(lines)
