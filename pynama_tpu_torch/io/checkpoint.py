"""Checkpoint / resume for transient runs.

A copy of pynama_tpu/io/checkpoint.py (numpy only), so each package
reads the other's checkpoints: (step, t, dt, vorticity, warm-start
velocity, FSAL derivative, and a JSON ``extra``) in one compressed npz,
written to a temporary name and moved into place.
"""

import json
import os

import numpy as np


def save_checkpoint(path, *, step, t, dt, vort, vel=None, f1=None, extra=None):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {
        "step": np.asarray(step),
        "t": np.asarray(t),
        "dt": np.asarray(dt),
        "vort": np.asarray(vort),
    }
    if vel is not None:
        payload["vel"] = np.asarray(vel)
    if f1 is not None:
        payload["f1"] = np.asarray(f1)
    if extra is not None:
        payload["extra_json"] = np.frombuffer(
            json.dumps(extra).encode(), dtype=np.uint8
        )
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **payload)
    os.replace(tmp, path)


def load_checkpoint(path):
    with np.load(path, allow_pickle=False) as z:
        out = {k: z[k] for k in z.files if k != "extra_json"}
        if "extra_json" in z.files:
            out["extra"] = json.loads(z["extra_json"].tobytes().decode())
    out["step"] = int(out["step"])
    out["t"] = float(out["t"])
    out["dt"] = float(out["dt"])
    return out
