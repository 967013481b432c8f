"""The port imports no JAX: in a fresh interpreter, every module of
pynama_tpu_torch (pkgutil.walk_packages), chip_smoke.py and
tests/torch_dist_cases.py (which spawned ranks import) are imported, and
afterwards sys.modules holds neither jax, jaxlib nor any module of
pynama_tpu."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# third-party packages a module of the port may need and a machine may
# lack (the card's Python has neither): such a module is skipped by name
OPTIONAL = ("h5py", "matplotlib")

PROBE = f"""
import importlib, json, pkgutil, sys
import pynama_tpu_torch
names = [m.name for m in pkgutil.walk_packages(pynama_tpu_torch.__path__,
                                                "pynama_tpu_torch.")]
names += ["chip_smoke", "tests.torch_dist_cases"]
skipped = {{}}
for name in names:
    try:
        importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name not in {OPTIONAL!r}:
            raise
        skipped[name] = e.name
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "pynama_tpu"))
print(json.dumps({{"names": names, "skipped": skipped, "jax": bad}}))
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.splitlines()[-1])
    assert "pynama_tpu_torch.parallel.unstructured" in res["names"]
    assert len(res["names"]) - len(res["skipped"]) > 40
    assert res["jax"] == [], res["jax"]
