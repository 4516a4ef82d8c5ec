"""The port stands alone: importing every module of hairgs_tpu_torch (the
drivers, the hair model, the topology and the native library's wrapper
too) and the module scope of chip_smoke.py, in a fresh interpreter, loads
nothing of JAX or of the JAX package, and leaves TF32
matmuls switched off."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import importlib, json, pkgutil, sys
import hairgs_tpu_torch
names = [m.name for m in pkgutil.walk_packages(hairgs_tpu_torch.__path__,
                                               "hairgs_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
import torch
print(json.dumps({
    "modules": names,
    "foreign": sorted(m for m in sys.modules
                      if m.startswith("jax")
                      or m == "hairgs_tpu" or m.startswith("hairgs_tpu.")),
    "tf32": torch.backends.cuda.matmul.allow_tf32,
}))
"""


def test_port_imports_nothing_of_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout.strip().splitlines()[-1])
    for name in ("drivers.train", "drivers.merge", "drivers.eval", "scene",
                 "models.hair", "topo.strands", "topo.graph_ops", "topo.merge",
                 "native", "core.hostsync", "losses.strand"):
        assert f"hairgs_tpu_torch.{name}" in report["modules"], name
    assert len(report["modules"]) >= 51
    assert report["foreign"] == []
    assert report["tf32"] is False
