"""The port stands alone: importing every module of hairgs_tpu_torch (the
drivers, the hair model, the topology, the parallel package and the native
library's wrapper too) and the module scope of chip_smoke.py, in a fresh interpreter, loads
nothing of JAX, of the JAX package, of scripts/ or of OpenCV (cv2, which the card's
machine does not have), and leaves TF32 switched off for matmuls and for cuDNN's
convolutions."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import importlib, json, os, pkgutil, sys
import hairgs_tpu_torch
scripts = os.path.join(os.getcwd(), "scripts") + os.sep
names = [m.name for m in pkgutil.walk_packages(hairgs_tpu_torch.__path__,
                                               "hairgs_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
import torch
print(json.dumps({
    "modules": names,
    "foreign": sorted(m for m, mod in list(sys.modules.items())
                      if m.startswith("jax")
                      or m == "cv2" or m.startswith("cv2.")
                      or m == "hairgs_tpu" or m.startswith("hairgs_tpu.")
                      or m == "scripts" or m.startswith("scripts.")
                      or (getattr(mod, "__file__", None) or "").startswith(scripts)),
    "tf32": torch.backends.cuda.matmul.allow_tf32,
    "cudnn_tf32": torch.backends.cudnn.allow_tf32,
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
                 "native", "core.hostsync", "losses.strand",
                 "evaluation.device_metrics", "topo.async_events", "drivers.render",
                 "drivers.parse_usc_hairsalon", "data.vision", "data.usc",
                 "data.head", "data.cy", "data.flame", "visualization",
                 "network_gui", "parallel", "parallel.mesh", "parallel.slab",
                 "parallel.multihost", "drivers.convert_output", "drivers.pipeline",
                 "drivers.grow_and_save", "drivers.parse_nersemble",
                 "drivers.synthesize_usc_sample"):
        assert f"hairgs_tpu_torch.{name}" in report["modules"], name
    assert len(report["modules"]) >= 75
    assert report["foreign"] == []
    assert report["tf32"] is False
    assert report["cudnn_tf32"] is False
