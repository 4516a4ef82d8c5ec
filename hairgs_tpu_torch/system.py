"""Process-level helpers (counterpart of hairgs_tpu/system.py).

Parity target: utils/general.py:87-116 (safe_state: timestamped stdout +
deterministic seeding)."""

import random
import sys
from datetime import datetime

import numpy as np
import torch


class _TimestampedStdout:
    def __init__(self, wrapped, silent: bool):
        self._wrapped = wrapped
        self._silent = silent

    def write(self, x):
        if self._silent:
            return
        if x.endswith("\n"):
            stamp = datetime.now().strftime("%d/%m %H:%M:%S")
            self._wrapped.write(x.replace("\n", f" [{stamp}]\n"))
        else:
            self._wrapped.write(x)

    def flush(self):
        self._wrapped.flush()

    def __getattr__(self, name):
        return getattr(self._wrapped, name)


def safe_state(silent: bool = False, seed: int = 0):
    """Timestamp every stdout line and seed the RNGs: Python's `random` and
    numpy's exactly as the JAX package seeds them (the Scene shuffle and
    the camera pops then draw the same sequence), plus torch's."""
    sys.stdout = _TimestampedStdout(sys.stdout, silent)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
