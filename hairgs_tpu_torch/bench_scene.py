"""The bench scene of the Stage-I train step (counterpart of
bench.py:build_bench).

It draws the same numpy stream as `build_bench` (points, z, colours, then
scalings, then per camera: image, mask, orientation, confidence), so the
same seed gives the same scene in both frameworks. `build_bench`'s kNN
initial scale is overwritten by those scalings, so no kNN is needed here.
"""

import math
from typing import List, NamedTuple

import numpy as np
import torch

from hairgs_tpu_torch import resolve_device
from hairgs_tpu_torch.config import OptimizationConfig
from hairgs_tpu_torch.core.camera import Camera, make_camera
from hairgs_tpu_torch.core.sh import RGB2SH
from hairgs_tpu_torch.models.gaussian import (
    GaussianParams,
    GaussianStats,
    _round_capacity,
    params_from_numpy,
)
from hairgs_tpu_torch.optim import AdamState, adam_init


class BenchScene(NamedTuple):
    params: GaussianParams
    stats: GaussianStats
    opt_state: AdamState
    active: torch.Tensor  # (capacity,) bool
    opt_cfg: OptimizationConfig
    cams: List[Camera]
    width: int
    height: int
    count: int


def build_bench_scene(n_gaussians=100_000, width=999, height=1000, seed=0,
                      capacity_round=4096, device="cuda") -> BenchScene:
    """100k head-scale Gaussians (sh_degree 0) padded with zero rows to a
    multiple of `capacity_round`, and 4 ring cameras with random targets."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    pts = rng.normal(0, 0.11, (n_gaussians, 3)).astype(np.float32)
    pts[:, 2] = 0.55 + rng.normal(0, 0.05, n_gaussians)
    colors = rng.uniform(0.05, 0.95, (n_gaussians, 3)).astype(np.float32)
    scaling = np.log(rng.uniform(5e-4, 3e-3, (n_gaussians, 3))).astype(np.float32)

    inv_sig = lambda x: math.log(x / (1 - x))
    rots = np.zeros((n_gaussians, 4), dtype=np.float32)
    rots[:, 0] = 1.0
    arrays = dict(
        xyz=pts,
        features_dc=RGB2SH(colors)[:, None, :],
        features_rest=np.zeros((n_gaussians, 0, 3), dtype=np.float32),
        scaling=scaling,
        rotation=rots,
        opacity=np.full((n_gaussians, 1), inv_sig(0.1), dtype=np.float32),
        mask=np.full((n_gaussians, 1), inv_sig(0.5), dtype=np.float32),
    )
    cap = _round_capacity(n_gaussians, capacity_round)
    arrays = {k: np.concatenate(
        [v, np.zeros((cap - n_gaussians,) + v.shape[1:], v.dtype)])
        for k, v in arrays.items()}
    params = params_from_numpy(arrays, dev)
    active = torch.arange(cap, device=dev) < n_gaussians
    stats = GaussianStats(
        max_radii2d=torch.zeros((cap,), device=dev),
        xyz_grad_accum=torch.zeros((cap, 1), device=dev),
        denom=torch.zeros((cap, 1), device=dev))

    cams = []
    c = np.array([0.0, 0.0, 0.55])  # cloud center
    for i in range(4):
        angle = 2 * np.pi * i / 4
        R = np.array([
            [np.cos(angle), 0, np.sin(angle)],
            [0, 1, 0],
            [-np.sin(angle), 0, np.cos(angle)],
        ])
        img = rng.uniform(0, 1, (height, width, 3)).astype(np.float32)
        mask = (rng.uniform(0, 1, (height, width)) > 0.5).astype(np.float32)
        orient = rng.uniform(0, np.pi, (height, width)).astype(np.float32)
        conf = rng.uniform(0, 1, (height, width)).astype(np.float32)
        cams.append(make_camera(R, c - R.T @ c, fovx=1.2, fovy=1.0, image=img,
                                mask=mask, orientation=orient,
                                confidence=conf, device=dev))
    return BenchScene(params=params, stats=stats, opt_state=adam_init(params),
                      active=active, opt_cfg=OptimizationConfig(), cams=cams,
                      width=width, height=height, count=n_gaussians)
