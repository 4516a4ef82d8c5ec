"""Plain PyTorch reference of the first Stage-III training steps: the strand
graph's segments as Gaussians (centre the midpoint, the long axis along the
segment with scale |b - a| / 2 x the p-value factor, both short axes the
segment's width), rendered, lossed and stepped by the Stage-I reference
(stage1.py), plus the angle-smoothness term on consecutive segments.

It works from the graph as the benchmark generated it (endpoints, segment
pairs, per-segment values): the consecutive-segment table comes from the
endpoints that join two segments, not from the program's strand walk. It
imports torch, numpy, math and statistics (for the normal quantile) and
the Stage-I reference only.
"""

import math
import statistics
from typing import Dict

import numpy as np
import torch

from benchmark.reference import stage1 as s1

MIN_VAL = 1e-7
LEAVES = ("endpoints", "features_dc", "opacity", "mask", "width")


def dist_to_scale_factor(pval: float) -> float:
    """1 / the standard normal quantile of 1 - pval / 2."""
    return 1.0 / statistics.NormalDist().inv_cdf(1.0 - pval / 2.0)


def initial_leaves(graph: dict, device) -> Dict[str, torch.Tensor]:
    def t(k):
        return torch.tensor(np.asarray(graph[k], np.float32), device=device)

    return {k: t(k) for k in LEAVES}


def consecutive_pairs(pairs: np.ndarray) -> np.ndarray:
    """(M, 2, 2) endpoint ids [[a, b], [b, c]] of every two segments that
    share an endpoint b of degree two."""
    pairs = np.asarray(pairs, np.int64)
    n_ep = int(pairs.max()) + 1
    deg = np.bincount(pairs.ravel(), minlength=n_ep)
    rows = np.repeat(np.arange(pairs.shape[0]), 2)
    ends = pairs.ravel()
    order = np.argsort(ends, kind="stable")
    ends, rows = ends[order], rows[order]
    joint = deg[ends] == 2
    ends, rows = ends[joint].reshape(-1, 2)[:, 0], rows[joint].reshape(-1, 2)
    other = np.where(pairs[rows, 0] == ends[:, None], pairs[rows, 1], pairs[rows, 0])
    return np.stack([np.stack([other[:, 0], ends], 1),
                     np.stack([ends, other[:, 1]], 1)], 1)


def hair_model(pairs: np.ndarray, opt: dict, device) -> s1.Model:
    """The Stage-III leaves as a stage1.Model over the graph `pairs`."""
    idx = torch.tensor(np.asarray(pairs, np.int64), device=device)
    consec = torch.tensor(consecutive_pairs(pairs), device=device)
    factor = dist_to_scale_factor(opt["pval"])
    cos_th = math.cos(math.radians(30.0))

    def segment(p):
        a, b = p["endpoints"][idx[:, 0]], p["endpoints"][idx[:, 1]]
        diff = b - a
        norm = torch.sqrt(torch.sum(diff * diff, dim=-1, keepdim=True) + 1e-24)
        return a, b, norm, diff / torch.clamp(norm, min=MIN_VAL)

    def geometry(p, prec):
        a, b, norm, d = segment(p)
        long2 = torch.clamp(norm / 2.0 * factor, min=MIN_VAL) ** 2
        short2 = torch.exp(p["width"]) ** 2
        outer = prec.mm((long2 - short2)[:, :, None] * d[:, :, None], d[:, None, :])
        cov3 = outer + short2[:, :, None] * torch.eye(3, device=d.device)
        return 0.5 * (a + b), cov3, torch.sigmoid(p["opacity"])[:, 0]

    def features(p):
        rgb = torch.clamp(s1.SH_C0 * p["features_dc"][:, 0, :] + 0.5, min=0.0)
        return torch.cat([rgb, torch.sigmoid(p["mask"]), segment(p)[3]], dim=1)

    def smoothness(p, prec):
        """Mean squared angle between consecutive segments that bend by
        more than 30 degrees (0 where none does)."""
        pos = p["endpoints"][consec]  # (M, 2, 2, 3)
        dirs = pos[:, :, 1] - pos[:, :, 0]
        norm = torch.sqrt(torch.sum(dirs * dirs, dim=-1, keepdim=True) + 1e-24)
        dirs = dirs / torch.clamp(norm, min=MIN_VAL)
        dots = torch.sum(dirs[:, 0] * dirs[:, 1], dim=-1)
        sel = dots <= cos_th
        angles = torch.arccos(torch.clamp(dots, -1 + 1e-6, 1 - 1e-6))
        total = torch.sum(torch.where(sel, angles * angles, torch.zeros_like(angles)))
        return opt["lambda_smooth"] * total / torch.clamp(sel.sum(), min=1)

    return s1.Model(
        LEAVES, "endpoints", geometry, features,
        lambda o: dict(endpoints=0.0, features_dc=o["feature_lr"], opacity=o["opacity_lr"],
                       mask=o["mask_lr"], width=o["scaling_lr"]),
        smoothness)
