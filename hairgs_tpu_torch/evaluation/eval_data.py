"""Adapters converting models / files into HairEvalData for metric
evaluation (counterpart of hairgs_tpu/evaluation/eval_data.py): the host
converters, and the device-side point sets that evaluation/device_metrics.py
matches without pulling the model.

Parity target: data/eval_data.py — converters from live models (l.121-171),
own checkpoint PLYs (l.174-186), and external method outputs (Strand
Integration l.38-82, Neural Haircut l.85-118).
"""

import numpy as np
import torch

from hairgs_tpu_torch.io.npz import HairEvalData, load_hair_eval_data_npz
from hairgs_tpu_torch.io.ply import count_ply_elements, read_ply


def eval_points_device_from_gaussian(model):
    """(points, directions, valid) on the model's device over the
    capacity-padded arena: the in-training counterpart of
    compute_eval_data_from_gaussian (no host pull; padded rows masked by
    `valid`). Foreground by the opacity and mask thresholds
    (scene/gaussian_model.py:727-795)."""
    from hairgs_tpu_torch.models.gaussian import (
        FG_BIN_TH,
        OPACITY_TH,
        gaussian_activations,
        gaussian_orientation,
    )

    p = model.params
    with torch.no_grad():
        act = gaussian_activations(p)
        valid = (model.active
                 & (act["opacity"][:, 0] >= OPACITY_TH)
                 & (act["mask"][:, 0] >= FG_BIN_TH))
        return p.xyz.detach(), gaussian_orientation(p), valid


def eval_points_device_from_hair(model):
    """(points, directions, valid) on the device for a HairModel: per
    segment of the strands info (the foreground segments the host
    converter walks), its first endpoint in strand order and its
    normalised direction, the point and direction set of
    compute_eval_data_from_hair, which the metrics take in any order.

    JAX's counterpart takes each segment's stored first endpoint instead;
    the strand walk runs some segments the other way and flips strands to
    start at the scalp, so its set differs from the host's (on the H100
    smoke capture its F1(b) read 0.5177 against the host oracle's 0.5263).
    The per-row order comes from the host-side strands info, which the
    topology events keep current; the endpoints stay on the device."""
    from hairgs_tpu_torch.core.maths import safe_norm

    cap = model.graph.endpoint_pairs.shape[0]
    ends = np.full((cap, 2), 0, np.int64)
    valid = np.zeros(cap, bool)
    info = model.strands_info
    if info is not None and info.list_strands:
        rows = np.concatenate(info.list_strands_segments_id)
        ends[rows] = np.concatenate(info.list_strands, axis=0)
        valid[rows] = True
    dev = model.device
    ends = torch.from_numpy(ends).to(dev)
    ep = model.params.endpoints
    with torch.no_grad():
        start = ep[ends[:, 0]]
        d = ep[ends[:, 1]] - start
        dirs = d / safe_norm(d, dim=-1, keepdim=True)
    return start, dirs, torch.from_numpy(valid).to(dev)


def compute_eval_data_from_gaussian(model) -> HairEvalData:
    """Foreground Gaussian centers + principal-axis directions
    (data/eval_data.py:121-130), on the host."""
    from hairgs_tpu_torch.models.gaussian import gaussian_orientation

    arrays = model.host_arrays()
    mask = model.compute_foreground_mask_np(arrays)
    points = arrays["xyz"][mask]
    with torch.no_grad():
        orient = gaussian_orientation(model.params)[: model.count].cpu().numpy()
    return HairEvalData(points=points, directions=orient[mask],
                        points_id_to_strand_id=None, edges=None)


def compute_eval_data_from_hair(model, compute_edges: bool = False) -> HairEvalData:
    """Per-segment start points + directions in strand order
    (data/eval_data.py:133-171), on the host."""
    endpoints = model.host_arrays(keys=("endpoints",))["endpoints"]
    info = model.strands_info
    if info is None or not info.list_strands:
        return HairEvalData(points=np.zeros((0, 3)), directions=np.zeros((0, 3)),
                            points_id_to_strand_id=np.zeros(0, np.int32), edges=None)
    segments_id = np.concatenate(info.list_strands, axis=0)
    segments = endpoints[segments_id]
    directions = segments[:, 1] - segments[:, 0]
    directions = directions / np.linalg.norm(directions, axis=1, keepdims=True)
    points_id = segments_id[:, 0]
    points = endpoints[points_id]
    p2s = info.id_to_strand_id[points_id]
    edges = None
    if compute_edges:
        mapping = np.zeros(int(segments_id.max()) + 1, dtype=np.int32)
        mapping[segments_id[:, 0]] = np.arange(segments_id.shape[0])
        u, c = np.unique(segments_id, return_counts=True)
        u = u[c > 1]
        mask = np.isin(segments_id[:, 1], u)
        edges = mapping[segments_id[mask]]
    return HairEvalData(points=points, directions=directions,
                        points_id_to_strand_id=p2s, edges=edges)


def load_eval_data_from_gaussians(path: str, sh_degree: int = 0,
                                  device="cuda") -> HairEvalData:
    """Load a checkpoint PLY on `device` and convert; the model class is
    dispatched on the element count (data/eval_data.py:174-186)."""
    from hairgs_tpu_torch.models.gaussian import GaussianModel
    from hairgs_tpu_torch.models.hair import HairModel

    if count_ply_elements(path) == 1:
        g = GaussianModel(sh_degree=sh_degree, device=device)
        g.load_ply(path)
        return compute_eval_data_from_gaussian(g)
    h = HairModel(sh_degree=sh_degree, device=device)
    h.load_ply(path)
    return compute_eval_data_from_hair(h, compute_edges=True)


def load_eval_data_from_strand_integration_output(path: str) -> HairEvalData:
    """data/eval_data.py:38-82 — points with directions in the normals."""
    elements = read_ply(path)
    assert len(elements) in (1, 4)
    v = elements[0][1]
    points = np.stack([v["x"], v["y"], v["z"]], axis=1)
    directions = np.stack([v["nx"], v["ny"], v["nz"]], axis=1)
    directions = directions / np.linalg.norm(directions, axis=1, keepdims=True)
    p2s = None
    edges = None
    if len(elements) == 4:
        p2s = np.asarray(elements[2][1]["points_id_to_strand_id"])
        e = elements[3][1]
        edges = np.stack([e["vertex1"], e["vertex2"]], axis=1)
    return HairEvalData(points=points, directions=directions,
                        points_id_to_strand_id=p2s, edges=edges)


def load_eval_data_from_neural_haircut_output(
    path: str, num_points_per_strand: int = 100
) -> HairEvalData:
    """data/eval_data.py:85-118 — flat vertex list of fixed-length strands."""
    elements = read_ply(path)
    v = elements[0][1]
    points = np.stack([v["x"], v["y"], v["z"]], axis=1)
    strands = points.reshape(-1, num_points_per_strand, 3)
    num_strands = strands.shape[0]
    n = num_strands * (num_points_per_strand - 1)
    directions = (strands[:, 1:] - strands[:, :-1]).reshape(n, 3)
    directions = directions / np.linalg.norm(directions, axis=1, keepdims=True)
    points = strands[:, :-1].reshape(n, 3)
    p2s = np.repeat(np.arange(num_strands), num_points_per_strand - 1)
    per = num_points_per_strand - 1
    offs = np.arange(num_strands)[:, None] * per
    base = np.arange(num_points_per_strand - 2)
    edges = np.stack(
        [(offs + base).ravel(), (offs + base + 1).ravel()], axis=1
    )
    return HairEvalData(points=points, directions=directions,
                        points_id_to_strand_id=p2s, edges=edges)


eval_data_loading_callbacks = {
    "gt": load_hair_eval_data_npz,
    "strand_integration": load_eval_data_from_strand_integration_output,
    "neural_haircut": load_eval_data_from_neural_haircut_output,
    "gs": load_eval_data_from_gaussians,
}
