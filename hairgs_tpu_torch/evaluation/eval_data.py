"""Adapters converting models / files into HairEvalData for metric
evaluation (counterpart of hairgs_tpu/evaluation/eval_data.py, host path;
the device-side point sets come with device_metrics.py, ROADMAP Queue 1
item 7).

Parity target: data/eval_data.py — converters from live models (l.121-171),
own checkpoint PLYs (l.174-186), and external method outputs (Strand
Integration l.38-82, Neural Haircut l.85-118).
"""

import numpy as np
import torch

from hairgs_tpu_torch.io.npz import HairEvalData, load_hair_eval_data_npz
from hairgs_tpu_torch.io.ply import count_ply_elements, read_ply


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
