"""npz formats for evaluation GT and head/scalp reconstruction data; the
port's own copy of hairgs_tpu/io/npz.py (numpy only).

Parity targets:
- hair_eval_data.npz (data/hair_data.py:30-60: points/directions/
  points_id_to_strand_id/edges; data/eval_data.py:23-35 loader)
- head_reconstruction_data.npz (data/head_reconstruction_data.py:13-38)
"""

from typing import NamedTuple, Optional

import numpy as np


class HairEvalData(NamedTuple):
    points: np.ndarray  # (N,3)
    directions: np.ndarray  # (N,3) normalized
    points_id_to_strand_id: Optional[np.ndarray]
    edges: Optional[np.ndarray]


class HeadReconstruction(NamedTuple):
    head_verts: np.ndarray
    scalp_verts: np.ndarray


class HairData(NamedTuple):
    """Parsed synthetic hair dataset (data/hair_data.py:21-27)."""

    verts: np.ndarray
    colors: np.ndarray
    normals: Optional[np.ndarray]
    edges: np.ndarray
    strand_root_idx: np.ndarray
    verts_id_to_strand_id: np.ndarray


def load_hair_eval_data_npz(path: str) -> HairEvalData:
    data = np.load(path)
    directions = data["directions"]
    directions = directions / np.linalg.norm(directions, axis=1, keepdims=True)
    return HairEvalData(
        points=data["points"],
        directions=directions,
        points_id_to_strand_id=data["points_id_to_strand_id"],
        edges=data["edges"],
    )


def save_hair_eval_data_npz(path: str, hair: HairData):
    """Per-segment eval points with the tip segment kept but each strand's
    last *edge* dropped and reindexed (data/hair_data.py:38-53)."""
    points = hair.verts[hair.edges[:, 0]]
    segment_points = hair.verts[hair.edges]
    directions = segment_points[:, 1] - segment_points[:, 0]
    directions = directions / np.linalg.norm(directions, axis=1, keepdims=True)
    verts_id_to_strand_id = hair.verts_id_to_strand_id[hair.edges[:, 0]]
    edges = hair.edges
    mask = np.isin(edges[:, 1], edges[:, 0])
    edges = edges[mask]
    old_indices = np.unique(edges)
    new_indices = np.arange(old_indices.shape[0])
    mapping = np.zeros(old_indices.max() + 1, dtype=new_indices.dtype)
    mapping[old_indices] = new_indices
    edges = mapping[edges]
    np.savez(
        path,
        points=points,
        directions=directions,
        points_id_to_strand_id=verts_id_to_strand_id,
        edges=edges,
    )


def load_head_reconstruction_data_npz(path: str) -> HeadReconstruction:
    data = np.load(path)
    return HeadReconstruction(
        head_verts=data["head_verts"], scalp_verts=data["scalp_verts"]
    )


def save_head_reconstruction_data_npz(path: str, head_verts: np.ndarray,
                                      scalp_verts: np.ndarray):
    np.savez(path, head_verts=head_verts, scalp_verts=scalp_verts)
