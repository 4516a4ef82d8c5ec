"""Head mesh loading (OBJ) for the synthetic dataset pipelines
(counterpart of hairgs_tpu/data/head.py; host numpy).

Parity target: data/head_data.py — USC-HairSalon and Cem-Yuksel head OBJ
loaders with the same scale/rotation conventions as the matching hair
loaders; vertex normals estimated when missing.
"""

from typing import NamedTuple, Optional

import numpy as np


class HeadData(NamedTuple):
    verts: np.ndarray
    colors: np.ndarray
    normals: Optional[np.ndarray]
    faces: np.ndarray


def load_obj(path: str):
    """Minimal OBJ reader: v / vn / f (triangulated on the fly)."""
    verts, normals, faces = [], [], []
    with open(path) as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == "v":
                verts.append([float(x) for x in t[1:4]])
            elif t[0] == "vn":
                normals.append([float(x) for x in t[1:4]])
            elif t[0] == "f":
                idx = [int(p.split("/")[0]) - 1 for p in t[1:]]
                for k in range(1, len(idx) - 1):  # fan triangulation
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return (
        np.asarray(verts, np.float32),
        np.asarray(normals, np.float32) if normals else None,
        np.asarray(faces, np.int64),
    )


def estimate_vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted face-normal accumulation (replaces the pytorch3d
    pointcloud-normal estimate of the reference, which is viz-only)."""
    normals = np.zeros_like(verts)
    tri = verts[faces]
    fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    for i in range(3):
        np.add.at(normals, faces[:, i], fn)
    norm = np.linalg.norm(normals, axis=1, keepdims=True)
    return normals / np.maximum(norm, 1e-12)


def load_head_from_usc_dataset(path: str, color=(0.8, 0.62, 0.52, 1.0)) -> HeadData:
    verts, normals, faces = load_obj(path)
    if normals is None or normals.shape[0] != verts.shape[0]:
        normals = estimate_vertex_normals(verts, faces)
    colors = np.tile(np.asarray(color, np.float32), (verts.shape[0], 1))
    return HeadData(verts=verts, colors=colors, normals=normals, faces=faces)


def load_head_from_cy_dataset(path: str, color=(0.8, 0.62, 0.52, 1.0)) -> HeadData:
    """Same scaling/rotation as the CY hair loader (data/hair_data.py:213-219)."""
    verts, normals, faces = load_obj(path)
    verts = 0.25 * verts / 100
    rx = np.array([[1, 0, 0], [0, 0, 1], [0, -1, 0]], dtype=np.float64)
    ry = np.array([[0, 0, -1], [0, 1, 0], [1, 0, 0]], dtype=np.float64)
    verts = ((ry @ rx @ verts.T).T).astype(np.float32)
    if normals is None or normals.shape[0] != verts.shape[0]:
        normals = estimate_vertex_normals(verts, faces)
    else:
        normals = ((ry @ rx @ normals.T).T).astype(np.float32)
    colors = np.tile(np.asarray(color, np.float32), (verts.shape[0], 1))
    return HeadData(verts=verts, colors=colors, normals=normals, faces=faces)


head_data_load_callbacks = {
    "usc_hair_salon": load_head_from_usc_dataset,
    "cem_yuksel": load_head_from_cy_dataset,
}
