"""Synthetic camera-ring generation for dataset preparation (counterpart
of hairgs_tpu/data/cameras.py; numpy only).

Parity target: utils/camera.py:41-100 — (N-1) cameras on a circle around the
anchor (rotating the given base pose about the y axis) plus one top view;
SIMPLE_PINHOLE with focal length 500px.
"""

import numpy as np

from hairgs_tpu_torch.io.colmap import ColmapCamera


def _rot(axis: str, angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    if axis == "x":
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    if axis == "y":
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def generate_cameras(number_cameras: int, height: int, width: int,
                     cam_pose: np.ndarray = None,
                     anchor_pos: np.ndarray = np.zeros(3),
                     offset: float = 0.5,
                     rotation_axis: str = "y",
                     focal_length_px: float = 500.0):
    """Returns (cameras: {id: ColmapCamera}, extrinsics: {id: 4x4 w2c})."""
    if cam_pose is None:
        cam_pose = np.eye(4)
    cameras, extrinsics = {}, {}
    n_ring = number_cameras - 1
    for i in range(n_ring):
        pose = cam_pose.copy()
        angle = 2 * np.pi * (i / n_ring)
        pose[:3, 3] -= anchor_pos
        t = np.eye(4)
        t[:3, :3] = _rot(rotation_axis, angle)
        pose = t @ pose
        pose[:3, 3] += anchor_pos
        extrinsics[i + 1] = np.linalg.inv(pose)
        cameras[i + 1] = ColmapCamera(
            id=i + 1, model="SIMPLE_PINHOLE", width=width, height=height,
            params=np.array([focal_length_px, width / 2, height / 2]),
        )
    # top view (utils/camera.py:85-99)
    pose = cam_pose.copy()
    pose[:3, 3] = anchor_pos + np.array([0, offset, 0])
    pose[:3, :3] = _rot("x", 3 * np.pi / 2) @ pose[:3, :3]
    extrinsics[number_cameras] = np.linalg.inv(pose)
    cameras[number_cameras] = ColmapCamera(
        id=number_cameras, model="SIMPLE_PINHOLE", width=width, height=height,
        params=np.array([focal_length_px, width / 2, height / 2]),
    )
    return cameras, extrinsics
