"""COLMAP scene reading -> the port's cameras (counterpart of
hairgs_tpu/io/dataset.py).

Parity target: data/dataset_readers.py (readColmapSceneInfo, readColmapCameras,
getNerfppNorm) and scene/cameras.py:135-202 (_loadCam resolution handling).
"""

import math
import os
from typing import List, NamedTuple, Optional

import numpy as np

from hairgs_tpu_torch.core.camera import Camera, fov2focal, focal2fov, make_camera, world_to_view
from hairgs_tpu_torch.io.colmap import (
    qvec2rotmat,
    read_extrinsics_binary,
    read_extrinsics_text,
    read_intrinsics_binary,
    read_intrinsics_text,
    read_points3D_binary,
    read_points3D_text,
)
from hairgs_tpu_torch.io.ply import fetch_point_ply, store_point_ply


class CameraInfo(NamedTuple):
    uid: int
    R: np.ndarray
    T: np.ndarray
    fovx: float
    fovy: float
    image_path: str
    image_name: str
    width: int
    height: int
    mask_path: Optional[str]
    orientation_path: Optional[str]
    confidence_path: Optional[str]


class SceneInfo(NamedTuple):
    points: Optional[np.ndarray]
    colors: Optional[np.ndarray]
    cameras: List[CameraInfo]
    nerf_normalization: dict
    ply_path: str


def get_nerfpp_norm(cam_infos) -> dict:
    """Camera-extent radius (data/dataset_readers.py:57-78)."""
    centers = []
    for cam in cam_infos:
        w2c = world_to_view(cam.R, cam.T)
        centers.append(np.linalg.inv(w2c)[:3, 3])
    centers = np.stack(centers, axis=1)
    avg = centers.mean(axis=1, keepdims=True)
    diagonal = np.linalg.norm(centers - avg, axis=0).max()
    return {"translate": -avg.flatten(), "radius": diagonal * 1.1}


def read_colmap_scene_info(path: str, images: Optional[str] = None) -> SceneInfo:
    sparse = os.path.join(path, "sparse/0")
    try:
        cam_extrinsics = read_extrinsics_binary(os.path.join(sparse, "images.bin"))
        cam_intrinsics = read_intrinsics_binary(os.path.join(sparse, "cameras.bin"))
    except (FileNotFoundError, OSError):
        cam_extrinsics = read_extrinsics_text(os.path.join(sparse, "images.txt"))
        cam_intrinsics = read_intrinsics_text(os.path.join(sparse, "cameras.txt"))

    images_folder = os.path.join(path, images or "images")
    masks_folder = os.path.join(path, "masks")
    orientations_folder = os.path.join(path, "orientations")

    cam_infos = []
    for key in cam_extrinsics:
        extr = cam_extrinsics[key]
        intr = cam_intrinsics[extr.camera_id]
        R = qvec2rotmat(extr.qvec).T
        T = np.array(extr.tvec)
        if intr.model == "SIMPLE_PINHOLE":
            fovy = focal2fov(intr.params[0], intr.height)
            fovx = focal2fov(intr.params[0], intr.width)
        elif intr.model == "PINHOLE":
            fovy = focal2fov(intr.params[1], intr.height)
            fovx = focal2fov(intr.params[0], intr.width)
        else:
            raise ValueError(
                f"COLMAP camera model {intr.model} not handled (PINHOLE only)"
            )
        image_file = os.path.basename(extr.name)
        image_path = os.path.join(images_folder, image_file)
        image_name = os.path.basename(image_path).split(".")[0]
        mask_path = os.path.join(masks_folder, image_file)
        orient_path = os.path.join(orientations_folder, f"{image_name}_orientation.png")
        conf_path = os.path.join(orientations_folder, f"{image_name}_confidence.png")
        cam_infos.append(
            CameraInfo(
                uid=intr.id,
                R=R,
                T=T,
                fovx=fovx,
                fovy=fovy,
                image_path=image_path,
                image_name=image_name,
                width=intr.width,
                height=intr.height,
                mask_path=mask_path if os.path.exists(mask_path) else None,
                orientation_path=orient_path if os.path.exists(orient_path) else None,
                confidence_path=conf_path if os.path.exists(conf_path) else None,
            )
        )
    cam_infos = sorted(cam_infos, key=lambda x: x.image_name)
    norm = get_nerfpp_norm(cam_infos)

    ply_path = os.path.join(sparse, "points3D.ply")
    if not os.path.exists(ply_path):
        try:
            xyz, rgb, _ = read_points3D_binary(os.path.join(sparse, "points3D.bin"))
        except (FileNotFoundError, OSError):
            xyz, rgb, _ = read_points3D_text(os.path.join(sparse, "points3D.txt"))
        store_point_ply(ply_path, xyz, rgb)
    try:
        points, colors, _ = fetch_point_ply(ply_path)
    except (FileNotFoundError, OSError):
        points, colors = None, None

    return SceneInfo(
        points=points,
        colors=colors,
        cameras=cam_infos,
        nerf_normalization=norm,
        ply_path=ply_path,
    )


def _resolve_resolution(orig_w, orig_h, resolution, resolution_scale):
    """Resolution policy of scene/cameras.py:135-158 (cap at 1600px width)."""
    if resolution in (1, 2, 4, 8):
        return (
            round(orig_w / (resolution_scale * resolution)),
            round(orig_h / (resolution_scale * resolution)),
        )
    if resolution == -1:
        global_down = orig_w / 1600 if orig_w > 1600 else 1
    else:
        global_down = orig_w / resolution
    scale = float(global_down) * float(resolution_scale)
    return int(orig_w / scale), int(orig_h / scale)


def load_camera(info: CameraInfo, resolution: int = -1, resolution_scale: float = 1.0,
                device="cuda") -> Camera:
    """Load images from disk and build a Camera on `device`.

    Mask is a binary {0,1} grayscale; orientation maps scale to [0,pi] and
    confidence to [0,1] (data/dataset_readers.py:123-159)."""
    from PIL import Image as PILImage

    pil = PILImage.open(info.image_path)
    w, h = _resolve_resolution(*pil.size, resolution, resolution_scale)
    img = np.asarray(pil.resize((w, h)), dtype=np.float32) / 255.0
    alpha = None
    if img.ndim == 3 and img.shape[2] == 4:
        alpha = img[..., 3]
        img = img[..., :3]
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=2)
    img = np.clip(img, 0.0, 1.0)
    if alpha is not None:
        img = img * alpha[..., None]

    def _gray(path, scale):
        if path is None:
            return None
        g = PILImage.open(path).convert("L")
        if (w, h) != g.size:
            g = g.resize((w, h), PILImage.NEAREST)
        return np.asarray(g, dtype=np.float32) * scale

    mask = _gray(info.mask_path, 1.0 / 255.0)
    if mask is not None:
        mask = (mask > 0.5).astype(np.float32)
    orientation = _gray(info.orientation_path, math.pi / 255.0)
    confidence = _gray(info.confidence_path, 1.0 / 255.0)

    return make_camera(
        info.R, info.T, info.fovx, info.fovy,
        image=img, mask=mask, orientation=orientation, confidence=confidence,
        device=device,
    )


def camera_to_json(idx: int, cam: CameraInfo) -> dict:
    """scene/cameras.py:205-225."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = cam.R.T
    Rt[:3, 3] = cam.T
    Rt[3, 3] = 1.0
    w2c = np.linalg.inv(Rt)
    return {
        "id": idx,
        "img_name": cam.image_name,
        "width": cam.width,
        "height": cam.height,
        "position": w2c[:3, 3].tolist(),
        "rotation": [r.tolist() for r in w2c[:3, :3]],
        "fy": fov2focal(cam.fovy, cam.height),
        "fx": fov2focal(cam.fovx, cam.width),
    }
