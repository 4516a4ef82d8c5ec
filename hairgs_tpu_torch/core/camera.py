"""Camera model (counterpart of hairgs_tpu/core/camera.py).

The matrices are built in numpy (float64, cast to float32) exactly as the
JAX package builds them, then moved to the requested device. Matrices are in
math convention and applied as ``M @ [p, 1]``.
"""

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from hairgs_tpu_torch import resolve_device


def fov2focal(fov, pixels):
    return pixels / (2 * math.tan(fov / 2))


def focal2fov(focal, pixels):
    return 2 * math.atan(pixels / (2 * focal))


def world_to_view(R, t, translate=np.array([0.0, 0.0, 0.0]), scale=1.0):
    """World->view 4x4 from COLMAP-style (R, t); reference getWorld2View2
    (utils/graphics.py:38-49). R is camera-to-world, t world-to-camera."""
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = np.asarray(R).T
    Rt[:3, 3] = np.asarray(t)
    Rt[3, 3] = 1.0
    C2W = np.linalg.inv(Rt)
    cam_center = (C2W[:3, 3] + translate) * scale
    C2W[:3, 3] = cam_center
    return np.linalg.inv(C2W).astype(np.float32)


def projection_matrix(znear, zfar, fovx, fovy):
    """OpenGL-style projection (reference utils/graphics.py:51-71)."""
    tan_half_fovy = math.tan(fovy / 2)
    tan_half_fovx = math.tan(fovx / 2)
    top = tan_half_fovy * znear
    right = tan_half_fovx * znear
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


class Camera(NamedTuple):
    """One view as tensors. image / mask / orientation are channels-last
    (H, W, C) / (H, W), the JAX package's layout."""

    world_view: torch.Tensor  # (4,4) world -> view
    full_proj: torch.Tensor  # (4,4) proj @ world_view
    cam_center: torch.Tensor  # (3,)
    tanfovx: torch.Tensor  # ()
    tanfovy: torch.Tensor  # ()
    image: Optional[torch.Tensor] = None  # (H,W,3) in [0,1]
    mask: Optional[torch.Tensor] = None  # (H,W) float {0,1}
    orientation: Optional[torch.Tensor] = None  # (H,W) radians in [0,pi)
    confidence: Optional[torch.Tensor] = None  # (H,W) in [0,1]

    @property
    def height(self) -> int:
        return int(self.image.shape[-3])

    @property
    def width(self) -> int:
        return int(self.image.shape[-2])


def _f32(x, device):
    return None if x is None else torch.tensor(
        np.asarray(x, dtype=np.float32), device=device)


def make_camera(R, t, fovx, fovy, image=None, mask=None, orientation=None,
                confidence=None, znear=0.01, zfar=100.0,
                trans=np.array([0.0, 0.0, 0.0]), scale=1.0,
                device="cuda") -> Camera:
    """Camera from COLMAP-style extrinsics (znear/zfar defaults match
    reference scene/cameras.py:87-88)."""
    dev = resolve_device(device)
    w2v = world_to_view(R, t, trans, scale)
    proj = projection_matrix(znear, zfar, fovx, fovy)
    full = proj @ w2v
    cam_center = np.linalg.inv(w2v)[:3, 3]
    return Camera(
        world_view=_f32(w2v, dev),
        full_proj=_f32(full, dev),
        cam_center=_f32(cam_center, dev),
        tanfovx=_f32(math.tan(fovx * 0.5), dev),
        tanfovy=_f32(math.tan(fovy * 0.5), dev),
        image=_f32(image, dev),
        mask=_f32(mask, dev),
        orientation=_f32(orientation, dev),
        confidence=_f32(confidence, dev),
    )


def stack_cameras(cams) -> Camera:
    """A batched Camera from a list of Cameras: every tensor gains a leading
    view axis B. A field that is None in any camera is None in the batch."""
    def _stack(*xs):
        if any(x is None for x in xs):
            return None
        return torch.stack(xs)

    return Camera(*[_stack(*fields) for fields in zip(*cams)])


def camera_view(camera: Camera, b: int) -> Camera:
    """View b of a batched Camera."""
    return Camera(*[None if x is None else x[b] for x in camera])
