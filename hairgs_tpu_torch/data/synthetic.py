"""Synthetic multi-view dataset generation from strand geometry
(counterpart of hairgs_tpu/data/synthetic.py).

GT strand polylines are rendered as thin opaque Gaussian segments with the
port's own renderer, and the dataset layout is the JAX package's:

    output/
      images/image_{id}.png
      masks/image_{id}.png                       (binary hair mask)
      orientations/image_{id}_orientation.png    (theta/pi * 255)
      orientations/image_{id}_confidence.png
      sparse/0/{cameras,images,points3D}.bin     (COLMAP)
      hair_eval_data.npz
      head_reconstruction_data.npz

The renders run on `device` (the card unless the caller asks for the CPU)
through whichever path `raster_cfg.use_pallas` selects: the default
configuration is the JAX package's (the XLA path); `use_pallas=True` renders
with the compositor kernels. `use_lighting` shades the segments with the
reference's Lambert term from kNN-PCA normals (ops/knn.py).
`orientation_source="gabor"` needs data/vision.py, which is not ported yet.
"""

import math
import os
from typing import Dict, Optional

import numpy as np
import torch

from hairgs_tpu_torch import resolve_device
from hairgs_tpu_torch.core.camera import focal2fov, make_camera
from hairgs_tpu_torch.core.maths import pval_to_dist_to_scale_factor
from hairgs_tpu_torch.core.transforms import quaternion_between_vectors
from hairgs_tpu_torch.data.cameras import generate_cameras
from hairgs_tpu_torch.io.colmap import (
    generate_colmap_data,
    write_cameras_binary,
    write_images_binary,
    write_points3D_binary,
)
from hairgs_tpu_torch.io.npz import HairData, save_hair_eval_data_npz, save_head_reconstruction_data_npz
from hairgs_tpu_torch.render.renderer import RasterConfig, render


def strand_segments_to_gaussians(hair: HairData, width_sigma: float = 1.5e-4,
                                 opacity: float = 0.98, pval: float = 0.05,
                                 use_lighting: bool = False,
                                 light_pos=(0.0, 5.0, 5.0),
                                 ka: float = 0.5, kd: float = 0.5,
                                 device="cuda"):
    """Convert GT polyline segments to splat parameters (one per edge), as
    numpy arrays; the rotations (and the kNN normals) are computed on
    `device`.

    use_lighting applies the reference's Lambert term to the segment colors
    (OpenGLRenderer.py fragment shader: color * (ka*ambient +
    kd*max(dot(n, normalize(lightPos - pos)), 0)*diffuse), white lights,
    ka=kd=0.5 and lightPos=(0,5,5) as set at parse_usc_hairsalon.py:103,159-162).
    Per-vertex normals come from hair.normals when the parser provides them,
    else from kNN-PCA estimation (ops/knn.py) like reference
    data/hair_data.py:124-128; a segment is shaded flat with its two
    endpoints' mean normal at its midpoint (GL interpolates per-fragment,
    indistinguishable at ~1px strand widths).
    """
    factor = pval_to_dist_to_scale_factor(pval)
    p = hair.verts[hair.edges]  # (S,2,3)
    diff = (p[:, 1] - p[:, 0]).astype(np.float32)
    length = np.linalg.norm(diff, axis=1, keepdims=True)
    ok = length[:, 0] > 1e-9
    xyz = p.mean(axis=1).astype(np.float32)
    scale_x = np.maximum(length / 2.0 * factor, 1e-7)
    scales = np.concatenate(
        [scale_x, np.full_like(scale_x, width_sigma), np.full_like(scale_x, width_sigma)],
        axis=1,
    ).astype(np.float32)
    v1 = np.tile(np.array([[1.0, 0, 0]], dtype=np.float32), (diff.shape[0], 1))
    safe = np.where(ok[:, None], diff, v1)
    dev = resolve_device(device)
    quats = quaternion_between_vectors(
        torch.tensor(v1, device=dev), torch.tensor(safe, device=dev)).cpu().numpy()
    colors = hair.colors[hair.edges[:, 0], :3].astype(np.float32)
    if use_lighting:
        if hair.normals is not None:
            vnormals = np.asarray(hair.normals, np.float32)
        else:
            from hairgs_tpu_torch.ops.knn import estimate_pointcloud_normals

            vnormals = estimate_pointcloud_normals(
                torch.tensor(np.asarray(hair.verts, np.float32), device=dev)
            ).cpu().numpy()
        n_seg = vnormals[hair.edges].mean(axis=1)
        n_seg = n_seg / np.maximum(
            np.linalg.norm(n_seg, axis=1, keepdims=True), 1e-9)
        ldir = np.asarray(light_pos, np.float32)[None, :] - xyz
        ldir = ldir / np.maximum(np.linalg.norm(ldir, axis=1, keepdims=True),
                                 1e-9)
        lambert = ka + kd * np.maximum(np.sum(n_seg * ldir, axis=1), 0.0)
        colors = colors * lambert[:, None].astype(np.float32)
    dirs = np.where(ok[:, None], diff / np.maximum(length, 1e-9), v1)
    return dict(
        means3d=xyz[ok],
        scales=scales[ok],
        rotations=quats[ok].astype(np.float32),
        opacity=np.full(ok.sum(), opacity, dtype=np.float32),
        colors=colors[ok],
        directions=dirs[ok].astype(np.float32),
    )


def _camera_from_colmap(cam, E, device):
    fov = focal2fov(cam.params[0], cam.height)
    fovx = focal2fov(cam.params[0], cam.width)
    R = E[:3, :3].T  # make_camera takes camera-to-world rotation
    return make_camera(R, E[:3, 3], fovx=fovx, fovy=fov, device=device)


def _render_strand_channels(gauss, cam, E, raster_cfg, device):
    """The fused render of one view: (channels (H, W, 7) numpy, camera,
    the renderer's output dict)."""
    camera = _camera_from_colmap(cam, E, device)
    w, h = int(cam.width), int(cam.height)
    cfg = raster_cfg or RasterConfig(max_tiles_per_gaussian=16,
                                     max_pairs_per_tile=1024, chunk=32)
    feats = np.concatenate(
        [gauss["colors"], np.ones((gauss["colors"].shape[0], 1), np.float32),
         gauss["directions"]], axis=1,
    )
    dev = camera.world_view.device
    with torch.no_grad():
        out = render(
            camera,
            **{k: torch.tensor(gauss[k], device=dev)
               for k in ("means3d", "scales", "rotations", "opacity")},
            features=torch.tensor(feats, device=dev),
            width=w,
            height=h,
            config=cfg,
        )
    return out["render"].cpu().numpy(), camera, out


def render_strand_view(gauss: Dict[str, np.ndarray], cam, E, raster_cfg=None,
                       device="cuda"):
    """Render (rgb, mask, theta-map, confidence) for one view."""
    img, camera, _ = _render_strand_channels(gauss, cam, E, raster_cfg, device)
    return _view_maps(img, camera)


def _view_maps(img, camera):
    rgb = np.clip(img[..., :3], 0, 1)
    coverage = np.clip(img[..., 3], 0, 1)
    mask = coverage > 0.5

    # analytic screen-space orientation from the rendered direction channels
    # (same projection math as the training loss, loss/losses.py:251-267)
    o_world = img[..., 4:7]
    wv = camera.world_view.cpu().numpy()
    o_view = o_world @ wv[:3, :3].T
    xy = o_view[..., :2]
    norm = np.linalg.norm(xy, axis=-1, keepdims=True)
    xy = xy / (norm + 1e-7)
    y = np.where(xy[..., 1] < 1e-7, xy[..., 1] + 1e-7, xy[..., 1])
    theta = np.arctan2(xy[..., 0], y)
    theta = np.where(theta < 0, theta + np.pi, theta)
    confidence = mask.astype(np.float32)
    return rgb, mask, theta, confidence


def generate_dataset(
    output: str,
    hair: HairData,
    head_verts: Optional[np.ndarray] = None,
    num_cameras: int = 16,
    width: int = 512,
    height: int = 512,
    cam_z: float = 0.5,
    orientation_source: str = "analytic",
    init_points: str = "gt_hair_verts",
    init_subsample: int = 10,
    raster_cfg: Optional[RasterConfig] = None,
    use_lighting: bool = False,
    device="cuda",
    overflow: Optional[list] = None,
):
    """Write a complete training dataset from strand geometry, rendered on
    `device`.

    orientation_source: "analytic" (exact, from rendered direction channels)
    or "gabor" (reference parity path, utils/vision.py Gabor bank on rgb).
    init_points: "gt_hair_verts" | "strand_roots" — COLMAP points3D seed.
    use_lighting: Lambert-shade segment colors like the reference's GL
    pipeline (see strand_segments_to_gaussians); off by default so existing
    seeded scenes stay bit-identical across rounds.
    overflow: a list that receives, per view, the renderer's overflow
    counters and pairs_demand (a GT render that drops pairs drops strands).
    """
    from PIL import Image as PILImage

    if orientation_source == "gabor":
        raise NotImplementedError(
            "orientation_source='gabor' needs the port of data/vision.py "
            "(ROADMAP Queue 1 item 8)")

    os.makedirs(output, exist_ok=True)
    for sub in ("images", "masks", "orientations"):
        os.makedirs(os.path.join(output, sub), exist_ok=True)

    # camera ring around the hair's vertical center (parse_usc:171-185)
    cam_pose = np.eye(4)
    cam_y = (hair.verts[:, 1].max() + hair.verts[:, 1].min()) / 2
    cam_pose[:3, 3] = [0, cam_y, cam_z]
    cam_pose[:3, 1:3] *= -1  # OpenCV convention: +z forward
    cameras, extrinsics = generate_cameras(
        num_cameras, height, width, cam_pose=cam_pose,
        anchor_pos=np.array([0, cam_y, 0]), offset=cam_z,
        # reference hardcodes f=500px for 1000^2 renders (utils/camera.py:65);
        # keep the same field of view at any resolution
        focal_length_px=500.0 * width / 1000.0,
    )

    gauss = strand_segments_to_gaussians(hair, use_lighting=use_lighting,
                                         device=device)
    for cam_id, cam in cameras.items():
        img, camera, out = _render_strand_channels(
            gauss, cam, extrinsics[cam_id], raster_cfg, device)
        if overflow is not None:
            overflow.append({k: int(out[k]) for k in (
                "overflow_pairs", "overflow_tiles", "overflow_capacity",
                "pairs_demand")} | {"max_tile_count": int(out["tile_counts"].max())})
        rgb, mask, theta, conf = _view_maps(img, camera)
        PILImage.fromarray((rgb * 255).astype(np.uint8)).save(
            os.path.join(output, "images", f"image_{cam_id}.png")
        )
        PILImage.fromarray((mask * 255).astype(np.uint8)).save(
            os.path.join(output, "masks", f"image_{cam_id}.png")
        )
        PILImage.fromarray((theta * 255 / math.pi).astype(np.uint8)).save(
            os.path.join(output, "orientations", f"image_{cam_id}_orientation.png")
        )
        PILImage.fromarray((conf * 255).astype(np.uint8)).save(
            os.path.join(output, "orientations", f"image_{cam_id}_confidence.png")
        )

    save_hair_eval_data_npz(os.path.join(output, "hair_eval_data.npz"), hair)
    scalp = hair.verts[hair.strand_root_idx]
    save_head_reconstruction_data_npz(
        os.path.join(output, "head_reconstruction_data.npz"),
        head_verts if head_verts is not None else scalp,
        scalp,
    )

    if init_points == "strand_roots":
        pts = hair.verts[hair.strand_root_idx]
        cols = hair.colors[hair.strand_root_idx, :3]
    else:
        pts = hair.verts[::init_subsample]
        cols = hair.colors[::init_subsample, :3]
    images, points3d = generate_colmap_data(cameras, extrinsics, pts, cols)
    sparse = os.path.join(output, "sparse", "0")
    os.makedirs(sparse, exist_ok=True)
    write_cameras_binary(cameras, os.path.join(sparse, "cameras.bin"))
    write_images_binary(images, os.path.join(sparse, "images.bin"))
    write_points3D_binary(points3d, os.path.join(sparse, "points3D.bin"))
    return output


def synthetic_test_hair(num_strands: int = 40, points_per_strand: int = 12,
                        seed: int = 0) -> HairData:
    """Small procedural hair wig (strands flowing down a sphere cap) for
    tests and benchmarks that don't ship the USC dataset."""
    rng = np.random.default_rng(seed)
    verts, edges, colors = [], [], []
    root_idx, v2s = [], []
    last = 0
    r_head = 0.085
    for s in range(num_strands):
        theta = rng.uniform(0, 2 * np.pi)
        phi = rng.uniform(0, 0.45 * np.pi)  # cap around the pole
        p = r_head * np.array(
            [np.sin(phi) * np.cos(theta), np.cos(phi), np.sin(phi) * np.sin(theta)]
        )
        direction = p / np.linalg.norm(p)
        pts = [p]
        d = direction.copy()
        for _ in range(points_per_strand - 1):
            d = d + np.array([0, -0.6, 0]) + rng.normal(0, 0.05, 3)
            d /= np.linalg.norm(d)
            pts.append(pts[-1] + d * 0.012)
        pts = np.asarray(pts, dtype=np.float32)
        root_idx.append(last)
        verts.append(pts)
        e1 = np.arange(last, last + len(pts) - 1)
        edges.append(np.column_stack([e1, e1 + 1]))
        v2s.append(np.full(len(pts), s, dtype=np.uint32))
        hue = s / num_strands
        import colorsys

        rgb = colorsys.hsv_to_rgb(hue, 0.8, 0.9)
        colors.append(np.tile(np.append(rgb, 1.0), (len(pts), 1)))
        last += len(pts)
    return HairData(
        verts=np.concatenate(verts, axis=0),
        colors=np.concatenate(colors, axis=0).astype(np.float32),
        normals=None,
        edges=np.concatenate(edges, axis=0).astype(np.int64),
        strand_root_idx=np.asarray(root_idx),
        verts_id_to_strand_id=np.concatenate(v2s, axis=0),
    )
