"""Scene orchestration: dataset loading, model construction/resume, saving
(counterpart of hairgs_tpu/scene.py).

Parity target: scene/__init__.py:30-134 — COLMAP scene info, camera lists,
model-type dispatch by checkpoint PLY element count (1 => GaussianModel,
5 => HairModel), iteration resume, GT +
head-reconstruction npz loading, checkpoint cadence paths
(model_path/point_cloud/iteration_N/point_cloud.ply). Cameras and the model
live on `args.data_device`.
"""

import json
import os
import random
import re
from typing import List, Optional

from hairgs_tpu_torch import resolve_device
from hairgs_tpu_torch.core.camera import Camera
from hairgs_tpu_torch.io.dataset import camera_to_json, load_camera, read_colmap_scene_info
from hairgs_tpu_torch.io.npz import (
    HairEvalData,
    HeadReconstruction,
    load_hair_eval_data_npz,
    load_head_reconstruction_data_npz,
)
from hairgs_tpu_torch.io.ply import count_ply_elements
from hairgs_tpu_torch.models.gaussian import GaussianModel
from hairgs_tpu_torch.models.hair import HairModel


def search_for_max_iteration(folder: str) -> int:
    """utils/system.py:30-32 — max iteration_N subdirectory."""
    iters = [
        int(m.group(1))
        for name in os.listdir(folder)
        if (m := re.match(r"iteration_(\d+)$", name))
    ]
    if not iters:
        raise FileNotFoundError(folder)
    return max(iters)


class Scene:
    def __init__(self, args, shuffle: bool = True, resolution_scales=(1.0,),
                 capacity_round: int = 4096):
        self.model_path = args.model_path
        self.device = resolve_device(getattr(args, "data_device", "cuda"))
        self.loaded_iter = None
        self.cameras = {}
        self.gt: Optional[HairEvalData] = None
        self.head_reconstruction: Optional[HeadReconstruction] = None

        scene_info = read_colmap_scene_info(args.source_path, getattr(args, "images", None))

        try:
            self.loaded_iter = search_for_max_iteration(
                os.path.join(self.model_path, "point_cloud")
            )
        except FileNotFoundError:
            os.makedirs(self.model_path, exist_ok=True)
            if scene_info.ply_path and os.path.exists(scene_info.ply_path):
                with open(scene_info.ply_path, "rb") as src, open(
                    os.path.join(self.model_path, "input.ply"), "wb"
                ) as dst:
                    dst.write(src.read())
            cams_json = [camera_to_json(i, c) for i, c in enumerate(scene_info.cameras)]
            with open(os.path.join(self.model_path, "cameras.json"), "w") as f:
                json.dump(cams_json, f)

        cam_infos = list(scene_info.cameras)
        if shuffle:
            random.shuffle(cam_infos)
        self.cameras_extent = scene_info.nerf_normalization["radius"]
        for scale in resolution_scales:
            self.cameras[scale] = [
                load_camera(c, getattr(args, "resolution", -1), scale,
                            device=self.device)
                for c in cam_infos
            ]

        common = dict(sh_degree=args.sh_degree,
                      spatial_lr_scale=self.cameras_extent,
                      capacity_round=capacity_round, device=self.device)
        if self.loaded_iter is None:
            self.gaussians = GaussianModel(**common)
            self.gaussians.create_from_pcd(scene_info.points, scene_info.colors)
            print(f"Created {type(self.gaussians).__name__} from PCD "
                  f"({self.gaussians.count} points)")
            self.loaded_iter = 0
        else:
            path = os.path.join(
                self.model_path, "point_cloud", f"iteration_{self.loaded_iter}",
                "point_cloud.ply",
            )
            model_cls = GaussianModel if count_ply_elements(path) == 1 else HairModel
            self.gaussians = model_cls(**common)
            print(f"Loaded {type(self.gaussians).__name__} from PLY at iteration "
                  f"{self.loaded_iter}")
            self.gaussians.load_ply(path)

        gt_path = os.path.join(args.source_path, "hair_eval_data.npz")
        if os.path.exists(gt_path):
            self.gt = load_hair_eval_data_npz(gt_path)
            print(f"GT loaded from {gt_path}")

        head_path = os.path.join(args.source_path, "head_reconstruction_data.npz")
        if os.path.exists(head_path):
            self.head_reconstruction = load_head_reconstruction_data_npz(head_path)
            self.gaussians.ref_strand_root = self.head_reconstruction.scalp_verts
            if isinstance(self.gaussians, HairModel):
                from hairgs_tpu_torch.topo.strands import (
                    compute_strands_info,
                    update_strand_root,
                )

                update_strand_root(self.gaussians)
                compute_strands_info(self.gaussians)
            print(f"Head reconstruction loaded from {head_path}")

    def save(self, iteration: int = 0):
        if self.loaded_iter:
            iteration += self.loaded_iter
        path = os.path.join(
            self.model_path, "point_cloud", f"iteration_{iteration}", "point_cloud.ply"
        )
        self.gaussians.save_ply(path)
        return path

    def get_cameras(self, scale: float = 1.0) -> List[Camera]:
        return self.cameras[scale]
