#!/usr/bin/env python
"""Offline render sets from a trained checkpoint (counterpart of the root
render.py).

    python3 -m hairgs_tpu_torch.drivers.render -m <model dir> [-t TYPE] [--skip_train]

Parity target: reference render.py:25-152 — for each type in
{0: rgb, 1: rgb_foreground (cleaned model, rendered last), 2: mask_foreground
(binarized mask splatted as colour), 3: mask_other (inverse indicator),
4: orientation_map (screen-space theta -> HSV)} write both the render and its
GT counterpart under

    model_path/render/train/iteration_N/{renders,gt}/<type_name>/NNNNN.png

-t selects one type (default -1 = all, in the order [0, 2, 3, 4, 1]: the
foreground type renders a cleaned copy of the model, ref render.py:139-141);
--skip_train mirrors the reference flag (the scene has train cameras only).
The flags not given are read from the model directory's `cfg_args`.

The model lives on `--data_device` ("cuda" unless the CPU is asked for);
with `--use_pallas auto` a CUDA model takes the paged path, whose forward
is the hand-written compositor kernel (the mask types run its 3-channel
instance). Rendering runs under `torch.no_grad()`: no backward launches.
"""

import os
import sys
import time
from argparse import ArgumentParser

import numpy as np
import torch

from hairgs_tpu_torch.config import (
    GeneralConfig,
    ModelConfig,
    OptimizationConfig,
    RuntimeConfig,
    add_config_args,
    extract_config,
    get_combined_args,
)

TYPE_MAP = {
    -1: "all",
    0: "rgb",
    1: "rgb_foreground",
    2: "mask_foreground",
    3: "mask_other",
    4: "orientation_map",
}
FG_BIN_TH = 0.25  # gaussian_model.py:38
MIN_VAL = 1e-7


def orientation_map_to_vis(theta: np.ndarray, confidence: np.ndarray) -> np.ndarray:
    """theta (H,W) in [0,pi) -> HSV hue-wheel RGB in [0,1]
    (utils/visualization.py:251-269), with the reference's quirk of
    blacking out pixels whose confidence is exactly 1.0."""
    hue = (np.asarray(theta, dtype=np.float32) / np.pi) % 1.0
    # S=V=1 hue wheel: the rgb channels are shifted triangle waves of the hue
    k = hue[..., None] * 6.0 + np.array([0.0, 4.0, 2.0], np.float32)
    out = np.clip(np.abs((k % 6.0) - 3.0) - 1.0, 0.0, 1.0).astype(np.float32)
    out[np.asarray(confidence) == 1.0] = 0.0
    return out


def screen_theta(o_world: np.ndarray, world_view: np.ndarray) -> np.ndarray:
    """World orientation channels -> screen-space theta in [0,pi) from the
    y-axis, clockwise (reference render.py:59-105)."""
    o_view = o_world @ world_view[:3, :3].T
    xy = o_view[..., :2]
    xy = xy / (np.linalg.norm(xy, axis=-1, keepdims=True) + MIN_VAL)
    y = np.where(xy[..., 1] < MIN_VAL, xy[..., 1] + MIN_VAL, xy[..., 1])
    theta = np.arctan2(xy[..., 0], y)
    return np.where(theta < 0, theta + np.pi, theta)


def _np(t):
    return t.cpu().numpy()


def render_sets(args) -> dict:
    """Render and write the selected types; returns, per type name, the
    number of views, the seconds spent rendering (the renders and their
    transfer to the host) and the seconds in all (PNG writes included)."""
    import copy

    from PIL import Image as PILImage

    from hairgs_tpu_torch.core.hostsync import sliced_pull
    from hairgs_tpu_torch.models.gaussian import gaussian_render_inputs
    from hairgs_tpu_torch.models.hair import HairModel, hair_render_inputs
    from hairgs_tpu_torch.render.renderer import RasterConfig, render
    from hairgs_tpu_torch.scene import Scene

    rt = extract_config(args, RuntimeConfig)
    scene = Scene(args, shuffle=False, capacity_round=rt.capacity_round)
    model = scene.gaussians
    is_hair = isinstance(model, HairModel)
    cameras = scene.get_cameras()

    use_pallas = rt.use_pallas
    if use_pallas == "auto":
        use_pallas = model.device.type == "cuda"
    cfg = RasterConfig(max_tiles_per_gaussian=rt.max_tiles_per_gaussian,
                       max_pairs_per_tile=rt.max_pairs_per_tile,
                       chunk=rt.composite_chunk,
                       use_pallas=bool(use_pallas) and use_pallas != "false",
                       antialiasing=rt.antialiasing,
                       alpha_min=rt.alpha_min)

    it = scene.loaded_iter
    types = [args.type] if args.type != -1 else [0, 2, 3, 4, 1]

    def inputs_for(m, cam):
        if is_hair:
            return (hair_render_inputs(m.params, m.graph, cam.cam_center,
                                       m.active_sh_degree,
                                       m.dist_to_scale_factor),
                    m.graph.seg_active)
        return (gaussian_render_inputs(m.params, cam.cam_center,
                                       m.active_sh_degree), m.active)

    def save(path, arr):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        PILImage.fromarray(
            (np.clip(arr, 0, 1) * 255).astype(np.uint8)).save(path)

    times = {}
    for t in types:
        t_type = time.perf_counter()
        t_render = 0.0
        type_name = TYPE_MAP[t]
        base = os.path.join(args.model_path, "render", "train",
                            f"iteration_{it}")
        render_path = os.path.join(base, "renders", type_name)
        gts_path = os.path.join(base, "gt", type_name)

        cur = model
        if t == 1:
            # the foreground type renders a cleaned copy (reference
            # render.py:54-57 cleans the live model; a copy keeps the
            # other types right)
            cur = copy.deepcopy(model)
            if is_hair:
                from hairgs_tpu_torch.topo.graph_ops import clean_hair_gaussians

                clean_hair_gaussians(cur)
            else:
                cur.clean_gaussians()

        fg_indicator = None
        if t in (2, 3):
            # the mask plane's live rows only
            n_rows = cur.num_segments if is_hair else cur.count
            mask_logit = sliced_pull({"mask": (cur.params.mask, n_rows)})["mask"]
            mask_act = 1.0 / (1.0 + np.exp(-mask_logit[:, 0]))
            fg = np.zeros(cur.params.mask.shape[0], np.float32)
            fg[:n_rows] = (mask_act >= FG_BIN_TH).astype(np.float32)
            fg_indicator = torch.tensor(fg, device=cur.device)

        for idx, cam in enumerate(cameras):
            t0 = time.perf_counter()
            with torch.no_grad():
                inputs, active = inputs_for(cur, cam)
                if t in (2, 3):
                    ind = fg_indicator if t == 2 else 1.0 - fg_indicator
                    # override_color: the indicator splatted as the colour
                    # channels (reference render.py:62-77)
                    inputs = dict(inputs, features=ind[:, None].repeat(1, 3))
                out = render(cam, **inputs, active=active, width=cam.width,
                             height=cam.height, config=cfg)
                img = _np(out["render"])
            t_render += time.perf_counter() - t0

            if t in (0, 1):
                rendering = np.clip(img[..., :3], 0, 1)
                gt = _np(cam.image)
            elif t == 2:
                rendering = np.repeat(np.clip(img[..., :1], 0, 1), 3, axis=2)
                gt = np.repeat(_np(cam.mask)[..., None], 3, axis=2)
            elif t == 3:
                rendering = np.repeat(np.clip(img[..., :1], 0, 1), 3, axis=2)
                gt = np.repeat(1.0 - _np(cam.mask)[..., None], 3, axis=2)
            else:  # t == 4
                theta = screen_theta(img[..., 4:7], _np(cam.world_view))
                conf = (_np(cam.confidence) if cam.confidence is not None
                        else np.zeros(theta.shape, np.float32))
                rendering = orientation_map_to_vis(theta, conf)
                gt_theta = (_np(cam.orientation) if cam.orientation is not None
                            else np.zeros(theta.shape, np.float32))
                gt = orientation_map_to_vis(gt_theta, conf)

            save(os.path.join(render_path, f"{idx:05d}.png"), rendering)
            save(os.path.join(gts_path, f"{idx:05d}.png"), gt)
        times[type_name] = dict(views=len(cameras), render_s=t_render,
                                total_s=time.perf_counter() - t_type)
        print(f"type {t} ({type_name}): {len(cameras)} views rendered")
    print(f"Render sets written under "
          f"{os.path.join(args.model_path, 'render')}")
    return times


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description="Testing script parameters")
    add_config_args(parser, ModelConfig)
    add_config_args(parser, OptimizationConfig)
    add_config_args(parser, GeneralConfig)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--type", "-t", type=int, default=-1,
                        help="Type of rendering")
    add_config_args(parser, RuntimeConfig)
    return parser


def main(argv=None):
    args = get_combined_args(build_parser(), sys.argv[1:] if argv is None else argv)
    if not args.skip_train:
        return render_sets(args)
    return {}


if __name__ == "__main__":
    main()
