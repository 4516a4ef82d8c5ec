#!/usr/bin/env python
"""NeRSemble multi-view capture preparation (counterpart of
scripts/parse_nersemble.py).

    python3 -m hairgs_tpu_torch.drivers.parse_nersemble -r <raw> -o <out> \\
        --flame_model_path <flame2023.pkl> --flame_mask_path <FLAME_masks.pkl> \\
        [-i <participant>] [--num_angles 180] [--device cuda|cpu]

Parity target: reference scripts/parse_nersemble.py:47-367 — per participant:

- read `calibration/camera_params.json` (shared intrinsics + per-camera
  world_2_cam OpenCV poses), rescale intrinsics 0.5 for the `images-2x`
  half-resolution release (ref l.159-193);
- build hair masks as the intersection of the capture alpha map with the
  facer hair segmentation (class 14) dilated 13x13, keeping only
  background-or-hair pixels (ref l.227-238);
- remove image backgrounds by multiplying with the alpha map (ref l.263-265)
  and estimate Gabor orientation/confidence maps on the cleaned images;
- evaluate the fitted FLAME (tracked_flame_params.npz: shape/expression/
  neck/eyes, plus a world transform from euler-XYZ rotation, translation and
  scale, ref l.304-340) for head verts, scalp verts
  (head_reconstruction_data.npz) and the init point cloud;
- write the COLMAP binary scene with the FLAME vertices as points3D and a
  head_mesh.ply for visualization (ref l.342-367).

The masks, the background removal and the Gabor maps run on `--device`
("cuda" unless the CPU is asked for) with OpenCV's arithmetic reproduced
in torch (`data/vision.py`); files go through PIL, so the port needs no
OpenCV. FLAME and the COLMAP files are host numpy. A missing mask or image
skips the participant (skip-and-continue, ref l.240-243, 288-291) as the
JAX script does; any other error is raised, not skipped. A real capture
needs the licensed FLAME 2023 model and masks (flame.is.tue.mpg.de).
"""

import argparse
import json
import os
import shutil
import sys

import numpy as np
import torch

HAIR_CLASS_ID = 14  # facer segmentation hair class (ref l.33)
SEQUENCE = "EXP-1-head"
FRAME = "frame_00000"
DILATION = 13


def euler_xyz_to_matrix(angles: np.ndarray) -> np.ndarray:
    """Intrinsic XYZ euler -> rotation matrix (dreifus Pose.from_euler(...,
    "XYZ") which delegates to scipy's capital-letter intrinsic convention)."""
    from scipy.spatial.transform import Rotation

    return Rotation.from_euler("XYZ", np.asarray(angles, dtype=np.float64)).as_matrix()


def build_hair_mask(segmentation: torch.Tensor, alpha_map: torch.Tensor,
                    resolution) -> torch.Tensor:
    """facer hair-segmentation ∩ alpha intersection (ref l.227-238).

    Keeps pixels that are background-or-hair in the segmentation AND within a
    13x13 dilation of the hair class (so the mask hugs the hair silhouette
    with a margin but never claims face/torso pixels), intersected with the
    alpha foreground. Returns uint8 {0,255} at `resolution` (h, w), on the
    segmentation's device."""
    from hairgs_tpu_torch.data.vision import dilate_uint8, resize_uint8

    hair = segmentation == HAIR_CLASS_ID
    keep = (segmentation == 0) | hair
    dilated = dilate_uint8(hair.to(torch.uint8), DILATION).bool()
    seg = (keep & dilated).to(torch.uint8) * 255
    seg = resize_uint8(seg, *resolution)
    alpha = resize_uint8(alpha_map, *resolution)
    return ((alpha > 0) & (seg > 0)).to(torch.uint8) * 255


def fitted_flame_vertices(model, flame_params) -> np.ndarray:
    """Evaluate the tracked FLAME fit at frame 0 and apply its world
    transform (ref l.304-339): verts are posed with zero global/jaw pose,
    then rotated by euler-XYZ `rotation` scaled by `scale`, translated by
    `translation`."""
    from hairgs_tpu_torch.data.flame import flame_forward

    verts = flame_forward(
        model,
        shape_params=np.asarray(flame_params["shape"][0]),
        expression_params=np.asarray(flame_params["expression"][0]),
        pose_params=np.zeros(6),
        neck_pose=np.asarray(flame_params["neck"][0]),
        eye_pose=np.asarray(flame_params["eyes"][0]),
        transl=None,
    ).astype(np.float64)
    rot = euler_xyz_to_matrix(flame_params["rotation"][0])
    rot = rot * np.asarray(flame_params["scale"][0])  # R *= scale (ref l.331)
    return (verts @ rot.T + np.asarray(flame_params["translation"][0])).astype(
        np.float32
    )


def save_head_mesh_ply(path: str, verts: np.ndarray, faces: np.ndarray):
    """Triangle mesh PLY for visualization (ref l.352-356 via pyvista)."""
    from hairgs_tpu_torch.io.ply import write_ply

    v = np.empty(
        len(verts), dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    )
    v["x"], v["y"], v["z"] = verts[:, 0], verts[:, 1], verts[:, 2]
    f = np.empty(len(faces), dtype=[("vertex_indices", "<i4", (3,))])
    f["vertex_indices"] = np.asarray(faces, dtype=np.int32)
    write_ply(path, [("vertex", v), ("face", f)])


def parse_participant(participant_folder: str, output: str, flame_model,
                      flame_masks, sequence: str, frame: str,
                      num_angles: int, device="cuda") -> bool:
    from hairgs_tpu_torch import resolve_device
    from hairgs_tpu_torch.data.vision import (
        estimate_orientation_field,
        read_gray,
        read_rgb,
        resize_uint8,
        write_png,
    )
    from hairgs_tpu_torch.io.colmap import (
        ColmapCamera,
        generate_colmap_data,
        write_cameras_binary,
        write_images_binary,
        write_points3D_binary,
    )
    from hairgs_tpu_torch.io.npz import save_head_reconstruction_data_npz

    dev = resolve_device(device)
    frame_dir = os.path.join(participant_folder, "sequences", sequence,
                             "timesteps", frame)

    # --- cameras: shared intrinsics rescaled 0.5 for images-2x (ref l.159-193)
    with open(os.path.join(participant_folder, "calibration",
                           "camera_params.json")) as f:
        camera_params = json.load(f)
    K = np.asarray(camera_params["intrinsics"], dtype=np.float64) * 0.5
    resolution = None
    colmap_cameras, extrinsics = {}, {}
    for cam_name in camera_params["world_2_cam"]:
        if resolution is None:
            image = read_rgb(
                os.path.join(frame_dir, "images-2x", f"cam_{cam_name}.jpg")
            )
            if image is None:
                print(f"missing first image in {frame_dir}, skipping")
                return False
            resolution = image.shape[:2]
        cam_id = int(cam_name)
        # the reference int-casts fx/fy/cx/cy (ref l.182-185)
        colmap_cameras[cam_id] = ColmapCamera(
            id=cam_id, model="PINHOLE",
            width=resolution[1], height=resolution[0],
            params=np.array([int(K[0, 0]), int(K[1, 1]),
                             int(K[0, 2]), int(K[1, 2])], dtype=np.float64),
        )
        extrinsics[cam_id] = np.asarray(
            camera_params["world_2_cam"][cam_name], dtype=np.float64
        )

    name_of = {int(n): n for n in camera_params["world_2_cam"]}

    # --- masks: facer ∩ alpha (ref l.195-243)
    masks_dir = os.path.join(output, "masks")
    os.makedirs(masks_dir, exist_ok=True)
    alpha_maps = {}
    try:
        for cam_id in colmap_cameras:
            alpha = read_gray(os.path.join(frame_dir, "alpha_map",
                                           f"cam_{name_of[cam_id]}.png"))
            seg = read_gray(os.path.join(frame_dir, "facer_segmentation_masks",
                                         f"segmentation_cam_{name_of[cam_id]}.png"))
            if alpha is None or seg is None:
                raise FileNotFoundError(cam_id)
            alpha = torch.from_numpy(alpha).to(dev)
            alpha_maps[cam_id] = resize_uint8(alpha, *resolution)
            mask = build_hair_mask(torch.from_numpy(seg).to(dev), alpha, resolution)
            write_png(os.path.join(masks_dir, f"image_{cam_id}.png"), mask)
    except FileNotFoundError as e:
        # skip-and-continue like the reference (l.240-243), saying why
        print(f"Masks failed for {frame_dir} ({type(e).__name__}: {e}), "
              f"skipping")
        shutil.rmtree(output)
        return False

    # --- images + orientation fields on alpha-cleaned images (ref l.245-291)
    images_dir = os.path.join(output, "images")
    orient_dir = os.path.join(output, "orientations")
    os.makedirs(images_dir, exist_ok=True)
    os.makedirs(orient_dir, exist_ok=True)
    try:
        for cam_id in colmap_cameras:
            rgb = read_rgb(os.path.join(frame_dir, "images-2x",
                                        f"cam_{name_of[cam_id]}.jpg"))
            if rgb is None:
                raise FileNotFoundError(cam_id)
            # remove background with the alpha map (ref l.263-265), in
            # float64 and truncated, as numpy does it
            alpha = alpha_maps[cam_id].to(torch.float64) / 255.0
            image = (torch.from_numpy(rgb).to(dev, torch.float64)
                     * alpha[:, :, None]).to(torch.uint8)
            write_png(os.path.join(images_dir, f"image_{cam_id}.png"), image)
            theta, conf = estimate_orientation_field(image, num_angles=num_angles)
            write_png(os.path.join(orient_dir, f"image_{cam_id}_orientation.png"),
                      (theta * 255 / np.pi).to(torch.uint8))
            write_png(os.path.join(orient_dir, f"image_{cam_id}_confidence.png"),
                      (conf * 255).to(torch.uint8))
    except FileNotFoundError as e:
        print(f"Images failed for {frame_dir} ({type(e).__name__}: {e}), "
              f"skipping")
        shutil.rmtree(output)
        return False

    # --- fitted FLAME -> head/scalp verts + init point cloud (ref l.293-349)
    flame_params = np.load(
        os.path.join(participant_folder, "sequences", sequence, "annotations",
                     "tracking", "FLAME2023_v2", "tracked_flame_params.npz")
    )
    verts = fitted_flame_vertices(flame_model, flame_params)
    scalp = verts[flame_masks["scalp"]]
    save_head_reconstruction_data_npz(
        os.path.join(output, "head_reconstruction_data.npz"), verts, scalp
    )
    save_head_mesh_ply(os.path.join(output, "head_mesh.ply"), verts,
                       flame_model.faces)

    colors = np.full((verts.shape[0], 3), 0.5, dtype=np.float32)
    images3d, points3d = generate_colmap_data(
        colmap_cameras, extrinsics, verts, colors
    )
    sparse = os.path.join(output, "sparse", "0")
    os.makedirs(sparse, exist_ok=True)
    write_cameras_binary(colmap_cameras, os.path.join(sparse, "cameras.bin"))
    write_images_binary(images3d, os.path.join(sparse, "images.bin"))
    write_points3D_binary(points3d, os.path.join(sparse, "points3D.bin"))
    print(f"{output}: {len(colmap_cameras)} cameras, {verts.shape[0]} FLAME "
          f"verts, {scalp.shape[0]} scalp verts")
    return True


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        "Generate data needed to optimize GS from NeRSemble captures"
    )
    parser.add_argument("--raw_path", "-r", required=True,
                        help="raw NeRSemble root (one folder per participant)")
    parser.add_argument("--output_path", "-o", required=True)
    parser.add_argument("--participant_id", "-i", default=None,
                        help="participant id; all participants if omitted")
    parser.add_argument("--sequence", default=SEQUENCE)
    parser.add_argument("--frame", type=int, default=0,
                        help="timestep index within the sequence")
    parser.add_argument("--flame_model_path", required=True)
    parser.add_argument("--flame_mask_path", required=True)
    # landmark embeddings: accepted for CLI parity with the reference
    # (parse_nersemble.py:65-104 exposes them to its FLAME constructor);
    # loaded + validated against the model when given, but — exactly like
    # the reference, whose parse pipeline never reads the returned
    # landmarks — they do not change the parsed outputs.
    parser.add_argument("--static_landmark_embedding_path", default=None)
    parser.add_argument("--dynamic_landmark_embedding_path", default=None)
    parser.add_argument("--use_face_contour", action="store_true",
                        help="include the yaw-indexed face-contour rows "
                        "when evaluating landmarks")
    parser.add_argument("--num_angles", type=int, default=180)
    parser.add_argument("--device", default="cuda",
                        help="torch device the masks and Gabor maps are computed on")
    return parser


def main(argv=None) -> int:
    """Parse the participants; returns how many were parsed."""
    args = build_parser().parse_args(sys.argv[1:] if argv is None else argv)

    from hairgs_tpu_torch.data.flame import (
        flame_forward,
        load_dynamic_landmark_embedding,
        load_flame_masks,
        load_flame_model,
        load_static_landmark_embedding,
    )

    flame_model = load_flame_model(args.flame_model_path)
    flame_masks = load_flame_masks(args.flame_mask_path)
    landmark_embedding = None
    if args.static_landmark_embedding_path:
        landmark_embedding = load_static_landmark_embedding(
            args.static_landmark_embedding_path)
    if args.dynamic_landmark_embedding_path:
        landmark_embedding = load_dynamic_landmark_embedding(
            args.dynamic_landmark_embedding_path, landmark_embedding)
    if landmark_embedding is not None:
        _, lmk = flame_forward(
            flame_model, landmark_embedding=landmark_embedding,
            use_face_contour=args.use_face_contour)
        print(f"landmark embedding loaded: {lmk.shape[0]} landmarks")

    if args.participant_id is not None:
        ids = [str(args.participant_id).zfill(3)]
    else:
        ids = sorted(
            f.name for f in os.scandir(args.raw_path) if f.is_dir()
        )

    done = 0
    for pid in ids:
        folder = os.path.join(args.raw_path, pid)
        if not os.path.isdir(folder):
            print(f"no folder for participant {pid}")
            continue
        output = os.path.join(args.output_path, pid)
        if os.path.exists(output):
            shutil.rmtree(output)  # delete old parse (ref l.146-148)
        os.makedirs(output)
        done += parse_participant(
            folder, output, flame_model, flame_masks,
            args.sequence, f"frame_{args.frame:05d}", args.num_angles,
            device=args.device,
        )
    print(f"parsed {done}/{len(ids)} participants")
    return done


if __name__ == "__main__":
    main()
