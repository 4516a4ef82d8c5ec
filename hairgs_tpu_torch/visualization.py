"""Visualization helpers (counterpart of hairgs_tpu/visualization.py).

Parity targets: utils/visualization.py (all-camera render dicts l.23-48,
tiled labelled grid compositor l.51-105, hair graph -> polyline data
l.108-134, orientation-map HSV l.251-269) and utils/general.py:127-197
(polyline / triangle PLY writers for external viewers). The interactive
pyvista (+Qt) plotters are gated on pyvista being installed (`_import_pv`,
which the tests replace by a recording fake); cv2 is optional too: without
it the grid resizes by nearest sampling and draws its labels with a 5x7
bitmap font.
"""

import math
from typing import Dict, Optional

import numpy as np
import torch

from hairgs_tpu_torch.io.ply import _structured, write_ply


def render_image_dict_from_cameras(model, cameras, max_cameras: int = 16,
                                   config=None) -> Dict[str, np.ndarray]:
    """Render every camera once into an id -> uint8 image dict
    (utils/visualization.py:23-48). `config` defaults to the renderer's
    defaults on the path `--use_pallas auto` picks: the compositor kernel
    for a model on a CUDA device, the XLA path elsewhere."""
    from hairgs_tpu_torch.models.gaussian import gaussian_render_inputs
    from hairgs_tpu_torch.models.hair import HairModel, hair_render_inputs
    from hairgs_tpu_torch.render.renderer import RasterConfig, render

    out = {}
    is_hair = isinstance(model, HairModel)
    cfg = config or RasterConfig(use_pallas=model.device.type == "cuda")
    for i, cam in enumerate(cameras[:max_cameras]):
        with torch.no_grad():
            if is_hair:
                inputs = hair_render_inputs(model.params, model.graph,
                                            cam.cam_center, model.active_sh_degree,
                                            model.dist_to_scale_factor)
                active = model.graph.seg_active
            else:
                inputs = gaussian_render_inputs(model.params, cam.cam_center,
                                                model.active_sh_degree)
                active = model.active
            img = render(cam, **inputs, active=active, width=cam.width,
                         height=cam.height, config=cfg)["render"]
            rgb = np.clip(img[..., :3].cpu().numpy(), 0, 1)
        out[f"{i}-render"] = (rgb * 255).astype(np.uint8)
        if cam.image is not None:
            out[f"{i}-gt"] = (np.clip(cam.image.cpu().numpy(), 0, 1) * 255
                              ).astype(np.uint8)
    return out


# 5x7 glyphs, one 5-bit row each (bit 4 is the left column)
_FONT = {
    "0": (14, 17, 19, 21, 25, 17, 14), "1": (4, 12, 4, 4, 4, 4, 14),
    "2": (14, 17, 1, 2, 4, 8, 31), "3": (31, 2, 4, 2, 1, 17, 14),
    "4": (2, 6, 10, 18, 31, 2, 2), "5": (31, 16, 30, 1, 1, 17, 14),
    "6": (6, 8, 16, 30, 17, 17, 14), "7": (31, 1, 2, 4, 8, 8, 8),
    "8": (14, 17, 17, 14, 17, 17, 14), "9": (14, 17, 17, 15, 1, 2, 12),
    "a": (14, 17, 17, 31, 17, 17, 17), "b": (30, 17, 17, 30, 17, 17, 30),
    "c": (14, 17, 16, 16, 16, 17, 14), "d": (30, 17, 17, 17, 17, 17, 30),
    "e": (31, 16, 16, 30, 16, 16, 31), "f": (31, 16, 16, 30, 16, 16, 16),
    "g": (14, 17, 16, 23, 17, 17, 15), "h": (17, 17, 17, 31, 17, 17, 17),
    "i": (14, 4, 4, 4, 4, 4, 14), "j": (7, 2, 2, 2, 2, 18, 12),
    "k": (17, 18, 20, 24, 20, 18, 17), "l": (16, 16, 16, 16, 16, 16, 31),
    "m": (17, 27, 21, 21, 17, 17, 17), "n": (17, 17, 25, 21, 19, 17, 17),
    "o": (14, 17, 17, 17, 17, 17, 14), "p": (30, 17, 17, 30, 16, 16, 16),
    "q": (14, 17, 17, 17, 21, 18, 13), "r": (30, 17, 17, 30, 20, 18, 17),
    "s": (15, 16, 16, 14, 1, 1, 30), "t": (31, 4, 4, 4, 4, 4, 4),
    "u": (17, 17, 17, 17, 17, 17, 14), "v": (17, 17, 17, 17, 17, 10, 4),
    "w": (17, 17, 17, 21, 21, 21, 10), "x": (17, 17, 10, 4, 10, 17, 17),
    "y": (17, 17, 17, 10, 4, 4, 4), "z": (31, 1, 2, 4, 8, 16, 31),
    "-": (0, 0, 0, 31, 0, 0, 0), "_": (0, 0, 0, 0, 0, 0, 31),
    ".": (0, 0, 0, 0, 0, 12, 12), " ": (0,) * 7,
}


def _draw_label(canvas: np.ndarray, text: str, x0: int, y0: int):
    """White 5x7 bitmap text with its top-left corner at (x0, y0), clipped
    to the canvas; characters without a glyph are left blank."""
    h, w = canvas.shape[:2]
    for k, ch in enumerate(text.lower()):
        rows = _FONT.get(ch, _FONT[" "])
        for r, bits in enumerate(rows):
            for c in range(5):
                y, x = y0 + r, x0 + 6 * k + c
                if bits >> (4 - c) & 1 and 0 <= y < h and 0 <= x < w:
                    canvas[y, x] = 255


def create_subplots_from_dict(images: Dict[str, np.ndarray], image_w: int = 1920,
                              image_h: int = 1080) -> np.ndarray:
    """Tile labelled images into one grid image (utils/visualization.py:51-105).
    Without cv2 the labels are drawn with a 5x7 bitmap font."""
    if not images:
        return np.zeros((image_h, image_w, 3), np.uint8)
    n = len(images)
    cols = math.ceil(math.sqrt(n))
    rows = math.ceil(n / cols)
    cell_w, cell_h = image_w // cols, image_h // rows
    canvas = np.zeros((image_h, image_w, 3), np.uint8)
    try:
        import cv2
    except ImportError:
        cv2 = None
    for idx, (name, img) in enumerate(images.items()):
        r, c = divmod(idx, cols)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=2)
        ih, iw = img.shape[:2]
        scale = min(cell_w / iw, cell_h / ih)
        tw, th = max(1, int(iw * scale)), max(1, int(ih * scale))
        if cv2 is not None:
            resized = cv2.resize(img, (tw, th))
        else:
            yi = (np.linspace(0, ih - 1, th)).astype(int)
            xi = (np.linspace(0, iw - 1, tw)).astype(int)
            resized = img[yi][:, xi]
        y0, x0 = r * cell_h, c * cell_w
        canvas[y0 : y0 + th, x0 : x0 + tw] = resized[..., :3]
        if cv2 is not None:
            cv2.putText(canvas, str(name), (x0 + 4, y0 + 16),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.5, (255, 255, 255), 1)
        else:
            _draw_label(canvas, str(name), x0 + 4, y0 + 4)
    return canvas


def get_joints_and_segments_from_hair(model):
    """(points (E,3), lines (S,2)) of the live graph for polyline plotting
    (utils/visualization.py:108-134)."""
    arrays = model.host_arrays(keys=("endpoints", "endpoint_pairs"))
    return arrays["endpoints"], arrays["endpoint_pairs"]


def orientation_map_to_hsv(theta: np.ndarray, mask: Optional[np.ndarray] = None) -> np.ndarray:
    """theta [0,pi) -> HSV hue-wheel RGB image (utils/visualization.py:251-269)."""
    try:
        import cv2

        h = (theta * 255 / np.pi).astype(np.uint8)
        hsv = np.stack([h, np.full_like(h, 255), np.full_like(h, 255)], axis=-1)
        rgb = cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB).astype(np.float32) / 255.0
    except ImportError:
        import colorsys

        flat = (theta / np.pi).reshape(-1)
        rgb = np.stack([
            np.asarray([colorsys.hsv_to_rgb(x, 1, 1)[c] for x in flat]).reshape(theta.shape)
            for c in range(3)
        ], axis=-1).astype(np.float32)
    if mask is not None:
        rgb = rgb * mask[..., None]
    return rgb


def save_ply_edges(vertex_xyz: np.ndarray, vertex_color: np.ndarray,
                   edges: Optional[np.ndarray], file_path: str):
    """Polyline PLY for viewers (utils/general.py:127-155)."""
    elements = []
    cols = [(ax, vertex_xyz[:, i].astype(np.float32), "f4") for i, ax in enumerate("xyz")]
    cols += [
        (ch, vertex_color[:, i].astype(np.uint8), "u1")
        for i, ch in enumerate(("red", "green", "blue"))
    ]
    elements.append(("vertex", _structured(cols)))
    if edges is not None:
        elements.append((
            "edge",
            _structured([
                ("vertex1", edges[:, 0].astype(np.int32), "i4"),
                ("vertex2", edges[:, 1].astype(np.int32), "i4"),
            ]),
        ))
    write_ply(file_path, elements)


def save_ply_faces(vertex_xyz: np.ndarray, vertex_color: np.ndarray,
                   edges: np.ndarray, file_path: str):
    """Each segment (A,B) as a degenerate triangle (A, mid, B) so mesh
    viewers without polyline support can show strands
    (utils/general.py:158-197)."""
    num_points = vertex_xyz.shape[0]
    seg = vertex_xyz[edges]
    mid = (seg[:, 0] + seg[:, 1]) / 2
    mid_color = (vertex_color[edges[:, 0]] + vertex_color[edges[:, 1]]) / 2
    verts = np.concatenate([vertex_xyz, mid], axis=0).astype(np.float32)
    colors = np.concatenate([vertex_color, mid_color], axis=0).astype(np.uint8)
    mid_idx = np.arange(edges.shape[0]) + num_points
    faces = np.column_stack([edges[:, 0], mid_idx, edges[:, 1]]).astype(np.int32)

    cols = [(ax, verts[:, i].astype(np.float32), "f4") for i, ax in enumerate("xyz")]
    cols += [
        (ch, colors[:, i].astype(np.uint8), "u1")
        for i, ch in enumerate(("red", "green", "blue"))
    ]
    face_arr = np.empty(len(faces), dtype=[("vertex_indices", "<i4", (3,))])
    face_arr["vertex_indices"] = faces
    write_ply(file_path, [("vertex", _structured(cols)), ("face", face_arr)])


def _import_pv():
    """Gated pyvista import (the tests replace it with a recording fake)."""
    try:
        import pyvista as pv
    except ImportError as e:
        raise ImportError(
            "interactive 3D visualization requires pyvista"
        ) from e
    return pv


def _as_np(x):
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def pv_visualize(plotter=None, point_clouds=None, lines=None, title="",
                 pv=None):
    """Point-cloud / line-set subplot (utils/visualization.py:137-180).

    point_clouds / lines: colour name -> (N,3) array or tensor. With a
    plotter given, draws into it as a subplot; otherwise creates one, shows
    it and blocks (the reference's behaviour)."""
    pv = pv or _import_pv()
    point_clouds = point_clouds or {}
    lines = lines or {}
    is_subplot = plotter is not None
    if not is_subplot:
        plotter = pv.Plotter()
    point_opacity = 1 if not lines else 0.5
    point_size = 1 if not lines else 3
    for color, pc in point_clouds.items():
        plotter.add_points(_as_np(pc), color=color, point_size=point_size,
                           opacity=point_opacity)
    for color, line in lines.items():
        plotter.add_lines(_as_np(line), color=color, width=1)
    plotter.add_axes()
    if is_subplot:
        plotter.add_text(title, font_size=18)
    else:
        plotter.add_title(title)
        plotter.render()
        plotter.show()
    return plotter


def _world_view_np(camera) -> np.ndarray:
    return _as_np(camera.world_view).astype(np.float64)


def camera_frustum_lines(camera, scale: float = 0.1) -> np.ndarray:
    """(16,3) world-space segment soup sketching a camera frustum: 4 rays
    from the origin to the corners and the far rectangle (the reference
    draws frusta with dreifus add_camera_frustum)."""
    c2w = np.linalg.inv(_world_view_np(camera))
    tx = float(camera.tanfovx)
    ty = float(camera.tanfovy)
    corners_cam = np.array(
        [[-tx, -ty, 1.0], [tx, -ty, 1.0], [tx, ty, 1.0], [-tx, ty, 1.0]]
    ) * scale
    origin = c2w[:3, 3]
    corners = corners_cam @ c2w[:3, :3].T + origin
    segs = []
    for i in range(4):
        segs.append(origin)
        segs.append(corners[i])
        segs.append(corners[i])
        segs.append(corners[(i + 1) % 4])
    return np.asarray(segs, dtype=np.float32)


def make_viewpoint_setter(plotter, camera):
    """Closure that moves the interactive view to a training camera
    (utils/visualization.py:228-244). Position, direction and up come from
    the inverted world_view; the focal point is pos + view_dir (the
    reference sets it to the bare direction vector, a latent bug fixed in
    JAX too)."""

    def set_viewpoint():
        c2w = np.linalg.inv(_world_view_np(camera))
        pos = c2w[:3, 3]
        view_dir = c2w[:3, :3] @ np.array([0.0, 0.0, 1.0])
        up = c2w[:3, :3] @ np.array([0.0, -1.0, 0.0])
        plotter.camera.SetPosition(pos)
        plotter.camera.SetFocalPoint(pos + view_dir)
        plotter.camera.SetViewUp(up)
        fovx = 2.0 * math.atan(float(camera.tanfovx))
        plotter.camera.SetViewAngle(180.0 * fovx / math.pi)

    return set_viewpoint


_CAM_COLOR_LIST = ["red", "green", "blue", "yellow", "cyan", "magenta",
                   "orange", "purple"]


def create_pv_background_plotter(model, cameras, pv=None, background=False):
    """Interactive 3D strand plotter with camera frustums and key-bound
    viewpoints (utils/visualization.py:184-248): keys 1..N move the view to
    training camera N. background=True uses pyvistaqt's non-blocking
    BackgroundPlotter (needs Qt); else a regular Plotter (call .show())."""
    pv = pv or _import_pv()
    if background:
        try:
            from pyvistaqt import BackgroundPlotter
        except ImportError as e:
            raise ImportError("background plotting requires pyvistaqt") from e
        plotter = BackgroundPlotter()
    else:
        plotter = pv.Plotter()
    points, lines = get_joints_and_segments_from_hair(model)
    cells = np.column_stack([np.full(lines.shape[0], 2), lines]).ravel()
    polydata = pv.PolyData(points, lines=cells)
    plotter.add_mesh(polydata, render_lines_as_tubes=True, line_width=2)
    for i, cam in enumerate(cameras):
        color = _CAM_COLOR_LIST[i % len(_CAM_COLOR_LIST)]
        plotter.add_lines(camera_frustum_lines(cam), color=color, width=1)
        plotter.add_key_event(str(i + 1), make_viewpoint_setter(plotter, cam))
    plotter.add_axes()
    if hasattr(plotter, "view_isometric"):
        plotter.view_isometric()
    return plotter, polydata


def update_polydata_from_hair(polydata, model):
    """Refresh a PolyData in place from the live model (reference
    train.py:222-227). The lines are rewritten too: topology events change
    the segment graph between updates."""
    points, lines = get_joints_and_segments_from_hair(model)
    polydata.points = points
    polydata.lines = np.column_stack(
        [np.full(lines.shape[0], 2), lines]
    ).ravel()
    return polydata


def make_merge_viz_callback(model, pv=None):
    """Live merge-progress plots (reference merge.py:118-158): each merge
    step shows the current strand graph and the candidate endpoint pairs
    as white lines. Returns a stage2_merge_loop viz_callback."""
    pv = pv or _import_pv()

    def viz(i, pairs):
        points, lines = get_joints_and_segments_from_hair(model)
        plotter = pv.Plotter()
        plotter.set_background("black")
        cells = np.column_stack([np.full(lines.shape[0], 2), lines]).ravel()
        plotter.add_mesh(pv.PolyData(points, lines=cells), line_width=1)
        pv_visualize(
            plotter=plotter,
            title=f"Merge step {i}",
            lines={"white": points[np.asarray(pairs)].reshape(-1, 3)},
            pv=pv,
        )
        plotter.show()

    return viz
