"""The capture a cell trains on, made from the seed: strand geometry, the
cameras, the photographs, masks and orientation maps, the initial point
cloud, written in the COLMAP layout that `Scene` reads.

One general generator driven by the `capture` block of a configuration
file. It imports nothing of the program: the photographs are a z-buffer
of densely sampled strand points (and, for a head capture, head-surface
points), not Gaussian renders. Everything runs on `device` with a
`torch.Generator` seeded from the run's seed, in a few large calls.

    hair:     strands, points_per_strand, segment_m, gravity, noise,
              head_radius_m, cap_polar_max (a fraction of pi)
    head:     null, or {"semi_axes_m": [a, b, c], "center_m": [x, y, z],
              "render_points": n}
    cameras:  {"layout": "ring", "count", "width", "height", "focal_px",
              "offset_m"} (the reference's 15-ring + top view), or
              {"layout": "arc", "width", "height", "focal_px",
              "radius_m", "target_m", "azimuth_deg": [...],
              "elevation_deg": [...]}
    init_points: {"from": "hair_vertices", "stride": k} or
              {"from": "head_surface", "count": n}
    samples_per_segment: points drawn on each GT segment for the z-buffer

A configuration's `merged_graph` block gives the strand graph a Stage-III
traffic starts from (`merged_graph`, below): pieces, segments_per_piece,
segment_points (GT steps a segment spans), gap_points (GT steps between
slots), jitter_m, width_m [lo, hi], opacity [lo, hi], mask [lo, hi],
iteration (the checkpoint's).
"""

import math
import os

import numpy as np
import torch
from PIL import Image

HAIR_PALETTE = ((0.30, 0.20, 0.12), (0.55, 0.40, 0.25), (0.15, 0.10, 0.07),
                (0.75, 0.62, 0.40), (0.45, 0.18, 0.10))
SKIN = (0.80, 0.62, 0.52)
ORIENT_EPS = 1e-7  # the orientation loss's MIN_VAL


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2**63 - 1))
    return g


def strands(cfg: dict, g: torch.Generator, device):
    """(S, P, 3) strand vertices and (S, 3) base colours: roots uniform on
    a cap of the head sphere, each strand grown by `segment_m` steps whose
    direction bends under gravity and seeded noise."""
    s, p = cfg["strands"], cfg["points_per_strand"]
    u = torch.rand((s, 2), generator=g, device=device)
    theta = 2 * math.pi * u[:, 0]
    cos_max = math.cos(cfg["cap_polar_max"] * math.pi)
    cos_phi = 1 - u[:, 1] * (1 - cos_max)
    sin_phi = torch.sqrt(torch.clamp(1 - cos_phi * cos_phi, min=0))
    normal = torch.stack([sin_phi * torch.cos(theta), cos_phi,
                          sin_phi * torch.sin(theta)], dim=1)
    noise = torch.randn((p - 1, s, 3), generator=g, device=device) * cfg["noise"]
    down = torch.tensor([0.0, -cfg["gravity"], 0.0], device=device)
    verts = [normal * cfg["head_radius_m"]]
    d = normal
    for k in range(p - 1):
        d = d + down + noise[k]
        d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
        verts.append(verts[-1] + d * cfg["segment_m"])
    pick = torch.randint(len(HAIR_PALETTE), (s,), generator=g, device=device)
    base = torch.tensor(HAIR_PALETTE, device=device)[pick]
    base = base * (0.85 + 0.3 * torch.rand((s, 1), generator=g, device=device))
    return torch.stack(verts, dim=1), torch.clamp(base, 0, 1)


def vertex_colours(base, p: int, g, device):
    """(S, P, 3): the strand colour, brighter toward the tip, with noise."""
    ramp = torch.linspace(0.8, 1.15, p, device=device)[None, :, None]
    jitter = 1 + 0.08 * torch.randn((base.shape[0], p, 1), generator=g, device=device)
    return torch.clamp(base[:, None, :] * ramp * jitter, 0, 1)


def head_points(cfg: dict, n: int, g, device):
    """n points uniform in direction on the head ellipsoid, with their
    outward normals."""
    v = torch.randn((n, 3), generator=g, device=device)
    v = v / torch.linalg.vector_norm(v, dim=1, keepdim=True)
    axes = torch.tensor(cfg["semi_axes_m"], device=device)
    pts = v * axes + torch.tensor(cfg["center_m"], device=device)
    nrm = v / axes
    return pts, nrm / torch.linalg.vector_norm(nrm, dim=1, keepdim=True)


def _rot(axis: str, angle: float) -> np.ndarray:
    c, s = math.cos(angle), math.sin(angle)
    if axis == "x":
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def ring_poses(count: int, cam_y: float, offset: float):
    """Camera-to-world poses of the reference's ring (utils/camera.py
    41-100 of the reference, as parse_usc_hairsalon.py calls it): count-1
    cameras around the hair's vertical centre at `offset`, then a top view."""
    base = np.eye(4)
    base[:3, 3] = [0, cam_y, offset]
    base[:3, 1:3] *= -1  # OpenCV: +z forward, +y down
    anchor = np.array([0, cam_y, 0])
    poses = []
    for i in range(count - 1):
        pose = base.copy()
        pose[:3, 3] -= anchor
        t = np.eye(4)
        t[:3, :3] = _rot("y", 2 * math.pi * i / (count - 1))
        pose = t @ pose
        pose[:3, 3] += anchor
        poses.append(pose)
    pose = base.copy()
    pose[:3, 3] = anchor + np.array([0, offset, 0])
    pose[:3, :3] = _rot("x", 3 * math.pi / 2) @ pose[:3, :3]
    poses.append(pose)
    return poses


def arc_poses(cfg: dict):
    """Look-at poses on a sphere around `target_m`, one per (elevation,
    azimuth), azimuth 0 on +z."""
    target = np.asarray(cfg["target_m"], np.float64)
    poses = []
    for el in cfg["elevation_deg"]:
        for az in cfg["azimuth_deg"]:
            a, e = math.radians(az), math.radians(el)
            eye = target + cfg["radius_m"] * np.array(
                [math.sin(a) * math.cos(e), math.sin(e), math.cos(a) * math.cos(e)])
            fwd = (target - eye) / np.linalg.norm(target - eye)
            right = np.cross(fwd, [0.0, 1.0, 0.0])
            right /= np.linalg.norm(right)
            down = np.cross(fwd, right)
            pose = np.eye(4)
            pose[:3, :3] = np.stack([right, down, fwd], axis=1)
            pose[:3, 3] = eye
            poses.append(pose)
    return poses


def rotmat2qvec(R) -> np.ndarray:
    """Rotation matrix -> wxyz quaternion with w >= 0 (COLMAP's formula)."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = np.asarray(R).flat
    K = np.array([[Rxx - Ryy - Rzz, 0, 0, 0],
                  [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
                  [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
                  [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz]]) / 3.0
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return -q if q[0] < 0 else q


def qvec2rotmat(q) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * z * x + 2 * w * y],
        [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
        [2 * z * x - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y]])


def cameras(cfg: dict, hair_verts):
    """[{qvec, tvec, focal, width, height, name}], world-to-camera as the
    COLMAP files store it."""
    if cfg["layout"] == "ring":
        ys = hair_verts[..., 1]
        cam_y = float((ys.max() + ys.min()) / 2)
        poses = ring_poses(cfg["count"], cam_y, cfg["offset_m"])
    else:
        poses = arc_poses(cfg)
    out = []
    for i, pose in enumerate(poses):
        w2c = np.linalg.inv(pose)
        out.append(dict(qvec=rotmat2qvec(w2c[:3, :3]), tvec=w2c[:3, 3].copy(),
                        focal=float(cfg["focal_px"]), width=int(cfg["width"]),
                        height=int(cfg["height"]), name=f"image_{i + 1}"))
    return out


def zbuffer_view(cam, pts, colour, direction, is_hair, device, seen=None):
    """The nearest point of each pixel: (rgb u8 (H,W,3), hair mask u8,
    orientation u8, confidence u8). The orientation is the hair point's
    direction in the camera frame, as the training loss reads it
    (theta = atan2(x, y) folded into [0, pi)). With `seen`, a bool per
    point, the hair points that win a pixel are marked in it."""
    w, h, f = cam["width"], cam["height"], cam["focal"]
    R = torch.tensor(qvec2rotmat(cam["qvec"]), dtype=torch.float32, device=device)
    t = torch.tensor(cam["tvec"], dtype=torch.float32, device=device)
    pv = pts @ R.T + t
    z = pv[:, 2]
    ok = z > 0.01
    zs = torch.where(ok, z, torch.ones_like(z))
    u = torch.round(f * pv[:, 0] / zs + (w - 1) / 2).to(torch.int64)
    v = torch.round(f * pv[:, 1] / zs + (h - 1) / 2).to(torch.int64)
    ok = ok & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    idx = torch.arange(pts.shape[0], device=device)
    dq = torch.clamp(z / 10.0 * (1 << 30), 0, (1 << 30) - 1).to(torch.int64)
    key = (dq << 24) | idx
    pix = torch.where(ok, v * w + u, torch.full_like(u, w * h))
    best = torch.full((w * h + 1,), torch.iinfo(torch.int64).max, dtype=torch.int64,
                      device=device)
    best.scatter_reduce_(0, pix, key, reduce="amin", include_self=True)
    best = best[:-1]
    hit = best != torch.iinfo(torch.int64).max
    win = torch.where(hit, best & ((1 << 24) - 1), torch.zeros_like(best))
    rgb = torch.where(hit[:, None], colour[win], torch.zeros_like(colour[win]))
    hair = hit & is_hair[win]
    if seen is not None:
        seen[win[hair]] = True
    dv = direction[win] @ R.T
    xy = dv[:, :2] / (torch.linalg.vector_norm(dv[:, :2], dim=1, keepdim=True) + ORIENT_EPS)
    y = torch.where(xy[:, 1] < ORIENT_EPS, xy[:, 1] + ORIENT_EPS, xy[:, 1])
    theta = torch.atan2(xy[:, 0], y)
    theta = torch.where(theta < 0, theta + math.pi, theta)
    theta = torch.where(hair, theta, torch.zeros_like(theta))

    def u8(x):
        return (x * 255).to(torch.uint8).reshape(h, w, *x.shape[1:]).cpu().numpy()

    return (u8(rgb), u8(hair.to(torch.float32)), u8(theta / math.pi),
            u8(hair.to(torch.float32)))


def make(config: dict, seed: int, device) -> dict:
    """The capture of `config` for `seed`, in memory: cameras, per view the
    rgb, mask, orientation and confidence images (uint8, as written), the
    initial points (float32) with their uint8 colours, the GT strands and
    which of their steps (S, P-1) some view shows."""
    cap = config["capture"]
    g = generator(seed, device)
    verts, base = strands(cap["hair"], g, device)
    s, p, _ = verts.shape
    vcol = vertex_colours(base, p, g, device)
    k = cap["samples_per_segment"]
    a, b = verts[:, :-1], verts[:, 1:]
    frac = (torch.arange(k, device=device, dtype=torch.float32) + 0.5) / k
    seg_pts = (a[:, :, None] + (b - a)[:, :, None] * frac[None, None, :, None]).reshape(-1, 3)
    seg_dir = (b - a) / torch.linalg.vector_norm(b - a, dim=-1, keepdim=True)
    seg_dir = seg_dir[:, :, None].expand(-1, -1, k, -1).reshape(-1, 3)
    seg_col = vcol[:, :-1, None].expand(-1, -1, k, -1).reshape(-1, 3)
    pts, col, dirs = seg_pts, seg_col, seg_dir
    is_hair = torch.ones(pts.shape[0], dtype=torch.bool, device=device)
    head = cap.get("head")
    if head:
        hp, hn = head_points(head, head["render_points"], g, device)
        light = torch.tensor([0.3, 0.5, 0.8], device=device)
        shade = 0.55 + 0.45 * torch.clamp(hn @ (light / light.norm()), min=0)
        hc = torch.tensor(SKIN, device=device) * shade[:, None]
        pts = torch.cat([pts, hp])
        col = torch.cat([col, hc])
        dirs = torch.cat([dirs, torch.zeros_like(hp)])
        is_hair = torch.cat([is_hair, torch.zeros(hp.shape[0], dtype=torch.bool,
                                                  device=device)])
    cams = cameras(cap["cameras"], verts.cpu().numpy())
    seen = torch.zeros(pts.shape[0], dtype=torch.bool, device=device)
    views = [zbuffer_view(c, pts, col, dirs, is_hair, device, seen) for c in cams]
    visible = seen[:s * (p - 1) * k].reshape(s, p - 1, k).any(dim=2)

    init = cap["init_points"]
    if init["from"] == "hair_vertices":
        ip = verts.reshape(-1, 3)[::init["stride"]]
        ic = vcol.reshape(-1, 3)[::init["stride"]]
    else:
        ip, hn = head_points(head, init["count"], g, device)
        ic = torch.tensor(SKIN, device=device).expand(init["count"], 3)
    return dict(cameras=cams, views=views,
                points=ip.cpu().numpy().astype(np.float32),
                colours=(ic * 255).to(torch.uint8).cpu().numpy(),
                gt_vertices=s * p, strands=(verts, vcol), visible=visible)


SH_C0 = 0.28209479177387814
GRAPH_STREAM = 0x5EED_0003  # the graph draws from its own stream of the seed


def _logit(p):
    return torch.log(p / (1 - p))


def merged_graph(cfg: dict, capture: dict, seed: int, device) -> dict:
    """The strand graph that Stage II's merge leaves, laid along the GT
    strands where the cameras see them: every strand is cut, from a seeded
    offset, into slots of `segments_per_piece` segments of `segment_points`
    GT steps each, `gap_points` steps apart; the `pieces` slots with the
    largest share of steps that some view shows (ties broken by the seed)
    become the pieces, so every seed gives as many. Endpoints are jittered
    by `jitter_m` per axis. Segment colours are the GT colours at their
    middles; opacity, mask and width are drawn per segment. Returns numpy
    arrays in the hair PLY's terms: endpoints (E,3), endpoint_pairs (S,2),
    features_dc (S,1,3) (SH DC), opacity, mask and width (S,1) (logit,
    logit, log), strand_root_idx (endpoints at a GT root),
    ref_strand_root (the GT roots), and where each piece lies: gt_strand
    (pieces,) and gt_index (pieces, segments_per_piece + 1)."""
    verts, vcol = capture["strands"]
    g = generator(seed ^ GRAPH_STREAM, device)
    n_str, n_pts, _ = verts.shape
    m, span, gap = cfg["segments_per_piece"], cfg["segment_points"], cfg["gap_points"]
    slot = m * span + gap
    n_slot = (n_pts - m * span) // slot  # as many on every strand, at any offset
    if n_str * n_slot < cfg["pieces"]:
        raise ValueError("the pieces do not fit on the strands")
    offset = torch.randint(slot, (n_str,), generator=g, device=device)
    starts = offset[:, None] + slot * torch.arange(n_slot, device=device)
    steps = starts[:, :, None] + torch.arange(m * span, device=device)
    rows = torch.arange(n_str, device=device)[:, None, None]
    share = capture["visible"][rows, steps].to(torch.float32).mean(dim=2)
    score = share + 0.01 * torch.rand(share.shape, generator=g, device=device)
    pick = torch.sort(torch.topk(score.reshape(-1), cfg["pieces"]).indices).values
    strand = pick // n_slot
    idx = starts.reshape(-1)[pick][:, None] + torch.arange(m + 1, device=device) * span
    pts = verts[strand[:, None], idx].reshape(-1, 3)
    pts = pts + cfg["jitter_m"] * torch.randn(pts.shape, generator=g, device=device)
    ids = torch.arange(pts.shape[0], device=device).reshape(-1, m + 1)
    pairs = torch.stack([ids[:, :-1], ids[:, 1:]], dim=-1).reshape(-1, 2)
    mid = idx[:, :-1] + span // 2
    rgb = vcol[strand[:, None], mid].reshape(-1, 3)
    n_seg = pairs.shape[0]

    def draw(bounds):
        a, b = bounds
        return a + (b - a) * torch.rand((n_seg, 1), generator=g, device=device)

    w_lo, w_hi = cfg["width_m"]
    width = math.log(w_lo) + (math.log(w_hi) - math.log(w_lo)) * torch.rand(
        (n_seg, 1), generator=g, device=device)
    opacity, mask = _logit(draw(cfg["opacity"])), _logit(draw(cfg["mask"]))
    is_root = (idx == 0).reshape(-1)

    def host(x, dt=np.float32):
        return x.cpu().numpy().astype(dt)

    return dict(endpoints=host(pts), endpoint_pairs=host(pairs, np.int64),
                features_dc=host(((rgb - 0.5) / SH_C0)[:, None, :]),
                opacity=host(opacity), mask=host(mask), width=host(width),
                strand_root_idx=host(torch.nonzero(is_root)[:, 0], np.int64),
                ref_strand_root=host(verts[:, 0]), gt_strand=host(strand, np.int64),
                gt_index=host(idx, np.int64))


def _ply(path: str, elements):
    """Binary little-endian PLY of [(name, [(property, column)])]: float32
    columns as `float`, int32 as `int`, uint8 as `uchar`."""
    kinds = {np.dtype(np.float32): "float", np.dtype(np.int32): "int",
             np.dtype(np.uint8): "uchar"}
    head = ["ply", "format binary_little_endian 1.0"]
    bodies = []
    for name, cols in elements:
        n = cols[0][1].shape[0]
        head.append(f"element {name} {n}")
        dt = np.dtype([(p, c.dtype.newbyteorder("<")) for p, c in cols])
        arr = np.empty(n, dtype=dt)
        for p, c in cols:
            head.append(f"property {kinds[c.dtype]} {p}")
            arr[p] = c
        bodies.append(arr.tobytes())
    head.append("end_header")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as fh:
        fh.write(("\n".join(head) + "\n").encode("ascii"))
        for b in bodies:
            fh.write(b)


def write_hair_ply(path: str, graph: dict):
    """The five-element hair checkpoint (vertex, edge, segment,
    strand_root_idx, ref_strand_root) that a Stage-III `Scene` loads, for
    SH degree 0 (no f_rest columns)."""
    f32 = np.float32
    ep = graph["endpoints"].astype(f32)
    zero = np.zeros(ep.shape[0], f32)
    pairs = graph["endpoint_pairs"].astype(np.int32)
    dc = graph["features_dc"].astype(f32)[:, 0, :]
    ref = graph["ref_strand_root"].astype(f32)
    _ply(path, [
        ("vertex", [("x", ep[:, 0]), ("y", ep[:, 1]), ("z", ep[:, 2]),
                    ("nx", zero), ("ny", zero), ("nz", zero)]),
        ("edge", [("vertex1", pairs[:, 0]), ("vertex2", pairs[:, 1])]),
        ("segment", [(f"f_dc_{i}", dc[:, i]) for i in range(3)]
         + [(k, graph[k].astype(f32)[:, 0]) for k in ("opacity", "mask", "width")]),
        ("strand_root_idx", [("strand_root_idx",
                              graph["strand_root_idx"].astype(np.int32))]),
        ("ref_strand_root", [("x", ref[:, 0]), ("y", ref[:, 1]), ("z", ref[:, 2])]),
    ])


def write_point_ply(path: str, xyz: np.ndarray, rgb: np.ndarray):
    """Binary PLY of x, y, z, nx, ny, nz (float32) and red, green, blue
    (uint8), the layout of the COLMAP points3D.ply."""
    f, c = xyz.astype(np.float32), rgb.astype(np.uint8)
    zero = np.zeros(f.shape[0], np.float32)
    _ply(path, [("vertex", [("x", f[:, 0]), ("y", f[:, 1]), ("z", f[:, 2]), ("nx", zero),
                            ("ny", zero), ("nz", zero), ("red", c[:, 0]),
                            ("green", c[:, 1]), ("blue", c[:, 2])])])


def write(capture: dict, root: str):
    """The COLMAP scene directory `Scene` reads: images/, masks/,
    orientations/, sparse/0/{cameras,images}.txt and points3D.ply."""
    for sub in ("images", "masks", "orientations", "sparse/0"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    cam_lines, img_lines = [], []
    for i, (cam, (rgb, mask, orient, conf)) in enumerate(
            zip(capture["cameras"], capture["views"])):
        name = cam["name"]

        def save(arr, *parts):
            Image.fromarray(arr).save(os.path.join(root, *parts), compress_level=1)

        save(rgb, "images", f"{name}.png")
        save(mask, "masks", f"{name}.png")
        save(orient, "orientations", f"{name}_orientation.png")
        save(conf, "orientations", f"{name}_confidence.png")
        cam_lines.append(f"{i + 1} SIMPLE_PINHOLE {cam['width']} {cam['height']} "
                         f"{cam['focal']!r} {cam['width'] / 2!r} {cam['height'] / 2!r}")
        q, t = cam["qvec"], cam["tvec"]
        img_lines.append(" ".join([str(i + 1), *(repr(float(x)) for x in q),
                                   *(repr(float(x)) for x in t), str(i + 1),
                                   f"{name}.png"]))
        img_lines.append("")
    sparse = os.path.join(root, "sparse", "0")
    with open(os.path.join(sparse, "cameras.txt"), "w") as fh:
        fh.write("\n".join(cam_lines) + "\n")
    with open(os.path.join(sparse, "images.txt"), "w") as fh:
        fh.write("\n".join(img_lines) + "\n")
    write_point_ply(os.path.join(sparse, "points3D.ply"), capture["points"],
                    capture["colours"])
