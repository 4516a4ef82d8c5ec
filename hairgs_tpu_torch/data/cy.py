"""Cem Yuksel HAIR file format parser + dataset loader (counterpart of
hairgs_tpu/data/cy.py; host numpy).

Parity targets: data/cy_hair.py (header layout: "<4sIIIIff3f88s", optional
segments/points/thickness/transparency/colors arrays) and
data/hair_data.py:139-232 (cm->m scaling x0.25/100, z-up -> y-up rotation,
HSV spectre coloring). The reference's interpretation of the segments array
as points-per-strand and its fallback joint count (point_count/(3*strands))
are replicated as-is for dataset parity.
"""

import struct
from typing import NamedTuple, Optional

import numpy as np

from hairgs_tpu_torch.io.npz import HairData

SEGMENTS_BIT = 1
POINTS_BIT = 2
THICKNESS_BIT = 4
TRANSPARENCY_BIT = 8
COLORS_BIT = 16


class CYHairHeader(NamedTuple):
    hair_count: int
    point_count: int
    arrays: int
    d_segments: int
    d_thickness: float
    d_transparency: float
    d_color: tuple
    info: str


class CYHairFile(NamedTuple):
    header: CYHairHeader
    segments: Optional[np.ndarray]
    points: Optional[np.ndarray]
    thickness: Optional[np.ndarray]
    transparency: Optional[np.ndarray]
    colors: Optional[np.ndarray]


def load_cy_hair_file(path: str) -> CYHairFile:
    with open(path, "rb") as f:
        header_data = f.read(128)
        if len(header_data) < 128:
            raise ValueError("cannot read HAIR header")
        u = struct.unpack("<4sIIIIff3f88s", header_data)
        if u[0] != b"HAIR":
            raise ValueError("wrong HAIR signature")
        header = CYHairHeader(
            hair_count=u[1], point_count=u[2], arrays=u[3], d_segments=u[4],
            d_thickness=u[5], d_transparency=u[6], d_color=tuple(u[7:10]),
            info=u[10].decode("ascii", errors="replace").rstrip("\0"),
        )
        segments = points = thickness = transparency = colors = None
        if header.arrays & SEGMENTS_BIT:
            segments = np.frombuffer(f.read(header.hair_count * 2), dtype="<u2")
        if header.arrays & POINTS_BIT:
            points = np.frombuffer(f.read(header.point_count * 12), dtype="<f4")
        if header.arrays & THICKNESS_BIT:
            thickness = np.frombuffer(f.read(header.point_count * 4), dtype="<f4")
        if header.arrays & TRANSPARENCY_BIT:
            transparency = np.frombuffer(f.read(header.point_count * 4), dtype="<f4")
        if header.arrays & COLORS_BIT:
            colors = np.frombuffer(f.read(header.point_count * 12), dtype="<f4")
    return CYHairFile(header=header, segments=segments, points=points,
                      thickness=thickness, transparency=transparency, colors=colors)


def save_cy_hair_file(path: str, points: np.ndarray, segments: np.ndarray = None,
                      info: str = ""):
    """Write a minimal HAIR file (points + optional segments array) — used by
    the test suite and the download/parse pipeline."""
    points = np.asarray(points, dtype="<f4").reshape(-1)
    point_count = points.shape[0] // 3
    arrays = POINTS_BIT
    hair_count = 1
    if segments is not None:
        segments = np.asarray(segments, dtype="<u2")
        hair_count = segments.shape[0]
        arrays |= SEGMENTS_BIT
    header = struct.pack(
        "<4sIIIIff3f88s", b"HAIR", hair_count, point_count, arrays, 0,
        1.0, 0.0, 1.0, 1.0, 1.0, info.encode("ascii")[:88].ljust(88, b"\0"),
    )
    with open(path, "wb") as f:
        f.write(header)
        if segments is not None:
            f.write(segments.tobytes())
        f.write(points.tobytes())


def _hsv_spectre(hue_deg180: float) -> np.ndarray:
    import colorsys

    r, g, b = colorsys.hsv_to_rgb(hue_deg180 / 180.0, 1.0, 1.0)
    rgb255 = np.array([round(r * 255), round(g * 255), round(b * 255)])
    return np.append(rgb255 / 255.0, 1.0)


def load_hair_from_cy_dataset(file_path: str, hsv_spectre_color: bool = True,
                              pct_strands: float = 100) -> HairData:
    color_palette = np.array(
        [[1.0, 0.85, 0.47, 1], [0.76, 0.75, 0.65, 1], [0.95, 0.8, 0.53, 1]]
    )
    hf = load_cy_hair_file(file_path)
    all_points = np.asarray(hf.points).reshape(-1, 3)
    num_strands = hf.header.hair_count
    if hf.segments is None:
        num_joints = int(all_points.shape[0] / (3 * num_strands))
        strand_points = np.full(num_strands, num_joints, dtype=np.int64)
    else:
        strand_points = np.asarray(hf.segments, dtype=np.int64)
    raw_colors = np.asarray(hf.colors).reshape(-1, 3) if hf.colors is not None else None

    strands, directions, edges, colors = [], [], [], []
    strand_root_idx, verts_id_to_strand_id = [], []
    all_points_idx = 0
    last_idx = 0
    load_freq = num_strands // int(num_strands * pct_strands / 100)
    hues = np.linspace(0, 180, num_strands)
    for i in range(num_strands):
        n = int(strand_points[i])
        start = all_points_idx
        all_points_idx += n
        if i % load_freq != 0:
            continue
        xyz = all_points[start : start + n]
        strand_root_idx.append(last_idx)
        d = xyz[1:] - xyz[:-1]
        d = np.concatenate([d, np.array([[0, 0, 1.0]])], axis=0)
        d = d / np.linalg.norm(d, axis=1, keepdims=True)
        directions.append(d)
        strands.append(xyz)
        e1 = np.arange(last_idx, last_idx + n - 1, dtype=np.uint32)
        edges.append(np.column_stack([e1, e1 + 1]))
        last_idx += n
        verts_id_to_strand_id.append(np.full(n, len(strands) - 1, dtype=np.uint32))
        if raw_colors is None or hsv_spectre_color:
            if hsv_spectre_color:
                color = _hsv_spectre(hues[i])
            else:
                color = color_palette[i % color_palette.shape[0]]
            colors.append(np.tile(color, (n, 1)))
        else:
            colors.append(raw_colors[start : start + n])
    verts = np.concatenate(strands, axis=0)
    # cm -> m and scale to ~0.17m head (data/hair_data.py:213-214)
    verts = 0.25 * verts / 100
    # z-up -> y-up (l.216-219): Ry(-90) @ Rx(-90)
    rx = np.array([[1, 0, 0], [0, 0, 1], [0, -1, 0]], dtype=np.float64)  # Rx(-90)
    ry = np.array([[0, 0, -1], [0, 1, 0], [1, 0, 0]], dtype=np.float64)  # Ry(-90)
    verts = (ry @ rx @ verts.T).T
    return HairData(
        verts=verts.astype(np.float32),
        colors=np.concatenate(colors, axis=0),
        normals=np.concatenate(directions, axis=0),
        edges=np.concatenate(edges, axis=0).astype(np.int64),
        strand_root_idx=np.array(strand_root_idx),
        verts_id_to_strand_id=np.concatenate(verts_id_to_strand_id, axis=0),
    )
