"""USC-HairSalon binary .data parser (counterpart of
hairgs_tpu/data/usc.py; host numpy).

Parity target: data/hair_data.py:63-136 (10000 strands, 100 verts each, HSV
spectre coloring by strand index, per-strand root index + strand-id maps).
"""

import struct

import numpy as np

from hairgs_tpu_torch.io.npz import HairData


def _hsv_to_rgb(h_deg180: float) -> np.ndarray:
    """OpenCV-convention HSV (H in [0,180], S=V=255) -> RGB in [0,1]."""
    import colorsys

    r, g, b = colorsys.hsv_to_rgb(h_deg180 / 180.0, 1.0, 1.0)
    # match cv2 uint8 rounding of the reference (data/hair_data.py:111-113)
    rgb255 = np.array([round(r * 255), round(g * 255), round(b * 255)])
    return rgb255 / 255.0


def load_hair_from_usc_dataset(file_path: str, normal_required: bool = False,
                               hsv_spectre_color: bool = True,
                               pct_strands: float = 100) -> HairData:
    color_palette = np.array(
        [[0.545, 0.271, 0.075, 1], [0.639, 0.341, 0.125, 1], [0.561, 0.388, 0.196, 1]]
    )
    strands, edges, colors = [], [], []
    strand_root_idx, verts_id_to_strand_id = [], []
    last_idx = 0
    with open(file_path, "rb") as f:
        num_strands = struct.unpack("<i", f.read(4))[0]
        assert num_strands == 10000, f"Expected 10000 strands, got: {num_strands}"
        strands_to_load = int(num_strands * pct_strands / 100)
        load_freq = num_strands // strands_to_load
        hues = np.linspace(0, 180, num_strands)
        for i in range(num_strands):
            num_verts = struct.unpack("<i", f.read(4))[0]
            assert num_verts in (1, 100), f"num_verts should be 1 or 100: {num_verts}"
            xyz = np.frombuffer(f.read(12 * num_verts), dtype="<f4").reshape(-1, 3)
            if i % load_freq != 0 or num_verts == 1:
                continue
            strand_root_idx.append(last_idx)
            strands.append(np.array(xyz))
            e1 = np.arange(last_idx, last_idx + num_verts - 1, dtype=np.uint32)
            edges.append(np.column_stack([e1, e1 + 1]))
            last_idx += num_verts
            verts_id_to_strand_id.append(
                np.full(num_verts, len(strands) - 1, dtype=np.uint32)
            )
            if hsv_spectre_color:
                color = np.append(_hsv_to_rgb(hues[i]), 1)
            else:
                color = color_palette[i % color_palette.shape[0]]
            colors.append(np.tile(color, (num_verts, 1)))
    verts = np.concatenate(strands, axis=0)
    normals = None
    if normal_required:
        # crude per-vertex normal: normalized segment direction (the
        # reference uses pytorch3d pointcloud normals, only needed for viz)
        d = np.zeros_like(verts)
        d[:-1] = verts[1:] - verts[:-1]
        d[-1] = d[-2]
        normals = d / np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-9)
    return HairData(
        verts=verts,
        colors=np.concatenate(colors, axis=0),
        normals=normals,
        edges=np.concatenate(edges, axis=0).astype(np.int64),
        strand_root_idx=np.array(strand_root_idx),
        verts_id_to_strand_id=np.concatenate(verts_id_to_strand_id, axis=0),
    )
