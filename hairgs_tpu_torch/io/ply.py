"""Self-contained PLY I/O + the two checkpoint formats of the pipeline;
the port's own copy of hairgs_tpu/io/ply.py (numpy only).

The environment has no `plyfile`; this module implements the subset of PLY
needed (binary_little_endian / ascii, scalar properties, multiple elements)
with numpy, writing headers in the same convention plyfile uses so files
interoperate byte-for-byte with the reference outputs.

Checkpoint formats kept compatible:
- GaussianModel PLY (1 element "vertex"): x,y,z,nx,ny,nz,f_dc_*,f_rest_*,
  opacity,mask,scale_*,rot_*  (scene/gaussian_model.py:268-319)
- HairGaussianModel PLY (5 elements: vertex / edge / segment /
  strand_root_idx / ref_strand_root)  (scene/hair_gaussian_model.py:310-367)
"""

import os
from typing import Dict, List, Tuple

import numpy as np

_DTYPE_TO_PLY = {
    np.dtype("float32"): "float",
    np.dtype("float64"): "double",
    np.dtype("int32"): "int",
    np.dtype("uint32"): "uint",
    np.dtype("int16"): "short",
    np.dtype("uint16"): "ushort",
    np.dtype("int8"): "char",
    np.dtype("uint8"): "uchar",
}
_PLY_TO_DTYPE = {v: k for k, v in _DTYPE_TO_PLY.items()}
_PLY_TO_DTYPE.update(
    {
        "float32": np.dtype("float32"),
        "float64": np.dtype("float64"),
        "int32": np.dtype("int32"),
        "uint32": np.dtype("uint32"),
        "int16": np.dtype("int16"),
        "uint16": np.dtype("uint16"),
        "int8": np.dtype("int8"),
        "uint8": np.dtype("uint8"),
    }
)


def _with_list_counts(arr: np.ndarray) -> np.ndarray:
    """Interleave uint8 count fields before fixed-arity subarray fields so the
    binary layout matches `property list uchar <type>` rows."""
    if not any(arr.dtype[f].shape for f in arr.dtype.names):
        return arr
    fields = []
    for f in arr.dtype.names:
        sub = arr.dtype[f]
        if sub.shape:
            fields.append((f"__n_{f}", np.uint8))
            fields.append((f, sub.base, sub.shape))
        else:
            fields.append((f, sub))
    out = np.empty(arr.shape[0], dtype=fields)
    for f in arr.dtype.names:
        sub = arr.dtype[f]
        if sub.shape:
            out[f"__n_{f}"] = sub.shape[0]
        out[f] = arr[f]
    return out


def write_ply(path: str, elements: List[Tuple[str, np.ndarray]], text: bool = False):
    """elements: list of (name, structured numpy array). Subarray fields
    (e.g. dtype [("vertex_indices", "<i4", (3,))]) are written as fixed-arity
    PLY list properties (triangle meshes for external viewers)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    header = ["ply"]
    header.append("format ascii 1.0" if text else "format binary_little_endian 1.0")
    for name, arr in elements:
        header.append(f"element {name} {arr.shape[0]}")
        for field in arr.dtype.names:
            sub = arr.dtype[field]
            ply_type = _DTYPE_TO_PLY[sub.base]
            if sub.shape:
                header.append(f"property list uchar {ply_type} {field}")
            else:
                header.append(f"property {ply_type} {field}")
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        for _, arr in elements:
            if text:
                for row in arr:
                    vals = []
                    for field in arr.dtype.names:
                        v = row[field]
                        if arr.dtype[field].shape:
                            vals.append(str(len(v)))
                            vals.extend(str(x) for x in v)
                        else:
                            vals.append(str(v))
                    f.write((" ".join(vals) + "\n").encode("ascii"))
            else:
                arr2 = _with_list_counts(arr)
                arr2 = arr2.astype(arr2.dtype.newbyteorder("<"), copy=False)
                f.write(arr2.tobytes())


def read_ply(path: str) -> List[Tuple[str, np.ndarray]]:
    with open(path, "rb") as f:
        # --- header
        magic = f.readline().strip()
        assert magic == b"ply", f"not a PLY file: {path}"
        fmt = None
        elements = []  # (name, count, [(prop_name, dtype)])
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unexpected EOF in PLY header")
            tok = line.decode("ascii").strip().split()
            if not tok:
                continue
            if tok[0] == "format":
                fmt = tok[1]
            elif tok[0] == "comment":
                continue
            elif tok[0] == "element":
                elements.append((tok[1], int(tok[2]), []))
            elif tok[0] == "property":
                if tok[1] == "list":
                    raise NotImplementedError("PLY list properties not supported")
                elements[-1][2].append((tok[2], _PLY_TO_DTYPE[tok[1]]))
            elif tok[0] == "end_header":
                break
        out = []
        if fmt == "binary_little_endian":
            for name, count, props in elements:
                dtype = np.dtype([(p, d.newbyteorder("<")) for p, d in props])
                arr = np.frombuffer(f.read(dtype.itemsize * count), dtype=dtype, count=count)
                out.append((name, arr.astype(np.dtype([(p, d) for p, d in props]))))
        elif fmt == "ascii":
            lines = f.read().decode("ascii").split("\n")
            idx = 0
            for name, count, props in elements:
                dtype = np.dtype(props)
                arr = np.empty(count, dtype=dtype)
                for i in range(count):
                    vals = lines[idx].split()
                    idx += 1
                    for (p, d), v in zip(props, vals):
                        arr[p][i] = d.type(float(v) if d.kind == "f" else int(v))
                out.append((name, arr))
        else:
            raise NotImplementedError(f"PLY format {fmt}")
    return out


def _structured(names_arrays: List[Tuple[str, np.ndarray, str]]) -> np.ndarray:
    """Build a structured array from (field, column (N,), typestr) triples."""
    n = names_arrays[0][1].shape[0]
    dtype = np.dtype([(name, t) for name, _, t in names_arrays])
    out = np.empty(n, dtype=dtype)
    for name, col, _ in names_arrays:
        out[name] = col
    return out


# --------------------------------------------------------------------------
# GaussianModel checkpoint (1-element PLY)
# --------------------------------------------------------------------------

def save_gaussian_ply(path: str, arrays: Dict[str, np.ndarray]):
    """arrays: xyz (N,3), features_dc (N,1,3), features_rest (N,K,3),
    opacity (N,1), mask (N,1), scaling (N,3), rotation (N,4) — raw (log/logit)
    values, as the reference stores them (scene/gaussian_model.py:283-319).

    Feature flattening matches the reference: (N,K,3)->transpose(1,2)->flatten
    i.e. channel-major (rgb outer, coefficient inner).
    """
    n = arrays["xyz"].shape[0]
    cols = []
    for i, ax in enumerate("xyz"):
        cols.append((ax, arrays["xyz"][:, i].astype(np.float32), "f4"))
    for i, ax in enumerate(["nx", "ny", "nz"]):
        cols.append((ax, np.zeros(n, np.float32), "f4"))
    f_dc = arrays["features_dc"].transpose(0, 2, 1).reshape(n, -1)
    for i in range(f_dc.shape[1]):
        cols.append((f"f_dc_{i}", f_dc[:, i].astype(np.float32), "f4"))
    f_rest = arrays["features_rest"].transpose(0, 2, 1).reshape(n, -1)
    for i in range(f_rest.shape[1]):
        cols.append((f"f_rest_{i}", f_rest[:, i].astype(np.float32), "f4"))
    cols.append(("opacity", arrays["opacity"][:, 0].astype(np.float32), "f4"))
    cols.append(("mask", arrays["mask"][:, 0].astype(np.float32), "f4"))
    for i in range(arrays["scaling"].shape[1]):
        cols.append((f"scale_{i}", arrays["scaling"][:, i].astype(np.float32), "f4"))
    for i in range(arrays["rotation"].shape[1]):
        cols.append((f"rot_{i}", arrays["rotation"][:, i].astype(np.float32), "f4"))
    write_ply(path, [("vertex", _structured(cols))])


def load_gaussian_ply(path: str, max_sh_degree: int) -> Dict[str, np.ndarray]:
    elements = read_ply(path)
    assert len(elements) == 1, "GaussianModel PLY must have a single element"
    v = elements[0][1]
    n = v.shape[0]
    xyz = np.stack([v["x"], v["y"], v["z"]], axis=1)
    opacity = np.asarray(v["opacity"])[:, None]
    mask = np.asarray(v["mask"])[:, None]
    f_dc = np.zeros((n, 3, 1), dtype=np.float32)
    for i in range(3):
        f_dc[:, i, 0] = v[f"f_dc_{i}"]
    rest_names = sorted(
        [p for p in v.dtype.names if p.startswith("f_rest_")],
        key=lambda x: int(x.split("_")[-1]),
    )
    assert len(rest_names) == 3 * (max_sh_degree + 1) ** 2 - 3
    f_rest = np.zeros((n, len(rest_names)), dtype=np.float32)
    for i, name in enumerate(rest_names):
        f_rest[:, i] = v[name]
    f_rest = f_rest.reshape(n, 3, (max_sh_degree + 1) ** 2 - 1)
    scale_names = sorted(
        [p for p in v.dtype.names if p.startswith("scale_")],
        key=lambda x: int(x.split("_")[-1]),
    )
    scaling = np.stack([v[s] for s in scale_names], axis=1)
    rot_names = sorted(
        [p for p in v.dtype.names if p.startswith("rot")],
        key=lambda x: int(x.split("_")[-1]),
    )
    rotation = np.stack([v[r] for r in rot_names], axis=1)
    return dict(
        xyz=xyz.astype(np.float32),
        features_dc=f_dc.transpose(0, 2, 1).astype(np.float32),  # (N,1,3)
        features_rest=f_rest.transpose(0, 2, 1).astype(np.float32),  # (N,K-1,3)
        opacity=opacity.astype(np.float32),
        mask=mask.astype(np.float32),
        scaling=scaling.astype(np.float32),
        rotation=rotation.astype(np.float32),
    )


# --------------------------------------------------------------------------
# HairGaussianModel checkpoint (5-element PLY)
# --------------------------------------------------------------------------

def save_hair_ply(path: str, arrays: Dict[str, np.ndarray],
                  strand_root_endpoint_idx: np.ndarray, ref_strand_root: np.ndarray):
    """5-element hair PLY (scene/hair_gaussian_model.py:310-367)."""
    endpoints = arrays["endpoints"].astype(np.float32)
    ne = endpoints.shape[0]
    vert_cols = [(ax, endpoints[:, i], "f4") for i, ax in enumerate("xyz")]
    vert_cols += [(ax, np.zeros(ne, np.float32), "f4") for ax in ("nx", "ny", "nz")]
    element_1 = ("vertex", _structured(vert_cols))

    pairs = arrays["endpoint_pairs"].astype(np.int32)
    element_2 = (
        "edge",
        _structured([("vertex1", pairs[:, 0], "i4"), ("vertex2", pairs[:, 1], "i4")]),
    )

    ns = pairs.shape[0]
    cols = []
    f_dc = arrays["features_dc"].transpose(0, 2, 1).reshape(ns, -1)
    for i in range(f_dc.shape[1]):
        cols.append((f"f_dc_{i}", f_dc[:, i].astype(np.float32), "f4"))
    f_rest = arrays["features_rest"].transpose(0, 2, 1).reshape(ns, -1)
    for i in range(f_rest.shape[1]):
        cols.append((f"f_rest_{i}", f_rest[:, i].astype(np.float32), "f4"))
    cols.append(("opacity", arrays["opacity"][:, 0].astype(np.float32), "f4"))
    cols.append(("mask", arrays["mask"][:, 0].astype(np.float32), "f4"))
    cols.append(("width", arrays["width"][:, 0].astype(np.float32), "f4"))
    element_3 = ("segment", _structured(cols))

    element_4 = (
        "strand_root_idx",
        _structured([("strand_root_idx", strand_root_endpoint_idx.astype(np.int32), "i4")]),
    )
    ref = ref_strand_root.astype(np.float32)
    element_5 = (
        "ref_strand_root",
        _structured([(ax, ref[:, i], "f4") for i, ax in enumerate("xyz")]),
    )
    write_ply(path, [element_1, element_2, element_3, element_4, element_5])


def load_hair_ply(path: str, max_sh_degree: int):
    elements = read_ply(path)
    assert len(elements) == 5, (
        f"Hair PLY must have 5 elements, got {len(elements)}"
    )
    v = elements[0][1]
    endpoints = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)
    e = elements[1][1]
    pairs = np.stack([e["vertex1"], e["vertex2"]], axis=1).astype(np.int32)
    s = elements[2][1]
    ns = s.shape[0]
    opacity = np.asarray(s["opacity"], dtype=np.float32)[:, None]
    mask = np.asarray(s["mask"], dtype=np.float32)[:, None]
    width = np.asarray(s["width"], dtype=np.float32)[:, None]
    f_dc = np.zeros((ns, 3, 1), dtype=np.float32)
    for i in range(3):
        f_dc[:, i, 0] = s[f"f_dc_{i}"]
    rest_names = sorted(
        [p for p in s.dtype.names if p.startswith("f_rest_")],
        key=lambda x: int(x.split("_")[-1]),
    )
    assert len(rest_names) == 3 * (max_sh_degree + 1) ** 2 - 3
    f_rest = np.zeros((ns, len(rest_names)), dtype=np.float32)
    for i, name in enumerate(rest_names):
        f_rest[:, i] = s[name]
    f_rest = f_rest.reshape(ns, 3, (max_sh_degree + 1) ** 2 - 1)
    root_idx = np.asarray(elements[3][1]["strand_root_idx"], dtype=np.int64)
    rr = elements[4][1]
    ref_root = np.stack([rr["x"], rr["y"], rr["z"]], axis=1).astype(np.float32)
    arrays = dict(
        endpoints=endpoints,
        endpoint_pairs=pairs,
        features_dc=f_dc.transpose(0, 2, 1),
        features_rest=f_rest.transpose(0, 2, 1),
        opacity=opacity,
        mask=mask,
        width=width,
    )
    return arrays, root_idx, ref_root


# --------------------------------------------------------------------------
# Point-cloud PLY (input.ply / points3D.ply; data/dataset_readers.py:181-213)
# --------------------------------------------------------------------------

def store_point_ply(path: str, xyz: np.ndarray, rgb: np.ndarray):
    n = xyz.shape[0]
    cols = [(ax, xyz[:, i].astype(np.float32), "f4") for i, ax in enumerate("xyz")]
    cols += [(ax, np.zeros(n, np.float32), "f4") for ax in ("nx", "ny", "nz")]
    for i, ch in enumerate(("red", "green", "blue")):
        cols.append((ch, rgb[:, i].astype(np.uint8), "u1"))
    write_ply(path, [("vertex", _structured(cols))])


def fetch_point_ply(path: str):
    elements = read_ply(path)
    v = elements[0][1]
    points = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)
    colors = (
        np.stack([v["red"], v["green"], v["blue"]], axis=1).astype(np.float32) / 255.0
    )
    if "nx" in (v.dtype.names or ()):
        normals = np.stack([v["nx"], v["ny"], v["nz"]], axis=1).astype(np.float32)
    else:
        normals = np.zeros_like(points)
    return points, colors, normals


def count_ply_elements(path: str) -> int:
    """Model-type dispatch helper (scene/__init__.py:90-103: 1 element =>
    GaussianModel, 5 => HairGaussianModel)."""
    return len(read_ply(path))
