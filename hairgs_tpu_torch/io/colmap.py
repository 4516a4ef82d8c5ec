"""COLMAP sparse-model binary/text I/O (no external dependencies); the
port's own copy of hairgs_tpu/io/colmap.py (numpy only).

Parity target: reference data/colmap.py:98-343 (readers, from the official
COLMAP read_write_model.py conventions) and l.471-525 (binary writers).
Byte-layout identical to COLMAP: little-endian structs, PINHOLE camera model.
"""

import collections
import struct
from typing import Dict

import numpy as np

ColmapCamera = collections.namedtuple(
    "ColmapCamera", ["id", "model", "width", "height", "params"]
)
ColmapImage = collections.namedtuple(
    "ColmapImage", ["id", "qvec", "tvec", "camera_id", "name", "xys", "point3D_ids"]
)
ColmapPoint3D = collections.namedtuple(
    "ColmapPoint3D", ["id", "xyz", "rgb", "error", "image_ids", "point2D_idxs"]
)

CAMERA_MODEL_IDS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_NAMES = {name: (mid, n) for mid, (name, n) in CAMERA_MODEL_IDS.items()}


def qvec2rotmat(qvec):
    """wxyz quaternion -> rotation matrix (data/colmap.py:56-75)."""
    w, x, y, z = qvec
    return np.array(
        [
            [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * z * x + 2 * w * y],
            [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
            [2 * z * x - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y],
        ]
    )


def rotmat2qvec(R):
    """Rotation matrix -> wxyz quaternion with w>=0 (data/colmap.py:78-95)."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = (
        np.array(
            [
                [Rxx - Ryy - Rzz, 0, 0, 0],
                [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
                [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
                [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz],
            ]
        )
        / 3.0
    )
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


def _read(fid, num_bytes, fmt):
    return struct.unpack("<" + fmt, fid.read(num_bytes))


def _write(fid, data, fmt):
    if isinstance(data, (list, tuple)):
        fid.write(struct.pack("<" + fmt, *data))
    else:
        fid.write(struct.pack("<" + fmt, data))


# --------------------------------------------------------------------------
# readers
# --------------------------------------------------------------------------

def read_intrinsics_binary(path) -> Dict[int, ColmapCamera]:
    cameras = {}
    with open(path, "rb") as fid:
        num_cameras = _read(fid, 8, "Q")[0]
        for _ in range(num_cameras):
            cam_id, model_id, width, height = _read(fid, 24, "iiQQ")
            model_name, num_params = CAMERA_MODEL_IDS[model_id]
            params = _read(fid, 8 * num_params, "d" * num_params)
            cameras[cam_id] = ColmapCamera(
                id=cam_id, model=model_name, width=width, height=height,
                params=np.array(params),
            )
    return cameras


def read_extrinsics_binary(path) -> Dict[int, ColmapImage]:
    images = {}
    with open(path, "rb") as fid:
        num_images = _read(fid, 8, "Q")[0]
        for _ in range(num_images):
            props = _read(fid, 64, "idddddddi")
            image_id = props[0]
            qvec = np.array(props[1:5])
            tvec = np.array(props[5:8])
            camera_id = props[8]
            name = b""
            ch = fid.read(1)
            while ch != b"\x00":
                name += ch
                ch = fid.read(1)
            num_points2d = _read(fid, 8, "Q")[0]
            data = _read(fid, 24 * num_points2d, "ddq" * num_points2d)
            xys = np.column_stack([data[0::3], data[1::3]]) if num_points2d else np.zeros((0, 2))
            p3d = np.array(data[2::3], dtype=np.int64)
            images[image_id] = ColmapImage(
                id=image_id, qvec=qvec, tvec=tvec, camera_id=camera_id,
                name=name.decode("utf-8"), xys=xys, point3D_ids=p3d,
            )
    return images


def read_points3D_binary(path):
    with open(path, "rb") as fid:
        num_points = _read(fid, 8, "Q")[0]
        xyzs = np.empty((num_points, 3))
        rgbs = np.empty((num_points, 3))
        errors = np.empty((num_points, 1))
        for i in range(num_points):
            props = _read(fid, 43, "QdddBBBd")
            xyzs[i] = props[1:4]
            rgbs[i] = props[4:7]
            errors[i] = props[7]
            track_len = _read(fid, 8, "Q")[0]
            _read(fid, 8 * track_len, "ii" * track_len)
    return xyzs, rgbs, errors


def read_intrinsics_text(path) -> Dict[int, ColmapCamera]:
    cameras = {}
    with open(path) as fid:
        for line in fid:
            line = line.strip()
            if not line or line[0] == "#":
                continue
            elems = line.split()
            cam_id = int(elems[0])
            model = elems[1]
            cameras[cam_id] = ColmapCamera(
                id=cam_id, model=model, width=int(elems[2]), height=int(elems[3]),
                params=np.array(list(map(float, elems[4:]))),
            )
    return cameras


def read_extrinsics_text(path) -> Dict[int, ColmapImage]:
    images = {}
    with open(path) as fid:
        lines = [l.strip() for l in fid]
    i = 0
    while i < len(lines):
        line = lines[i]
        i += 1
        if not line or line[0] == "#":
            continue
        elems = line.split()
        image_id = int(elems[0])
        qvec = np.array(list(map(float, elems[1:5])))
        tvec = np.array(list(map(float, elems[5:8])))
        camera_id = int(elems[8])
        name = elems[9]
        pts = lines[i].split() if i < len(lines) else []
        i += 1
        xys = np.column_stack(
            [list(map(float, pts[0::3])), list(map(float, pts[1::3]))]
        ) if pts else np.zeros((0, 2))
        p3d = np.array(list(map(int, pts[2::3])), dtype=np.int64)
        images[image_id] = ColmapImage(
            id=image_id, qvec=qvec, tvec=tvec, camera_id=camera_id, name=name,
            xys=xys, point3D_ids=p3d,
        )
    return images


def read_points3D_text(path):
    xyzs, rgbs, errors = [], [], []
    with open(path) as fid:
        for line in fid:
            line = line.strip()
            if not line or line[0] == "#":
                continue
            elems = line.split()
            xyzs.append(list(map(float, elems[1:4])))
            rgbs.append(list(map(int, elems[4:7])))
            errors.append([float(elems[7])])
    return np.array(xyzs), np.array(rgbs), np.array(errors)


# --------------------------------------------------------------------------
# writers (data/colmap.py:471-525)
# --------------------------------------------------------------------------

def write_cameras_binary(cameras: Dict[int, ColmapCamera], path):
    with open(path, "wb") as fid:
        _write(fid, len(cameras), "Q")
        for cam in cameras.values():
            model_id = CAMERA_MODEL_NAMES[cam.model][0]
            _write(fid, [cam.id, model_id, cam.width, cam.height], "iiQQ")
            for p in cam.params:
                _write(fid, float(p), "d")


def write_images_binary(images: Dict[int, ColmapImage], path):
    with open(path, "wb") as fid:
        _write(fid, len(images), "Q")
        for img in images.values():
            _write(fid, img.id, "i")
            _write(fid, list(np.asarray(img.qvec, dtype=float)), "dddd")
            _write(fid, list(np.asarray(img.tvec, dtype=float)), "ddd")
            _write(fid, img.camera_id, "i")
            fid.write(img.name.encode("utf-8") + b"\x00")
            _write(fid, len(img.point3D_ids), "Q")
            for xy, p3d_id in zip(img.xys, img.point3D_ids):
                _write(fid, [float(xy[0]), float(xy[1]), int(p3d_id)], "ddq")


def write_points3D_binary(points3d: Dict[int, ColmapPoint3D], path):
    with open(path, "wb") as fid:
        _write(fid, len(points3d), "Q")
        for pt in points3d.values():
            _write(fid, pt.id, "Q")
            _write(fid, list(np.asarray(pt.xyz, dtype=float)), "ddd")
            _write(fid, list(np.asarray(pt.rgb, dtype=int)), "BBB")
            _write(fid, float(pt.error), "d")
            track_len = len(pt.image_ids)
            _write(fid, track_len, "Q")
            for image_id, p2d in zip(pt.image_ids, pt.point2D_idxs):
                _write(fid, [int(image_id), int(p2d)], "ii")


def generate_colmap_data(cameras: Dict[int, ColmapCamera],
                         extrinsics: Dict[int, np.ndarray],
                         vertices: np.ndarray, vertex_color: np.ndarray):
    """Synthesize a COLMAP scene from cameras + a point cloud, including
    per-image visible-keypoint lists (data/colmap.py:369-434).

    extrinsics: cam_id -> 4x4 (or 3x4) world->camera matrix E.
    """
    images = {}
    points_3d = {}
    image_to_xys = {k: [] for k in cameras}
    image_to_ids = {k: [] for k in cameras}

    # project all points into all cameras at once (OpenCV pinhole)
    for pid in range(vertices.shape[0]):
        point_3d_id = pid + 1
        image_ids = []
        point_2d_ids = []
        for cam_id, cam in cameras.items():
            E = extrinsics[cam_id]
            pc = E[:3, :3] @ vertices[pid] + E[:3, 3]
            if pc[2] <= 0:
                continue
            fx, fy, cx, cy = cam.params[:4] if cam.model == "PINHOLE" else (
                cam.params[0], cam.params[0], cam.params[1], cam.params[2]
            )
            x = fx * pc[0] / pc[2] + cx
            y = fy * pc[1] / pc[2] + cy
            if 0 <= x < cam.width and 0 <= y < cam.height:
                image_ids.append(cam_id)
                image_to_ids[cam_id].append(point_3d_id)
                image_to_xys[cam_id].append(np.array([x, y]))
                point_2d_ids.append(len(image_to_xys[cam_id]))
        color = (vertex_color[pid] * 255).astype(np.uint8)
        points_3d[point_3d_id] = ColmapPoint3D(
            id=point_3d_id, xyz=vertices[pid], rgb=color[:3], error=0,
            image_ids=np.array(image_ids), point2D_idxs=point_2d_ids,
        )

    for cam_id in cameras:
        E = extrinsics[cam_id]
        images[cam_id] = ColmapImage(
            id=cam_id, qvec=rotmat2qvec(E[:3, :3]), tvec=E[:3, 3],
            camera_id=cam_id, name=f"image_{cam_id}.png",
            xys=image_to_xys[cam_id], point3D_ids=image_to_ids[cam_id],
        )
    return images, points_3d
