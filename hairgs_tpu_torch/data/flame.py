"""FLAME head model (linear blend skinning) in host numpy (counterpart of
hairgs_tpu/data/flame.py).

Parity target: scene/flame.py (smplx-based differentiable FLAME used only to
extract fitted-head vertices and the scalp vertex region for NeRSemble scenes,
parse_nersemble.py:150-367). This implementation reads the standard FLAME
pickle (v_template, shapedirs, posedirs, J_regressor, lbs_weights,
kintree_table) and evaluates

    verts = LBS(v_template + shapedirs.(beta|psi) + posedirs.pose_feature)

with Rodrigues joint rotations — the full generic FLAME forward, no smplx
needed. The scalp region comes from the FLAME_masks pickle ("scalp" entry),
as the reference does (scene/flame.py mask handling).

Gated at call time on the model files being present (they are licensed
artifacts the user downloads from flame.is.tue.mpg.de).
"""

import pickle
from typing import NamedTuple

import numpy as np


class FlameModel(NamedTuple):
    v_template: np.ndarray  # (V,3)
    shapedirs: np.ndarray  # (V,3,n_shape+n_expr)
    posedirs: np.ndarray  # (V,3,9*(J-1)) stored flattened as (9*(J-1), V*3)
    j_regressor: np.ndarray  # (J,V)
    lbs_weights: np.ndarray  # (V,J)
    parents: np.ndarray  # (J,)
    faces: np.ndarray  # (F,3)


def _to_np(x):
    if hasattr(x, "todense"):
        return np.asarray(x.todense())
    if hasattr(x, "r"):  # chumpy
        return np.asarray(x.r)
    return np.asarray(x)


def load_flame_model(path: str) -> FlameModel:
    with open(path, "rb") as f:
        data = pickle.load(f, encoding="latin1")
    posedirs = _to_np(data["posedirs"])
    v = _to_np(data["v_template"]).shape[0]
    posedirs = posedirs.reshape(v * 3, -1).T  # (P, V*3)
    return FlameModel(
        v_template=_to_np(data["v_template"]).astype(np.float64),
        shapedirs=_to_np(data["shapedirs"]).astype(np.float64),
        posedirs=posedirs.astype(np.float64),
        j_regressor=_to_np(data["J_regressor"]).astype(np.float64),
        lbs_weights=_to_np(data["weights"]).astype(np.float64),
        parents=_to_np(data["kintree_table"])[0].astype(np.int64),
        faces=_to_np(data["f"]).astype(np.int64),
    )


def _rodrigues(rvecs: np.ndarray) -> np.ndarray:
    """(J,3) axis-angle -> (J,3,3)."""
    theta = np.linalg.norm(rvecs, axis=1, keepdims=True)
    theta = np.maximum(theta, 1e-12)
    axis = rvecs / theta
    x, y, z = axis[:, 0], axis[:, 1], axis[:, 2]
    zeros = np.zeros_like(x)
    K = np.stack(
        [zeros, -z, y, z, zeros, -x, -y, x, zeros], axis=1
    ).reshape(-1, 3, 3)
    s = np.sin(theta)[:, :, None]
    c = np.cos(theta)[:, :, None]
    eye = np.eye(3)[None]
    return eye + s * K + (1 - c) * (K @ K)


def build_full_pose(j: int, pose_params=None, neck_pose=None,
                    eye_pose=None) -> np.ndarray:
    """(J,3) per-joint axis-angle in FLAME joint order [global, neck, jaw,
    eye_L, eye_R]: the reference concatenates full_pose = [pose[:3], neck,
    pose[3:], eyes] (scene/flame.py:259-260)."""
    full_pose = np.zeros((j, 3))
    if pose_params is not None:
        full_pose[0] = pose_params[:3]  # global
        if len(pose_params) >= 6:
            full_pose[2] = pose_params[3:6]  # jaw
    if neck_pose is not None:
        full_pose[1] = neck_pose  # neck
    if eye_pose is not None:
        full_pose[3] = eye_pose[:3]
        full_pose[4] = eye_pose[3:6]
    return full_pose


def flame_forward(model: FlameModel, shape_params=None, expression_params=None,
                  pose_params=None, neck_pose=None, eye_pose=None,
                  transl=None, landmark_embedding=None,
                  use_face_contour: bool = False) -> np.ndarray:
    """FLAME forward returning vertices (V,3) — or (vertices, landmarks)
    when a landmark_embedding is given, matching the reference forward's
    (vertices, landmarks) return (scene/flame.py:234-304).

    pose_params: (6,) global + jaw axis-angle; neck_pose (3,), eye_pose (6,),
    matching the smplx FLAME layout the reference uses (scene/flame.py:234+).
    """
    n_shape_total = model.shapedirs.shape[2]
    v = model.v_template.shape[0]
    j = model.j_regressor.shape[0]

    betas = np.zeros(n_shape_total)
    if shape_params is not None:
        betas[: len(shape_params)] = shape_params
    if expression_params is not None:
        # FLAME convention: first 300 shape, remainder expression
        n_shape = n_shape_total - len(expression_params)
        betas[n_shape : n_shape + len(expression_params)] = expression_params

    v_shaped = model.v_template + np.einsum("vks,s->vk", model.shapedirs, betas)
    joints = model.j_regressor @ v_shaped  # (J,3)

    full_pose = build_full_pose(j, pose_params, neck_pose, eye_pose)

    rots = _rodrigues(full_pose)  # (J,3,3)
    # pose-dependent corrective blendshapes (exclude global joint)
    pose_feature = (rots[1:] - np.eye(3)[None]).reshape(-1)
    v_posed = v_shaped + (pose_feature @ model.posedirs).reshape(v, 3)

    # forward kinematics
    transforms = np.zeros((j, 4, 4))
    transforms[0] = np.eye(4)
    transforms[0, :3, :3] = rots[0]
    transforms[0, :3, 3] = joints[0]
    for i in range(1, j):
        local = np.eye(4)
        local[:3, :3] = rots[i]
        local[:3, 3] = joints[i] - joints[model.parents[i]]
        transforms[i] = transforms[model.parents[i]] @ local
    # remove rest-pose joint locations
    rel = transforms.copy()
    for i in range(j):
        rel[i, :3, 3] -= rel[i, :3, :3] @ joints[i]

    # linear blend skinning
    vert_t = np.einsum("vj,jab->vab", model.lbs_weights, rel)  # (V,4,4)
    homo = np.concatenate([v_posed, np.ones((v, 1))], axis=1)
    out = np.einsum("vab,vb->va", vert_t, homo)[:, :3]
    if landmark_embedding is not None:
        # landmarks are sampled BEFORE translation, then both are shifted
        # (reference applies transl to vertices and landmarks alike,
        # scene/flame.py:299-302)
        lmk = flame_landmarks(model, landmark_embedding, out,
                              full_pose=full_pose,
                              use_face_contour=use_face_contour)
        if transl is not None:
            t = np.asarray(transl)
            out = out + t
            lmk = (lmk + t).astype(np.float32)
        return out.astype(np.float32), lmk
    if transl is not None:
        out = out + np.asarray(transl)
    return out.astype(np.float32)


class FlameLandmarkEmbedding(NamedTuple):
    """Facial-landmark embeddings (barycentric samples on mesh faces).

    Parity target: scene/flame.py:144-184 (static + dynamic landmark
    embedding buffers) and its forward's vertices2landmarks call.
    static_*: the 51/68-point static embedding; dynamic_* (optional): the
    79-row yaw-indexed contour table (rows 0..39 = looking left by that many
    degrees, 40..78 = looking right by 1..39 degrees, smplx convention).
    """

    static_faces: np.ndarray  # (L,) int64 face indices
    static_bary: np.ndarray  # (L,3) barycentric coords
    dynamic_faces: np.ndarray = None  # (79, Ld) int64, optional
    dynamic_bary: np.ndarray = None  # (79, Ld, 3), optional


def load_static_landmark_embedding(path: str) -> FlameLandmarkEmbedding:
    """flame_static_embedding.pkl: {lmk_face_idx, lmk_b_coords}
    (scene/flame.py:144-153)."""
    with open(path, "rb") as f:
        data = pickle.load(f, encoding="latin1")
    return FlameLandmarkEmbedding(
        static_faces=_to_np(data["lmk_face_idx"]).astype(np.int64),
        static_bary=_to_np(data["lmk_b_coords"]).astype(np.float64),
    )


def load_dynamic_landmark_embedding(path: str,
                                    static: FlameLandmarkEmbedding = None
                                    ) -> FlameLandmarkEmbedding:
    """flame_dynamic_embedding.npy: pickled dict with per-yaw-angle contour
    tables (scene/flame.py:155-177). Merges into `static` when given."""
    data = np.load(path, allow_pickle=True, encoding="latin1")[()]
    dyn_faces = np.array(data["lmk_face_idx"]).astype(np.int64)
    dyn_bary = np.array([np.asarray(b) for b in data["lmk_b_coords"]],
                        dtype=np.float64)
    if static is None:
        static = FlameLandmarkEmbedding(
            static_faces=np.zeros(0, np.int64),
            static_bary=np.zeros((0, 3), np.float64),
        )
    return static._replace(dynamic_faces=dyn_faces, dynamic_bary=dyn_bary)


def _rot_mat_to_y_euler(rot: np.ndarray) -> float:
    """Y euler angle of a rotation matrix (smplx rot_mat_to_euler:
    atan2(-R[2,0], sqrt(R[0,0]^2 + R[1,0]^2)))."""
    sy = np.sqrt(rot[0, 0] ** 2 + rot[1, 0] ** 2)
    return float(np.arctan2(-rot[2, 0], sy))


def _dynamic_lmk_index(full_pose: np.ndarray, parents: np.ndarray,
                       neck_idx: int = 1) -> int:
    """Row of the 79-entry dynamic contour table for the head's current yaw
    (scene/flame.py:186-232 _find_dynamic_lmk_idx_and_bcoords).

    Composes the rotations along the neck kinematic chain (neck -> global),
    converts to a yaw angle in degrees, and maps [-39, 39] onto table rows
    [78..40, 0..39] exactly like the smplx masking arithmetic."""
    chain = []
    idx = neck_idx
    while True:
        chain.append(idx)
        if idx == 0:
            break
        idx = int(parents[idx])
    rots = _rodrigues(full_pose[chain])
    rel = np.eye(3)
    for r in rots:
        rel = r @ rel
    y_deg = np.clip(np.round(-_rot_mat_to_y_euler(rel) * 180.0 / np.pi),
                    a_min=None, a_max=39)
    y = int(y_deg)
    if y < 0:
        return 78 if y < -39 else 39 - y
    return y


def flame_landmarks(model: FlameModel, embedding: FlameLandmarkEmbedding,
                    vertices: np.ndarray, full_pose: np.ndarray = None,
                    use_face_contour: bool = False) -> np.ndarray:
    """Barycentric landmark positions on a posed FLAME mesh
    (smplx vertices2landmarks; scene/flame.py:286-297).

    vertices: (V,3) posed mesh; full_pose: (J,3) axis-angle per joint (only
    needed with use_face_contour). Returns (L_dyn + L_static, 3) with the
    contour landmarks first, matching the reference's concatenation order."""
    faces_idx = embedding.static_faces
    bary = embedding.static_bary
    if use_face_contour:
        assert embedding.dynamic_faces is not None, (
            "use_face_contour requires a dynamic landmark embedding")
        assert full_pose is not None, "face contour needs the pose"
        row = _dynamic_lmk_index(full_pose, model.parents)
        faces_idx = np.concatenate(
            [embedding.dynamic_faces[row], faces_idx])
        bary = np.concatenate([embedding.dynamic_bary[row], bary])
    tri = model.faces[faces_idx]  # (L,3) vertex ids
    corner = vertices[tri]  # (L,3,3)
    return np.einsum("lkc,lk->lc", corner, bary).astype(np.float32)


def load_flame_masks(path: str) -> dict:
    """FLAME_masks.pkl: region name -> vertex index array; the "scalp" region
    provides ref_strand_root for NeRSemble scenes."""
    with open(path, "rb") as f:
        masks = pickle.load(f, encoding="latin1")
    return {k: np.asarray(val, dtype=np.int64) for k, val in masks.items()}
