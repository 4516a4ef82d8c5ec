"""Quaternion / rotation utilities (counterpart of
hairgs_tpu/core/transforms.py). Quaternions are wxyz."""

import torch


def build_rotation(q):
    """Batched quaternion (N,4 wxyz) -> rotation matrices (N,3,3), normalized
    with +1e-24 inside the sqrt so zero quaternions (arena pad rows) get a
    finite (zero) gradient."""
    norm = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + 1e-24)
    q = q / norm
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = torch.stack(
        [
            1 - 2 * (y * y + z * z),
            2 * (x * y - r * z),
            2 * (x * z + r * y),
            2 * (x * y + r * z),
            1 - 2 * (x * x + z * z),
            2 * (y * z - r * x),
            2 * (x * z - r * y),
            2 * (y * z + r * x),
            1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return R.reshape(q.shape[:-1] + (3, 3))


def build_scaling_rotation(s, q):
    """L = R @ diag(s); covariance = L @ L^T."""
    return build_rotation(q) * s[..., None, :]


def strip_symmetric(cov):
    """(N,3,3) symmetric -> (N,6) upper triangle [xx,xy,xz,yy,yz,zz]."""
    return torch.stack(
        [cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2],
         cov[..., 1, 1], cov[..., 1, 2], cov[..., 2, 2]],
        dim=-1,
    )


def matrix_to_quaternion(R):
    """Batched rotation matrix (N,3,3) -> quaternion (N,4) wxyz: all four
    Shepperd candidates, the one with the largest pivot kept, sign w >= 0."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    tr = m00 + m11 + m22
    # four candidates, each scaled by 4*q_pivot
    qw0 = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx0 = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy0 = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz0 = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)
    pivots = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
        dim=-1,
    )
    best = torch.argmax(pivots, dim=-1)
    cands = torch.stack([qw0, qx0, qy0, qz0], dim=-2)  # (..., 4cand, 4comp)
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return torch.where(q[..., :1] < 0, -q, q)


def rotation_between_vectors(v1, v2, eps: float = 1e-7):
    """Rotation matrix taking each unit v1 onto each (normalised) v2:
    Rodrigues R = I + K + K^2 / (1 + v1.v2) (reference utils/transform.py:
    69-86)."""
    v2 = v2 / torch.linalg.vector_norm(v2, dim=-1, keepdim=True)
    dot = torch.clamp(torch.sum(v1 * v2, dim=-1), -1.0 + eps, 1.0 - eps)
    cross = torch.linalg.cross(v1, v2, dim=-1)
    cx, cy, cz = cross[..., 0], cross[..., 1], cross[..., 2]
    zeros = torch.zeros_like(cx)
    K = torch.stack([zeros, -cz, cy, cz, zeros, -cx, -cy, cx, zeros],
                    dim=-1).reshape(cross.shape[:-1] + (3, 3))
    eye = torch.eye(3, dtype=v2.dtype, device=v2.device).expand(K.shape)
    return eye + K + (K @ K) / (1.0 + dot)[..., None, None]


def quaternion_between_vectors(v1, v2, eps: float = 1e-7):
    """Quaternion (wxyz) rotating v1 onto v2 (scene/hair_gaussian_model.py:
    147-165)."""
    return matrix_to_quaternion(rotation_between_vectors(v1, v2, eps))
