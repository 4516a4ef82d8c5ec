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
