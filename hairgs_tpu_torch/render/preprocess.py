"""Per-Gaussian preprocessing: frustum cull, EWA 3D->2D covariance
projection, conic / radius / tile rect (counterpart of
hairgs_tpu/render/preprocess.py; reference forward.cu:74-256).

Batched elementwise torch over the Gaussian axis. No kernel of its own:
there is no reuse or matrix structure to exploit.
"""

from typing import NamedTuple, Optional

import torch

from hairgs_tpu_torch.core.maths import constant_like
from hairgs_tpu_torch.core.transforms import build_rotation


class Preprocessed(NamedTuple):
    valid: torch.Tensor  # (N,) bool — survives culling, radius > 0
    depth: torch.Tensor  # (N,) view-space z
    xy: torch.Tensor  # (N,2) pixel-space mean
    conic: torch.Tensor  # (N,3) inverse 2D covariance (a, b, c)
    radius: torch.Tensor  # (N,) float pixel radius (ceil'd, 3-sigma)
    rect: torch.Tensor  # (N,4) int32 BINNING tile rect [xmin,ymin,xmax,ymax)
    tiles_touched: torch.Tensor  # (N,) int32 (3-sigma rect)
    cull_radius: Optional[torch.Tensor] = None  # (N,) alpha-cutoff radius
    compensation: Optional[torch.Tensor] = None  # (N,) Mip-Splatting factor


def ndc2pix(v, size):
    return ((v + 1.0) * size - 1.0) * 0.5


def compute_cov3d(scales, rotations, scale_modifier=1.0):
    """World-space covariance (N,3,3) = R S S^T R^T."""
    R = build_rotation(rotations)
    S = scales * scale_modifier
    M = R * S[..., None, :]
    return M @ M.transpose(-1, -2)


def project_cov2d(mean3d, cov3d, world_view, focal_x, focal_y, tanfovx,
                  tanfovy, return_compensation=False):
    """EWA projection to the 2D screen covariance (cov_xx, cov_xy, cov_yy)
    with the +0.3 px low-pass; optionally the Mip-Splatting compensation."""
    Wm = world_view[:3, :3]
    t = mean3d @ Wm.T + world_view[:3, 3]
    limx = 1.3 * tanfovx
    limy = 1.3 * tanfovy
    # Guard the depth divisions BEFORE dividing: rows at or behind the camera
    # plane (arena pad rows sit at the world origin, which is a ring camera's
    # plane) would give inf here, and the backward's 0 * inf = NaN would
    # reach xyz / scaling / rotation even though `valid` masks the forward.
    # 0.19 sits strictly below the 0.2 frustum cull, so every guarded row is
    # culled anyway.
    tz = torch.where(t[..., 2] > 0.19, t[..., 2], torch.ones_like(t[..., 2]))
    txtz = t[..., 0] / tz
    tytz = t[..., 1] / tz
    tx = torch.minimum(torch.maximum(txtz, -limx), limx) * tz
    ty = torch.minimum(torch.maximum(tytz, -limy), limy) * tz

    inv_tz = 1.0 / tz
    inv_tz2 = inv_tz * inv_tz
    zeros = torch.zeros_like(tz)
    J = torch.stack(
        [
            torch.stack([focal_x * inv_tz, zeros, -focal_x * tx * inv_tz2], dim=-1),
            torch.stack([zeros, focal_y * inv_tz, -focal_y * ty * inv_tz2], dim=-1),
        ],
        dim=-2,
    )  # (N,2,3)
    M = J @ Wm
    cov = M @ cov3d @ M.transpose(-1, -2)
    c_xx = cov[..., 0, 0]
    c_xy = cov[..., 0, 1]
    c_yy = cov[..., 1, 1]
    out = torch.stack([c_xx + 0.3, c_xy, c_yy + 0.3], dim=-1)
    if not return_compensation:
        return out
    det_raw = c_xx * c_yy - c_xy * c_xy
    det_blur = (c_xx + 0.3) * (c_yy + 0.3) - c_xy * c_xy
    # where-clamped below a positive epsilon BEFORE the sqrt: a thin strand
    # cancels to det_raw <= 0, and sqrt's derivative at 0 would emit NaN
    eps = 1e-6
    det_raw_safe = torch.where(det_raw > eps, det_raw, torch.full_like(det_raw, eps))
    det_blur_safe = torch.where(det_blur > eps, det_blur, torch.full_like(det_blur, eps))
    return out, torch.sqrt(det_raw_safe / det_blur_safe)


def _to_int32(x):
    # XLA converts NaN to 0 when casting to an integer; torch leaves it
    # undefined, so a garbage (culled) row is zeroed first
    return torch.nan_to_num(x, nan=0.0).to(torch.int32)


def preprocess(mean3d, scales, rotations, camera, width: int, height: int,
               tile_size: int, active=None, scale_modifier: float = 1.0,
               cov3d_precomp=None, mean2d_offset=None, opacity=None,
               antialiasing: bool = False,
               alpha_min: float = 1.0 / 255.0) -> Preprocessed:
    """Vectorized preprocess over all Gaussians; same contract as
    hairgs_tpu.render.preprocess.preprocess.

    opacity (activated) makes the binning rect use the exact alpha-cutoff
    radius min(3 sigma, r_alpha); `radius` keeps the 3-sigma value.
    """
    grid_w = (width + tile_size - 1) // tile_size
    grid_h = (height + tile_size - 1) // tile_size

    focal_x = width / (2.0 * camera.tanfovx)
    focal_y = height / (2.0 * camera.tanfovy)

    ones = torch.ones_like(mean3d[..., :1])
    p_hom = torch.cat([mean3d, ones], dim=-1) @ camera.full_proj.T
    p_w = 1.0 / (p_hom[..., 3] + 1e-7)
    p_proj = p_hom[..., :3] * p_w[..., None]

    p_view_z = mean3d @ camera.world_view[2, :3] + camera.world_view[2, 3]
    in_frustum = p_view_z > 0.2  # auxiliary.h:154

    cov3d = (compute_cov3d(scales, rotations, scale_modifier)
             if cov3d_precomp is None else cov3d_precomp)
    compensation = None
    if antialiasing:
        cov, compensation = project_cov2d(
            mean3d, cov3d, camera.world_view, focal_x, focal_y,
            camera.tanfovx, camera.tanfovy, return_compensation=True)
    else:
        cov = project_cov2d(mean3d, cov3d, camera.world_view, focal_x,
                            focal_y, camera.tanfovx, camera.tanfovy)

    det = cov[..., 0] * cov[..., 2] - cov[..., 1] * cov[..., 1]
    det_ok = det != 0.0
    det_inv = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    conic = torch.stack(
        [cov[..., 2] * det_inv, -cov[..., 1] * det_inv, cov[..., 0] * det_inv],
        dim=-1)

    mid = 0.5 * (cov[..., 0] + cov[..., 2])
    lambda1 = mid + torch.sqrt(torch.maximum(mid * mid - det, constant_like(0.1, det)))
    radius = torch.ceil(3.0 * torch.sqrt(lambda1))

    xy = torch.stack([ndc2pix(p_proj[..., 0], width),
                      ndc2pix(p_proj[..., 1], height)], dim=-1)
    if mean2d_offset is not None:
        # gradient hook in CUDA dL_dmean2D units (pixel grads x 0.5W, 0.5H)
        xy = xy + torch.stack([mean2d_offset[..., 0] * (0.5 * width),
                               mean2d_offset[..., 1] * (0.5 * height)], dim=-1)

    def tile_rect(r):
        # auxiliary.h:46-56
        x, y = xy[..., 0].detach(), xy[..., 1].detach()
        rxmin = _to_int32(torch.clamp(torch.floor((x - r) / tile_size), 0, grid_w))
        rymin = _to_int32(torch.clamp(torch.floor((y - r) / tile_size), 0, grid_h))
        rxmax = _to_int32(torch.clamp(
            torch.floor((x + r + tile_size - 1) / tile_size), 0, grid_w))
        rymax = _to_int32(torch.clamp(
            torch.floor((y + r + tile_size - 1) / tile_size), 0, grid_h))
        return rxmin, rymin, rxmax, rymax

    radius = radius.detach()
    rxmin, rymin, rxmax, rymax = tile_rect(radius)
    tiles_touched = (rxmax - rxmin) * (rymax - rymin)

    cull_radius = radius
    if opacity is not None:
        opa_cull = opacity.detach()
        if compensation is not None:
            opa_cull = opa_cull * compensation.detach()
        r_alpha2 = 2.0 * lambda1.detach() * torch.log(
            torch.clamp(opa_cull / alpha_min, min=1.0))
        # +1px slack absorbs the float boundary (the gate is alpha>=alpha_min)
        cull_radius = torch.minimum(radius, torch.ceil(torch.sqrt(r_alpha2)) + 1.0)
        rxmin, rymin, rxmax, rymax = tile_rect(cull_radius)

    valid = in_frustum & det_ok & (tiles_touched > 0)
    if active is not None:
        valid = valid & active
    tiles_touched = torch.where(valid, tiles_touched, torch.zeros_like(tiles_touched))
    radius = torch.where(valid, radius, torch.zeros_like(radius))

    # sanitize culled rows: inactive arena rows can carry degenerate inputs
    # whose NaN/Inf would otherwise leak through 0*NaN in the compositor
    conic = torch.where(valid[..., None], conic, torch.zeros_like(conic))
    xy = torch.where(valid[..., None], xy, torch.zeros_like(xy))
    if compensation is not None:
        compensation = torch.where(valid, compensation, torch.zeros_like(compensation))

    rect = torch.stack([rxmin, rymin, rxmax, rymax], dim=-1)
    return Preprocessed(valid=valid, depth=p_view_z, xy=xy, conic=conic,
                        radius=radius, rect=rect, tiles_touched=tiles_touched,
                        cull_radius=cull_radius, compensation=compensation)
