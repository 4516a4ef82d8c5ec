"""Photometric + mask + orientation losses on the fused multi-channel render
(counterpart of hairgs_tpu/losses/photometric.py; reference loss/losses.py).
"""

import math

import torch

from hairgs_tpu_torch.core.maths import MIN_VAL, safe_norm


def l1_loss(a, b):
    return torch.mean(torch.abs(a - b))


def l2_loss(a, b):
    return torch.mean((a - b) ** 2)


def psnr(a, b):
    """Peak signal-to-noise ratio in dB for [0,1]-range images."""
    mse = torch.mean((a - b) ** 2)
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))


def bce_with_logits(logits, targets):
    """torch.nn.BCEWithLogitsLoss (mean reduction), written out as the JAX
    package writes it, with JAX's gradients at logits == 0 (every uncovered
    pixel of the rendered mask): torch.maximum splits the gradient there as
    jnp.maximum does (torch.clamp would pass all of it), and |x| is written
    as a select so that its slope at 0 is 1, as jnp.abs has it (torch.abs
    has 0)."""
    abs_logits = torch.where(logits >= 0, logits, -logits)
    return torch.mean(
        torch.maximum(logits, logits.new_zeros(())) - logits * targets
        + torch.log1p(torch.exp(-abs_logits)))


def bidirectional_angle_difference(a1, a2):
    """min angular difference mod pi; loss/losses.py:87-103."""
    half_pi = math.pi / 2
    return half_pi - torch.abs(torch.abs(a1 - a2) - half_pi)


def mask_loss_from_channel(rendered_mask, gt_mask):
    """BCEWithLogits on the rendered, already sigmoided mask channel: the
    reference's double squashing (loss/losses.py:311-315) is kept."""
    return bce_with_logits(rendered_mask, gt_mask)


def orientation_loss_from_channels(orient_world, camera):
    """Confidence-weighted bidirectional screen-angle difference over the
    hair pixels; orient_world (H,W,3) rendered world-space directions."""
    o_view = orient_world @ camera.world_view[:3, :3].T
    xy = o_view[..., :2]
    norm = safe_norm(xy, dim=-1, keepdim=True)
    xy = xy / (norm + MIN_VAL)
    x = xy[..., 0]
    y = xy[..., 1]
    y = torch.where(y < MIN_VAL, y + MIN_VAL, y)
    theta = torch.atan2(x, y)
    theta = torch.where(theta < 0, theta + math.pi, theta)
    diff = bidirectional_angle_difference(theta, camera.orientation)
    confidence = (camera.confidence if camera.confidence is not None
                  else torch.ones_like(diff))
    weighted = diff * confidence
    if camera.mask is not None:
        sel = camera.mask
    else:
        sel = torch.any(orient_world != 0.0, dim=-1).to(weighted.dtype)
    denom = torch.clamp(torch.sum(sel), min=1.0)
    return torch.sum(weighted * sel) / denom


def compute_losses(channels, camera, opt_cfg, extra_losses=None):
    """The composite training loss (reference loss_function,
    loss/losses.py:319-355) of a fused render (H, W, 7): l1 and D-SSIM on
    the RGB channels, the mask and orientation terms where the camera has
    their targets, and the precomputed strand terms of `extra_losses`
    ({"smooth": x, "magnet": y}) with their lambdas. Returns (loss,
    loss_dict). The train steps add the same terms with the photometric part
    kept apart (train/trainer.py), since only it feeds the densification
    statistics."""
    from hairgs_tpu_torch.models.gaussian import MASK, ORIENT, RGB
    from hairgs_tpu_torch.ops.ssim import ssim

    image = channels[..., RGB]
    gt = camera.image
    loss_dict = {"l1": l1_loss(image, gt)}
    loss = max(0.0, 1.0 - opt_cfg.lambda_dssim) * loss_dict["l1"]
    loss_dict["dssim"] = 1.0 - ssim(image, gt)
    loss = loss + opt_cfg.lambda_dssim * loss_dict["dssim"]
    if opt_cfg.lambda_mask > 0 and camera.mask is not None:
        loss_dict["mask"] = mask_loss_from_channel(channels[..., MASK], camera.mask)
        loss = loss + opt_cfg.lambda_mask * loss_dict["mask"]
    if opt_cfg.lambda_orientation > 0 and camera.orientation is not None:
        loss_dict["orientation"] = orientation_loss_from_channels(
            channels[..., ORIENT], camera)
        loss = loss + opt_cfg.lambda_orientation * loss_dict["orientation"]
    for name, value in (extra_losses or {}).items():
        lam = getattr(opt_cfg, f"lambda_{name}")
        if lam > 0:
            loss_dict[name] = value
            loss = loss + lam * value
    return loss, loss_dict
