"""Image-quality metrics (PSNR / SSIM) over a camera set (counterpart of
hairgs_tpu/evaluation/image_metrics.py).

Renders every camera once through the fused renderer, on the model's
device and through the path `config` selects, and reports full-frame PSNR,
hair-masked PSNR and SSIM, averaged over cameras.
"""

from typing import Dict

import torch


def masked_psnr(a, b, mask):
    """PSNR restricted to mask > 0 pixels (hair region); mask is (H,W) for
    (H,W,C) images."""
    if mask.ndim == a.ndim - 1:
        mask = mask[..., None]
    denom = torch.clamp(torch.sum(mask) * (a.shape[-1] / mask.shape[-1]), min=1.0)
    mse = torch.sum(((a - b) ** 2) * mask) / denom
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))


def evaluate_image_metrics(model, cameras, config=None) -> Dict[str, float]:
    """Render each camera and compare to its GT image.

    Returns {"psnr", "masked_psnr", "ssim"} means over the camera set
    (masked_psnr only when cameras carry masks). Renders are clipped to
    [0,1] before comparison, matching standard 3DGS eval practice.
    """
    from hairgs_tpu_torch.losses.photometric import psnr
    from hairgs_tpu_torch.models.gaussian import gaussian_render_inputs
    from hairgs_tpu_torch.models.hair import HairModel, hair_render_inputs
    from hairgs_tpu_torch.ops.ssim import ssim
    from hairgs_tpu_torch.render.renderer import RasterConfig, render

    cfg = config if config is not None else RasterConfig()
    if isinstance(model, HairModel):
        active = model.graph.seg_active

        def inputs_for(cam):
            return hair_render_inputs(model.params, model.graph, cam.cam_center,
                                      model.active_sh_degree,
                                      model.dist_to_scale_factor)
    else:
        active = model.active

        def inputs_for(cam):
            return gaussian_render_inputs(model.params, cam.cam_center,
                                          model.active_sh_degree)
    vals = []
    with torch.no_grad():
        for cam in cameras:
            if cam.image is None:
                continue
            out = render(cam, **inputs_for(cam), active=active, width=cam.width,
                         height=cam.height, config=cfg)
            img = torch.clamp(out["render"][..., :3], 0.0, 1.0)
            result = {"psnr": psnr(img, cam.image), "ssim": ssim(img, cam.image)}
            if cam.mask is not None:
                result["masked_psnr"] = masked_psnr(img, cam.image, cam.mask)
            vals.append(result)
    if not vals:
        return {}
    # one host transfer for all views
    keys = list(vals[0])
    sums = torch.stack([torch.stack([v[k] for k in keys]) for v in vals]).sum(0)
    return {k: float(s) / len(vals) for k, s in zip(keys, sums.tolist())}
