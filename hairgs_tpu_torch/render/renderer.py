"""Top-level differentiable render entry point (counterpart of
hairgs_tpu/render/renderer.py).

The renderer is channel-generic: one fused pass renders rgb + hair mask +
orientation together. It always takes the paged path of the JAX package
(sorted binning, paged pair table, `composite_pairs`), whose two passes are
the hand-written CUDA kernels on the card.
"""

import dataclasses

import torch

from hairgs_tpu_torch.core.maths import safe_norm
from hairgs_tpu_torch.core.sh import eval_sh
from hairgs_tpu_torch.render.binning import bin_gaussians_sorted, gather_pairs
from hairgs_tpu_torch.render.composite_pairs import (
    assemble_image,
    composite_pairs,
    pack_geo_rows,
    pad_feat_rows,
)
from hairgs_tpu_torch.render.preprocess import preprocess


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    """Static rasterizer configuration, with the JAX package's fields.

    `use_pallas`, `tiles_per_step` and `dma_lookahead` select or schedule
    the TPU kernels; they are accepted and ignored here (the port always
    runs the paged compositor). `feat_bf16=True` is not ported yet and
    raises in `render`.
    """

    tile_size: int = 16
    max_tiles_per_gaussian: int = 16
    max_pairs_per_tile: int = 1024
    chunk: int = 32
    use_pallas: bool = False
    feat_bf16: bool = False
    tiles_per_step: int = 32
    # Mip-Splatting-style dilation compensation of opacity
    antialiasing: bool = False
    # > 0 sizes the paged table to this many slots instead of the
    # n * max_tiles_per_gaussian worst case; tiles that no longer fit are
    # truncated and counted in overflow_capacity
    pair_capacity: int = 0
    # emit the photometric-only viewspace gradients (densification stats)
    # into the aux rows of the compositor backward
    viewspace_stats: bool = True
    dma_lookahead: bool = False
    # per-pair alpha gate (reference 1/255, forward.cu:343-351)
    alpha_min: float = 1.0 / 255.0

    def __post_init__(self):
        assert self.max_pairs_per_tile % self.chunk == 0


def render(camera, *, means3d, opacity, features, scales=None, rotations=None,
           cov3d_precomp=None, bg=None, active=None, mean2d_offset=None,
           scale_modifier: float = 1.0, width: int, height: int,
           config: RasterConfig = RasterConfig()):
    """Differentiable multi-channel splatting render.

    means3d (N,3); opacity (N,); features (N,C); scales (N,3) + rotations
    (N,4 wxyz) or cov3d_precomp (N,3,3); bg (C,); active (N,) bool;
    mean2d_offset (N,2) zeros whose gradient is the photometric-only CUDA
    dL_dmean2D. Returns the JAX package's dict: render (H,W,C), render_photo
    (same values, for photometric losses), final_T (H,W), radii (N,),
    visibility_filter, the overflow counters, pairs_demand and tile_counts.
    """
    ts = config.tile_size
    grid_w = (width + ts - 1) // ts
    grid_h = (height + ts - 1) // ts
    prep, binning, geo_rows, feat_rows = paged_pair_table(
        camera, means3d=means3d, opacity=opacity, features=features,
        scales=scales, rotations=rotations, cov3d_precomp=cov3d_precomp,
        active=active, mean2d_offset=mean2d_offset,
        scale_modifier=scale_modifier, width=width, height=height,
        config=config)
    max_chunks = config.max_pairs_per_tile // config.chunk
    tiles, tiles_photo, trans_tiles = composite_pairs(
        geo_rows, feat_rows, binning.starts, binning.counts, grid_w, grid_h,
        ts, config.chunk, max_chunks, features.shape[-1],
        with_stats=config.viewspace_stats, alpha_min=config.alpha_min)
    image = assemble_image(tiles, grid_w, grid_h, ts, height, width)
    image_photo = assemble_image(tiles_photo, grid_w, grid_h, ts, height, width)
    final_t = assemble_image(trans_tiles, grid_w, grid_h, ts, height, width)
    if bg is not None:
        image = image + final_t[..., None] * bg
        image_photo = image_photo + final_t[..., None] * bg

    return {
        "render": image,
        # identical values; photometric losses read this one so the
        # dual-cotangent backward can split the viewspace statistics
        "render_photo": image_photo,
        "final_T": final_t,
        "radii": prep.radius,
        "visibility_filter": prep.radius > 0,
        "overflow_pairs": binning.overflow_pairs,
        "overflow_tiles": binning.overflow_tiles,
        "overflow_capacity": binning.overflow_capacity,
        "pairs_demand": binning.pairs_demand,
        "tile_counts": binning.counts,
    }


def paged_pair_table(camera, *, means3d, opacity, features, scales, rotations,
                     cov3d_precomp, active, mean2d_offset, scale_modifier,
                     width, height, config):
    """Everything `render` does before compositing: preprocess, sorted
    binning and the two gathered planes. Returns (prep, binning,
    geo_rows (8, P_pad), feat_rows (C_pad, P_pad)), the planes contiguous
    as the compositor kernels read them."""
    if config.feat_bf16:
        raise NotImplementedError("RasterConfig.feat_bf16 is not ported yet")
    ts = config.tile_size
    grid_w = (width + ts - 1) // ts
    grid_h = (height + ts - 1) // ts
    prep = preprocess(
        means3d, scales, rotations, camera, width, height, ts, active=active,
        scale_modifier=scale_modifier, cov3d_precomp=cov3d_precomp,
        mean2d_offset=None, opacity=opacity,
        antialiasing=config.antialiasing, alpha_min=config.alpha_min)

    opa_eff = torch.where(prep.valid, opacity, torch.zeros_like(opacity))
    if config.antialiasing:
        opa_eff = opa_eff * prep.compensation
    # a tile whose minimum exponent exceeds ln(opa / alpha_min) can never
    # pass the alpha gate
    q_cut = torch.log(torch.clamp(opa_eff.detach(), min=1e-12) / config.alpha_min)

    binning = bin_gaussians_sorted(
        prep.rect, prep.depth, prep.valid, grid_w, grid_h,
        config.max_tiles_per_gaussian, config.max_pairs_per_tile,
        config.chunk, xy=prep.xy.detach(), conic=prep.conic.detach(),
        q_cut=q_cut, tile_size=ts, pair_capacity=config.pair_capacity)
    # NaN hygiene for inactive rows
    feat_eff = torch.where(prep.valid[:, None], features, torch.zeros_like(features))
    aux = None
    if mean2d_offset is not None:
        # CUDA dL_dmean2D units: pixel grads x (0.5W, 0.5H)
        aux = torch.stack([mean2d_offset[:, 0] * (0.5 * width),
                           mean2d_offset[:, 1] * (0.5 * height)], dim=1)
    geo_packed = pack_geo_rows(prep.xy, prep.conic, opa_eff, aux=aux)
    feat_packed = pad_feat_rows(feat_eff, config.feat_bf16)
    r_max = config.max_tiles_per_gaussian

    def with_zero_row(t):
        # zero row: the source of padding slots (virtual index n * r_max)
        return torch.cat([t, torch.zeros((1, t.shape[1]), dtype=t.dtype,
                                         device=t.device)])

    geo_paged = gather_pairs(with_zero_row(geo_packed), binning.paged_src,
                             binning.inv_paged, r_max)
    feat_paged = gather_pairs(with_zero_row(feat_packed), binning.paged_src,
                              binning.inv_paged, r_max)
    return prep, binning, geo_paged.T.contiguous(), feat_paged.T.contiguous()


def sh_to_color(features_dc, features_rest, means3d, cam_center,
                active_sh_degree: int, max_sh_degree: int):
    """SH -> RGB with the 0-clamp of forward.cu:20-71; features_dc (N,1,3),
    features_rest (N,K-1,3); returns (N,3)."""
    del max_sh_degree
    sh = torch.cat([features_dc, features_rest], dim=1)  # (N,K,3)
    sh = sh.transpose(1, 2)  # (N,3,K)
    dirs = means3d - cam_center
    dirs = dirs / safe_norm(dirs, dim=-1, keepdim=True)
    rgb = eval_sh(active_sh_degree, sh, dirs) + 0.5
    # torch.maximum splits the gradient at a tie, as jnp.maximum does
    return torch.maximum(rgb, rgb.new_zeros(()))
