"""Top-level differentiable render entry point (counterpart of
hairgs_tpu/render/renderer.py).

The renderer is channel-generic: one fused pass renders rgb + hair mask +
orientation together. `RasterConfig.use_pallas` selects the path as in the
JAX package: True takes the paged path (sorted binning, paged pair table,
`composite_pairs`), whose two passes are the hand-written CUDA kernels on
the card; False (the default) takes the XLA path (dense binning and the
log-space `composite` in stock torch operations), which runs no kernel of
this package and serves as the kernels' independent oracle.
"""

import dataclasses

import torch

from hairgs_tpu_torch import telemetry
from hairgs_tpu_torch.core.maths import safe_norm
from hairgs_tpu_torch.core.sh import eval_sh
from hairgs_tpu_torch.render.binning import (
    bin_gaussians,
    bin_gaussians_sorted,
    gather_pairs,
)
from hairgs_tpu_torch.render.composite import assemble_image, composite
from hairgs_tpu_torch.render.composite_pairs import (
    composite_pairs,
    pack_geo_rows,
    pad_feat_rows,
)
from hairgs_tpu_torch.render.preprocess import preprocess


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    """Static rasterizer configuration, with the JAX package's fields.

    `use_pallas=True` selects the paged path, whose compositor passes are
    the hand-written CUDA kernels (csrc/composite_fwd.cu,
    csrc/composite_bwd.cu) on the card and their plain versions on the CPU;
    `use_pallas=False`, the default as in JAX, selects the XLA path
    (`bin_gaussians` + `composite`), stock torch operations only. The name
    is kept so that a JAX configuration means the same here. `feat_bf16`
    gives the paged path a bf16 feature plane (the XLA path ignores it, as
    in JAX). `tiles_per_step` and `dma_lookahead` schedule the TPU kernels
    and are accepted and ignored.
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
    mean2d_offset (N,2) zeros whose gradient is the CUDA dL_dmean2D: on the
    paged path that of the photometric loss alone (the aux rows), on the
    XLA path that of whatever loss is pulled (the hook is added to the
    projected means). Returns the JAX package's dict: render (H,W,C), render_photo
    (same values, for photometric losses), final_T (H,W), radii (N,),
    visibility_filter, the overflow counters, pairs_demand and tile_counts.
    """
    ts = config.tile_size
    grid_w = (width + ts - 1) // ts
    grid_h = (height + ts - 1) // ts
    common = dict(means3d=means3d, opacity=opacity, features=features,
                  scales=scales, rotations=rotations,
                  cov3d_precomp=cov3d_precomp, active=active,
                  mean2d_offset=mean2d_offset, scale_modifier=scale_modifier,
                  width=width, height=height, config=config)
    if config.use_pallas:
        prep, binning, geo_rows, feat_rows = paged_pair_table(camera, **common)
        max_chunks = config.max_pairs_per_tile // config.chunk
        with telemetry.span(telemetry.RENDER_COMPOSITE):
            tiles, tiles_photo, trans_tiles = composite_pairs(
                geo_rows, feat_rows, binning.starts, binning.counts, grid_w, grid_h,
                ts, config.chunk, max_chunks, features.shape[-1],
                with_stats=config.viewspace_stats, alpha_min=config.alpha_min)
        counters = dict(overflow_capacity=binning.overflow_capacity,
                        pairs_demand=binning.pairs_demand,
                        tile_counts=binning.counts)
    else:
        prep, binning, tiles, trans_tiles = _xla_composite(camera, **common)
        tiles_photo = None
        k = config.max_pairs_per_tile
        # the chunk-padded slots the paged table would need (renderer.py:251-256)
        demand = torch.sum((torch.clamp(binning.tile_counts, max=k)
                            + config.chunk - 1) // config.chunk) * config.chunk
        counters = dict(
            overflow_capacity=torch.zeros((), dtype=torch.int32,
                                          device=means3d.device),
            pairs_demand=(demand + config.chunk).to(torch.int32),
            tile_counts=binning.tile_counts)
    image = assemble_image(tiles, grid_w, grid_h, ts, height, width)
    final_t = assemble_image(trans_tiles, grid_w, grid_h, ts, height, width)
    image_photo = None if tiles_photo is None else assemble_image(
        tiles_photo, grid_w, grid_h, ts, height, width)
    if bg is not None:
        image = image + final_t[..., None] * bg
        if image_photo is not None:
            image_photo = image_photo + final_t[..., None] * bg

    return {
        "render": image,
        # identical values; photometric losses read this one so the
        # dual-cotangent backward can split the viewspace statistics (the
        # same tensor as "render" on the XLA path)
        "render_photo": image if image_photo is None else image_photo,
        "final_T": final_t,
        "radii": prep.radius,
        "visibility_filter": prep.radius > 0,
        "overflow_pairs": binning.overflow_pairs,
        "overflow_tiles": binning.overflow_tiles,
        **counters,
    }


def _xla_composite(camera, *, means3d, opacity, features, scales, rotations,
                   cov3d_precomp, active, mean2d_offset, scale_modifier,
                   width, height, config):
    """The XLA path (renderer.py:198-224 of the JAX package): preprocess
    with the additive viewspace hook, dense binning, and `composite` over
    the gathered slots. Returns (prep, binning, tiles, trans_tiles)."""
    ts = config.tile_size
    grid_w = (width + ts - 1) // ts
    grid_h = (height + ts - 1) // ts
    with telemetry.span(telemetry.RENDER_PREPROCESS):
        prep = preprocess(
            means3d, scales, rotations, camera, width, height, ts, active=active,
            scale_modifier=scale_modifier, cov3d_precomp=cov3d_precomp,
            mean2d_offset=mean2d_offset, opacity=opacity,
            antialiasing=config.antialiasing, alpha_min=config.alpha_min)
        opa_eff = torch.where(prep.valid, opacity, torch.zeros_like(opacity))
        if config.antialiasing:
            opa_eff = opa_eff * prep.compensation
        q_cut = torch.log(torch.clamp(opa_eff.detach(), min=1e-12) / config.alpha_min)
    with telemetry.span(telemetry.RENDER_BINNING):
        binning = bin_gaussians(
            prep.rect, prep.depth, prep.valid, grid_w, grid_h,
            config.max_tiles_per_gaussian, config.max_pairs_per_tile,
            xy=prep.xy.detach(), conic=prep.conic.detach(), q_cut=q_cut,
            tile_size=ts)
        gid = binning.gather_idx.long()
        pv = binning.pair_valid
        # zero every invalid slot before any product: clamped gather indices
        # may alias rows whose (inactive) attributes are NaN, and 0 * NaN
        # would poison the forward and the backward
        zero = torch.zeros((), dtype=torch.float32, device=gid.device)
        xy_g = torch.where(pv[..., None], prep.xy[gid], zero)
        con_g = torch.where(pv[..., None], prep.conic[gid], zero)
        opa_g = torch.where(pv, opa_eff[gid], zero)
        feat_g = torch.where(pv[..., None], features[gid], zero)
    with telemetry.span(telemetry.RENDER_COMPOSITE):
        tiles, trans_tiles = composite(xy_g, con_g, opa_g, feat_g, grid_w, grid_h,
                                       ts, config.chunk, config.alpha_min)
    return prep, binning, tiles, trans_tiles


def paged_pair_table(camera, *, means3d, opacity, features, scales, rotations,
                     cov3d_precomp, active, mean2d_offset, scale_modifier,
                     width, height, config):
    """Everything `render` does before compositing: preprocess, sorted
    binning and the two gathered planes. Returns (prep, binning,
    geo_rows (8, P_pad), feat_rows (C_pad, P_pad)), the planes contiguous
    as the compositor kernels read them; feat_rows is bf16 with
    `config.feat_bf16`."""
    ts = config.tile_size
    grid_w = (width + ts - 1) // ts
    grid_h = (height + ts - 1) // ts
    with telemetry.span(telemetry.RENDER_PREPROCESS):
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

    with telemetry.span(telemetry.RENDER_BINNING):
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
