"""Stage-I and Stage-III training steps (counterpart of
hairgs_tpu/train/trainer.py): render -> loss -> backward -> densification
statistics -> Adam, for one camera or a batch of views per step.

One fused render per view. On the paged path one backward pass: the
photometric losses read `render_photo` and the mask / orientation losses
read `render`, so the compositor's backward receives the two cotangents
separately and writes the photometric-only viewspace gradients into the
aux rows. On the XLA path (`use_pallas=False`) a second, photometric-only
pull gives those gradients, as in JAX.
"""

import torch

from hairgs_tpu_torch import resolve_device, telemetry
from hairgs_tpu_torch.core.camera import camera_view
from hairgs_tpu_torch.core.schedules import expon_lr
from hairgs_tpu_torch.losses.photometric import (
    l1_loss,
    mask_loss_from_channel,
    orientation_loss_from_channels,
    psnr,
)
from hairgs_tpu_torch.losses.strand import (
    angle_smoothness_loss,
    strand_joints_magnet_loss,
)
from hairgs_tpu_torch.models.gaussian import (
    MASK,
    ORIENT,
    GaussianParams,
    GaussianStats,
    gaussian_render_inputs,
)
from hairgs_tpu_torch.models.hair import HairParams, hair_render_inputs
from hairgs_tpu_torch.ops.ssim import ssim
from hairgs_tpu_torch.optim import adam_step
from hairgs_tpu_torch.render.renderer import RasterConfig, render
from hairgs_tpu_torch.train.graphed import GraphedStep


def gaussian_lr_tree(opt_cfg, step, spatial_lr_scale):
    """Per-group learning rates (scene/gaussian_model.py:216-258)."""
    xyz_lr = expon_lr(
        step,
        opt_cfg.position_lr_init * spatial_lr_scale,
        opt_cfg.position_lr_final * spatial_lr_scale,
        lr_delay_mult=opt_cfg.position_lr_delay_mult,
        max_steps=opt_cfg.position_lr_max_steps,
    )
    return GaussianParams(
        xyz=xyz_lr,
        features_dc=opt_cfg.feature_lr,
        features_rest=opt_cfg.feature_lr / 20.0,
        scaling=opt_cfg.scaling_lr,
        rotation=opt_cfg.rotation_lr,
        opacity=opt_cfg.opacity_lr,
        mask=opt_cfg.mask_lr,
    )


def hair_lr_tree(opt_cfg, step, spatial_lr_scale):
    """Per-group learning rates of the hair model
    (hair_gaussian_model.py:221-252)."""
    pos_lr = expon_lr(
        step,
        opt_cfg.position_lr_init * spatial_lr_scale,
        opt_cfg.position_lr_final * spatial_lr_scale,
        lr_delay_mult=opt_cfg.position_lr_delay_mult,
        max_steps=opt_cfg.position_lr_max_steps,
    )
    return HairParams(
        endpoints=pos_lr,
        features_dc=opt_cfg.feature_lr,
        features_rest=opt_cfg.feature_lr / 20.0,
        opacity=opt_cfg.opacity_lr,
        mask=opt_cfg.mask_lr,
        width=opt_cfg.scaling_lr,
    )


def _update_stats(stats: GaussianStats, radii, offset_grad, active, out=None):
    """Densification statistics (scene/gaussian_model.py:675-682): max
    screen radius, accumulated viewspace-gradient norm, visit count. Takes
    one view (radii (N,)) or a batch of views (radii (B,N)). With `out` (a
    GaussianStats, `stats` itself may be given) the results are written
    into it."""
    if radii.ndim == 1:
        radii = radii[None]
        offset_grad = offset_grad[None]
    out = GaussianStats(None, None, None) if out is None else out
    with telemetry.span(telemetry.ADAM):
        vis = (radii > 0) & active[None]
        best = torch.amax(torch.where(vis, radii, torch.zeros_like(radii)), dim=0)
        max_radii2d = torch.maximum(stats.max_radii2d, best, out=out.max_radii2d)
        gnorm = torch.linalg.vector_norm(offset_grad[..., :2], dim=-1, keepdim=True)
        xyz_grad_accum = torch.add(stats.xyz_grad_accum, torch.sum(
            torch.where(vis[..., None], gnorm, torch.zeros_like(gnorm)), dim=0),
            out=out.xyz_grad_accum)
        denom = torch.add(stats.denom, torch.sum(vis[..., None], dim=0).to(
            stats.denom.dtype), out=out.denom)
    return GaussianStats(max_radii2d=max_radii2d, xyz_grad_accum=xyz_grad_accum,
                         denom=denom)


def _photometric_loss(channels, camera, opt_cfg):
    """The l1 + D-SSIM part only: what drives the densification statistics
    in the reference (train.py:173-177)."""
    image = channels[..., :3]
    l1 = l1_loss(image, camera.image)
    dssim = 1.0 - ssim(image, camera.image)
    loss = max(0.0, 1.0 - opt_cfg.lambda_dssim) * l1 + opt_cfg.lambda_dssim * dssim
    with torch.no_grad():
        train_psnr = psnr(torch.clamp(image, 0.0, 1.0), camera.image)
    return loss, {"l1": l1, "dssim": dssim, "psnr": train_psnr}


def _auxiliary_loss(channels, camera, opt_cfg):
    """Mask + orientation terms on the fused channels."""
    loss = torch.zeros((), device=channels.device)
    loss_dict = {}
    if opt_cfg.lambda_mask > 0 and camera.mask is not None:
        loss_dict["mask"] = mask_loss_from_channel(channels[..., MASK], camera.mask)
        loss = loss + opt_cfg.lambda_mask * loss_dict["mask"]
    if opt_cfg.lambda_orientation > 0 and camera.orientation is not None:
        loss_dict["orientation"] = orientation_loss_from_channels(
            channels[..., ORIENT], camera)
        loss = loss + opt_cfg.lambda_orientation * loss_dict["orientation"]
    return loss, loss_dict


def render_loss_and_grads(render_inputs_fn, params, camera, active, opt_cfg,
                          raster_cfg, width, height, render_fn=render):
    """One fused forward and its backward. Returns (loss, param_grads,
    offset_grad, aux): param_grads from the total loss, offset_grad the
    photometric-only viewspace gradient (N,2) that feeds the statistics."""
    leaves = [t.detach().requires_grad_(True) for t in params]
    p = type(params)(*leaves)
    offset0 = torch.zeros((active.shape[0], 2), dtype=torch.float32,
                          device=active.device, requires_grad=True)
    with telemetry.span(telemetry.RENDER_INPUTS):
        inputs = render_inputs_fn(p)
    out = render_fn(camera, **inputs, active=active, mean2d_offset=offset0,
                    width=width, height=height, config=raster_cfg)
    with telemetry.span(telemetry.LOSS):
        photo_loss, photo_parts = _photometric_loss(out["render_photo"], camera, opt_cfg)
        aux_loss, aux_parts = _auxiliary_loss(out["render"], camera, opt_cfg)
        loss = photo_loss + aux_loss
    photo_offset_grad = None
    with telemetry.span(telemetry.BACKWARD):
        if not raster_cfg.use_pallas:
            # XLA path: "render_photo" is "render", so the total-loss pull
            # gives total-loss offset gradients; pull the photometric loss
            # alone first for the statistics (the paged path gets them from
            # the aux rows)
            (photo_offset_grad,) = torch.autograd.grad(photo_loss, offset0,
                                                       retain_graph=True)
        grads = torch.autograd.grad(loss, leaves + [offset0], allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for g, t in zip(grads, leaves + [offset0])]
    if photo_offset_grad is not None:
        grads[-1] = photo_offset_grad
    aux = dict(
        loss_dict={k: v.detach() for k, v in {**photo_parts, **aux_parts}.items()},
        radii=out["radii"],
        overflow_pairs=out["overflow_pairs"],
        overflow_tiles=out["overflow_tiles"],
        overflow_capacity=out["overflow_capacity"],
        pairs_demand=out["pairs_demand"],
        image=out["render"][..., :3].detach(),
    )
    return loss.detach(), type(params)(*grads[:-1]), grads[-1], aux


def _per_view(fn, camera):
    """fn(camera) on a single camera, or on each view of a batched camera
    (world_view (B,4,4)) in turn, averaging losses and gradients over the
    views (trainer.py:191-211 of the JAX package). Each view runs its render
    and its backward before the next view starts, so only one view's graph
    is alive at a time. radii and the offset gradients stay per view,
    (B, N) and (B, N, 2): `_update_stats` counts them like B separate
    reference iterations. Overflow counters are summed, pairs_demand is the
    largest view's, and the image is view 0's."""
    if camera.world_view.ndim != 3:
        return fn(camera)
    views = [fn(camera_view(camera, b)) for b in range(camera.world_view.shape[0])]
    losses, grads, offset_grads, auxes = zip(*views)

    def stack(key):
        return torch.stack([a[key] for a in auxes])

    aux = dict(
        loss_dict={k: torch.stack([a["loss_dict"][k] for a in auxes]).mean()
                   for k in auxes[0]["loss_dict"]},
        radii=stack("radii"),
        overflow_pairs=stack("overflow_pairs").sum(dtype=torch.int32),
        overflow_tiles=stack("overflow_tiles").sum(dtype=torch.int32),
        overflow_capacity=stack("overflow_capacity").sum(dtype=torch.int32),
        # the pair capacity must cover the largest single view
        pairs_demand=stack("pairs_demand").amax(),
        image=auxes[0]["image"])
    mean_grads = type(grads[0])(*[torch.stack(g).mean(dim=0) for g in zip(*grads)])
    return torch.stack(losses).mean(), mean_grads, torch.stack(offset_grads), aux


COUNTERS = ("overflow_pairs", "overflow_tiles", "overflow_capacity", "pairs_demand")


def _merge_views(reducer, loss, grads, offset_grad, aux, stats, active, out=None):
    """The step's view results with the statistics folded in: (loss, grads,
    loss_dict, stats, counters), the statistics written into `out` where
    given (one process only). A `reducer` (parallel/mesh.py::MeshReducer)
    merges each rank's results over the ranks first: the viewspace
    gradients (`offsets`), then the losses, gradients, this step's
    statistics and counters (`merge`)."""
    loss_dict = dict(aux["loss_dict"])
    counters = {k: aux[k] for k in COUNTERS}
    if reducer is None:
        return (loss, grads, loss_dict,
                _update_stats(stats, aux["radii"], offset_grad, active, out=out),
                counters)
    offset_grad = reducer.offsets(offset_grad)
    delta = _update_stats(GaussianStats(*[torch.zeros_like(s) for s in stats]),
                          aux["radii"], offset_grad, active)
    loss, merged, loss_dict, delta, counters = reducer.merge(
        loss, grads, loss_dict, delta, counters)
    stats = GaussianStats(
        max_radii2d=torch.maximum(stats.max_radii2d, delta.max_radii2d),
        xyz_grad_accum=stats.xyz_grad_accum + delta.xyz_grad_accum,
        denom=stats.denom + delta.denom)
    return loss, type(grads)(*merged), loss_dict, stats, counters


def _metrics(loss, loss_dict, counters):
    train_psnr = loss_dict.pop("psnr")
    return dict(loss=loss, psnr=train_psnr,
                **{f"loss/{k}": v for k, v in loss_dict.items()}, **counters)


def make_gaussian_train_step(opt_cfg, raster_cfg: RasterConfig, *, width: int,
                             height: int, active_sh_degree: int,
                             spatial_lr_scale: float = 1.0, device="cuda",
                             render_fn=render, reducer=None):
    """Build the Stage-I train step.

    step_fn(params, stats, opt_state, active, camera, step) -> (params,
    stats, opt_state, metrics, image), the JAX step's signature. `camera`
    is one Camera or a batched one (`stack_cameras`, a leading view axis):
    a batch averages the views' losses and gradients into one Adam step.
    All tensors live on `device`. `step` is a Python int (its learning rate
    is then computed in float32 on the host, so the card never waits for a
    copy) or a 0-d tensor. `render_fn` and `reducer` make the parallel
    steps of parallel/ (a depth-slab render; the merge over ranks), which
    run eagerly. Without them the step is a `graphed.GraphedStep`: on a
    CUDA device with one camera it is replayed as a CUDA graph, and the
    params, stats and opt_state it returns are then its static buffers,
    which the next step overwrites in place.
    """
    resolve_device(device)

    def train_step(params, stats, opt_state, active, camera, lr_tree, in_place=False):
        """The step with its learning rates given; `in_place` writes the new
        params, stats and opt_state into the given ones."""
        def one_view(cam):
            return render_loss_and_grads(
                lambda p: gaussian_render_inputs(p, cam.cam_center, active_sh_degree),
                params, cam, active, opt_cfg, raster_cfg, width, height,
                render_fn=render_fn)

        loss, grads, offset_grad, aux = _per_view(one_view, camera)
        loss, grads, loss_dict, new_stats, counters = _merge_views(
            reducer, loss, grads, offset_grad, aux, stats, active,
            out=stats if in_place else None)
        with torch.no_grad(), telemetry.span(telemetry.ADAM):
            params, opt_state = adam_step(params, grads, opt_state, lr_tree,
                                          out=(params, opt_state) if in_place else None)
        return params, new_stats, opt_state, _metrics(loss, loss_dict, counters), aux["image"]

    def lr_tree_at(step):
        return gaussian_lr_tree(opt_cfg, step, spatial_lr_scale)

    def step_fn(params, stats, opt_state, active, camera, step):
        lr_tree = lr_tree_at(step)
        if not torch.is_tensor(step):
            lr_tree = lr_tree._replace(xyz=lr_tree.xyz.item())
        return train_step(params, stats, opt_state, active, camera, lr_tree)

    if reducer is not None or render_fn is not render:
        return step_fn
    return GraphedStep(step_fn, train_step, lr_tree_at)


def _endpoint_term(loss_fn, params):
    """Value and endpoint gradient of a regularizer on params.endpoints
    alone (no render path); the other leaves get no gradient from it."""
    with telemetry.span(telemetry.STRAND_TERMS):
        endpoints = params.endpoints.detach().requires_grad_(True)
        value = loss_fn(endpoints)
        (grad,) = torch.autograd.grad(value, endpoints)
    return value.detach(), grad


def make_hair_train_step(opt_cfg, raster_cfg: RasterConfig, *, width: int,
                         height: int, active_sh_degree: int,
                         spatial_lr_scale: float = 1.0,
                         dist_to_scale_factor: float, use_smooth: bool = True,
                         use_magnet: bool = False, device="cuda",
                         render_fn=render, reducer=None):
    """Build the Stage-III train step.

    step_fn(params, graph, stats, opt_state, camera, step, smooth_pairs,
    smooth_valid, magnet_idx=None) -> (params, stats, opt_state, metrics,
    image), the JAX step's signature. Beside Stage I's render and losses it
    takes the (non-differentiable) segment graph, and the consecutive-
    segment index table of the smoothness term (constant between topology
    changes, rebuilt on the host after each). With use_magnet, magnet_idx =
    (strand_endpoint_ids, complementary_ids, valid) from
    topo.strands.magnet_indices. Index tables are int64 tensors on
    `device`; `step` is a Python int or a 0-d tensor, as in Stage I. The
    strand regularizers act on the replicated endpoints, so a `reducer`
    merges the render terms first and they are added once after it.
    """
    resolve_device(device)

    def step_fn(params, graph, stats, opt_state, camera, step, smooth_pairs,
                smooth_valid, magnet_idx=None):
        def one_view(cam):
            return render_loss_and_grads(
                lambda p: hair_render_inputs(p, graph, cam.cam_center,
                                             active_sh_degree, dist_to_scale_factor),
                params, cam, graph.seg_active, opt_cfg, raster_cfg, width, height,
                render_fn=render_fn)

        loss, grads, offset_grad, aux = _per_view(one_view, camera)
        loss, grads, loss_dict, stats, counters = _merge_views(
            reducer, loss, grads, offset_grad, aux, stats, graph.seg_active)

        # the strand regularizers act on the endpoints directly
        if use_smooth and opt_cfg.lambda_smooth > 0:
            smooth, g = _endpoint_term(
                lambda e: opt_cfg.lambda_smooth * angle_smoothness_loss(
                    e, smooth_pairs, smooth_valid), params)
            loss = loss + smooth
            grads = grads._replace(endpoints=grads.endpoints + g)
            loss_dict["smooth"] = smooth / opt_cfg.lambda_smooth

        if use_magnet and opt_cfg.lambda_magnet > 0 and magnet_idx is not None:
            m_ids, m_comp, m_valid = magnet_idx
            magnet, g = _endpoint_term(
                lambda e: opt_cfg.lambda_magnet * strand_joints_magnet_loss(
                    e, m_ids, m_comp, m_valid), params)
            loss = loss + magnet
            grads = grads._replace(endpoints=grads.endpoints + g)
            loss_dict["magnet"] = magnet / opt_cfg.lambda_magnet

        lr_tree = hair_lr_tree(opt_cfg, step, spatial_lr_scale)
        if not torch.is_tensor(step):
            lr_tree = lr_tree._replace(endpoints=lr_tree.endpoints.item())
        with torch.no_grad(), telemetry.span(telemetry.ADAM):
            params, opt_state = adam_step(params, grads, opt_state, lr_tree)
        return params, stats, opt_state, _metrics(loss, loss_dict, counters), aux["image"]

    return step_fn
