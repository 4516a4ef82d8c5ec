#!/usr/bin/env python
"""Stage-I / Stage-III training driver (counterpart of the root train.py).

    python3 -m hairgs_tpu_torch.drivers.train -s <scene> -m <out> [flags]

Same flag surface and `cfg_args` persistence as train.py, same schedule:
a random camera per step (popped from a shuffled stack), SH degree bump
every 1000 iterations, densify in (densify_from_iter, densify_until_iter]
every densification_interval (with the world-size prune after the first
opacity reset), opacity reset every opacity_reset_interval, the
densification-statistics rows dropped from the compositor backward once the
densify window closes, metric syncs only at the logging cadence, checkpoint
every save_frequency and eval at eval_frequency and at the end. A model
directory whose last checkpoint is a hair PLY (Stage II's output) trains
the strand graph (Stage III): the smoothness (and magnet) terms, the
merge-threshold schedule, and hair merging every merge_interval and
growing every growth_interval (at most growth_max_events times), between
steps; with `--async_topology` the densify and merge events are computed
on a worker thread while training goes on (topo/async_events.py).

The model and cameras live on `--data_device` (default "cuda"); with
`--use_pallas auto` a CUDA device takes the paged path, whose compositor
passes are the hand-written kernels, and the CPU takes the XLA path. The
three adaptive controllers resize the pair table between steps; in torch a
new size costs no recompilation. The in-training strand metrics run on the
model's device (`--device_eval`, evaluation/device_metrics.py; `auto` on a
CUDA model); the final evaluation takes the host oracle. The SIBR viewer
(`--ip`, `--port`), the 2D grid (`--vis2d`) and the pyvista strand view
(`--vis3d`) are served as in train.py.

Under torchrun (WORLD_SIZE > 1) the driver joins the process group by the
backend rule of parallel/mesh.py (nccl when each rank has a card of its
own, gloo on the CPU or when ranks share a card) and builds the mesh as
train.py does: `--gauss_shard g` cuts the Gaussian axis into g depth slabs
(parallel/slab.py) over a (data x g) mesh, data = min(world // g,
view_batch) reduced until it divides view_batch; otherwise the
`--view_batch` views spread over the largest rank count that divides the
batch (`--mesh_max_devices` caps it). A rank outside the mesh raises at
start-up. Every rank pops the same cameras from the seeded stream and
takes its slice, every rank runs the topology events on identical state,
and rank 0 alone writes the PLY, cfg_args, logs and evaluations and serves
the viewer while the others wait at a barrier:

    torchrun --nproc_per_node N -m hairgs_tpu_torch.drivers.train -s <scene> \
        -m <out> --view_batch K [--gauss_shard G]
"""

import os
import random
import sys
import time
import uuid
from argparse import ArgumentParser

import numpy as np
import torch
import torch.distributed as dist

from hairgs_tpu_torch.config import (
    GeneralConfig,
    ModelConfig,
    OptimizationConfig,
    RuntimeConfig,
    add_config_args,
    extract_config,
    load_cfg_args,
    save_cfg_args,
)


class TileBudgetController:
    """Adaptive per-gaussian tile budget (train.py:36-68).

    The fixed-shape pair table caps tiles-per-gaussian. This controller
    grows the cap (x2 up to `cap`) when a sync observes >`grow_frac` of the
    pair budget truncated, and shrinks it back toward the configured base
    after `shrink_after` consecutive overflow-free syncs.
    """

    def __init__(self, base, cap=64, grow_frac=0.01, shrink_after=20):
        self.base = base
        self.cap = cap
        self.grow_frac = grow_frac
        self.shrink_after = shrink_after
        self.clean_syncs = 0

    def update(self, overflow_pairs, n_prims, budget):
        """Returns the new budget, or None when no change is needed."""
        if overflow_pairs > self.grow_frac * n_prims * budget and budget < self.cap:
            self.clean_syncs = 0
            return min(budget * 2, self.cap)
        if overflow_pairs == 0:
            self.clean_syncs += 1
            if self.clean_syncs >= self.shrink_after and budget > self.base:
                self.clean_syncs = 0
                return budget // 2
        else:
            self.clean_syncs = 0
        return None


class PairCapacityController:
    """Adaptive compact pair-table sizing (RasterConfig.pair_capacity;
    train.py:71-108): grow immediately on any capacity truncation
    (truncated pairs get no gradient), shrink only after `shrink_after`
    consecutive syncs of <50% occupancy."""

    def __init__(self, granule, headroom=1.25, shrink_after=50):
        self.granule = granule
        self.headroom = headroom
        self.shrink_after = shrink_after
        self.low_syncs = 0

    def bucket(self, demand):
        want = int(demand * self.headroom)
        return ((want + self.granule - 1) // self.granule) * self.granule

    def update(self, overflow_capacity, pairs_demand, capacity):
        """Returns the new capacity, or None when no change is needed."""
        if overflow_capacity > 0:
            self.low_syncs = 0
            return max(self.bucket(pairs_demand), capacity + self.granule)
        if pairs_demand < 0.5 * capacity:
            self.low_syncs += 1
            if self.low_syncs >= self.shrink_after:
                self.low_syncs = 0
                new = self.bucket(pairs_demand)
                if new < capacity - self.granule:
                    return new
        else:
            self.low_syncs = 0
        return None


class TilePairCapController:
    """Adaptive per-tile pair cap (RasterConfig.max_pairs_per_tile;
    train.py:111-145): x2 (a multiple of the chunk stays one) whenever a
    sync drops more than `grow_frac` of the step's real pair demand, back
    toward the base after `shrink_after` consecutive clean syncs."""

    def __init__(self, base, cap=8192, grow_frac=0.001, shrink_after=50):
        self.base = base
        self.cap = cap
        self.grow_frac = grow_frac
        self.shrink_after = shrink_after
        self.clean_syncs = 0

    def update(self, overflow_tiles, pairs_demand, max_pairs):
        """Returns the new per-tile cap, or None when no change is needed."""
        if (overflow_tiles > self.grow_frac * max(pairs_demand, 1)
                and max_pairs < self.cap):
            self.clean_syncs = 0
            return min(max_pairs * 2, self.cap)
        if overflow_tiles == 0:
            self.clean_syncs += 1
            if self.clean_syncs >= self.shrink_after and max_pairs > self.base:
                self.clean_syncs = 0
                return max_pairs // 2
        else:
            self.clean_syncs = 0
        return None


def prepare_output_path(args):
    """utils/system.py:41-54 — default ./output/<uuid>, persist cfg_args.
    Under torchrun only rank 0 writes, and the output path must be given:
    each rank would draw its own uuid."""
    rank = int(os.environ.get("RANK", "0"))
    if not args.model_path:
        if int(os.environ.get("WORLD_SIZE", "1")) > 1:
            raise ValueError("pass -m <model_path> under torchrun")
        args.model_path = os.path.join("./output/", str(uuid.uuid4())[:10])
    print(f"Output folder: {args.model_path}")
    os.makedirs(args.model_path, exist_ok=True)
    if rank == 0:
        save_cfg_args(args.model_path, args)


def use_device_eval(device_eval: str, device: torch.device) -> bool:
    """Whether the non-final evaluations run on the model's device:
    "true" always, "auto" when the model lives on a CUDA device (as JAX's
    auto does on its accelerator), otherwise the host oracle."""
    return device_eval == "true" or (device_eval == "auto" and device.type == "cuda")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _pull_metrics(metrics) -> dict:
    """The step's scalar metrics on the host, in one transfer."""
    keys = list(metrics)
    vals = torch.stack([metrics[k].detach().reshape(()).to(torch.float64)
                        for k in keys]).tolist()
    return dict(zip(keys, vals))


def training(mp, op, gp, rt, args, logger=None):
    """The Stage-I loop; returns (scene, model). `logger` (a
    logging_utils.Logger) replaces the one `--logger` selects."""
    from hairgs_tpu_torch import resolve_device
    from hairgs_tpu_torch.core.camera import stack_cameras
    from hairgs_tpu_torch.core.schedules import expon_lr
    from hairgs_tpu_torch.evaluation.eval_data import (
        compute_eval_data_from_gaussian,
        compute_eval_data_from_hair,
    )
    from hairgs_tpu_torch.evaluation.image_metrics import evaluate_image_metrics
    from hairgs_tpu_torch.evaluation.metrics import compute_metrics
    from hairgs_tpu_torch.logging_utils import Logger, TrainingInfo, get_logger
    from hairgs_tpu_torch.models.hair import HairModel
    from hairgs_tpu_torch.parallel.mesh import (
        MeshReducer,
        init_distributed,
        make_view_mesh,
        replicate,
        shard_view_batch,
    )
    from hairgs_tpu_torch.parallel.slab import make_2d_mesh, make_slab_train_step
    from hairgs_tpu_torch.render.renderer import RasterConfig
    from hairgs_tpu_torch.scene import Scene
    from hairgs_tpu_torch.topo.graph_ops import (
        hair_densification,
        hair_growing,
        hair_merging,
        hair_reset_opacity,
    )
    from hairgs_tpu_torch.topo.strands import magnet_indices, smooth_pair_indices
    from hairgs_tpu_torch.train.trainer import (
        make_gaussian_train_step,
        make_hair_train_step,
    )

    device = resolve_device(mp.data_device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:
        if rt.async_topology:
            raise ValueError("--async_topology installs an event when its thread "
                             "finishes, which differs between ranks: run it in "
                             "one process")
        if not dist.is_initialized():
            init_distributed(mp.data_device)
    rank = dist.get_rank() if world > 1 else 0
    writer = rank == 0  # the rank that writes files and logs
    scene = Scene(args, shuffle=True, capacity_round=rt.capacity_round)
    model = scene.gaussians
    model.training_setup(op)
    is_hair = isinstance(model, HairModel)
    if logger is None:
        logger = get_logger(args) if writer else Logger()
    info = TrainingInfo(iter=scene.loaded_iter)

    cameras = scene.get_cameras()
    height, width = cameras[0].height, cameras[0].width
    use_pallas = rt.use_pallas
    if use_pallas == "auto":
        use_pallas = device.type == "cuda"
    pallas_on = bool(use_pallas) and use_pallas != "false"
    if pallas_on and rt.max_pairs_per_tile % rt.composite_chunk:
        # fail at startup, not after the scene load
        raise ValueError(f"max_pairs_per_tile ({rt.max_pairs_per_tile}) must "
                         f"be a multiple of composite_chunk ({rt.composite_chunk})")

    num_tiles = (((width + 15) // 16) * ((height + 15) // 16))
    cap_ctl = PairCapacityController(rt.pair_capacity_round)
    # the densification-statistics rows of the compositor backward are only
    # read by densification events: they are dropped once the densify
    # window is closed
    stats_enabled = op.densify_until_iter > 1

    def initial_pair_capacity():
        if rt.pair_capacity < 0:
            return 0  # worst-case n*max_tiles sizing, never truncates
        if rt.pair_capacity > 0:
            return rt.pair_capacity
        # adaptive start: ~3 surviving tiles/prim + the per-tile chunk pad
        # floor; the controller re-buckets from measured demand after the
        # first sync
        est = 3 * model.capacity + (num_tiles + 1) * rt.composite_chunk
        return cap_ctl.bucket(est / cap_ctl.headroom)

    def make_raster_cfg(max_tiles, pair_cap=None, max_pairs=None):
        max_pairs = rt.max_pairs_per_tile if max_pairs is None else max_pairs
        return RasterConfig(
            max_tiles_per_gaussian=max_tiles,
            max_pairs_per_tile=max_pairs,
            chunk=rt.composite_chunk,
            use_pallas=pallas_on,
            feat_bf16=rt.feat_bf16,
            antialiasing=rt.antialiasing,
            alpha_min=rt.alpha_min,
            viewspace_stats=stats_enabled,
            dma_lookahead=rt.dma_lookahead and pallas_on,
            # compact tables only exist on the paged path; the XLA path
            # ignores them
            pair_capacity=((initial_pair_capacity() if pallas_on else 0)
                           if pair_cap is None else pair_cap),
        )

    raster_cfg = make_raster_cfg(rt.max_tiles_per_gaussian)

    # interactive 3D strand view (reference train.py:61-62; pyvista-gated)
    vis3d_plotter = vis3d_polydata = None
    if gp.vis3d and is_hair and writer:
        try:
            from hairgs_tpu_torch.visualization import create_pv_background_plotter

            vis3d_plotter, vis3d_polydata = create_pv_background_plotter(
                model, cameras, background=True)
        except ImportError as e:
            print(f"[vis3d] disabled ({e})")

    # the in-training evaluations on the device (evaluation/device_metrics.py);
    # the final one keeps the host oracle, whose strand consistency needs
    # sparse per-strand vote counts
    device_eval = use_device_eval(rt.device_eval, device)
    gt_device = None

    def run_eval_device():
        nonlocal gt_device
        from hairgs_tpu_torch.evaluation.device_metrics import compute_metrics_device
        from hairgs_tpu_torch.evaluation.eval_data import (
            eval_points_device_from_gaussian,
            eval_points_device_from_hair,
        )

        if gt_device is None:
            gt_device = tuple(torch.tensor(np.asarray(a, np.float32), device=device)
                              for a in (scene.gt.points, scene.gt.directions))
        pts, dirs, valid = (eval_points_device_from_hair(model) if is_hair
                            else eval_points_device_from_gaussian(model))
        return compute_metrics_device(pts, dirs, *gt_device, pred_valid=valid,
                                      bidirectional=op.bidirectional_eval)

    def run_eval(final: bool = False):
        if scene.gt is None or not writer:
            return None, None
        info.eval_on_device = device_eval and not final
        if info.eval_on_device:
            return run_eval_device()
        pred = (compute_eval_data_from_hair(model) if is_hair
                else compute_eval_data_from_gaussian(model))
        info.pred = pred
        return compute_metrics(pred=pred, gt=scene.gt, bidirectional=op.bidirectional_eval)

    def run_image_eval():
        if not writer:
            return
        info.image_metrics = evaluate_image_metrics(model, cameras, config=raster_cfg)
        if info.image_metrics and not gp.quiet:
            parts = "  ".join(f"{k} {v:.3f}" for k, v in info.image_metrics.items())
            print(f"[eval] iter {info.iter}: {parts}")

    info.eval_metrics, info.eval_thresholds = run_eval()
    logger.log(info, model)

    # view batches: a K-view step advances the iteration counter by K, so
    # every cadence and the number of views seen match K reference
    # iterations; gradients are the view mean, statistics count per view.
    # Under torchrun the views spread over the ranks of a mesh
    # (train.py:327-367)
    view_batch = max(1, rt.view_batch)
    gauss_shard = max(1, rt.gauss_shard)
    mesh = None
    if gauss_shard > 1:
        if world < gauss_shard:
            raise ValueError(f"--gauss_shard {gauss_shard} needs that many ranks "
                             f"(torchrun --nproc_per_node), have {world}")
        data_size = max(1, min(world // gauss_shard, view_batch))
        while view_batch % data_size:
            data_size -= 1
        mesh = make_2d_mesh(data_size, gauss_shard, device=mp.data_device)
        capacity = (model.graph.endpoint_pairs.shape[0] if is_hair
                    else model.capacity)
        if capacity % gauss_shard:
            raise ValueError(f"arena capacity {capacity} must be a multiple of "
                             f"--gauss_shard {gauss_shard} (use a capacity_round "
                             f"that is)")
        print(f"[parallel] gauss_shard={gauss_shard} x data={data_size} "
              f"({mesh.size} device(s))")
    elif world > 1:
        mesh = make_view_mesh(view_batch, rt.mesh_max_devices, device=mp.data_device)
    if view_batch > 1 and gauss_shard == 1:
        print(f"[parallel] view_batch={view_batch} over "
              f"{mesh.size if mesh is not None else 1} device(s)")
    if world > 1 and (mesh is None or mesh.coords is None):
        raise RuntimeError(
            f"rank {rank} of {world} lies outside the mesh "
            f"({mesh.size if mesh is not None else 1} rank(s) for --view_batch "
            f"{view_batch}, --gauss_shard {gauss_shard}, --mesh_max_devices "
            f"{rt.mesh_max_devices}): launch that many processes")
    if mesh is not None:
        # one model, replicated: every rank starts from rank 0's state
        replicate((model.params, model.stats, model.opt_state), mesh)
        # every rank must sync (and so run the controllers) on the same steps
        flag = torch.tensor([float(type(logger) is not Logger)], device=device)
        logging_from_writer = bool(mesh.broadcast(flag).item())

    def check_replicas(iteration):
        """The ranks' parameters stay bit-equal only if every all-reduced
        value is identical on every rank: checked, never assumed, after
        each topology event and at the end, by an exact checksum (the
        float bits summed as integers) gathered from every rank."""
        if mesh is None:
            return
        bits = torch.stack([p.detach().contiguous().view(torch.int32)
                            .to(torch.int64).sum() for p in model.params]).sum()
        sums = mesh.all_gather(bits.reshape(1), "mesh").reshape(-1).tolist()
        if len(set(sums)) != 1:
            raise RuntimeError(f"the ranks' parameters diverged at iteration "
                               f"{iteration}: checksums {sums}")
        if not gp.quiet:
            print(f"[parallel] iter {iteration}: parameters bit-equal on "
                  f"{len(sums)} ranks (checksum {sums[0]})")

    def build_step():
        common = dict(width=width, height=height,
                      active_sh_degree=model.active_sh_degree,
                      spatial_lr_scale=model.spatial_lr_scale)
        if gauss_shard > 1:
            return make_slab_train_step(
                "hair" if is_hair else "gaussian", op, raster_cfg,
                dist_to_scale_factor=model.dist_to_scale_factor if is_hair else None,
                mesh=mesh, **common)
        # the view-parallel step (JAX's make_sharded_*_step): the trainer's
        # step merging each rank's views over the mesh
        reducer = MeshReducer(mesh) if mesh is not None else None
        if is_hair:
            return make_hair_train_step(
                op, raster_cfg, dist_to_scale_factor=model.dist_to_scale_factor,
                use_magnet=op.lambda_magnet > 0, device=device, reducer=reducer,
                **common)
        return make_gaussian_train_step(op, raster_cfg, device=device,
                                        reducer=reducer, **common)

    step_fn = build_step()

    # the strand regularizers' index tables, on the device and rebuilt
    # after every topology change (their padding changes no loss value)
    def strand_tables():
        if not is_hair:
            return None, None, None

        def dev(*arrays):
            # int64: torch indexes with it
            return tuple(torch.tensor(a.astype(np.int64) if a.dtype != np.bool_
                                      else a, device=device) for a in arrays)

        pairs, valid = dev(*smooth_pair_indices(model.strands_info))
        magnet = dev(*magnet_indices(model)) if op.lambda_magnet > 0 else None
        return pairs, valid, magnet

    smooth_pairs, smooth_valid, magnet_idx = strand_tables()

    topo_worker = None
    if is_hair and rt.async_topology:
        from hairgs_tpu_torch.topo.async_events import TopologyWorker

        topo_worker = TopologyWorker(model)
    elif rt.async_topology and not gp.quiet:
        print("[topo] --async_topology applies to hair models only; ignored")

    # live viewer (SIBR protocol; train.py:95-131)
    gui = None
    if gp.ip and writer:
        from hairgs_tpu_torch.network_gui import NetworkGUI

        gui = NetworkGUI()
        try:
            gui.init(gp.ip, gp.port)
        except OSError as e:
            print(f"[gui] disabled ({e})")
            gui = None

    def serve_gui(iteration):
        if gui is None:
            return
        if gui.conn is None:
            gui.try_connect()
        while gui.conn is not None:
            try:
                cam, do_training, _, _, keep_alive, scaling_mod = gui.receive()
                img_bytes = None
                if cam is not None:
                    from hairgs_tpu_torch.models.gaussian import gaussian_render_inputs
                    from hairgs_tpu_torch.models.hair import hair_render_inputs
                    from hairgs_tpu_torch.render.renderer import render

                    c = cam.to_camera(device)
                    with torch.no_grad():
                        if is_hair:
                            inputs = hair_render_inputs(
                                model.params, model.graph, c.cam_center,
                                model.active_sh_degree, model.dist_to_scale_factor)
                            active = model.graph.seg_active
                        else:
                            inputs = gaussian_render_inputs(
                                model.params, c.cam_center, model.active_sh_degree)
                            active = model.active
                        out = render(c, **inputs, active=active,
                                     scale_modifier=scaling_mod or 1.0,
                                     width=cam.width, height=cam.height,
                                     config=raster_cfg)
                        rgb = np.clip(out["render"][..., :3].cpu().numpy(), 0, 1)
                    img_bytes = memoryview((rgb * 255).astype(np.uint8))
                gui.send(img_bytes, args.source_path)
                if do_training and (iteration < op.iterations or not keep_alive):
                    break
            except Exception as e:
                # a viewer that disconnects or misbehaves must not stop the
                # training: drop the connection and listen again
                print(f"[gui] viewer connection dropped ({e!r})")
                gui.conn.close()
                gui.conn = None

    profile_dir = os.path.join(args.model_path, "profile")
    profiler = None

    def stop_profiler():
        os.makedirs(profile_dir, exist_ok=True)
        profiler.stop()
        profiler.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
        print(f"[profile] trace written to {profile_dir}")

    def check_finite(loss, iteration):
        if rt.debug and not np.isfinite(loss):
            dump = os.path.join(args.model_path, f"snapshot_iter{iteration}.npz")
            if writer:
                model.save_checkpoint(dump)
            raise FloatingPointError(
                f"non-finite loss {loss} at iteration {iteration}; state dumped"
                f" to {dump}"
            )

    viewpoint_stack = []
    ema_loss = 0.0
    logging_active = (type(logger) is not Logger if mesh is None
                      else logging_from_writer)
    report_interval = 50
    rt.log_interval = max(1, rt.log_interval)
    budget_ctl = TileBudgetController(rt.max_tiles_per_gaussian)
    tilecap_ctl = TilePairCapController(rt.max_pairs_per_tile)
    start_time = time.time()
    iteration = 0
    prev_iter = 0
    step_count = 0
    growth_events_done = 0

    def grow_allowed():
        # growth_max_events caps the growth events (0 keeps the
        # reference's uncapped cadence)
        return (op.growth_max_events <= 0
                or growth_events_done < op.growth_max_events)

    def crossed(interval):
        """Did this step cross an interval boundary? For view_batch=1 this is
        exactly `iteration % interval == 0`; for K>1 each boundary fires once."""
        return iteration // interval > prev_iter // interval

    while iteration < op.iterations:
        prev_iter = iteration
        iteration += view_batch
        step_count += 1
        if rt.profile_steps > 0 and writer:
            if step_count == 2:  # skip the first step
                profiler = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    *([torch.profiler.ProfilerActivity.CUDA]
                      if device.type == "cuda" else [])])
                profiler.start()
            elif profiler is not None and step_count == 2 + rt.profile_steps:
                stop_profiler()
                profiler = None
        serve_gui(iteration)
        info.iter = scene.loaded_iter + iteration
        info.densification_info = {}
        info.topology_ms = None

        # thresholds scheduled like LRs (hair_gaussian_model.py:285-293)
        if is_hair:
            model.merge_dist_th = float(expon_lr(
                iteration, op.merge_dist_th_init, op.merge_dist_th_final,
                lr_delay_mult=op.position_lr_delay_mult,
                max_steps=op.position_lr_max_steps))
            model.merge_angle_th = float(expon_lr(
                iteration, op.merge_angle_th_init, op.merge_angle_th_final,
                lr_delay_mult=op.position_lr_delay_mult,
                max_steps=op.position_lr_max_steps))

        if crossed(1000) and model.active_sh_degree < model.max_sh_degree:
            model.oneup_sh_degree()
            step_fn = build_step()

        # drop the densification-statistics rows from the compositor
        # backward once the densify window closes
        if (stats_enabled and raster_cfg.use_pallas
                and iteration >= op.densify_until_iter):
            stats_enabled = False
            raster_cfg = make_raster_cfg(raster_cfg.max_tiles_per_gaussian,
                                         raster_cfg.pair_capacity,
                                         raster_cfg.max_pairs_per_tile)
            step_fn = build_step()
            if not gp.quiet:
                print(f"[raster] iter {iteration}: densify window closed — "
                      "dropping viewspace-stats rows from the backward")

        cams_step = []
        for _ in range(view_batch):
            if not viewpoint_stack:
                viewpoint_stack = list(cameras)
            cams_step.append(
                viewpoint_stack.pop(random.randint(0, len(viewpoint_stack) - 1))
            )
        cam = cams_step[0]
        cam_input = stack_cameras(cams_step) if view_batch > 1 else cam
        if mesh is not None and view_batch > 1:
            cam_input = shard_view_batch(cam_input, mesh)

        t0 = time.time()
        if is_hair:
            model.params, model.stats, model.opt_state, metrics, image = step_fn(
                model.params, model.graph, model.stats, model.opt_state,
                cam_input, iteration, smooth_pairs, smooth_valid,
                magnet_idx=magnet_idx)
        else:
            model.params, model.stats, model.opt_state, metrics, image = step_fn(
                model.params, model.stats, model.opt_state, model.active,
                cam_input, iteration)
        info.elapsed_time = (time.time() - t0) * 1000.0

        # a host read waits for the device: only at the logging cadence
        sync_now = (
            (logging_active and crossed(rt.log_interval))
            or crossed(report_interval)
            or iteration >= op.iterations
        )
        if sync_now:
            m = _pull_metrics(metrics)
            loss = m["loss"]
            check_finite(loss, iteration)
            info.loss = loss
            info.loss_dict = {k[5:]: v for k, v in m.items() if k.startswith("loss/")}
            info.train_psnr = m["psnr"]
            ema_loss = 0.4 * loss + 0.6 * ema_loss

            n_prims = model.num_segments if is_hair else model.count
            overflow_pairs = int(m["overflow_pairs"])
            # overflow counters are summed over the K views of a step;
            # scale the per-view budget test accordingly
            new_budget = None if rt.freeze_tile_budget else budget_ctl.update(
                overflow_pairs, n_prims * view_batch,
                raster_cfg.max_tiles_per_gaussian
            )
            if new_budget is not None:
                verb = ("raising" if new_budget > raster_cfg.max_tiles_per_gaussian
                        else "shrinking")
                print(f"[raster] iter {iteration}: {overflow_pairs} truncated "
                      f"pairs — {verb} max_tiles_per_gaussian to {new_budget}")
                raster_cfg = make_raster_cfg(new_budget,
                                             raster_cfg.pair_capacity,
                                             raster_cfg.max_pairs_per_tile)
                step_fn = build_step()
                # persist the converged budget for a resumed run
                args.max_tiles_per_gaussian = new_budget
                if writer:
                    save_cfg_args(args.model_path, args)
            # compact pair-table capacity: grow immediately on truncation,
            # shrink on sustained low occupancy
            overflow_cap = int(m.get("overflow_capacity", 0))
            demand = int(m.get("pairs_demand", 0))
            if (rt.pair_capacity == 0 and raster_cfg.pair_capacity > 0
                    and raster_cfg.use_pallas):
                new_cap = cap_ctl.update(overflow_cap, demand,
                                         raster_cfg.pair_capacity)
                if new_cap is not None:
                    verb = "raising" if new_cap > raster_cfg.pair_capacity \
                        else "shrinking"
                    print(f"[raster] iter {iteration}: pair demand {demand} "
                          f"(capacity-truncated {overflow_cap}) — {verb} "
                          f"pair_capacity to {new_cap}")
                    raster_cfg = make_raster_cfg(
                        raster_cfg.max_tiles_per_gaussian, new_cap,
                        raster_cfg.max_pairs_per_tile)
                    step_fn = build_step()
            overflow_tiles = int(m["overflow_tiles"])
            # per-tile pair cap: grow on sustained tile-cap drops, shrink
            # back after a long clean streak
            new_mp = None if rt.freeze_tile_budget else tilecap_ctl.update(
                overflow_tiles, demand, raster_cfg.max_pairs_per_tile)
            if new_mp is not None:
                verb = ("raising" if new_mp > raster_cfg.max_pairs_per_tile
                        else "shrinking")
                print(f"[raster] iter {iteration}: {overflow_tiles} tile-cap "
                      f"dropped pairs — {verb} max_pairs_per_tile to {new_mp}")
                raster_cfg = make_raster_cfg(
                    raster_cfg.max_tiles_per_gaussian,
                    raster_cfg.pair_capacity, new_mp)
                step_fn = build_step()
                args.max_pairs_per_tile = new_mp
                if writer:
                    save_cfg_args(args.model_path, args)
            overflow = overflow_tiles + overflow_pairs + overflow_cap
            if overflow and not gp.quiet:
                print(f"[warn] iter {iteration}: {overflow} binning overflows "
                      f"({overflow_pairs} pair-budget, {overflow_tiles} "
                      f"tile-cap, {overflow_cap} capacity)")
            if not gp.quiet and crossed(100):
                print(f"iter {iteration:6d}  loss {ema_loss:.5f}  "
                      f"psnr {info.train_psnr:.2f}  "
                      f"prims {n_prims}  {info.elapsed_time:.1f} ms")
        else:
            # don't re-log stale scalars on non-sync iterations
            info.loss = None
            info.loss_dict = None
            info.train_psnr = None

        # --- topology cadence (train.py:171-200, 725-783): densify, reset,
        # then for a hair model merge and grow
        in_window = iteration < op.densify_until_iter
        due_densify = (in_window and iteration > op.densify_from_iter
                       and crossed(op.densification_interval))
        due_reset = in_window and crossed(op.opacity_reset_interval)
        due_merge = is_hair and crossed(op.merge_interval)
        due_grow = is_hair and crossed(op.growth_interval) and grow_allowed()
        size_th = (op.prune_max_radii_2d if iteration > op.opacity_reset_interval
                   else None)
        if topo_worker is not None:
            # densify and merge are computed on the worker from a snapshot
            # and installed by poll() between later steps. The opacity reset
            # and growth change surviving rows on the host, so they stay
            # synchronous and settle a flight first; so do a new launch and
            # the final iteration, whose launch is settled at once so the
            # final evaluation and checkpoint see it, as in a synchronous run
            t_topo = time.perf_counter()
            final = iteration >= op.iterations
            topo_changed = topo_worker.poll(
                force=due_reset or due_grow or due_densify or due_merge or final,
                training_info=info)
            if due_reset:
                hair_reset_opacity(model)
            if due_grow:
                hair_growing(model, info, growth_length=op.growth_length)
                growth_events_done += 1
                topo_changed = True
            if due_densify or due_merge:
                topo_worker.launch(densify=due_densify, merge=due_merge,
                                   extent=scene.cameras_extent, size_th=size_th)
                if final:
                    topo_worker.poll(force=True, training_info=info)
                    topo_changed = True
        else:
            # synchronous between steps; a densify and a merge in the same
            # iteration share one host mirror
            topo_changed = due_densify or due_merge or due_grow
            arrays_cache = None
            if topo_changed:
                # time the event alone: the queued steps finish first
                _sync(device)
                t_topo = time.perf_counter()
            if due_densify:
                if is_hair:
                    _, arrays_cache = hair_densification(
                        model, scene.cameras_extent, size_th, info,
                        return_arrays=True)
                else:
                    model.densification(scene.cameras_extent, size_th, info)
            if due_reset:
                if is_hair:
                    hair_reset_opacity(model)
                    arrays_cache = None  # the opacity plane changed on the device
                else:
                    model.reset_opacity()
            if due_merge:
                hair_merging(model, info, arrays=arrays_cache)
            if due_grow:
                hair_growing(model, info, growth_length=op.growth_length)
                growth_events_done += 1
        if due_reset and not gp.quiet:
            print(f"[densify] iter {iteration}: opacity reset")
        if topo_changed:
            if is_hair:
                smooth_pairs, smooth_valid, magnet_idx = strand_tables()
            _sync(device)
            info.topology_ms = (time.perf_counter() - t_topo) * 1e3
            check_replicas(iteration)
            if not gp.quiet:
                size = (f"{model.num_segments} segments, "
                        f"{len(model.strands_info.list_strands)} strands"
                        if is_hair else f"{model.count} Gaussians")
                print(f"[densify] iter {iteration}: {info.densification_info}"
                      f" -> {size} in {info.topology_ms:.1f} ms")

        # --- 2D visualization grid (train.py:785-812; logged, shown with
        # --vis2d where cv2 and a display are present) and the live 3D view
        if crossed(gp.update_vis2d_frequency):
            from hairgs_tpu_torch.visualization import create_subplots_from_dict

            def u8(t):
                return (np.clip(t.cpu().numpy(), 0, 1) * 255).astype(np.uint8)

            info.composed_image = create_subplots_from_dict(
                {"render": u8(image), "gt": u8(cam.image)}, 1280, 480)
            if gp.vis2d:
                try:
                    import cv2

                    cv2.imshow("Image Grid",
                               cv2.cvtColor(info.composed_image, cv2.COLOR_RGB2BGR))
                    cv2.waitKey(1)
                except Exception as e:  # no cv2, or no display
                    print(f"[vis2d] disabled ({e})")
                    gp.vis2d = False
            if vis3d_plotter is not None:
                from hairgs_tpu_torch.visualization import update_polydata_from_hair

                update_polydata_from_hair(vis3d_polydata, model)
                vis3d_plotter.render()
                if hasattr(vis3d_plotter, "app"):
                    vis3d_plotter.app.processEvents()
        else:
            info.composed_image = None

        # --- eval / log / save
        if crossed(gp.eval_frequency) or iteration >= op.iterations:
            if scene.gt is not None:
                info.eval_metrics, info.eval_thresholds = run_eval(
                    final=iteration >= op.iterations)
                if info.eval_metrics is not None and not gp.quiet:
                    size = (f"{model.num_segments} segments, "
                            f"{len(model.strands_info.list_strands)} strands"
                            if is_hair else f"{model.count} Gaussians")
                    where = "device" if info.eval_on_device else "host"
                    parts = "  ".join(f"{k} {float(v[-1]):.4f}"
                                      for k, v in info.eval_metrics.items())
                    print(f"[eval] iter {info.iter}: {size}; strands at "
                          f"{info.eval_thresholds[-1]} ({where}): {parts}")
            run_image_eval()
        else:
            info.image_metrics = None
        logger.log(info, model)
        if crossed(gp.save_frequency) or iteration >= op.iterations:
            if writer:
                path = scene.save(iteration)
                print(f"\n[ITER {iteration}] Saved scene to {path}")
            if mesh is not None:
                mesh.barrier()

    check_replicas(iteration)
    if device.type == "cuda":
        from hairgs_tpu_torch.render.composite_pairs import launches

        print(f"[kernels] rank {rank} launches {launches}")
        print(f"[memory] rank {rank} peak {torch.cuda.max_memory_allocated(device) / 2**30:.3f} "
              f"GiB (torch.cuda.max_memory_allocated)")
    if profiler is not None:
        stop_profiler()
    if vis3d_plotter is not None:  # reference train.py:263-265
        vis3d_plotter.close()
    if gui is not None:
        gui.close()
    total = time.time() - start_time
    print(f"Training completed in {total:.1f}s "
          f"({iteration / max(total, 1e-9):.2f} it/s, "
          f"{step_count / max(total, 1e-9):.2f} steps/s)")
    logger.close()
    return scene, model


def main(argv=None):
    parser = ArgumentParser(description="Training script parameters")
    add_config_args(parser, ModelConfig)
    add_config_args(parser, OptimizationConfig)
    add_config_args(parser, GeneralConfig)
    add_config_args(parser, RuntimeConfig)
    argv = sys.argv[1:] if argv is None else argv
    args = parser.parse_args(argv)
    # resume: adopt a previously persisted (converged) tile budget unless the
    # flag was given explicitly on this command line
    stored = load_cfg_args(args.model_path) if args.model_path else None
    if (stored is not None
            and hasattr(stored, "max_tiles_per_gaussian")
            and not any(a.startswith("--max_tiles_per_gaussian") for a in argv)):
        args.max_tiles_per_gaussian = stored.max_tiles_per_gaussian
    prepare_output_path(args)
    from hairgs_tpu_torch.system import safe_state

    safe_state(getattr(args, "quiet", False))
    try:
        return training(
            extract_config(args, ModelConfig),
            extract_config(args, OptimizationConfig),
            extract_config(args, GeneralConfig),
            extract_config(args, RuntimeConfig),
            args,
        )
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
