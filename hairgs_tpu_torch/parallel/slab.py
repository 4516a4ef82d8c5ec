"""Depth-slab sharding of the Gaussian axis (counterpart of
hairgs_tpu/parallel/slab.py).

Per camera the N Gaussian rows are sorted by view-space depth and cut into
k contiguous slabs, front to back. Every row of slab i lies in front of
every row of slab i+1, so each slab is composited alone by the ordinary
renderer (both compositor kernels on the card, with the slab's own pair
table) into a partial (colour, T) segment, and the segments fold front to
back: (c1, T1) o (c2, T2) = (c1 + T1 c2, T1 T2).

Order at depth ties: the unsharded renderer sorts each tile on [tile |
quantized depth] and breaks ties by row index; the rows of a slab are
already in exact depth order, so a slab render equals `render(x[perm])`
(the depth-permuted rows in one table), not `render(x)`, wherever two rows
of a tile share a quantized depth.

A slab starts from T = 1, so its stop test (T (1 - alpha) below 1e-4) and
the chunk boundaries of its table see other values than one table would.
The two can disagree only where one table's T has fallen below
1e-4 / (1 - 0.99) = 0.01, and there by at most that T times the largest
feature (tests/test_torch_port_slab.py::test_slab_boundary_latch_bound).

Densification statistics: the compositor's photometric rows start their
carry at 0, since one table's photometric loss never reads final_T; a
front slab's T scales the colours of the slabs behind it, so the slab
path's viewspace gradients leave that part out and differ from one
table's. JAX's slab path does the same (ROADMAP Queue 3).

Capacities (max_pairs_per_tile, pair_capacity) apply to each slab.
"""

import os
from typing import Optional

import numpy as np
import torch

from hairgs_tpu_torch.parallel.mesh import (
    Mesh,
    MeshReducer,
    _world,
    build_mesh,
    make_mesh,
)
from hairgs_tpu_torch.render.binning import permute_rows
from hairgs_tpu_torch.render.renderer import RasterConfig, render

COUNTERS = ("overflow_pairs", "overflow_tiles", "overflow_capacity")


def _depth_slab_permutation(means3d, active, world_view):
    """Front-to-back permutation of the Gaussian axis by view-space z.
    Inactive rows take a +inf key, so they pad the last slab. Returns
    (perm, inv_perm): x[perm] is depth-ordered, y[inv_perm] undoes it."""
    with torch.no_grad():
        depth = means3d @ world_view[2, :3] + world_view[2, 3]
        if active is not None:
            depth = torch.where(active, depth, torch.full_like(depth, float("inf")))
        perm = torch.argsort(depth, stable=True)
        inv_perm = torch.empty_like(perm)
        inv_perm[perm] = torch.arange(perm.shape[0], device=perm.device)
    return perm, inv_perm


def compose_segments(images, final_ts):
    """Fold k alpha-compositing segments front to back. images: (k,H,W,C)
    partial colours (a tensor or a sequence); final_ts: (k,H,W) partial
    transmittances. Returns (merged (H,W,C), T (H,W))."""
    color = torch.zeros_like(images[0])
    t = torch.ones_like(final_ts[0])
    for ci, ti in zip(images, final_ts):
        color = color + t[..., None] * ci
        t = t * ti
    return color, t


def _rows(x, perm, inv_perm):
    """x[perm], with a gather as the backward (bool masks: a plain gather)."""
    if x is None:
        return None
    if x.dtype == torch.bool:
        return x[perm]
    return permute_rows(x, perm, inv_perm)


def _light(camera, device):
    """The camera without its images, on `device`."""
    cam = camera._replace(image=None, mask=None, orientation=None, confidence=None)
    return type(cam)(*[None if x is None else x.to(device) for x in cam])


def _with_bg(image, final_t, bg):
    return image if bg is None else image + final_t[..., None] * bg


def render_gauss_sharded(camera, *, means3d, opacity, features, scales=None,
                         rotations=None, bg=None, active=None, mean2d_offset=None,
                         width: int, height: int,
                         config: RasterConfig = RasterConfig(), num_slabs: int,
                         devices=None):
    """`render` with the Gaussian axis cut into `num_slabs` depth slabs, in
    one process: each slab is rendered in turn with its own pair table, on
    devices[i] (every slab on the model's device by default), and the
    segments are folded on the model's device. JAX's output dict: the
    overflow counters summed over the slabs, pairs_demand the largest
    slab's. Differentiable, as `render` is."""
    k = num_slabs
    n = means3d.shape[0]
    if n % k:
        raise ValueError(f"Gaussian capacity {n} must be a multiple of the slab "
                         f"count {k} (choose a capacity_round that is)")
    home = means3d.device
    devices = [home] * k if devices is None else [torch.device(d) for d in devices]
    if active is None:
        active = torch.ones((n,), dtype=torch.bool, device=home)
    perm, inv_perm = _depth_slab_permutation(means3d, active, camera.world_view)
    inputs = dict(means3d=means3d, opacity=opacity, features=features,
                  scales=scales, rotations=rotations, active=active,
                  mean2d_offset=mean2d_offset)
    inputs = {key: _rows(x, perm, inv_perm) for key, x in inputs.items()}
    n_local = n // k
    outs = []
    for i, dev in enumerate(devices):
        rows = {key: None if x is None else x[i * n_local:(i + 1) * n_local].to(dev)
                for key, x in inputs.items()}
        outs.append(render(_light(camera, dev), **rows, bg=None, width=width,
                           height=height, config=config))
    ts = [o["final_T"].to(home) for o in outs]
    image, final_t = compose_segments([o["render"].to(home) for o in outs], ts)
    image_photo, _ = compose_segments([o["render_photo"].to(home) for o in outs], ts)
    radii = torch.cat([o["radii"].to(home) for o in outs])[inv_perm]
    return {
        "render": _with_bg(image, final_t, bg),
        "render_photo": _with_bg(image_photo, final_t, bg),
        "final_T": final_t,
        "radii": radii,
        "visibility_filter": radii > 0,
        **{key: sum(o[key].to(home) for o in outs) for key in COUNTERS},
        "pairs_demand": torch.stack([o["pairs_demand"].to(home) for o in outs]).amax(),
    }


def make_2d_mesh(data_size: int, gauss_size: int, device="cuda",
                 nodes=None) -> Mesh:
    """(data x gauss) mesh for view-DP composed with depth slabs.

    Multi-node aware, as JAX's multi-slice layout: every data row (the
    ranks of one gauss group, which exchange image segments every view)
    lies inside one node, and only the data axis crosses nodes. `nodes`
    gives each global rank's node; by default rank // LOCAL_WORLD_SIZE, as
    torchrun numbers ranks node by node. On one node this is the row-major
    reshape of ranks 0..data*gauss-1."""
    world = _world()[1]
    if nodes is None:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        nodes = [r // local for r in range(world)]
    return build_mesh(grid_ranks(data_size, gauss_size, nodes), device)


def grid_ranks(data_size: int, gauss_size: int, nodes) -> np.ndarray:
    """(data, gauss) ranks: each node's ranks, in order, fill whole rows of
    `gauss_size`; the first `data_size` rows make the grid."""
    rows = []
    for node in sorted(set(nodes)):
        ranks = [r for r, nd in enumerate(nodes) if nd == node]
        rows += [ranks[i:i + gauss_size]
                 for i in range(0, len(ranks) - gauss_size + 1, gauss_size)]
    if len(rows) < data_size:
        raise ValueError(
            f"a {data_size}x{gauss_size} mesh needs {data_size} rows of "
            f"{gauss_size} ranks inside one node; {len(nodes)} ranks on "
            f"{len(set(nodes))} node(s) give {len(rows)}")
    return np.asarray(rows[:data_size], dtype=np.int64)


def gauss_mesh(num_devices: Optional[int] = None, device="cuda") -> Mesh:
    """Mesh with a single "gauss" axis over the first `num_devices` ranks."""
    return make_mesh(num_devices, axis_name="gauss", device=device)


def make_slab_render(mesh: Mesh, num_slabs: Optional[int] = None):
    """render()-compatible function that renders only this rank's depth
    slab and folds the k segments of its gauss group.

    Slab selection is `permute_rows` (a gather in both directions) and a
    slice. The segments (colour and T, with the slab's radii) are
    all-gathered in one buffer. `render_photo` holds the values of `render`
    in the forward, so it is not sent: the photometric fold reads the other
    slabs' colours. In the fold the rank's own segment is its
    differentiable output and the others' are constants, so autograd gives
    the local backward of the fold: slab i's colour receives
    (prod_{j<i} T_j) g_c, and its T the cotangent that flows from the later
    segments. Each rank's parameter gradients then reach only its slab's
    rows, and a SUM over the gauss group merges them (MeshReducer). JAX
    differentiates through its all_gather instead, which hands every rank
    k copies of each cotangent, and takes pmean over gauss to cancel them:
    the same numbers, and no collective in the backward here."""
    k = mesh.axis_size("gauss") if num_slabs is None else num_slabs
    if k != mesh.axis_size("gauss"):
        raise ValueError(f"{k} slabs on a gauss axis of {mesh.axis_size('gauss')}")

    def slab_render(camera, *, means3d, opacity, features, scales=None,
                    rotations=None, cov3d_precomp=None, bg=None, active=None,
                    mean2d_offset=None, scale_modifier=1.0, width, height,
                    config: RasterConfig = RasterConfig()):
        n = means3d.shape[0]
        if n % k:
            raise ValueError(f"capacity {n} must be a multiple of {k} slabs")
        if cov3d_precomp is not None:
            raise ValueError("the slab render takes scales and rotations")
        n_local = n // k
        if active is None:
            active = torch.ones((n,), dtype=torch.bool, device=means3d.device)
        perm, inv_perm = _depth_slab_permutation(means3d, active, camera.world_view)
        lo = mesh.axis_index("gauss") * n_local

        def take(x):
            x = _rows(x, perm, inv_perm)
            return None if x is None else x[lo:lo + n_local]

        out = render(camera, means3d=take(means3d), opacity=take(opacity),
                     features=take(features), scales=take(scales),
                     rotations=take(rotations), bg=None, active=take(active),
                     mean2d_offset=take(mean2d_offset),
                     scale_modifier=scale_modifier, width=width, height=height,
                     config=config)
        img, trans, radii = out["render"], out["final_T"], out["radii"]
        sizes = (img.numel(), trans.numel(), radii.numel())
        seg = torch.cat([img.detach().reshape(-1), trans.detach().reshape(-1),
                         radii.reshape(-1).to(img.dtype)])
        gathered = mesh.all_gather(seg, "gauss")
        imgs = list(gathered[:, :sizes[0]].reshape((k,) + img.shape).unbind(0))
        ts = list(gathered[:, sizes[0]:sizes[0] + sizes[1]]
                  .reshape((k,) + trans.shape).unbind(0))
        me = mesh.axis_index("gauss")
        photos = list(imgs)
        imgs[me], photos[me], ts[me] = img, out["render_photo"], trans
        image, final_t = compose_segments(imgs, ts)
        image_photo, _ = compose_segments(photos, ts)
        # radii back in model order, identical on every gauss rank
        radii = gathered[:, sizes[0] + sizes[1]:].reshape(n)[inv_perm].to(radii.dtype)
        return {
            "render": _with_bg(image, final_t, bg),
            "render_photo": _with_bg(image_photo, final_t, bg),
            "final_T": final_t,
            "radii": radii,
            "visibility_filter": radii > 0,
            **{key: out[key] for key in COUNTERS + ("pairs_demand",)},
        }

    return slab_render


def make_slab_train_step(model_kind: str, opt_cfg, raster_cfg, *, width: int,
                         height: int, active_sh_degree: int,
                         spatial_lr_scale: float = 1.0,
                         dist_to_scale_factor: Optional[float] = None,
                         mesh: Mesh):
    """Train step with the Gaussian axis in depth slabs over the mesh's
    gauss axis, composed with view-DP over its data axis (JAX's
    make_slab_train_step, the step of `--gauss_shard`).

    model_kind "gaussian": step(params, stats, opt_state, active, camera,
    step); "hair": step(params, graph, stats, opt_state, camera, step,
    smooth_pairs, smooth_valid, magnet_idx=None). `camera` holds this
    rank's views (the data row's slice of the global batch); every rank of
    a gauss group renders the same views. The viewspace gradients are
    summed over gauss before the statistics, which are then reduced over
    data only; the gradients are summed over the whole mesh and divided by
    the data size (MeshReducer). On a 1x1 mesh (no process group) this is
    the one-process slab step: one slab, the depth-permuted rows, the
    compositing order of the sharded step."""
    from hairgs_tpu_torch.train.trainer import (
        make_gaussian_train_step,
        make_hair_train_step,
    )

    common = dict(width=width, height=height, active_sh_degree=active_sh_degree,
                  spatial_lr_scale=spatial_lr_scale, device=mesh.device,
                  render_fn=make_slab_render(mesh), reducer=MeshReducer(mesh))
    if model_kind == "hair":
        return make_hair_train_step(
            opt_cfg, raster_cfg, dist_to_scale_factor=dist_to_scale_factor,
            use_magnet=opt_cfg.lambda_magnet > 0, **common)
    if model_kind != "gaussian":
        raise ValueError(f"model_kind {model_kind!r}: 'gaussian' or 'hair'")
    return make_gaussian_train_step(opt_cfg, raster_cfg, **common)
