"""Data parallelism over camera views with torch.distributed (counterpart of
hairgs_tpu/parallel/mesh.py).

JAX runs one controller over a mesh of devices and lets XLA insert the
all-reduce; PyTorch runs one process per rank (`torchrun`), and every
collective is written out. The port's `Mesh` is a (data, gauss) grid of
ranks, row-major (data outer, gauss inner): the "data" axis splits the view
batch, the "gauss" axis the Gaussian rows into depth slabs
(parallel/slab.py). Each rank holds one process group along each axis and
one over the whole mesh.

The backend is fixed before `init_process_group` by one rule
(`choose_backend`): nccl when every rank of a node has a card of its own,
gloo on the CPU or when ranks share a card (NCCL refuses two ranks on one
device: ncclInvalidUsage on the H100 with torch 2.11 and NCCL 2.28). The
choice follows the counts, never a caught error. The gloo of that torch
takes every collective used here (all_reduce SUM and MAX in f32, f64 and
i64, broadcast, all_gather) on CUDA tensors itself, copying through host
memory, so no collective is staged by hand.

The steps of this module hold the model replicated on every rank, run each
rank's local views through `trainer._per_view`, and merge the results with
explicit all-reduces before Adam, which then runs on identical inputs on
every rank (`MeshReducer`).
"""

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from hairgs_tpu_torch import resolve_device
from hairgs_tpu_torch.models.gaussian import GaussianStats

def choose_backend(device: torch.device, local_world_size: int) -> str:
    """nccl when every rank of a node has a card of its own; gloo on the
    CPU, or when several ranks of a node share a card (NCCL refuses two
    ranks on one device)."""
    if device.type != "cuda":
        return "gloo"
    return "nccl" if local_world_size <= torch.cuda.device_count() else "gloo"


def rank_device(device="cuda") -> torch.device:
    """This rank's device: `cuda:{LOCAL_RANK % device_count}` for "cuda",
    the CPU only when asked for."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def init_distributed(device="cuda", backend: Optional[str] = None):
    """Join the process group that torchrun's environment describes (RANK,
    WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT).
    Returns (device, backend); the backend follows `choose_backend` unless
    given, and is printed. A CUDA rank's card becomes the current one, so
    "cuda" names it from here on."""
    dev = rank_device(device)
    world = int(os.environ["WORLD_SIZE"])
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    backend = backend or choose_backend(dev, local_world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    rank = int(os.environ["RANK"])
    dist.init_process_group(backend, rank=rank, world_size=world)
    print(f"[parallel] rank {rank} of {world} on {dev}, backend {backend} "
          f"({local_world} rank(s) on this node)")
    return dev, backend


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _world():
    """(rank, world size) of the process group, (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@dataclasses.dataclass
class Mesh:
    """A (data, gauss) grid of ranks and this rank's place in it.

    grid: (data, gauss) array of global ranks; coords: this rank's (data,
    gauss) index, None when the rank lies outside the grid; groups: this
    rank's process group along "data" (the ranks of its gauss column),
    "gauss" (the ranks of its data row) and "mesh" (every rank of the
    grid). A collective along an axis without a group (one rank of a
    larger mesh, or no process group at all) returns its input; a process
    group of one rank runs every collective on itself, so that its
    backend's calls run."""

    grid: np.ndarray
    device: torch.device
    backend: str
    coords: Optional[tuple]
    groups: dict
    # this rank's collectives since reset_counts(): {op: [calls, bytes of
    # the local tensors handed in]}, and (with `timing`, which synchronizes
    # the card around each call) milliseconds spent inside them
    timing: bool = False
    counts: dict = dataclasses.field(default_factory=dict)
    ms: float = 0.0

    @property
    def shape(self) -> dict:
        return {"data": self.grid.shape[0], "gauss": self.grid.shape[1]}

    @property
    def size(self) -> int:
        return int(self.grid.size)

    def axis_size(self, axis: str) -> int:
        return self.size if axis == "mesh" else self.shape[axis]

    def axis_index(self, axis: str) -> int:
        return self.coords[0 if axis == "data" else 1]

    @property
    def calls(self) -> int:
        return sum(c for c, _ in self.counts.values())

    @property
    def bytes(self) -> int:
        return sum(b for _, b in self.counts.values())

    def reset_counts(self):
        self.counts, self.ms = {}, 0.0

    def _run(self, name, t, call):
        """call(t), counted (and timed)."""
        count = self.counts.setdefault(name, [0, 0])
        count[0] += 1
        count[1] += t.numel() * t.element_size()
        if self.timing:
            _sync(self.device)
            t0 = time.perf_counter()
        out = call(t)
        out = t if out is None else out
        if self.timing:
            _sync(self.device)
            self.ms += (time.perf_counter() - t0) * 1e3
        return out

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM, axis="mesh"):
        """In-place all-reduce of `t` along `axis`; returns `t`."""
        group = self.groups[axis]
        if group is None:
            return t
        return self._run("all_reduce", t,
                         lambda b: dist.all_reduce(b, op=op, group=group))

    def broadcast(self, t: torch.Tensor, axis="mesh"):
        """In place, from the first rank of this rank's group along `axis`;
        returns `t`."""
        group = self.groups[axis]
        if group is None:
            return t
        src = int(self._axis_ranks(axis)[0])
        return self._run("broadcast", t,
                         lambda b: dist.broadcast(b, src=src, group=group))

    def all_gather(self, t: torch.Tensor, axis="gauss") -> torch.Tensor:
        """(k, *t.shape): the k ranks' tensors along `axis`, in axis order."""
        k, group = self.axis_size(axis), self.groups[axis]
        if group is None:
            return t[None]

        def gather(b):
            out = [torch.empty_like(b) for _ in range(k)]
            dist.all_gather(out, b, group=group)
            return torch.stack(out)

        return self._run("all_gather", t.contiguous(), gather)

    def barrier(self):
        if self.groups["mesh"] is not None:
            flag = torch.zeros(1, device=self.device)
            self.all_reduce(flag)
            flag.item()

    def _axis_ranks(self, axis):
        d, g = self.coords
        if axis == "data":
            return self.grid[:, g]
        if axis == "gauss":
            return self.grid[d, :]
        return self.grid.reshape(-1)


def build_mesh(grid, device="cuda") -> Mesh:
    """A Mesh over `grid` ((data, gauss) global ranks). Every rank of the
    process group must call this with the same grid: each creates every
    row's and every column's group, as `new_group` requires."""
    grid = np.asarray(grid, dtype=np.int64)
    dev = rank_device(device)
    rank, world = _world()
    if grid.size > world:
        raise ValueError(f"a {grid.shape[0]}x{grid.shape[1]} mesh needs "
                         f"{grid.size} ranks, the world has {world}"
                         + ("" if dist.is_initialized() else " (use torchrun)"))
    if not dist.is_initialized():
        return Mesh(grid, dev, "", (0, 0), {"data": None, "gauss": None, "mesh": None})
    if world == 1:
        w = dist.group.WORLD
        return Mesh(grid, dev, dist.get_backend(), (0, 0),
                    {"data": w, "gauss": w, "mesh": w})

    def group(ranks):
        # every rank creates every group, as new_group requires
        return dist.new_group([int(r) for r in ranks]) if len(ranks) > 1 else None

    rows = [group(row) for row in grid]
    cols = [group(col) for col in grid.T]
    everyone = (dist.group.WORLD if grid.size == world
                else group(grid.reshape(-1)))
    hit = np.argwhere(grid == rank)
    if not len(hit):
        return Mesh(grid, dev, dist.get_backend(), None, {})
    d, g = (int(i) for i in hit[0])
    return Mesh(grid, dev, dist.get_backend(), (d, g),
                {"data": cols[g], "gauss": rows[d], "mesh": everyone})


def make_mesh(num_devices: Optional[int] = None, axis_name: str = "data",
              device="cuda") -> Mesh:
    """The first `num_devices` ranks (all of them by default) along one
    axis."""
    _, world = _world()
    n = world if num_devices is None else num_devices
    shape = (n, 1) if axis_name == "data" else (1, n)
    return build_mesh(np.arange(n).reshape(shape), device)


def make_view_mesh(view_batch: int, max_devices: int = 0,
                   device="cuda") -> Optional[Mesh]:
    """Mesh for the train driver's view-batch DP, or None when one rank
    suffices: the largest rank count <= min(world size, view_batch) that
    divides view_batch (even shards, as in JAX), capped by `max_devices`
    when it is > 0."""
    if view_batch <= 1:
        return None
    n = min(_world()[1], view_batch)
    if max_devices > 0:
        n = min(n, max_devices)
    while view_batch % n:
        n -= 1
    if n <= 1:
        return None
    return make_mesh(n, device=device)


def _tree_map(fn, tree):
    """fn over the tensors of a tree of NamedTuples, tuples, lists and
    dicts; None stays None."""
    if tree is None:
        return None
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_tree_map(fn, v) for v in tree])
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def replicate(tree, mesh: Mesh):
    """Broadcast every tensor of `tree` in place from the mesh's first
    rank; returns the tree."""
    return _tree_map(lambda t: mesh.broadcast(t, "mesh"), tree)


def shard_view_batch(camera_batch, mesh: Mesh, axis_name: str = "data"):
    """This rank's contiguous slice of a batched Camera's leading (view)
    axis, as JAX's P("data") sharding gives each device."""
    b = camera_batch.world_view.shape[0]
    k = mesh.axis_size(axis_name)
    if b % k:
        raise ValueError(f"view batch {b} does not split over {k} ranks")
    i = mesh.axis_index(axis_name)
    local = b // k
    return type(camera_batch)(*[None if x is None else x[i * local:(i + 1) * local]
                                for x in camera_batch])


def _flat(tensors):
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat(flat, like):
    out, at = [], 0
    for t in like:
        out.append(flat[at:at + t.numel()].reshape(t.shape).to(t.dtype))
        at += t.numel()
    return out


class MeshReducer:
    """Merges a train step's per-rank results over a Mesh (the `reducer`
    of trainer.make_*_train_step).

    Losses and parameter gradients become the mean over the global view
    batch: each rank holds the mean over its local views, the ranks' means
    are summed by an all-reduce and divided by the data-axis size (the
    meaning of JAX's pmean(mean)). On a gauss axis each rank's gradient
    reaches only the rows of its own slab, so the same sum over the whole
    mesh also merges the slabs (see parallel/slab.py). Densification
    statistics: max_radii2d by MAX, xyz_grad_accum and denom by SUM over
    data; overflow counters by SUM and pairs_demand by MAX over the whole
    mesh. Calls per step: 3 on a data-only mesh; with a gauss axis the
    viewspace gradients over gauss, the gradients over the mesh, the
    view-level values over data (when it has more than one rank), the
    counters and the maxima, beside the slab render's gather per view."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def offsets(self, offset_grad):
        """Viewspace gradients: each gauss rank holds its slab's rows."""
        return self.mesh.all_reduce(offset_grad.contiguous(), dist.ReduceOp.SUM,
                                    "gauss")

    def merge(self, loss, grads, loss_dict, delta: GaussianStats, counters):
        m = self.mesh
        reduce = m.all_reduce
        d = m.axis_size("data")
        keys = list(loss_dict)
        views = [loss.reshape(1)] + [loss_dict[k].reshape(1).float() for k in keys] \
            + [delta.xyz_grad_accum, delta.denom]
        grads = list(grads)
        if m.axis_size("gauss") == 1:
            # every sum runs over data, which is the whole mesh: one call
            flat = reduce(_flat(views + grads), dist.ReduceOp.SUM, "data")
            out = _unflat(flat, views + grads)
            views, grads = out[:len(views)], out[len(views):]
        else:
            grads = _unflat(reduce(_flat(grads), dist.ReduceOp.SUM, "mesh"),
                            grads)
            views = _unflat(reduce(_flat(views), dist.ReduceOp.SUM, "data"),
                            views)
        grads = [g / d for g in grads]
        loss = views[0][0] / d
        loss_dict = {k: v[0] / d for k, v in zip(keys, views[1:1 + len(keys)])}
        names = ("overflow_pairs", "overflow_tiles", "overflow_capacity")
        sums = reduce(torch.stack([counters[k].reshape(()).to(torch.float64)
                                         for k in names]), dist.ReduceOp.SUM, "mesh")
        maxes = reduce(
            torch.cat([delta.max_radii2d.to(torch.float64),
                       counters["pairs_demand"].reshape(1).to(torch.float64)]),
            dist.ReduceOp.MAX, "mesh")
        counters = {k: sums[i].to(torch.int32) for i, k in enumerate(names)}
        counters["pairs_demand"] = maxes[-1].to(torch.int32)
        delta = GaussianStats(max_radii2d=maxes[:-1].to(delta.max_radii2d.dtype),
                              xyz_grad_accum=views[-2], denom=views[-1])
        return loss, grads, loss_dict, delta, counters


def make_shardmap_gaussian_step(opt_cfg, raster_cfg, *, width: int, height: int,
                                active_sh_degree: int, spatial_lr_scale: float = 1.0,
                                mesh: Mesh):
    """The view-parallel Stage-I step: the answer to both JAX's
    make_sharded_gaussian_step (GSPMD) and make_shardmap_gaussian_step
    (shard_map and explicit collectives), which compute the same update;
    `make_sharded_gaussian_step` is this function under JAX's other name.
    It is trainer.make_gaussian_train_step with a MeshReducer.

    step_fn(params, stats, opt_state, active, camera, step) -> (params,
    stats, opt_state, metrics, image), the trainer's signature, where
    `camera` holds THIS rank's views (`shard_view_batch` of the global
    batch, or `multihost.global_view_batch`); every rank passes the same
    replicated state and receives the same new state. `image` is the
    rank's first local view."""
    from hairgs_tpu_torch.train.trainer import make_gaussian_train_step

    return make_gaussian_train_step(
        opt_cfg, raster_cfg, width=width, height=height,
        active_sh_degree=active_sh_degree, spatial_lr_scale=spatial_lr_scale,
        device=mesh.device, reducer=MeshReducer(mesh))


def make_shardmap_hair_step(opt_cfg, raster_cfg, *, width: int, height: int,
                            active_sh_degree: int, spatial_lr_scale: float = 1.0,
                            dist_to_scale_factor: float, mesh: Mesh):
    """The view-parallel Stage-III step (JAX's make_sharded_hair_step and
    make_shardmap_hair_step; `make_sharded_hair_step` is this function
    under the other name): render and photometric gradients merged over
    the ranks; the smoothness term acts on the replicated endpoints and is
    added once per rank after the collectives. A step with the magnet term
    is trainer.make_hair_train_step(use_magnet=True,
    reducer=MeshReducer(mesh)), which adds it the same way.

    step_fn(params, graph, stats, opt_state, camera, step, smooth_pairs,
    smooth_valid, magnet_idx=None), `camera` holding this rank's views."""
    from hairgs_tpu_torch.train.trainer import make_hair_train_step

    return make_hair_train_step(
        opt_cfg, raster_cfg, width=width, height=height,
        active_sh_degree=active_sh_degree, spatial_lr_scale=spatial_lr_scale,
        dist_to_scale_factor=dist_to_scale_factor, device=mesh.device,
        reducer=MeshReducer(mesh))


make_sharded_gaussian_step = make_shardmap_gaussian_step
make_sharded_hair_step = make_shardmap_hair_step
