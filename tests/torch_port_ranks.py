"""gloo ranks on the CPU for the port's parallel tests.

`Ranks(world, cases, inputs, workdir)` starts `world` processes of this
module, each a rank of one gloo process group (one intra-op thread, a
timeout of 120 s each), which run the named cases of CASES in order;
`.wait()` returns {rank: {case: result}}, the results as numpy arrays.
Inputs travel as a pickle of numpy arrays written by the test; a case
imports torch and the port only, never JAX.

    python -m tests.torch_port_ranks <inputs.pkl> <out_dir> <case> [<case>...]

(RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR and
MASTER_PORT in the environment, as torchrun sets them.)
"""

import os
import pickle
import socket
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Ranks:
    """`world` processes of this module running `cases`; wait() returns
    {rank: {case: result}}, or fails with every rank's output when a rank
    fails or times out. The caller can work while the ranks run."""

    def __init__(self, world, cases, inputs, workdir, local_world=None,
                 timeout=TIMEOUT_S):
        os.makedirs(workdir, exist_ok=True)
        self.world, self.workdir, self.timeout = world, workdir, timeout
        in_path = os.path.join(workdir, "inputs.pkl")
        with open(in_path, "wb") as f:
            pickle.dump(inputs, f)
        local_world = local_world or world
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
                   WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(local_world),
                   OMP_NUM_THREADS="1")
        self.procs = [subprocess.Popen(
            [sys.executable, "-m", "tests.torch_port_ranks", in_path, workdir, *cases],
            cwd=ROOT, env=dict(env, RANK=str(rank), LOCAL_RANK=str(rank % local_world)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for rank in range(world)]

    def wait(self):
        outs = []
        try:
            for p in self.procs:
                try:
                    outs.append(p.communicate(timeout=self.timeout)[0])
                except subprocess.TimeoutExpired:
                    p.kill()
                    outs.append(p.communicate()[0]
                                + f"\n[timed out after {self.timeout} s]")
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        bad = [r for r, p in enumerate(self.procs) if p.returncode != 0]
        if bad:
            raise AssertionError("ranks %s failed:\n%s" % (bad, "\n".join(
                f"--- rank {r}\n{o[-4000:]}" for r, o in enumerate(outs))))
        results = {}
        for rank in range(self.world):
            with open(os.path.join(self.workdir, f"rank{rank}.pkl"), "rb") as f:
                results[rank] = pickle.load(f)
        return results


# --- the cases: each takes the inputs dict and the run directory --------


def _np(tree):
    """numpy copies of a tree of tensors (NamedTuples become dicts)."""
    import torch

    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy().copy()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {k: _np(v) for k, v in tree._asdict().items()}
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree


def _cams(cams):
    import torch

    from hairgs_tpu_torch.core.camera import stack_cameras
    from hairgs_tpu_torch.models.gaussian import camera_from_numpy

    return stack_cameras([camera_from_numpy(c, torch.device("cpu")) for c in cams])


def _gaussian_state(inputs):
    import torch

    from hairgs_tpu_torch.models.gaussian import (
        adam_state_from_numpy,
        params_from_numpy,
        stats_from_numpy,
    )

    cpu = torch.device("cpu")
    return (params_from_numpy(inputs["params"], cpu),
            stats_from_numpy(inputs["stats"], cpu),
            adam_state_from_numpy(inputs["moments"], 0, cpu),
            torch.tensor(inputs["active"]))


def _configs(inputs):
    from hairgs_tpu_torch.config import OptimizationConfig
    from hairgs_tpu_torch.render.renderer import RasterConfig

    return OptimizationConfig(**inputs["opt"]), RasterConfig(**inputs["raster"])


def _hair_state(inputs):
    import torch

    from hairgs_tpu_torch.models.hair import HairModel

    model = HairModel(sh_degree=0, capacity_round=inputs["capacity_round"],
                      device="cpu")
    model.restore(dict(np.load(inputs["checkpoint"])))
    pairs, valid = (torch.tensor(inputs["smooth_pairs"].astype(np.int64)),
                    torch.tensor(inputs["smooth_valid"]))
    return model, pairs, valid


def _run(step, *args):
    p, s, o, m, image = step(*args)
    return dict(params=_np(p), stats=_np(s), opt=_np(o.mu),
                metrics={k: float(v) for k, v in m.items()}, image=_np(image))


def case_view_gaussian(inputs, workdir):
    """The view-parallel Stage-I step, through both JAX names and as the
    train driver builds it (the trainer's step with a MeshReducer), on
    this rank's slice of the batch."""
    from hairgs_tpu_torch.parallel.mesh import (
        MeshReducer,
        make_mesh,
        make_sharded_gaussian_step,
        make_shardmap_gaussian_step,
        shard_view_batch,
    )
    from hairgs_tpu_torch.train.trainer import make_gaussian_train_step

    g = inputs["gaussian"]
    opt, raster = _configs(g)
    mesh = make_mesh(device="cpu")
    params, stats, opt_state, active = _gaussian_state(g)
    local = shard_view_batch(_cams(g["cams"]), mesh)
    size = dict(width=g["width"], height=g["height"], active_sh_degree=0)
    steps = {
        "shardmap": make_shardmap_gaussian_step(opt, raster, mesh=mesh, **size),
        "sharded": make_sharded_gaussian_step(opt, raster, mesh=mesh, **size),
        "driver": make_gaussian_train_step(opt, raster, device="cpu",
                                           reducer=MeshReducer(mesh), **size),
    }
    out = {}
    for name, step in steps.items():
        mesh.reset_counts()
        out[name] = _run(step, params, stats, opt_state, active, local, 1)
        out[name]["collectives"] = (mesh.calls, mesh.bytes)
    return out


def case_view_hair(inputs, workdir):
    """The view-parallel Stage-III step, through both JAX names and as the
    train driver builds it."""
    from hairgs_tpu_torch.parallel.mesh import (
        MeshReducer,
        make_mesh,
        make_sharded_hair_step,
        make_shardmap_hair_step,
        shard_view_batch,
    )
    from hairgs_tpu_torch.train.trainer import make_hair_train_step

    h = inputs["hair"]
    opt, raster = _configs(h)
    mesh = make_mesh(device="cpu")
    model, pairs, valid = _hair_state(h)
    local = shard_view_batch(_cams(h["cams"]), mesh)
    size = dict(width=h["width"], height=h["height"], active_sh_degree=0,
                spatial_lr_scale=model.spatial_lr_scale,
                dist_to_scale_factor=model.dist_to_scale_factor)
    steps = {
        "shardmap": make_shardmap_hair_step(opt, raster, mesh=mesh, **size),
        "sharded": make_sharded_hair_step(opt, raster, mesh=mesh, **size),
        "driver": make_hair_train_step(opt, raster, device="cpu",
                                       reducer=MeshReducer(mesh), **size),
    }
    return {name: _run(step, model.params, model.graph, model.stats,
                       model.opt_state, local, 1, pairs, valid)
            for name, step in steps.items()}


def case_slab_steps(inputs, workdir):
    """The slab train steps (Gaussian and hair) on a (2 x 2) mesh."""
    from hairgs_tpu_torch.parallel.mesh import shard_view_batch
    from hairgs_tpu_torch.parallel.slab import make_2d_mesh, make_slab_train_step

    mesh = make_2d_mesh(2, 2, device="cpu")
    g = inputs["gaussian"]
    opt, raster = _configs(g)
    params, stats, opt_state, active = _gaussian_state(g)
    step = make_slab_train_step("gaussian", opt, raster, width=g["width"],
                                height=g["height"], active_sh_degree=0, mesh=mesh)
    mesh.reset_counts()
    out = {"gaussian": _run(step, params, stats, opt_state, active,
                            shard_view_batch(_cams(g["cams"]), mesh), 1)}
    out["gaussian"]["collectives"] = (mesh.calls, mesh.bytes)
    h = inputs["hair"]
    opt, raster = _configs(h)
    model, pairs, valid = _hair_state(h)
    step = make_slab_train_step(
        "hair", opt, raster, width=h["width"], height=h["height"],
        active_sh_degree=0, spatial_lr_scale=model.spatial_lr_scale,
        dist_to_scale_factor=model.dist_to_scale_factor, mesh=mesh)
    out["hair"] = _run(step, model.params, model.graph, model.stats,
                       model.opt_state, shard_view_batch(_cams(h["cams"]), mesh), 1,
                       pairs, valid)
    out["coords"] = mesh.coords
    return out


def case_node_layout(inputs, workdir):
    """make_2d_mesh with a faked two-node layout: the ranks of each gauss
    group, seen through a real all_gather."""
    import torch

    from hairgs_tpu_torch.parallel.slab import make_2d_mesh

    out = {}
    for name, nodes in (("env", None), ("interleaved", [0, 1, 0, 1])):
        mesh = make_2d_mesh(2, 2, device="cpu", nodes=nodes)
        me = torch.tensor([float(torch.distributed.get_rank())])
        out[name] = dict(grid=mesh.grid, coords=mesh.coords,
                         gauss=mesh.all_gather(me, "gauss").reshape(-1).numpy(),
                         data=mesh.all_gather(me, "data").reshape(-1).numpy())
    return out


def case_checkpoint(inputs, workdir):
    """Two ranks save half the rows each (and replicated step counters),
    then reload into a fresh template; also load the JAX-written
    checkpoint of the inputs, each rank its half of the rows."""
    import torch

    from hairgs_tpu_torch.parallel.multihost import (
        RowShard,
        load_sharded_state,
        save_sharded_state,
    )

    rank = torch.distributed.get_rank()
    c = inputs["checkpoint"]
    n = c["endpoints"].shape[0]
    half = n // 2
    lo = rank * half

    def tree(endpoints, width, step_count):
        return {"params": {"endpoints": RowShard((n, 3), lo, endpoints),
                           "width": RowShard((n, 1), lo, width)},
                "step_count": step_count, "host_value": np.asarray([1.0, 2.0])}

    state = tree(torch.tensor(c["endpoints"][lo:lo + half]),
                 torch.tensor(c["width"][lo:lo + half]), torch.tensor([11.0]))
    ckpt = os.path.join(workdir, "port_ckpt")
    save_sharded_state(ckpt, state, step=42)
    torch.distributed.barrier()
    template = tree(torch.zeros(half, 3), torch.zeros(half, 1), torch.zeros(1))
    loaded, step = load_sharded_state(ckpt, template)
    from_jax, jax_step = load_sharded_state(inputs["jax_checkpoint"], template)
    files = sorted(os.listdir(ckpt))

    def arrays(t):
        return dict(endpoints=t["params"]["endpoints"].block.numpy(),
                    width=t["params"]["width"].block.numpy(),
                    step_count=t["step_count"].numpy(), host_value=t["host_value"])

    return dict(loaded=arrays(loaded), step=step, from_jax=arrays(from_jax),
                jax_step=jax_step, files=files,
                my_file=sorted(np.load(os.path.join(ckpt, f"shard_{rank}.npz")).files))


def case_view_counts(inputs, workdir):
    """multihost.global_view_batch on even and on uneven local batches."""
    import torch

    from hairgs_tpu_torch.core.camera import make_camera, stack_cameras
    from hairgs_tpu_torch.parallel.mesh import make_mesh
    from hairgs_tpu_torch.parallel.multihost import global_view_batch

    mesh = make_mesh(device="cpu")
    rank = torch.distributed.get_rank()

    def views(n):
        return stack_cameras([make_camera(np.eye(3), np.zeros(3), 1.0, 1.0,
                                          device="cpu")] * n)

    local = views(2)
    assert global_view_batch(local, mesh, global_size=4) is local
    try:
        global_view_batch(views(1 + rank), mesh)
        uneven = False
    except ValueError:
        uneven = True
    return {"even": [2, 2], "uneven_raises": uneven}


def case_train_driver(inputs, workdir):
    """drivers/train.py::training() under this process group, with each
    variant's flags; returns, per variant, the recorded rows, the final
    state and a checksum all-gathered from every rank."""
    import random

    import torch

    from hairgs_tpu_torch import config
    from hairgs_tpu_torch.drivers import train as driver

    class Recorder:
        def __init__(self):
            self.rows = []

        def log(self, info, model):
            self.rows.append((info.iter, info.loss, dict(info.densification_info),
                              model.count))

        def close(self):
            pass

    out = {}
    for name, argv in inputs["driver_runs"].items():
        parser = driver.ArgumentParser()
        for cfg in ("ModelConfig", "OptimizationConfig", "GeneralConfig",
                    "RuntimeConfig"):
            config.add_config_args(parser, getattr(config, cfg))
        args = parser.parse_args(argv)
        driver.prepare_output_path(args)
        random.seed(0)
        np.random.seed(0)
        rec = Recorder()
        _, model = driver.training(
            *(config.extract_config(args, getattr(config, c))
              for c in ("ModelConfig", "OptimizationConfig", "GeneralConfig",
                        "RuntimeConfig")), args, logger=rec)
        total = torch.stack([p.double().sum() for p in model.params]).sum().reshape(1)
        sums = [torch.zeros(1, dtype=torch.float64)
                for _ in range(torch.distributed.get_world_size())]
        torch.distributed.all_gather(sums, total)
        out[name] = dict(rows=rec.rows, count=model.count,
                         params={k: v[:model.count] for k, v in _np(model.params).items()},
                         checksums=[float(s) for s in sums])
    return out


CASES = {name[5:]: fn for name, fn in list(globals().items())
         if name.startswith("case_")}


def main():
    in_path, workdir, *cases = sys.argv[1:]
    import torch

    torch.set_num_threads(1)
    from hairgs_tpu_torch.parallel.mesh import init_distributed

    with open(in_path, "rb") as f:
        inputs = pickle.load(f)
    init_distributed("cpu")
    results = {name: CASES[name](inputs, workdir) for name in cases}
    rank = torch.distributed.get_rank()
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
