#!/usr/bin/env python
"""Stage II.5 (counterpart of scripts/grow_and_save.py): apply strand-growth
events to a hair checkpoint, weld the grown tips with a Stage-II merge
pass, optionally smooth each strand's polyline, and save the result as a
checkpoint directory of its own.

    python3 -m hairgs_tpu_torch.drivers.grow_and_save -s <scene> -m <model dir> \\
        --out <dir> [--base_iter N] [--events 2] [--growth_length 0.002] \\
        [--merge_iters 30] [--smooth_lam 0] [--data_device cuda|cpu]

Then score it with
`python3 -m hairgs_tpu_torch.drivers.eval -s <scene> -p <out>/point_cloud/iteration_M/point_cloud.ply -m <out>`.

Steps: copy `iteration_<base_iter>` (0: the latest) into `<out>`, load a
Scene there (it must hold a hair model at that iteration), run up to
`--events` growth events (`topo/graph_ops.py::hair_growing`, stopping at one
that grows nothing), the merge loop for at most `--merge_iters` iterations,
the Laplacian pass (float64, stored float32), and save at base_iter +
events. With the scene's GT it prints the grown strands' metric table, as
the merge driver does. The model lives on `--data_device` ("cuda" unless
the CPU is asked for); growth, merging and smoothing are host work, as in
JAX. The port's growth extends only tips that are an endpoint of one
segment: JAX's also extends a foreground tip that goes on into a
background segment, giving it a third segment (ROADMAP Queue 3);
`branching_tips` counts such tips.
"""

import os
import shutil
import sys
import types
from argparse import ArgumentParser

import numpy as np
import torch


def build_parser() -> ArgumentParser:
    ap = ArgumentParser(description="Stage II.5: grow strand tips and save")
    ap.add_argument("--data", "-s", default="_runs/syn150_512/data")
    ap.add_argument("--model", "-m", default="_runs/syn150_512/model")
    ap.add_argument("--base_iter", type=int, default=0,
                    help="checkpoint iteration to grow (0 = latest in the model dir)")
    ap.add_argument("--out", default="_runs/s3_growth")
    ap.add_argument("--events", type=int, default=2)
    ap.add_argument("--growth_length", type=float, default=0.002)
    ap.add_argument("--merge_iters", type=int, default=30,
                    help="Stage-II merge pass after growth; 0 disables")
    ap.add_argument("--smooth_lam", type=float, default=0.0,
                    help="one Laplacian smoothing pass over strand polylines "
                         "after the merge (0 = off)")
    ap.add_argument("--data_device", default="cuda",
                    help="device the model loads on")
    return ap


def branching_tips(model) -> int:
    """Strands whose tip is an endpoint of more than one segment of the
    whole graph (it goes on into a background segment): JAX's growth
    extends them, the port's does not."""
    pairs = model.host_arrays(keys=("endpoint_pairs",))["endpoint_pairs"].astype(np.int64)
    degree = np.bincount(pairs.ravel(), minlength=model.num_endpoints)
    return sum(int(degree[s[-1, 1]] != 1) for s in model.strands_info.list_strands)


def new_endpoints_on_strands(model, first_new: int) -> int:
    """How many endpoints numbered from `first_new` on (each new segment of
    a growth event adds one) lie on a strand of the model's strands info: a
    new segment counts in the metrics only if the walk after the event
    puts it on a strand, which it does not while it stays background."""
    if not model.strands_info.list_strands:
        return 0
    ids = np.unique(np.concatenate(model.strands_info.list_strands).ravel())
    return int((ids >= first_new).sum())


def laplacian_smooth(model, lam: float):
    """One pass over each strand's polyline of three or more points: an
    interior point moves to (1 - lam) p + lam (prev + next) / 2, computed
    in float64 from the points before the pass (scripts/grow_and_save.py:97-113)."""
    p = model.params
    ep = p.endpoints.detach().cpu().numpy().astype(np.float64)
    ep_new = ep.copy()
    for pairs in model.strands_info.list_strands:
        seq = np.concatenate([pairs[:1, 0], pairs[:, 1]])
        if len(seq) < 3:
            continue
        interior = seq[1:-1]
        ep_new[interior] = (1 - lam) * ep[interior] + lam * 0.5 * (
            ep[seq[:-2]] + ep[seq[2:]])
    model.params = p._replace(endpoints=torch.as_tensor(
        ep_new.astype(np.float32), device=p.endpoints.device))


def main(argv=None):
    """Grow, merge, smooth and save; returns a dict: the saved PLY's path,
    the new segments of each event and how many of them the strands info
    walked after it holds, the strands before and after the merge
    pass (None without one), the merge iterations, the count of branching
    tips before the first event and the strand metrics of the result
    (printed as the merge driver prints them; None without GT)."""
    from hairgs_tpu_torch.config import OptimizationConfig
    from hairgs_tpu_torch.models.hair import HairModel
    from hairgs_tpu_torch.scene import Scene, search_for_max_iteration
    from hairgs_tpu_torch.topo.graph_ops import hair_growing

    args = build_parser().parse_args(sys.argv[1:] if argv is None else argv)
    if args.base_iter == 0:
        args.base_iter = search_for_max_iteration(os.path.join(args.model, "point_cloud"))
        print(f"growing latest checkpoint: iteration_{args.base_iter}")
    base = os.path.join(args.model, "point_cloud", f"iteration_{args.base_iter}")
    os.makedirs(os.path.join(args.out, "point_cloud"), exist_ok=True)
    stage = os.path.join(args.out, "point_cloud", f"iteration_{args.base_iter}")
    if not os.path.exists(stage):
        shutil.copytree(base, stage)

    scene_args = types.SimpleNamespace(
        source_path=args.data, model_path=args.out, images="images",
        resolution=-1, sh_degree=0, data_device=args.data_device, eval=False)
    scene = Scene(scene_args, shuffle=False)
    model = scene.gaussians
    if not isinstance(model, HairModel):
        raise TypeError(f"{stage} holds a {type(model).__name__}, not a hair model")
    if scene.loaded_iter != args.base_iter:
        raise ValueError(f"{args.out} holds iteration {scene.loaded_iter} past the "
                         f"base iteration {args.base_iter}")
    model.training_setup(OptimizationConfig())
    print(f"loaded iteration_{args.base_iter}: {model.num_segments} segments, "
          f"{len(model.strands_info.list_strands)} strands")
    branching = branching_tips(model)
    print(f"strands whose tip goes on into another segment (not grown): {branching}")

    grown, joined = [], []
    for ev in range(args.events):
        first_new = model.num_endpoints
        n = hair_growing(model, growth_length=args.growth_length)
        grown.append(n)
        print(f"growth event {ev + 1}: +{n} tip segments ({model.num_segments} total)")
        joined.append(new_endpoints_on_strands(model, first_new))
        print(f"  of them in the recomputed strands info: {joined[-1]}")
        if n == 0:
            break

    strands, merge_iters = None, 0
    if args.merge_iters > 0:
        from hairgs_tpu_torch.topo.merge import stage2_merge_loop

        n_before = len(model.strands_info.list_strands)
        merge_iters = stage2_merge_loop(model, max_iterations=args.merge_iters)
        strands = (n_before, len(model.strands_info.list_strands))
        print(f"merge pass: {strands[0]} -> {strands[1]} strands")

    if args.smooth_lam > 0:
        laplacian_smooth(model, args.smooth_lam)
        print(f"laplacian smoothing pass (lam={args.smooth_lam}) applied")

    metrics = None
    if scene.gt is not None:  # the merge driver's table, on the grown strands
        from hairgs_tpu_torch.evaluation.eval_data import compute_eval_data_from_hair
        from hairgs_tpu_torch.evaluation.metrics import compute_metrics, format_metric_table

        metrics, ths = compute_metrics(pred=compute_eval_data_from_hair(model), gt=scene.gt,
                                       bidirectional=True)
        print(format_metric_table(metrics, ths))

    out_ply = scene.save(args.events)  # Scene.save adds loaded_iter
    print(f"saved grown checkpoint ({sum(grown)} new segments) -> {out_ply}")
    return dict(path=out_ply, grown=grown, joined=joined, strands=strands,
                merge_iterations=merge_iters,
                branching_tips=branching, metrics=metrics)


if __name__ == "__main__":
    main()
