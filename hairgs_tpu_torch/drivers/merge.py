#!/usr/bin/env python
"""Stage-II driver (counterpart of the root merge.py): convert the Stage-I
Gaussian fit to a strand-segment graph and greedily merge nearby,
direction-aligned endpoints into strands.

    python3 -m hairgs_tpu_torch.drivers.merge -s <scene> -m <model dir> [--clean]

Parity target: reference merge.py:26-193 — load the Stage-I checkpoint,
assert it is a GaussianModel, convert (to_hair_gaussian_model), loop
compute_endpoint_pair_to_merge + merge_endpoint_pairs until no candidates,
save the 5-element hair PLY. The models live on `--data_device` ("cuda"
unless the CPU is asked for); the candidate search and the strand walk run
on the host in the native library.
"""

import sys
from argparse import ArgumentParser

from hairgs_tpu_torch.config import (
    GeneralConfig,
    ModelConfig,
    OptimizationConfig,
    RuntimeConfig,
    add_config_args,
    extract_config,
)


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description="Stage-II merging parameters")
    for cls in (ModelConfig, OptimizationConfig, GeneralConfig, RuntimeConfig):
        add_config_args(parser, cls)
    parser.add_argument("--clean", action="store_true",
                        help="drop background gaussians before conversion")
    return parser


def main(args):
    """Run Stage II on parsed `args`; returns a dict: the hair model, the
    counts after conversion (segments, endpoints, strands), one row per
    merge iteration (merged pairs, segments, strands, seconds of the
    candidate search and of the whole iteration), the iteration count, the
    strand metrics (None without GT) and the saved PLY's path."""
    from hairgs_tpu_torch.evaluation.eval_data import compute_eval_data_from_hair
    from hairgs_tpu_torch.evaluation.metrics import compute_metrics, format_metric_table
    from hairgs_tpu_torch.models.hair import HairModel
    from hairgs_tpu_torch.scene import Scene
    from hairgs_tpu_torch.topo.merge import stage2_merge_loop

    op = extract_config(args, OptimizationConfig)
    rt = extract_config(args, RuntimeConfig)
    gp = extract_config(args, GeneralConfig)
    scene = Scene(args, shuffle=False, capacity_round=rt.capacity_round)
    assert not isinstance(scene.gaussians, HairModel), (
        "Stage II expects a Stage-I GaussianModel checkpoint (merge.py:39-41)"
    )
    model = scene.gaussians
    model.training_setup(op)
    if getattr(args, "clean", False):
        model.clean_gaussians()
        print(f"Cleaned to {model.count} foreground gaussians")

    assert scene.head_reconstruction is not None, (
        "head_reconstruction_data.npz required for scalp anchoring"
    )
    if gp.vis3d:
        print("[vis3d] the 3D merge plots are not ported yet (ROADMAP Queue 1 "
              "item 8); off")

    hair = model.to_hair_model(scene.head_reconstruction.scalp_verts)
    hair.training_setup(op)
    converted = (hair.num_segments, hair.num_endpoints,
                 len(hair.strands_info.list_strands))
    print(f"Converted to hair model: {hair.num_segments} segments")

    rows = []

    def progress(i, n, times):
        rows.append(dict(iteration=i, merged=n, segments=hair.num_segments,
                         strands=len(hair.strands_info.list_strands), **times))
        print(f"merge iter {i}: merged {n} endpoint pairs -> "
              f"{hair.num_segments} segments, "
              f"{len(hair.strands_info.list_strands)} strands "
              f"({times['total']:.3f} s, candidates {times['candidates']:.3f} s)")

    iters = stage2_merge_loop(hair, max_iterations=op.iterations, callback=progress)
    print(f"Merging converged after {iters} iterations")

    metrics = None
    if scene.gt is not None:
        pred = compute_eval_data_from_hair(hair)
        metrics, ths = compute_metrics(pred=pred, gt=scene.gt,
                                       bidirectional=op.bidirectional_eval)
        print(format_metric_table(metrics, ths))
        metrics = (metrics, ths)

    scene.gaussians = hair
    path = scene.save(iters if iters > 0 else 1)
    print(f"Saved hair model to {path}")
    return dict(hair=hair, converted=converted, rows=rows, iterations=iters,
                metrics=metrics, path=path)


if __name__ == "__main__":
    main(build_parser().parse_args(sys.argv[1:]))
