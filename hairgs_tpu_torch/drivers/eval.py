#!/usr/bin/env python
"""Standalone evaluation (counterpart of the root eval.py): GT npz against
a prediction file.

    python3 -m hairgs_tpu_torch.drivers.eval -s <scene> -p <prediction.ply> \\
        [-pt gs|strand_integration|neural_haircut] [-m <model dir>]

Parity target: reference eval.py:13-59 (which is broken as shipped — it
unpacks a `return_table` result that loss/metrics.py never implemented; the
intended table output is implemented here). The strand metrics run on the
host. With a model directory, PSNR/SSIM are rendered over the training
views with eval.py's default tables on `--data_device` ("cuda" unless the
CPU is asked for): on the paged path (the kernels) on a card, on the XLA
path on the CPU.
"""

import os
import sys
import types
from argparse import ArgumentParser, BooleanOptionalAction


def main(argv=None):
    """Print the metric table (and the image metrics with -m); returns the
    metric dict."""
    from hairgs_tpu_torch.evaluation.eval_data import eval_data_loading_callbacks
    from hairgs_tpu_torch.evaluation.metrics import compute_metrics

    parser = ArgumentParser(description="Evaluation parameters")
    parser.add_argument("--source_path", "-s", required=True,
                        help="dataset path containing hair_eval_data.npz")
    parser.add_argument("--prediction_path", "-p", required=True)
    parser.add_argument("--prediction_type", "-pt", default="gs",
                        choices=sorted(eval_data_loading_callbacks.keys()))
    parser.add_argument("--bidirectional", action=BooleanOptionalAction, default=True)
    parser.add_argument("--sh_degree", type=int, default=0)
    parser.add_argument("--model_path", "-m", default=None,
                        help="with a model dir, additionally report "
                             "PSNR/SSIM image metrics over the training views")
    parser.add_argument("--data_device", default="cuda",
                        help="device the models load and render on")
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)

    gt = eval_data_loading_callbacks["gt"](
        os.path.join(args.source_path, "hair_eval_data.npz")
    )
    loader = eval_data_loading_callbacks[args.prediction_type]
    if args.prediction_type == "gs":
        pred = loader(args.prediction_path, sh_degree=args.sh_degree,
                      device=args.data_device)
    else:
        pred = loader(args.prediction_path)

    metrics, thresholds, table = compute_metrics(
        pred=pred, gt=gt, bidirectional=args.bidirectional, return_table=True
    )
    print(table)

    if args.model_path:
        from hairgs_tpu_torch.evaluation.image_metrics import evaluate_image_metrics
        from hairgs_tpu_torch.render.renderer import RasterConfig
        from hairgs_tpu_torch.scene import Scene

        scene_args = types.SimpleNamespace(
            source_path=args.source_path, model_path=args.model_path,
            images="images", resolution=-1, sh_degree=args.sh_degree,
            data_device=args.data_device, eval=False)
        scene = Scene(scene_args, shuffle=False)
        # eval.py's default tables; the paged path (the kernels) on a card
        cfg = RasterConfig(use_pallas=scene.device.type == "cuda",
                           viewspace_stats=False)
        im = evaluate_image_metrics(scene.gaussians, scene.get_cameras(), config=cfg)
        print("image metrics (train views): "
              + "  ".join(f"{k} {v:.3f}" for k, v in im.items()))
    return metrics


if __name__ == "__main__":
    main()
