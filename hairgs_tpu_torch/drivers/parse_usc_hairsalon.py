#!/usr/bin/env python
"""USC-HairSalon dataset preparation (counterpart of
scripts/parse_usc_hairsalon.py).

    python3 -m hairgs_tpu_torch.drivers.parse_usc_hairsalon -d <dataset> -o <out> [flags]

Parity target: reference scripts/parse_usc_hairsalon.py — per sample: parse
the binary .data strands, synthesize a ring of views, render images, hair
masks and orientation + confidence maps, write the COLMAP scene plus
hair_eval_data.npz and head_reconstruction_data.npz: the training scene of
the train driver.

The views are rendered by the port's own splatting renderer (thin opaque
Gaussian segments) instead of the reference's OpenGL line renderer, on
`--device` ("cuda" unless the CPU is asked for), with generate_dataset's
default tables: on a card through the compositor kernels (the paged path),
on the CPU through the XLA path. Each sample prints the worst overflow
counters over its views (a render that drops pairs drops strands) and, on
a card, the kernels' launches. The orientation maps come from the analytic
projection of the rendered strand directions or from the Gabor bank
(`--orientation gabor`, the reference's method).
"""

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset_path", "-d", required=True,
                        help="directory with hairstyles/strands%%05d.data and head_model.obj")
    parser.add_argument("--output_path", "-o", required=True)
    parser.add_argument("--samples", nargs="+", type=int, default=[1])
    parser.add_argument("--cameras", type=int, default=16)
    parser.add_argument("--width", type=int, default=1000)
    parser.add_argument("--height", type=int, default=1000)
    parser.add_argument("--cam_z", type=float, default=0.5)
    parser.add_argument("--pct_strands", type=float, default=100)
    parser.add_argument("--hsv", action="store_true", default=True)
    parser.add_argument("--orientation", choices=["analytic", "gabor"],
                        default="analytic")
    parser.add_argument("--init_points",
                        choices=["gt_hair_verts", "strand_roots"],
                        default="gt_hair_verts")
    parser.add_argument("--device", default="cuda",
                        help="torch device the views are rendered on")
    return parser


def main(argv=None):
    args = build_parser().parse_args(sys.argv[1:] if argv is None else argv)

    from hairgs_tpu_torch.data.head import load_head_from_usc_dataset
    from hairgs_tpu_torch.data.synthetic import default_gt_config, generate_dataset
    from hairgs_tpu_torch.data.usc import load_hair_from_usc_dataset
    from hairgs_tpu_torch.render import composite_pairs

    head_path = os.path.join(args.dataset_path, "head_model.obj")
    head = load_head_from_usc_dataset(head_path) if os.path.exists(head_path) else None

    cfg = default_gt_config(args.device)
    written = []
    for sample in args.samples:
        data_path = os.path.join(
            args.dataset_path, "hairstyles", f"strands{sample:05d}.data"
        )
        if not os.path.exists(data_path):
            print(f"skip missing {data_path}")
            continue
        hair = load_hair_from_usc_dataset(
            data_path, hsv_spectre_color=args.hsv, pct_strands=args.pct_strands
        )
        out = os.path.join(args.output_path, f"{sample:05d}")
        overflow = []
        generate_dataset(
            out, hair,
            head_verts=head.verts if head is not None else None,
            num_cameras=args.cameras, width=args.width, height=args.height,
            cam_z=args.cam_z, orientation_source=args.orientation,
            init_points=args.init_points, raster_cfg=cfg, device=args.device,
            overflow=overflow,
        )
        worst = {k: max(v[k] for v in overflow) for k in overflow[0]}
        print(f"sample {sample}: dataset written to {out} "
              f"({hair.edges.shape[0]} GT segments); worst over {len(overflow)} views "
              f"{worst}")
        if cfg.use_pallas:
            print(f"[kernels] launches {composite_pairs.launches}")
        written.append(out)
    return written


if __name__ == "__main__":
    main()
