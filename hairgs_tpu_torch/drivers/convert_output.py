#!/usr/bin/env python
"""Convert reconstruction outputs into viewer-friendly strand geometry
(counterpart of scripts/convert_output.py).

    python3 -m hairgs_tpu_torch.drivers.convert_output -i <point_cloud.ply> \\
        [-t gs|strand_integration|neural_haircut] [--edges] [-o <out.ply>] \
        [--device cuda|cpu]

Parity target: reference scripts/convert_output.py:18-77: dispatch on
`--type` through the eval-data loader registry, colour each strand by an
HSV hue ramp, and write a polyline-edge PLY (--edges) or a triangle-fan
face PLY; without -o, `strands.ply` beside the input. A `gs` checkpoint
is loaded on `--device` ("cuda" unless the CPU is asked for); the rest is
host work.
"""

import colorsys
import os
import sys
from argparse import ArgumentParser

import numpy as np


def strand_hue_colors(points_id_to_strand_id: np.ndarray) -> np.ndarray:
    """Per-vertex RGB from an HSV hue ramp over strands (ref l.59-69: hues
    0..180 in OpenCV's half-degree convention = 0..360 degrees, S=V=max)."""
    sid = np.asarray(points_id_to_strand_id)
    num_strands = int(sid.max()) + 1
    hues = np.linspace(0.0, 1.0, num=num_strands)
    rgb = np.array([colorsys.hsv_to_rgb(h, 1.0, 1.0) for h in hues])
    return (rgb[sid] * 255).astype(np.uint8)


def main(argv=None):
    """Write the viewer PLY; returns its path."""
    from hairgs_tpu_torch.evaluation.eval_data import eval_data_loading_callbacks
    from hairgs_tpu_torch.visualization import save_ply_edges, save_ply_faces

    parser = ArgumentParser("Convert GS output to visualizable ply lines")
    parser.add_argument("--input", "-i", required=True, help="Input ply file path")
    parser.add_argument("--type", "-t", default="gs", help="Type of the input ply file")
    parser.add_argument("--edges", "-e", action="store_true",
                        help="Save ply edges (polylines) instead of faces")
    parser.add_argument("--output", "-o", default=None)
    parser.add_argument("--device", default="cuda",
                        help="device of a gs checkpoint's model")
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)

    output_path = args.output
    if output_path is None:
        output_path = os.path.join(os.path.dirname(args.input), "strands.ply")
        print(f"Output path not specified. Saving to {output_path}")
    if args.type not in eval_data_loading_callbacks:
        raise ValueError(f"Type {args.type} not supported "
                         f"(have {sorted(eval_data_loading_callbacks)})")
    loader = eval_data_loading_callbacks[args.type]
    data = (loader(args.input, device=args.device) if args.type == "gs"
            else loader(args.input))
    if data.edges is None:
        raise ValueError("Edges are None")
    if data.points_id_to_strand_id is not None:
        vertex_colors = strand_hue_colors(data.points_id_to_strand_id)
    else:
        vertex_colors = np.tile(np.array([128, 128, 128], np.uint8),
                                (data.points.shape[0], 1))
    save = save_ply_edges if args.edges else save_ply_faces
    save(data.points, vertex_colors, data.edges, file_path=output_path)
    print(f"Saved to {output_path}")
    return output_path


if __name__ == "__main__":
    main()
