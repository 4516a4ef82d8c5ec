#!/usr/bin/env python
"""Synthesize a format-exact USC-HairSalon sample for the reference-scale
dress rehearsal (counterpart of scripts/synthesize_usc_sample.py, whose
bytes it writes for the same arguments): a byte-layout-identical stand-in
for the real dataset, which needs a download.

    python3 -m hairgs_tpu_torch.drivers.synthesize_usc_sample --out <dir> \
        [--sample 1] [--num_strands 10000] [--points_per_strand 100] \
        [--stub_fraction 0.01] [--step 0.0035] [--seed 0]

Writes <out>/hairstyles/strands%05d.data in the USC binary layout parsed by
hairgs_tpu_torch/data/usc.py (reference data/hair_data.py:63-136): int32
num_strands == 10000, then per strand int32 num_verts in {1, 100} followed
by num_verts little-endian float32 xyz triplets. Also writes a UV-sphere
head_model.obj at the USC head scale so the parser's head branch runs.

Geometry: strands rooted on a spherical cap (head r=0.085 m around the
origin, matching the USC coordinate convention), ~100 verts at 3.5 mm steps
flowing down under gravity with per-strand curl noise — ~990k GT points /
~980k segments per sample, the reference's workload scale. A fraction of
strands get num_verts=1 (the real dataset contains such stubs; the parser
must skip them).
"""

import argparse
import os
import struct
import sys

import numpy as np


def make_strand(rng, root, points_per_strand, step):
    direction = root / np.linalg.norm(root)
    pts = [root]
    d = direction.copy()
    curl = rng.normal(0, 0.03, 3)  # per-strand coherent curl
    for _ in range(points_per_strand - 1):
        d = d + np.array([0, -0.55, 0]) + curl + rng.normal(0, 0.04, 3)
        d /= np.linalg.norm(d)
        pts.append(pts[-1] + d * step)
    return np.asarray(pts, dtype="<f4")


def write_head_obj(path, r=0.085, nu=24, nv=16):
    with open(path, "w") as f:
        for j in range(nv + 1):
            phi = np.pi * j / nv
            for i in range(nu):
                th = 2 * np.pi * i / nu
                x = r * np.sin(phi) * np.cos(th)
                y = r * np.cos(phi)
                z = r * np.sin(phi) * np.sin(th)
                f.write(f"v {x:.6f} {y:.6f} {z:.6f}\n")
        for j in range(nv):
            for i in range(nu):
                a = j * nu + i + 1
                b = j * nu + (i + 1) % nu + 1
                c = (j + 1) * nu + i + 1
                d = (j + 1) * nu + (i + 1) % nu + 1
                f.write(f"f {a} {b} {d} {c}\n")


def main(argv=None) -> str:
    """Write the sample; returns the path of its .data file."""
    p = argparse.ArgumentParser()
    p.add_argument("--out", "-o", required=True)
    p.add_argument("--sample", type=int, default=1)
    p.add_argument("--num_strands", type=int, default=10000,
                   help="USC layout requires 10000 (the parser asserts it)")
    p.add_argument("--points_per_strand", type=int, default=100)
    p.add_argument("--stub_fraction", type=float, default=0.01,
                   help="fraction of strands written as 1-vert stubs")
    p.add_argument("--step", type=float, default=0.0035)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(sys.argv[1:] if argv is None else argv)

    rng = np.random.default_rng(args.seed)
    os.makedirs(os.path.join(args.out, "hairstyles"), exist_ok=True)
    path = os.path.join(args.out, "hairstyles",
                        f"strands{args.sample:05d}.data")
    n_pts = 0
    with open(path, "wb") as f:
        f.write(struct.pack("<i", args.num_strands))
        for _ in range(args.num_strands):
            if rng.uniform() < args.stub_fraction:
                f.write(struct.pack("<i", 1))
                f.write(np.zeros(3, "<f4").tobytes())
                n_pts += 1
                continue
            theta = rng.uniform(0, 2 * np.pi)
            phi = rng.uniform(0, 0.45 * np.pi)
            root = 0.085 * np.array([
                np.sin(phi) * np.cos(theta),
                np.cos(phi),
                np.sin(phi) * np.sin(theta),
            ])
            pts = make_strand(rng, root, args.points_per_strand, args.step)
            f.write(struct.pack("<i", pts.shape[0]))
            f.write(pts.tobytes())
            n_pts += pts.shape[0]
    head = os.path.join(args.out, "head_model.obj")
    if not os.path.exists(head):
        write_head_obj(head)
    print(f"wrote {path} ({args.num_strands} strands, {n_pts} verts) + {head}")
    return path


if __name__ == "__main__":
    main()
