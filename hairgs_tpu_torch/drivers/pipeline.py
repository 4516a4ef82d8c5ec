#!/usr/bin/env python
"""The full reconstruction of one scene (counterpart of
run_full_pipeline_single.sh and scripts/run_reference_schedule.sh):
Stage I (Gaussian fit) -> Stage II (merge) -> Stage III (strand-graph fit,
resuming from the hair PLY) -> evaluation of the last checkpoint.

    python3 -m hairgs_tpu_torch.drivers.pipeline -s <scene> -m <out> \\
        [--synthetic] [--stages stage1,merge,stage3,eval] \\
        [--data_device cuda|cpu] [train flags...]

Each stage is a child process `python3 -m hairgs_tpu_torch.drivers.<driver>`
in a fresh interpreter, as the shell scripts run them, and the run stops at
the first one that fails. Flags the pipeline does not know pass through to
both train stages (the scripts' COMMON); the merge and eval stages get the
scene, the model directory and the device only. `--synthetic` first writes
run_reference_schedule.sh's scene to `-s` unless one is there: 150
procedural strands of 24 points (seed 0), 16 ring cameras at 512x512,
rendered on the device. `--stages` runs a part of the chain in order, as
scripts/resume_stage3.sh runs Stage III and the evaluation alone. Every
stage runs on `--data_device` ("cuda" unless the CPU is asked for).

The reference schedule of run_reference_schedule.sh:

    python3 -m hairgs_tpu_torch.drivers.pipeline --synthetic \\
        -s _runs/syn150_512/data -m _runs/syn150_512/model \\
        --max_tiles_per_gaussian 64 --capacity_round 65536 --eval_frequency 10000
"""

import os
import shlex
import subprocess
import sys
import time
from argparse import ArgumentParser

STAGES = ("stage1", "merge", "stage3", "eval")
TITLES = {"stage1": "Stage I: Gaussian splatting fit",
          "merge": "Stage II: segment conversion + greedy merge",
          "stage3": "Stage III: strand-graph optimization",
          "eval": "Evaluation"}
# run_reference_schedule.sh:15-25
SYNTHETIC = dict(num_strands=150, points_per_strand=24, seed=0, num_cameras=16,
                 width=512, height=512)
# the GT renders' tables: generate_dataset's default sizes, on the kernel
# path on a card
GT_TABLES = dict(max_tiles_per_gaussian=16, max_pairs_per_tile=1024, chunk=32)


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description="Stage I -> merge -> Stage III -> eval",
                            allow_abbrev=False)
    parser.add_argument("--source_path", "-s", required=True)
    parser.add_argument("--model_path", "-m", required=True)
    parser.add_argument("--synthetic", action="store_true",
                        help="write the reference scene to -s first, unless "
                             "one is there")
    parser.add_argument("--stages", default=",".join(STAGES),
                        help="the stages to run, in the chain's order")
    parser.add_argument("--data_device", default="cuda",
                        help="the device every stage runs on")
    return parser


def parse(argv):
    """(pipeline args, the stages to run, the flags for both train stages)."""
    args, common = build_parser().parse_known_args(argv)
    stages = [s for s in args.stages.split(",") if s]
    if not stages or any(s not in STAGES for s in stages):
        raise ValueError(f"--stages takes a list of {','.join(STAGES)}, got "
                         f"{args.stages!r}")
    if stages != [s for s in STAGES if s in stages]:
        raise ValueError(f"--stages must keep the chain's order {STAGES}")
    return args, stages, common


def last_iteration(model_path: str) -> int:
    """The highest iteration_N under <model>/point_cloud (the scripts'
    `ls | sed | sort -n | tail -1`)."""
    its = [int(d.split("_")[-1])
           for d in os.listdir(os.path.join(model_path, "point_cloud"))
           if d.startswith("iteration_")]
    if not its:
        raise FileNotFoundError(f"no checkpoint under {model_path}/point_cloud")
    return max(its)


def stage_argv(stage, args, common):
    """The argv of one stage's driver; the eval stage's names the last
    checkpoint, so build it after the stages before it ran."""
    scene = ["-s", args.source_path]
    dev = ["--data_device", args.data_device]
    if stage in ("stage1", "stage3"):
        return [*scene, "-m", args.model_path, *common, *dev]
    if stage == "merge":
        return [*scene, "-m", args.model_path, *dev]
    ply = os.path.join(args.model_path, "point_cloud",
                       f"iteration_{last_iteration(args.model_path)}", "point_cloud.ply")
    return [*scene, "-p", ply, "-pt", "gs", "-m", args.model_path, *dev]


def stage_module(stage) -> str:
    return "hairgs_tpu_torch.drivers." + ("train" if stage.startswith("stage") else stage)


def write_reference_scene(path: str, device: str = "cuda"):
    """run_reference_schedule.sh's scene, rendered on `device`; prints the
    GT segment count and the worst overflow counters over the views (a GT
    render that drops pairs drops strands)."""
    from hairgs_tpu_torch.data.synthetic import generate_dataset, synthetic_test_hair
    from hairgs_tpu_torch.render.renderer import RasterConfig

    s = SYNTHETIC
    hair = synthetic_test_hair(num_strands=s["num_strands"],
                               points_per_strand=s["points_per_strand"], seed=s["seed"])
    overflow = []
    cfg = RasterConfig(**GT_TABLES, use_pallas=device.startswith("cuda"),
                       viewspace_stats=False)
    generate_dataset(path, hair, num_cameras=s["num_cameras"], width=s["width"],
                     height=s["height"], raster_cfg=cfg, device=device,
                     overflow=overflow)
    worst = {k: max(v[k] for v in overflow) for k in overflow[0]}
    print("dataset done:", path, hair.edges.shape[0], "GT segments; worst over "
          f"{len(overflow)} views {worst}", flush=True)
    if cfg.use_pallas:
        from hairgs_tpu_torch.render.composite_pairs import launches

        print(f"[kernels] launches {launches}", flush=True)


def run(argv=None) -> int:
    """Run the chain as child processes; returns the first non-zero exit
    code, or 0."""
    args, stages, common = parse(sys.argv[1:] if argv is None else argv)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    cmds = []
    if args.synthetic and not os.path.exists(
            os.path.join(args.source_path, "sparse", "0", "points3D.bin")):
        code = ("import sys; from hairgs_tpu_torch.drivers.pipeline import "
                "write_reference_scene as w; w(sys.argv[1], sys.argv[2])")
        cmds.append(("scene", "Generating synthetic dataset (150 strands, 16 cams, "
                     "512^2)", lambda: ["-c", code, args.source_path, args.data_device]))
    for stage in stages:
        cmds.append((stage, TITLES[stage], lambda stage=stage: [
            "-m", stage_module(stage), *stage_argv(stage, args, common)]))
    t_all = time.perf_counter()
    for name, title, make in cmds:
        cmd = [sys.executable, *make()]
        print(f"=== {title} ===\n{shlex.join(cmd)}", flush=True)
        t0 = time.perf_counter()
        rc = subprocess.call(cmd, env=env)
        print(f"[pipeline] {name} exited {rc} after "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        if rc:
            return rc
    print(f"=== DONE === ({time.perf_counter() - t_all:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(run())
