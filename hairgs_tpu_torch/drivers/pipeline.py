#!/usr/bin/env python
"""The full reconstruction of one scene (counterpart of
run_full_pipeline_single.sh, scripts/run_reference_schedule.sh,
scripts/run_reference_schedule_1k.sh and scripts/usc_dress_rehearsal.sh):
Stage I (Gaussian fit) -> Stage II (merge) -> [Stage II.5 (growth)] ->
Stage III (strand-graph fit, resuming from the hair PLY) -> evaluation of
the last checkpoint.

    python3 -m hairgs_tpu_torch.drivers.pipeline -s <scene> -m <out> \\
        [--synthetic] [--recipe 512|1k|usc] [--stages stage1,merge,grow,stage3,eval] \\
        [--data_device cuda|cpu] [train flags...]

Each stage is a child process `python3 -m hairgs_tpu_torch.drivers.<driver>`
in a fresh interpreter, as the shell scripts run them, and the run stops at
the first one that fails. Flags the pipeline does not know pass through to
both train stages (the scripts' COMMON); the merge, grow and eval stages
get the scene, the model directory and the device only. Every stage runs
on `--data_device` ("cuda" unless the CPU is asked for). Files the chain
writes beside the model directory (its parent, the scripts' run directory):
`grown_postmerge/` and `growth_eval.txt` of Stage II.5, and with the 1k
recipe `post_merge_iter.txt`, `final_eval.txt`, `grown_final/`,
`grown_final_eval.txt` and `done.txt`. An evaluation written to a file is
printed too.

`--recipe 512` (the default) is run_reference_schedule.sh: `--synthetic`
first writes its scene to `-s` unless one is there (150 procedural strands
of 24 points, seed 0, 16 ring cameras at 512x512, rendered on the device),
the stages run as given (`--stages`, default stage1,merge,stage3,eval; the
optional `grow` stage, Stage II.5, grows the latest checkpoint into
`grown_postmerge/` and evaluates it), and the train flags are the
caller's:

    python3 -m hairgs_tpu_torch.drivers.pipeline --synthetic \\
        -s _runs/syn150_512/data -m _runs/syn150_512/model \\
        --max_tiles_per_gaussian 64 --capacity_round 65536 --eval_frequency 10000

`--recipe 1k` is run_reference_schedule_1k.sh: the same scene at
1000x1000 (written unless there), its COMMON flags (RECIPE_1K_COMMON:
antialiasing, alpha_min 1e-5, 64 tiles per Gaussian frozen, 2048 pairs per
tile) on both train stages, and its resumable steps, each skipped when its
output is there: Stage I trains from the latest checkpoint up to
`--iterations` (default 30000) in all; the merge runs when the latest
checkpoint is that iteration and `post_merge_iter.txt` does not exist, and
writes it; Stage II.5 grows the post-merge checkpoint unless
`growth_eval.txt` exists; Stage III trains from the post-merge state (not
the grown one) up to post-merge + `--iterations` with
RECIPE_1K_STAGE3 (async topology events, densify threshold 0.0004); the
eval stage evaluates the last checkpoint, grows it into `grown_final/` and
evaluates that. `--stages` picks among them (default all five):

    python3 -m hairgs_tpu_torch.drivers.pipeline --recipe 1k \\
        -s _runs/syn150_1k/data -m _runs/syn150_1k/model

`--recipe usc` is usc_dress_rehearsal.sh, the reference-scale rehearsal:
in the run directory, a USC-HairSalon sample of 10 000 strands x 100
points (`drivers/synthesize_usc_sample.py`, into raw/, log synth.log), the
USC parser at 16 views of 1000x1000 on `--data_device` (into dataset/,
whose 00001/ must be `-s`; log parse.log), a 500-iteration Stage I
(USC_STAGE1, log fit.log) and the eval driver on its last PLY (eval.txt),
each step skipped when its output is there; done.txt at the end. Its
stages are stage1 and eval (the sample and the parse run first):

    python3 -m hairgs_tpu_torch.drivers.pipeline --recipe usc \\
        -s _runs/usc_rehearsal/dataset/00001 -m _runs/usc_rehearsal/model
"""

import os
import shlex
import subprocess
import sys
import time
from argparse import ArgumentParser

# the chain, and the default stages of the 512 recipe (run_reference_schedule.sh
# has no growth step)
CHAIN = ("stage1", "merge", "grow", "stage3", "eval")
STAGES = ("stage1", "merge", "stage3", "eval")
TITLES = {"stage1": "Stage I: Gaussian splatting fit",
          "merge": "Stage II: segment conversion + greedy merge",
          "grow": "Stage II.5: strand growth + merge pass",
          "grow_eval": "Evaluation of the grown post-merge model",
          "stage3": "Stage III: strand-graph optimization",
          "eval": "Evaluation",
          "grow_final": "Growth of the final model",
          "grow_final_eval": "Evaluation of the grown final model",
          "sample": "USC-HairSalon sample (10 000 strands x 100 points)",
          "parse": "USC-HairSalon parse (16 views at 1000x1000)"}
# run_reference_schedule.sh:15-25
SYNTHETIC = dict(num_strands=150, points_per_strand=24, seed=0, num_cameras=16,
                 width=512, height=512)
# run_reference_schedule_1k.sh:35-49,103: the scene at 1000x1000, COMMON,
# and Stage III's extra flags
RECIPE_1K_SIZE = 1000
RECIPE_1K_COMMON = ["--max_tiles_per_gaussian", "64", "--freeze_tile_budget",
                    "--max_pairs_per_tile", "2048", "--capacity_round", "131072",
                    "--eval_frequency", "10000", "--save_frequency", "5000",
                    "--antialiasing", "--alpha_min", "0.00001", "--logger", "none"]
RECIPE_1K_STAGE3 = ["--async_topology", "--densify_grad_threshold", "0.0004"]
RECIPE_1K_TARGET = 30000  # the train driver's default --iterations
# usc_dress_rehearsal.sh:20,26-27,40-43: the sample, the parse, Stage I
USC_SAMPLE = 1
USC_PARSE = ["--cameras", "16", "--width", "1000", "--height", "1000"]
USC_STAGE1 = ["--logger", "none", "--iterations", "500", "--position_lr_max_steps",
              "30000", "--max_tiles_per_gaussian", "64", "--capacity_round", "131072",
              "--save_frequency", "500", "--eval_frequency", "250"]
DEFAULT_STAGES = {"512": STAGES, "1k": CHAIN, "usc": ("stage1", "eval")}


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description="Stage I -> merge -> [growth] -> Stage III -> eval",
                            allow_abbrev=False)
    parser.add_argument("--source_path", "-s", required=True)
    parser.add_argument("--model_path", "-m", required=True)
    parser.add_argument("--synthetic", action="store_true",
                        help="write the reference scene to -s first, unless "
                             "one is there (the 1k recipe always does)")
    parser.add_argument("--recipe", choices=("512", "1k", "usc"), default="512",
                        help="run_reference_schedule.sh (512), "
                             "run_reference_schedule_1k.sh (1k) or "
                             "usc_dress_rehearsal.sh (usc)")
    parser.add_argument("--stages", default=None,
                        help="the stages to run, in the chain's order "
                             f"({','.join(CHAIN)}; default: the recipe's)")
    parser.add_argument("--data_device", default="cuda",
                        help="the device every stage runs on")
    return parser


def parse(argv):
    """(pipeline args, the stages to run, the flags for both train stages)."""
    args, common = build_parser().parse_known_args(argv)
    stages = (list(DEFAULT_STAGES[args.recipe]) if args.stages is None
              else [s for s in args.stages.split(",") if s])
    if not stages or any(s not in CHAIN for s in stages):
        raise ValueError(f"--stages takes a list of {','.join(CHAIN)}, got "
                         f"{args.stages!r}")
    if stages != [s for s in CHAIN if s in stages]:
        raise ValueError(f"--stages must keep the chain's order {CHAIN}")
    if args.recipe == "usc" and not set(stages) <= set(DEFAULT_STAGES["usc"]):
        raise ValueError(f"--recipe usc runs the stages {DEFAULT_STAGES['usc']}, "
                         f"got {stages}")
    return args, stages, common


def iterations_of(model_path: str):
    """The iterations N of the iteration_N directories under
    <model>/point_cloud."""
    folder = os.path.join(model_path, "point_cloud")
    if not os.path.isdir(folder):
        return []
    return [int(d.split("_")[-1]) for d in os.listdir(folder) if d.startswith("iteration_")]


def last_iteration(model_path: str) -> int:
    """The highest iteration_N under <model>/point_cloud (the scripts'
    `ls | sed | sort -n | tail -1`)."""
    its = iterations_of(model_path)
    if not its:
        raise FileNotFoundError(f"no checkpoint under {model_path}/point_cloud")
    return max(its)


def run_dir(args) -> str:
    """The directory beside the model directory's (the scripts' $RUN)."""
    return os.path.dirname(os.path.normpath(args.model_path))


def eval_argv(args, model_dir):
    """The eval driver on the last checkpoint of `model_dir`, with its
    image metrics."""
    ply = os.path.join(model_dir, "point_cloud", f"iteration_{last_iteration(model_dir)}",
                       "point_cloud.ply")
    return ["-s", args.source_path, "-p", ply, "-pt", "gs", "-m", model_dir,
            "--data_device", args.data_device]


def grow_argv(args, out, base_iter=0):
    """The grow driver on `base_iter` of the model directory (0: its
    latest), into `out`."""
    base = ["--base_iter", str(base_iter)] if base_iter else []
    return ["-s", args.source_path, "-m", args.model_path, *base, "--out", out,
            "--data_device", args.data_device]


def stage_argv(stage, args, common):
    """The argv of one stage's driver (the first for grow, whose evaluation
    follows); the eval stage's names the last checkpoint, so build it after
    the stages before it ran."""
    scene = ["-s", args.source_path]
    dev = ["--data_device", args.data_device]
    if stage in ("stage1", "stage3"):
        return [*scene, "-m", args.model_path, *common, *dev]
    if stage == "merge":
        return [*scene, "-m", args.model_path, *dev]
    if stage == "grow":
        return grow_argv(args, os.path.join(run_dir(args), "grown_postmerge"),
                         last_iteration(args.model_path))
    return eval_argv(args, args.model_path)


def stage_module(stage) -> str:
    name = {"stage1": "train", "stage3": "train", "grow": "grow_and_save",
            "grow_final": "grow_and_save", "sample": "synthesize_usc_sample",
            "parse": "parse_usc_hairsalon"}.get(stage, "eval" if "eval" in stage else stage)
    return "hairgs_tpu_torch.drivers." + name


def split_iterations(common):
    """(the --iterations among the train flags, default 30000; the rest)."""
    p = ArgumentParser(add_help=False, allow_abbrev=False)
    p.add_argument("--iterations", type=int, default=RECIPE_1K_TARGET)
    known, rest = p.parse_known_args(common)
    return known.iterations, rest


def read_post_merge(args):
    """The post-merge iteration the 1k recipe's merge recorded, or None."""
    path = os.path.join(run_dir(args), "post_merge_iter.txt")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return int(f.read().split()[0])


def recipe_1k_steps(stage, args, common):
    """run_reference_schedule_1k.sh's step(s) for one stage, decided from
    the run directory as it is now: a list of (name, argv maker, file the
    output also goes to, action after success), or a string saying why the
    stage is skipped."""
    n, rest = split_iterations(common)
    run = run_dir(args)
    its = iterations_of(args.model_path)
    cur = max(its, default=0)
    post_merge = read_post_merge(args)

    def train(target, extra):
        if cur >= target:
            return f"the latest checkpoint {cur} reached {target}"
        return [(stage, lambda: ["-s", args.source_path, "-m", args.model_path,
                                 *RECIPE_1K_COMMON, *extra, *rest,
                                 "--iterations", str(target - cur),
                                 "--data_device", args.data_device], None, None)]

    if stage == "stage1":
        return train(n, [])
    if stage == "merge":
        if post_merge is not None or cur != n:
            return (f"post_merge_iter.txt holds {post_merge}" if post_merge is not None
                    else f"the latest checkpoint is {cur}, not {n}")

        def record():
            with open(os.path.join(run, "post_merge_iter.txt"), "w") as f:
                f.write(f"{last_iteration(args.model_path)}\n")
        return [("merge", lambda: stage_argv("merge", args, common), None, record)]
    if post_merge is None:
        return "no post_merge_iter.txt: the merge has not run"
    if stage == "grow":
        if os.path.exists(os.path.join(run, "growth_eval.txt")):
            return "growth_eval.txt exists"
        out = os.path.join(run, "grown_postmerge")
        return [("grow", lambda: grow_argv(args, out, post_merge), None, None),
                ("grow_eval", lambda: eval_argv(args, out),
                 os.path.join(run, "growth_eval.txt"), None)]
    if stage == "stage3":
        return train(post_merge + n, RECIPE_1K_STAGE3)

    def done():
        with open(os.path.join(run, "done.txt"), "w") as f:
            f.write(time.strftime("%c") + "\n")
    out = os.path.join(run, "grown_final")
    return [("eval", lambda: eval_argv(args, args.model_path),
             os.path.join(run, "final_eval.txt"), None),
            ("grow_final", lambda: grow_argv(args, out), None, None),
            ("grow_final_eval", lambda: eval_argv(args, out),
             os.path.join(run, "grown_final_eval.txt"), done)]


def usc_scene_steps(args):
    """usc_dress_rehearsal.sh's steps 0-1 (recipe_1k_steps' form): the
    sample into <run>/raw unless its .data file is there, then the parse
    into the parent of -s unless -s holds a COLMAP scene."""
    run = run_dir(args)
    raw = os.path.join(run, "raw")
    dataset, sample = os.path.split(os.path.normpath(args.source_path))
    if sample != f"{USC_SAMPLE:05d}":
        raise ValueError(f"--recipe usc parses sample {USC_SAMPLE} into the parent of -s, "
                         f"so -s must end in {USC_SAMPLE:05d}: {args.source_path}")
    steps = []
    if not os.path.exists(os.path.join(raw, "hairstyles", f"strands{USC_SAMPLE:05d}.data")):
        steps.append(("sample", lambda: ["--out", raw, "--sample", str(USC_SAMPLE)],
                      os.path.join(run, "synth.log"), None))
    if not os.path.exists(os.path.join(args.source_path, "sparse", "0", "points3D.bin")):
        steps.append(("parse", lambda: ["-d", raw, "-o", dataset, "--samples",
                                        str(USC_SAMPLE), *USC_PARSE,
                                        "--device", args.data_device],
                      os.path.join(run, "parse.log"), None))
    return steps


def recipe_usc_steps(stage, args, common):
    """usc_dress_rehearsal.sh's steps 2-3 (recipe_1k_steps' form): Stage I
    unless the model directory has a point_cloud/, the eval driver on its
    last PLY unless eval.txt is there; done.txt after the eval."""
    run = run_dir(args)
    if stage == "stage1":
        if os.path.isdir(os.path.join(args.model_path, "point_cloud")):
            return f"{args.model_path}/point_cloud exists"
        return [("stage1", lambda: ["-s", args.source_path, "-m", args.model_path,
                                    *USC_STAGE1, *common, "--data_device", args.data_device],
                 os.path.join(run, "fit.log"), None)]
    if not iterations_of(args.model_path):
        return "no checkpoint to evaluate"
    if os.path.exists(os.path.join(run, "eval.txt")):
        return "eval.txt exists"

    def done():
        with open(os.path.join(run, "done.txt"), "w") as f:
            f.write(time.strftime("%c") + "\n")
    return [("eval", lambda: eval_argv(args, args.model_path), os.path.join(run, "eval.txt"),
             done)]


def stage_steps(stage, args, common):
    """The steps of one stage (recipe_1k_steps' form)."""
    if args.recipe == "1k":
        return recipe_1k_steps(stage, args, common)
    if args.recipe == "usc":
        return recipe_usc_steps(stage, args, common)
    steps = [(stage, lambda: stage_argv(stage, args, common), None, None)]
    if stage == "grow":
        out = os.path.join(run_dir(args), "grown_postmerge")
        steps.append(("grow_eval", lambda: eval_argv(args, out),
                      os.path.join(run_dir(args), "growth_eval.txt"), None))
    return steps


def write_reference_scene(path: str, device: str = "cuda", size: int = 512):
    """run_reference_schedule.sh's scene at size x size pixels, rendered on
    `device`; prints the GT segment count and the worst overflow counters
    over the views (a GT render that drops pairs drops strands)."""
    from hairgs_tpu_torch.data.synthetic import (
        default_gt_config,
        generate_dataset,
        synthetic_test_hair,
    )

    s = SYNTHETIC
    hair = synthetic_test_hair(num_strands=s["num_strands"],
                               points_per_strand=s["points_per_strand"], seed=s["seed"])
    overflow = []
    cfg = default_gt_config(device)
    generate_dataset(path, hair, num_cameras=s["num_cameras"], width=size,
                     height=size, raster_cfg=cfg, device=device, overflow=overflow)
    worst = {k: max(v[k] for v in overflow) for k in overflow[0]}
    print("dataset done:", path, hair.edges.shape[0], "GT segments; worst over "
          f"{len(overflow)} views {worst}", flush=True)
    if cfg.use_pallas:
        from hairgs_tpu_torch.render.composite_pairs import launches

        print(f"[kernels] launches {launches}", flush=True)


def run_child(cmd, env, tee=None) -> int:
    """One child process; with `tee`, its output (stderr too) also goes to
    that file, as the scripts' `> file 2>&1`."""
    if tee is None:
        return subprocess.call(cmd, env=env)
    with open(tee, "w") as f, subprocess.Popen(
            cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) as p:
        for line in p.stdout:
            sys.stdout.write(line)
            f.write(line)
        sys.stdout.flush()
    return p.returncode


def run(argv=None) -> int:
    """Run the chain as child processes; returns the first non-zero exit
    code, or 0."""
    args, stages, common = parse(sys.argv[1:] if argv is None else argv)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    size = RECIPE_1K_SIZE if args.recipe == "1k" else SYNTHETIC["width"]

    def step(name, title, argv, tee=None):
        cmd = [sys.executable, *argv]
        print(f"=== {title} ===\n{shlex.join(cmd)}", flush=True)
        t0 = time.perf_counter()
        rc = run_child(cmd, env, tee)
        print(f"[pipeline] {name} exited {rc} after {time.perf_counter() - t0:.1f} s",
              flush=True)
        return rc

    def chain():
        """(stage, its steps), each decided when the stages before it ran."""
        if args.recipe == "usc":
            os.makedirs(run_dir(args), exist_ok=True)
            yield "scene", usc_scene_steps(args)
        for stage in stages:
            yield stage, stage_steps(stage, args, common)

    t_all = time.perf_counter()
    if args.recipe != "usc" and (args.synthetic or args.recipe == "1k") and not os.path.exists(
            os.path.join(args.source_path, "sparse", "0", "points3D.bin")):
        code = ("import sys; from hairgs_tpu_torch.drivers.pipeline import "
                "write_reference_scene as w; w(sys.argv[1], sys.argv[2], int(sys.argv[3]))")
        rc = step("scene", f"Generating synthetic dataset (150 strands, 16 cams, {size}^2)",
                  ["-c", code, args.source_path, args.data_device, str(size)])
        if rc:
            return rc
    for stage, steps in chain():
        if isinstance(steps, str):
            print(f"[pipeline] {stage} skipped: {steps}", flush=True)
            continue
        for name, make, tee, after in steps:
            rc = step(name, TITLES[name], ["-m", stage_module(name), *make()], tee)
            if rc:
                return rc
            if after is not None:
                after()
    print(f"=== DONE === ({time.perf_counter() - t_all:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(run())
