"""One run of one cell: make the capture from the seed, call the program's
`training()` with the traffic's flags and the window logger, read the
end-to-end metrics (and with tracing the per-layer ones, each from its
reader in metrics/), then free the program's state and decide `correct`
with the plain reference.

Everything a cell needs is found by name: BENCHMARK.json names the cell's
configuration (configs/<file>) and traffic (traffic/<traffic>.json); the
per-layer metrics it reports are those whose `workloads` list it, read by
metrics/<metric>.py; the limits of its compared numbers are in
limits/<cell>.json."""

import contextlib
import importlib.util
import json
import os
import random
import shutil
import sys
import tempfile
import time
from argparse import ArgumentParser
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from benchmark import capture, check
from benchmark import trace as trace_mod
from benchmark.window import WindowClosed, WindowLogger, live_rows, splats, tail_s_per_it

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


class Cell(NamedTuple):
    manifest: dict
    cell: dict  # the BENCHMARK.json workload entry
    config: dict
    traffic: dict
    limits: dict


def load_cell(root: str, workload: str) -> Cell:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        manifest = json.load(fh)
    cell = next((w for w in manifest["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload named {workload!r} in BENCHMARK.json")
    conf = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    with open(os.path.join(root, conf["file"])) as fh:
        config = json.load(fh)
    with open(os.path.join(BENCH_DIR, "traffic", f"{cell['traffic']}.json")) as fh:
        traffic = json.load(fh)
    with open(os.path.join(BENCH_DIR, "limits", f"{workload}.json")) as fh:
        limits = json.load(fh)
    return Cell(manifest, cell, config, traffic, limits)


def reported(metrics, workload):
    return [m for m in metrics if workload in m.get("workloads", [workload])]


def reader(name: str):
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def port_args(argv):
    """The driver's flags parsed as its command line parses them."""
    from hairgs_tpu_torch import config as pc

    classes = (pc.ModelConfig, pc.OptimizationConfig, pc.GeneralConfig, pc.RuntimeConfig)
    parser = ArgumentParser()
    for c in classes:
        pc.add_config_args(parser, c)
    args = parser.parse_args(argv)
    return args, [pc.extract_config(args, c) for c in classes]


@dataclass
class Context:
    """What the per-layer readers read."""
    logger: WindowLogger
    trace: trace_mod.Trace
    model: object
    args: object
    cameras: list  # the capture's cameras (qvec, tvec, focal, width, height)
    device: torch.device
    seed: int
    _tables: dict = field(default_factory=dict)

    @property
    def window_s(self):
        return self.logger.t_close - self.logger.t_open

    @property
    def tail_s_per_it(self):
        """Wall seconds per iteration of the window's stretch next to the
        profiled one, as many iterations long or a little longer."""
        return tail_s_per_it(self.logger, self.traced_its)

    @property
    def traced_its(self):
        return len(self.logger.prof_rows)

    @property
    def splats(self) -> int:
        """Gaussians, or a strand graph's segments, of the model."""
        return splats(self.model)

    @property
    def parameters(self) -> int:
        """Parameter elements the optimiser steps."""
        rows = live_rows(self.model)
        return sum(rows[k] * v[0].numel() for k, v in self.model.params._asdict().items())

    def raster(self):
        from hairgs_tpu_torch.render.renderer import RasterConfig

        a = self.args
        return RasterConfig(max_tiles_per_gaussian=a.max_tiles_per_gaussian,
                            max_pairs_per_tile=a.max_pairs_per_tile, chunk=a.composite_chunk,
                            use_pallas=True, feat_bf16=a.feat_bf16,
                            antialiasing=a.antialiasing, alpha_min=a.alpha_min,
                            viewspace_stats=a.densify_until_iter > 1)

    def camera(self, v: int):
        from hairgs_tpu_torch.core.camera import focal2fov, make_camera

        c = self.cameras[v]
        R = capture.qvec2rotmat(c["qvec"]).T
        return make_camera(R, np.asarray(c["tvec"]), focal2fov(c["focal"], c["width"]),
                           focal2fov(c["focal"], c["height"]), device=self.device)

    def table(self, v: int):
        """(geo rows, feature rows, starts, counts, grid_w, C) of view v's
        paged pair table from the model state, as the step builds it (view
        0's is kept for the readers that share it)."""
        if v not in self._tables:
            from hairgs_tpu_torch.models.gaussian import gaussian_render_inputs
            from hairgs_tpu_torch.models.hair import hair_render_inputs
            from hairgs_tpu_torch.render.renderer import paged_pair_table

            cam, m, c = self.camera(v), self.model, self.cameras[v]
            with torch.no_grad():
                if hasattr(m, "graph"):
                    inputs = hair_render_inputs(m.params, m.graph, cam.cam_center,
                                                m.active_sh_degree, m.dist_to_scale_factor)
                    active = m.graph.seg_active
                else:
                    inputs = gaussian_render_inputs(m.params, cam.cam_center,
                                                    m.active_sh_degree)
                    active = m.active
                _, b, geo, feat = paged_pair_table(
                    cam, **inputs, cov3d_precomp=None, active=active,
                    mean2d_offset=None, scale_modifier=1.0, width=c["width"],
                    height=c["height"], config=self.raster())
            table = (geo, feat, b.starts, b.counts, (c["width"] + 15) // 16,
                     inputs["features"].shape[1])
            if v != 0:
                return table
            self._tables[v] = table
        return self._tables[v]


def seed_all(seed: int):
    random.seed(seed)
    np.random.seed(seed % 2**32)
    torch.manual_seed(seed)


def run(spec: Cell, seed: int, seconds: float, traced: bool, t_start: float,
        device="cuda"):
    """(result dict without `correct`, compared rows, correct)."""
    from hairgs_tpu_torch.drivers.train import training

    t_begin = time.perf_counter()
    manifest, cell, config, traffic, limits = spec
    workload = cell["name"]
    dev = torch.device(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    work = tempfile.mkdtemp(prefix=f"hairbench_{workload}_")
    try:
        cap, graph = start(config, traffic, seed, dev)
        sync()
        t_made = time.perf_counter()
        capture.write(cap, os.path.join(work, "scene"))
        if graph is not None:  # the hair checkpoint a Stage-III `Scene` loads
            block = config[START_BLOCKS[traffic["start"]]]
            capture.write_hair_ply(os.path.join(
                work, "model", "point_cloud", f"iteration_{block['iteration']}",
                "point_cloud.ply"), graph)
        t_written = time.perf_counter()
        print(f"[bench] set-up: imports {t_begin - t_start:.3f} s, capture made "
              f"{t_made - t_begin:.3f} s, written {t_written - t_made:.3f} s",
              file=sys.stderr)
        argv = ["-s", os.path.join(work, "scene"), "-m", os.path.join(work, "model"),
                "--data_device", dev.type, *config.get("flags", []), *traffic["flags"]]
        args, (mp, op, gp, rt) = port_args(argv)
        os.makedirs(args.model_path, exist_ok=True)
        initial_rt = rt_values(args)  # the controllers change args
        logger = WindowLogger(rt, seconds, traffic["warmup_iterations"],
                              traffic["log_interval"], traced, sync,
                              profile_max=traffic.get("profile_max_iterations", 250))
        seed_all(seed)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        try:
            with contextlib.redirect_stdout(sys.stderr):
                training(mp, op, gp, rt, args, logger=logger)
        except WindowClosed:
            pass
        else:
            raise RuntimeError("training() ended before the window closed")
        sync()
        setup_s = logger.t_open - t_start
        rows = logger.rows
        k = max(1, len(rows) // 6)
        slices = [(rows[i + k - 1][0] - rows[i][0]) / max(rows[i + k - 1][1] - rows[i][1], 1e-9)
                  for i in range(0, len(rows) - k + 1, k)]
        print("[bench] window it/s by sixths: " + " ".join(f"{r:.2f}" for r in slices),
              file=sys.stderr)
        print("[bench] splats at the sixths' ends: "
              + " ".join(str(rows[min(i + k, len(rows)) - 1].splats)
                         for i in range(0, len(rows) - k + 1, k)), file=sys.stderr)
        print(f"[bench] set-up: training() to the window {logger.t_open - t_written:.3f} s "
              f"({logger.it_open} warm-up iterations); set-up {setup_s:.3f} s",
              file=sys.stderr)
        values = {traffic["rate_metric"]: logger.it_s, "setup_s": setup_s}
        result = {"attempted": logger.it_close - logger.it_open, "failed": 0}
        if traced:
            tr = trace_mod.read(logger.prof)
            ctx = Context(logger, tr, logger.model, args, cap["cameras"], dev, seed)
            values = {}
            for m in reported(manifest["per_layer"], workload):
                v = reader(m["name"])(ctx)
                if v is not None:
                    values[m["name"]] = v
            result["breakdown"] = {"device_ops": tr.device_ops, "idle_gaps": tr.idle_gaps}
            result["busy_s"] = tr.busy_s
            result["window_s"] = logger.t_prof_end - logger.t_prof
            del ctx
        units = {m["name"]: m["unit"] for m in manifest["end_to_end"] + manifest["per_layer"]}
        result["metrics"] = {k: {"value": v, "unit": units[k]} for k, v in values.items()}
        result["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                       if dev.type == "cuda" else 0)
        first = logger.first
        logger.model = logger.prof = None  # free the program's state
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        correct, rows, fol, prog = judge_first_steps(cap, args, first, initial_rt, limits,
                                                     dev, graph)
        result["check"] = {"followed": fol, "program": prog}
        return result, rows, correct
    finally:
        shutil.rmtree(work, ignore_errors=True)


def opt_values(args) -> dict:
    keys = ("lambda_dssim", "lambda_mask", "lambda_orientation", "lambda_smooth", "pval",
            "feature_lr", "scaling_lr", "rotation_lr", "opacity_lr", "mask_lr",
            "position_lr_init", "position_lr_final", "position_lr_max_steps")
    return {k: getattr(args, k) for k in keys}


def rt_values(args) -> dict:
    keys = ("max_tiles_per_gaussian", "max_pairs_per_tile", "composite_chunk",
            "pair_capacity", "pair_capacity_round", "capacity_round", "alpha_min")
    return {k: getattr(args, k) for k in keys}


# the configuration block that describes each Stage-III start
START_BLOCKS = {"merged_graph": "merged_graph", "fitted_graph": "fitted_start"}
# the arrays of a strand graph start, as capture.merged_graph returns them
GRAPH_KEYS = ("endpoints", "endpoint_pairs", "features_dc", "opacity", "mask", "width",
              "strand_root_idx", "ref_strand_root")


def start(config, traffic, seed, dev):
    """(capture, graph) of the traffic's start. `initial_points`: the
    capture of `seed` and no graph (Stage I from its point cloud).
    `merged_graph`: the capture of `seed` and the strand graph generated
    from it along the GT strands. `fitted_graph`: the capture of the
    configuration's `fitted_start.capture_seed`, whatever `seed`, and the
    strand graph that the program fitted to it, read from the archive
    `fitted_start.file` (a path from the checkout's root); `seed` still
    seeds training and the reference."""
    kind = traffic["start"]
    if kind not in ("initial_points", *START_BLOCKS):
        raise ValueError(f"unknown start {kind!r}")
    if kind == "fitted_graph":
        fitted = config["fitted_start"]
        cap = capture.make(config, fitted["capture_seed"], dev)
        return cap, load_graph(os.path.join(ROOT, fitted["file"]))
    cap = capture.make(config, seed, dev)
    if kind == "initial_points":
        return cap, None
    return cap, capture.merged_graph(config["merged_graph"], cap, seed, dev)


def load_graph(path: str) -> dict:
    """The strand graph of a fitted-start archive (`make_start.py`)."""
    with np.load(path) as z:
        return {k: z[k] for k in GRAPH_KEYS}


def judge_first_steps(cap, args, first, initial_rt, limits, dev, graph=None):
    """Follow the program's first steps with the reference and judge:
    (correct, [(name, value, limit)], the reference's run, the program's
    readout). The first row is the least share of splats whose held radii
    name the view the reference took (a floor: under it the run fails)."""
    fol = check.follow(cap, opt_values(args), initial_rt, dev, held=first["max_radii"],
                       graph=graph)
    match = [("view_match", min(fol.agree), check.VIEW_MATCH)]
    if min(fol.agree) < check.VIEW_MATCH:
        return False, match, fol, None
    prog = check.program_readout(first, fol.readout.grads)
    numbers, _ = check.compare(prog, fol.readout, kept=~(fol.truncated | fol.capped))
    correct, rows = check.judge(numbers, limits)
    return correct, match + rows, fol, prog
