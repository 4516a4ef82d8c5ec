#!/usr/bin/env python3
"""Run one cell of the benchmark once, from the root of a checkout:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

With --trace 0 the last line of standard output carries the cell's
end-to-end metrics; with --trace 1 its per-layer metrics, read from a
profiled stretch after the window. Every run decides `correct` with the
plain reference (reference/) and prints each compared number beside its
limit as the last lines of standard error and under `compared`, the last
key of the result line. The run needs a CUDA device; it exits with code 2
and prints no result without one."""

import time

T_START = time.perf_counter()  # set-up counts from here: imports included

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "hairgs_tpu")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cache_dirs(root: str):
    """Kernel and build caches at fixed paths inside the checkout."""
    base = os.path.join(root, ".bench_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(base, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(base, "triton"))


def forbidden_modules():
    """Loaded modules whose top-level name is that of JAX or the JAX
    package, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_state():
    """The card's name, power limit and draw, SM clock and temperature as
    nvidia-smi reads them (empty where it cannot run)."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,clocks.sm,"
             "temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.strip()


def main(argv=None) -> int:
    opts = parse(argv)
    cache_dirs(ROOT)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import harness

    spec = harness.load_cell(ROOT, opts.workload)
    cell = spec.cell
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, rows, correct = harness.run(spec, opts.seed, opts.seconds, bool(opts.trace),
                                        T_START)
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    print(f"card: {card_state()}")
    result.pop("check")
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"], "memory_peak_bytes": result.pop("memory_peak_bytes")}
    if opts.trace:
        device["busy_s"] = result.pop("busy_s")
        device["window_s"] = result.pop("window_s")
    for name, value, limit in rows:
        bound = "at least" if name == "view_match" else "limit"
        print(f"compared {name} {value!r} {bound} {limit!r}", file=sys.stderr)
    line = {"correct": correct, "attempted": result["attempted"], "failed": result["failed"],
            "metrics": result["metrics"], "device": device}
    if "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    line["compared"] = {name: {"value": value, "limit": limit} for name, value, limit in rows}
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
