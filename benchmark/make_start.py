#!/usr/bin/env python3
"""Make a configuration's fitted Stage-III start, once, on a CUDA device:

    python3 benchmark/make_start.py --config <name> --commit <the port's commit> \
        [--out <archive>]

It makes the capture of the configuration's `fitted_start.capture_seed`
(capture.py) and writes it with a head reconstruction whose scalp is the
GT strand roots, runs the program's Stage I on it through `training()`
for the driver's iterations at its defaults (`--logger none`), then the
program's Stage II (`drivers/merge.py::main`) in process, reads the merged
5-element hair PLY back and writes the strand graph as a compressed numpy
archive with the keys `harness.load_graph` reads (default: the
configuration's `fitted_start.file`). It prints the Gaussians at the end
of Stage I, the segments, endpoints and strands after the merge, the
graph's joints, the wall time of each stage, the card and the commit, and
ends with one JSON line of them.

Stage I runs the program's eager step: its graphed step (train/graphed.py),
whose results are the eager step's bit for bit, ran out of the card's 80 GB
at iteration ~13 100 of this capture, with 36.8 GiB held in the graphs'
memory pool. The scene and both models go to `.bench_start/<config>/`. The
archive is frozen data: the benchmark reads it and never remakes it."""

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def joints(graph: dict) -> dict:
    """Degrees and components of the foreground segments, which the
    program's strand walk and the reference's smoothness term read: the
    largest endpoint degree and the components with no free end (cycles)."""
    import numpy as np
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    from benchmark.reference.stage3 import foreground

    fg = foreground(graph)
    pairs = graph["endpoint_pairs"][fg]
    n = graph["endpoints"].shape[0]
    deg = np.bincount(pairs.ravel(), minlength=n)
    adj = coo_matrix((np.ones(len(pairs)), (pairs[:, 0], pairs[:, 1])), shape=(n, n))
    _, label = connected_components(adj, directed=False)
    used = deg > 0
    free = np.zeros(label.max() + 1, bool)
    free[label[used & (deg == 1)]] = True
    comps = np.unique(label[used])
    return {"foreground_segments": int(fg.sum()), "max_degree": int(deg.max()),
            "cycles": int((~free[comps]).sum())}


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return ""


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True, help="a file name under benchmark/configs")
    p.add_argument("--commit", required=True, help="the commit of the program that runs")
    p.add_argument("--out", help="the archive (default: the configuration's)")
    a = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from benchmark import capture, harness
    from hairgs_tpu_torch.drivers import merge
    from hairgs_tpu_torch.drivers.train import training
    from hairgs_tpu_torch.io.npz import save_head_reconstruction_data_npz
    from hairgs_tpu_torch.io.ply import load_hair_ply
    from hairgs_tpu_torch.train import graphed

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    with open(os.path.join(ROOT, "benchmark", "configs", f"{a.config}.json")) as fh:
        config = json.load(fh)
    fitted = config["fitted_start"]
    out = a.out or os.path.join(ROOT, fitted["file"])
    work = os.path.join(ROOT, ".bench_start", a.config)
    scene, model = os.path.join(work, "scene"), os.path.join(work, "model")
    flags = ["-s", scene, "-m", model, *config.get("flags", [])]
    record = {"config": a.config, "capture_seed": fitted["capture_seed"],
              "commit": a.commit, "card": card()}

    t0 = time.perf_counter()
    cap = capture.make(config, fitted["capture_seed"], dev)
    capture.write(cap, scene)
    roots = cap["strands"][0][:, 0].cpu().numpy().astype(np.float32)
    save_head_reconstruction_data_npz(os.path.join(scene, "head_reconstruction_data.npz"),
                                      roots, roots)
    record["capture_s"] = time.perf_counter() - t0

    args, (mp, op, gp, rt) = harness.port_args([*flags, "--logger", "none"])
    graphed.CudaGraphs.supports = staticmethod(lambda t: False)  # the eager step
    os.makedirs(model, exist_ok=True)
    harness.seed_all(fitted["capture_seed"])
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        _, gaussians = training(mp, op, gp, rt, args)
    torch.cuda.synchronize(dev)
    record.update(stage1_iterations=op.iterations, stage1_s=time.perf_counter() - t1,
                  stage1_gaussians=int(gaussians.count))
    del gaussians
    torch.cuda.empty_cache()

    t2 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        res = merge.main(merge.build_parser().parse_args(flags))
    record["merge_s"] = time.perf_counter() - t2
    record["converted_segments"], _, record["converted_strands"] = res["converted"]
    record["merge_iterations"] = res["iterations"]
    record["strands"] = len(res["hair"].strands_info.list_strands)
    del res["hair"]

    arrays, root_idx, ref_root = load_hair_ply(res["path"], 0)
    graph = dict(endpoints=arrays["endpoints"],
                 endpoint_pairs=arrays["endpoint_pairs"].astype(np.int64),
                 features_dc=arrays["features_dc"], opacity=arrays["opacity"],
                 mask=arrays["mask"], width=arrays["width"], strand_root_idx=root_idx,
                 ref_strand_root=ref_root)
    assert set(graph) == set(harness.GRAPH_KEYS)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez_compressed(out, **graph)
    record.update(segments=int(graph["endpoint_pairs"].shape[0]),
                  endpoints=int(graph["endpoints"].shape[0]),
                  archive_bytes=os.path.getsize(out),
                  array_bytes={k: int(v.nbytes) for k, v in graph.items()},
                  **joints(graph))
    print(f"[start] Stage I: {record['stage1_gaussians']} Gaussians at "
          f"{op.iterations} in {record['stage1_s']:.1f} s; merge: "
          f"{record['segments']} segments, {record['endpoints']} endpoints, "
          f"{record['strands']} strands in {record['merge_s']:.1f} s; "
          f"archive {out} ({record['archive_bytes']} bytes)", flush=True)
    print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main()
