#!/usr/bin/env python3
"""The readings that the limits of a cell's compared numbers are set from,
in one process (set-up is long):

    python3 benchmark/calibrate.py --workload <name> --seeds 12 --controls 3 \
        --out calibrate_<name>.json

For each seed the program's first steps in `training()` (a one-second
window), judged as a run judges them; for the first `--controls` seeds
also the control (the reference computed in TF32 in the program's place)
and the planted fault (half of the pixels left out of the loss, the mean
taken over the rest), each against the reference in float32. A state left
unchanged reads 1 on `change` by its definition and needs no run. Each
control and fault is judged against the cell's limits as a run is judged,
and must come out not correct. Beside the numbers it prints, per seed, the
per-leaf gaps and where the first gradients differ (`where_grads_differ`).
The benchmark's own runs never run this."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def where_grads_differ(prog, refr, truncated, capped, top: int = 5):
    """Per leaf of one row per splat: the shares of the first gradient's
    squared difference that sit on splats the tile budget cut and on splats
    near a tile cap's cut (discrete choices that rounding can flip), and
    the rows that differ most."""
    out = {}
    for k in refr.grads:
        if refr.grads[k].shape[0] != truncated.shape[0]:
            continue  # not one row per splat (a strand graph's endpoints)
        d = (prog.grads[k] - refr.grads[k]).reshape(refr.grads[k].shape[0], -1)
        d2 = (d.double() ** 2).sum(dim=1)
        total = float(d2.sum())
        rows = torch.topk(d2, min(top, d2.numel())).indices
        out[k] = {"cut_share": float(d2[truncated].sum()) / total if total else 0.0,
                  "cap_share": float(d2[capped].sum()) / total if total else 0.0,
                  "top_rows": rows.tolist(), "top_cut": truncated[rows].tolist(),
                  "top_capped": capped[rows].tolist()}
    return out


def planted(spec, seed, fol, device):
    """{control_tf32: numbers, fault_half_batch: numbers} of one seed: the
    reference in TF32 and the reference with half of the pixels left out,
    each in the program's place, judged against the reference in float32
    on the views the program drew."""
    from benchmark import capture, check, harness

    cap = capture.make(spec.config, seed, device)
    graph = harness.start_graph(spec.config, spec.traffic, cap, seed, device)
    args, _ = harness.port_args(["-s", "", *spec.config.get("flags", []),
                                 *spec.traffic["flags"]])
    opt, rt = harness.opt_values(args), harness.rt_values(args)
    inputs = check.reference_inputs(cap, opt, device, graph)
    base = check.follow(cap, opt, rt, device, order=fol.order, inputs=inputs).readout
    kept = ~(fol.truncated | fol.capped)
    out = {}
    for name, kw in (("control_tf32", {"precision": "tf32"}),
                     ("fault_half_batch", {"fault": "half_batch"})):
        other = check.follow(cap, opt, rt, device, order=fol.order, inputs=inputs,
                             **kw).readout
        numbers, detail = check.compare(other, base, kept=kept)
        judged, _ = check.judge(numbers, spec.limits)
        out[name] = dict(numbers, judged_correct=judged, grad_gaps=detail["grad_gaps"],
                         change_gaps=detail["change_gaps"])
    return out


def calibrate(spec, seeds, controls, device, seconds=1.0):
    from benchmark import check, harness

    rows = []
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        result, compared, correct = harness.run(spec, seed, seconds, False, t0,
                                                device=device)
        fol, prog = result["check"]["followed"], result["check"]["program"]
        row = {"seed": seed, "correct": correct,
               "program": {n: v for n, v, _ in compared}, "order": fol.order,
               "agree": fol.agree}
        if prog is not None:
            kept = ~(fol.truncated | fol.capped)
            _, detail = check.compare(prog, fol.readout, kept=kept)
            row.update(detail=detail, kept=int(kept.sum()), splats=int(kept.numel()),
                       where=where_grads_differ(prog, fol.readout, fol.truncated,
                                                fol.capped))
            if i < controls:
                row.update(planted(spec, seed, fol, device))
        rows.append(row)
        print(json.dumps(row, default=str), flush=True)
    return rows


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=3_000_000_017)
    p.add_argument("--out", required=True)
    a = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark import harness

    spec = harness.load_cell(ROOT, a.workload)
    seeds = [a.first_seed + 7919 * k for k in range(a.seeds)]
    rows = calibrate(spec, seeds, a.controls, "cuda")
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "w") as fh:
        json.dump(rows, fh, indent=1)


if __name__ == "__main__":
    main()
