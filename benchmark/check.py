"""How `correct` is decided for a training cell: the plain reference
(reference/) follows the first steps that `training()` took in set-up, from
the initial parameters it works out itself from the benchmark's inputs (the
capture's point cloud, or the strand graph a Stage-III traffic starts
from), on the views the program drew, and three numbers are compared, each
with its limit:

    loss    the largest relative gap of a step's total loss
    grad    the first gradient, as Adam's first moment holds it after one
            step (mu / 0.1), and the viewspace-gradient norms that the
            densification statistics add up in that step: per leaf the gap
            between the program's norm and the reference's, over the
            larger of the reference's norm of that leaf and of the median
            leaf; the worst leaf
    change  the same measure of each leaf's change over the steps, leaves
            whose reference gradient is under a thousandth of the median
            leaf's left out (Adam moves those by round-off alone)

with `loss_first` (the first step's loss gap) and the median leaf's gaps
(`grad_median`, `change_median`; `grad_median_kept` over the splats whose
tiles no budget or cap cut in the first step, where a last-bit difference
cannot flip which pairs are kept). A cell's limits file names the numbers
it compares.

The views are identified by the statistics: after each step the program
holds the largest screen radius each Gaussian reached so far, and the
reference takes the view whose radii, from its own state, fold into it.
A step whose view matches on fewer than VIEW_MATCH of the Gaussians
fails the run.
"""

import math
from typing import Dict

import torch

from benchmark.reference import stage1 as ref
from benchmark.reference import stage3

OUT_RULE = 1e-3  # leaves with a reference gradient under this x the median's
VIEW_MATCH = 0.95


def leaf_gaps(prog: Dict[str, torch.Tensor], refs: Dict[str, torch.Tensor]):
    norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in refs.items()}
    med = sorted(norms.values())[len(norms) // 2]
    gaps = {}
    for k, v in refs.items():
        p = float(torch.linalg.vector_norm(prog[k].double()))
        gaps[k] = abs(p - norms[k]) / max(norms[k], med, 1e-30)
    return gaps, norms


def compare(prog: ref.Readout, refr: ref.Readout, kept=None):
    """{number: value} and the per-leaf readings behind them. With `kept`,
    a bool per splat, also `grad_median_kept`: `grad_median` over the rows
    of the splats it holds, in the leaves of one row per splat."""
    gaps = [abs(a - b) / abs(b) for a, b in zip(prog.losses, refr.losses)]
    g_gaps, g_norms = leaf_gaps(prog.grads, refr.grads)
    accum_ref = float(torch.linalg.vector_norm(refr.grad_accum.double()))
    accum_prog = float(torch.linalg.vector_norm(prog.grad_accum.double()))
    g_gaps["grad_accum"] = abs(accum_prog - accum_ref) / max(accum_ref, 1e-30)
    kept_gaps = {}
    if kept is not None:
        both = {k: (prog.grads[k], refr.grads[k]) for k in refr.grads
                if refr.grads[k].shape[0] == kept.shape[0]}
        both["grad_accum"] = (prog.grad_accum, refr.grad_accum)
        kept_gaps, _ = leaf_gaps({k: p[kept] for k, (p, _) in both.items()},
                                 {k: r[kept] for k, (_, r) in both.items()})
    med = sorted(g_norms.values())[len(g_norms) // 2]
    moved = [k for k in refr.grads if g_norms[k] >= OUT_RULE * med]
    c_gaps, c_norms = leaf_gaps({k: prog.changes[k] for k in moved},
                                {k: refr.changes[k] for k in moved})
    numbers = {"loss": max(gaps), "loss_first": gaps[0], "grad": max(g_gaps.values()),
               "grad_median": sorted(g_gaps.values())[len(g_gaps) // 2],
               "change": max(c_gaps.values()),
               "change_median": sorted(c_gaps.values())[len(c_gaps) // 2]}
    if kept_gaps:
        numbers["grad_median_kept"] = sorted(kept_gaps.values())[len(kept_gaps) // 2]
    detail = {"numbers": dict(numbers), "grad_gaps": g_gaps, "change_gaps": c_gaps,
              "kept_gaps": kept_gaps, "grad_norms": g_norms,
              "change_norms": c_norms, "left_out": [k for k in refr.grads if k not in moved],
              "losses_prog": list(prog.losses), "losses_ref": list(refr.losses)}
    return numbers, detail


def initial_pair_capacity(rt, arena_rows: int, num_tiles: int) -> int:
    """The pair capacity the driver's first step uses: 0 (the worst-case
    table) for a negative flag, the flag when positive, else about three
    tiles per row plus a chunk of padding per tile, in granule steps."""
    if rt["pair_capacity"] < 0:
        return 0
    if rt["pair_capacity"] > 0:
        return rt["pair_capacity"]
    est = 3 * arena_rows + (num_tiles + 1) * rt["composite_chunk"]
    want = int(est / 1.25 * 1.25)
    granule = rt["pair_capacity_round"]
    return (want + granule - 1) // granule * granule


def reference_inputs(cap: dict, opt: dict, device, graph: dict = None):
    """(views, initial leaves, reference model): the Gaussians of the
    initial point cloud, or with `graph` (a Stage-III start) its segments."""
    views = [ref.make_view(c, m, device) for c, m in zip(cap["cameras"], cap["views"])]
    if graph is None:
        return views, ref.initial_leaves(cap["points"], cap["colours"], device), ref.GAUSSIANS
    return (views, stage3.initial_leaves(graph, device),
            stage3.hair_model(graph, opt, device))


def raster(rt: dict, arena_rows: int, view) -> dict:
    nt = ((view.width + 15) // 16) * ((view.height + 15) // 16)
    return dict(max_tiles=rt["max_tiles_per_gaussian"], max_pairs=rt["max_pairs_per_tile"],
                chunk=rt["composite_chunk"],
                pair_capacity=initial_pair_capacity(rt, arena_rows, nt),
                adaptive_capacity=rt["pair_capacity"] == 0,
                granule=rt["pair_capacity_round"], alpha_min=rt["alpha_min"])


def arena_rows(count: int, capacity_round: int) -> int:
    return max(capacity_round, math.ceil(count / capacity_round) * capacity_round)


def follow(cap: dict, opt: dict, rt: dict, device, order=None, held=None,
           precision: str = "fp32", fault: str = None, inputs=None,
           graph: dict = None) -> ref.Followed:
    """The reference's run of the followed steps, on the views of `order`
    or on those the program's held maximum radii identify; from the initial
    point cloud, or from the strand graph `graph`."""
    views, p0, model = inputs or reference_inputs(cap, opt, device, graph)
    rows = arena_rows(p0["opacity"].shape[0], rt["capacity_round"])
    return ref.run_steps(p0, views, raster(rt, rows, views[0]), opt,
                         ref.camera_extent(cap["cameras"]), rows, order=order,
                         held=held, precision=precision, fault=fault, model=model)


def program_readout(first: dict, leaves) -> ref.Readout:
    mu = first["mu1"]
    p0, p3 = first["p0"], first["p3"]
    return ref.Readout(losses=list(first["losses"]),
                       grads={k: mu[k] / (1 - 0.9) for k in leaves},
                       changes={k: p3[k] - p0[k] for k in leaves},
                       grad_accum=first["grad_accum"])


def judge(numbers: dict, limits: dict):
    """(correct, [(name, value, limit)]): every number at or under its
    limit; a number that is not finite fails."""
    rows = [(k, numbers[k], limits[k]) for k in limits]
    ok = all(math.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
