"""Oriented-point-cloud reconstruction metrics; the port's own copy of
hairgs_tpu/evaluation/metrics.py (numpy and scipy, run on the host).

Parity target: loss/metrics.py:12-173 — precision / recall / F1 / strand
consistency at paired (distance, angle) thresholds (2mm,20°), (3mm,30°),
(4mm,40°), (4mm,90°), with optional bidirectional angle matching.

The reference iterates point by point over cKDTree ball-query results,
parallelized with a process pool of 8 (loss/metrics.py:113-149). This host
has a single CPU, so instead of process parallelism the grid is made fast
algorithmically: neighbor pairs are enumerated ONCE per matching direction at
the maximum radius (via `cKDTree.sparse_distance_matrix(output_type=
'ndarray')`, which stays in C instead of materializing ~1e8 Python list
entries), and every (distance, angle) threshold plus the strand-consistency
votes are derived from that shared pair stream by masking. Results are
identical to the per-threshold reference loop; the USC-scale bidirectional
grid (990k GT points / 10k strands vs 400k predictions) drops from ~200s to
well under a minute. For in-training cadence use evaluation.device_metrics
(precision/recall/F1 on the accelerator). `processes` is accepted for
signature parity.
"""

from typing import Dict, List, Optional, Tuple

import numpy as np
from scipy.spatial import cKDTree

from hairgs_tpu_torch.io.npz import HairEvalData

DEFAULT_DIST_THS = [2e-3, 3e-3, 4e-3, 4e-3]
DEFAULT_ANGLE_THS = [20, 30, 40, 90]


def _pair_chunks(p1_points: np.ndarray, tree2: cKDTree, rmax: float, chunk: int):
    """Yield (owner, nn, dist) arrays for every pair within `rmax`, enumerated
    in `chunk`-point slices of p1 to bound memory. A per-slice cKDTree +
    `sparse_distance_matrix(output_type='ndarray')` keeps the enumeration in
    C; the reference's query_ball_point path materializes the same pairs as
    Python lists (loss/metrics.py:30-36), which dominates wall time at USC
    scale."""
    for start in range(0, len(p1_points), chunk):
        stop = min(start + chunk, len(p1_points))
        sub = cKDTree(p1_points[start:stop])
        pairs = sub.sparse_distance_matrix(tree2, rmax, output_type="ndarray")
        yield pairs["i"].astype(np.int64) + start, pairs["j"].astype(np.int64), pairs["v"]


def _strand_consistency_score(
    p1_strand: np.ndarray, vote_keys: List[np.ndarray], s2_base: int
) -> float:
    """max-share vote reduction (loss/metrics.py:58-85): votes per (p1 strand,
    p2 strand) pair; each p1 strand scores its best p2 strand's vote share."""
    sids, inv, pts_per_strand = np.unique(
        p1_strand, return_inverse=True, return_counts=True
    )
    max_vote = np.zeros(len(sids))
    if vote_keys:
        # chunks cover disjoint owner ranges, so keys are globally unique
        key = np.concatenate(vote_keys)
        pt, s2 = key // s2_base, key % s2_base
        pair_key = inv[pt].astype(np.int64) * s2_base + s2
        upair, votes = np.unique(pair_key, return_counts=True)
        np.maximum.at(max_vote, upair // s2_base, votes)
    return float((max_vote / pts_per_strand).sum() / len(sids))


def pct_matched_points_multi(
    p1: HairEvalData,
    p2: HairEvalData,
    dist_ths: List[float],
    angle_ths: List[float],
    bidirectional: bool = False,
    compute_strand_consistency: bool = False,
    chunk: int = 200_000,
) -> Tuple[np.ndarray, List[Optional[float]]]:
    """All thresholds in ONE neighbor enumeration at max(dist_ths).

    Returns (matched ratios over thresholds, strand-consistency list). Each
    (dist, angle) threshold is a mask over the shared pair stream, so results
    are bit-identical to running the reference's per-threshold loop
    (loss/metrics.py:12-85) T times."""
    rmax = float(max(dist_ths))
    cos_ths = np.cos(np.deg2rad(np.asarray(angle_ths, dtype=np.float64)))
    n_th = len(dist_ths)
    n_points = p1.points.shape[0]
    tree2 = cKDTree(p2.points)
    matched = np.zeros((n_th, n_points), dtype=bool)

    # the default grid loosens monotonically in BOTH distance and angle, so
    # pass-sets nest (good_0 ⊆ good_1 ⊆ …): each pair then carries one
    # "tightest tier passed" and the vote dedup runs once, not per threshold
    nested = all(
        dist_ths[t] <= dist_ths[t + 1] and angle_ths[t] <= angle_ths[t + 1]
        for t in range(n_th - 1)
    )

    if compute_strand_consistency:
        p1_strand = np.asarray(p1.points_id_to_strand_id)
        p2_strand = np.asarray(p2.points_id_to_strand_id, dtype=np.int64)
        s2_base = int(p2_strand.max()) + 1
        vote_keys: List[List[np.ndarray]] = [[] for _ in range(n_th)]
        tiered_keys: List[np.ndarray] = []
        tiered_tiers: List[np.ndarray] = []

    # keep the input dtype: a float32 downcast would flip matches whose dot
    # product sits within ~1e-7 of a cos threshold, breaking the bit-parity
    # claim vs the reference loop
    d1 = np.asarray(p1.directions)
    d2 = np.asarray(p2.directions)
    for owner, nn, dist in _pair_chunks(np.asarray(p1.points), tree2, rmax, chunk):
        if owner.size == 0:
            continue
        dots = np.einsum("ij,ij->i", d1[owner], d2[nn])
        if bidirectional:
            dots = np.abs(dots)
        if nested:
            tier = np.full(owner.shape, n_th, dtype=np.int8)
        for t in range(n_th - 1, -1, -1):
            good = (dist <= dist_ths[t]) & (dots >= cos_ths[t])
            matched[t, owner[good]] = True
            if nested:
                tier[good] = t
            elif compute_strand_consistency and good.any():
                # one vote per unique (p1 point, p2 strand) — the reference
                # np.unique's the per-point strand list (loss/metrics.py:65-68)
                key = owner[good] * s2_base + p2_strand[nn[good]]
                vote_keys[t].append(np.unique(key))
        if nested and compute_strand_consistency:
            sel = tier < n_th
            if sel.any():
                key = owner[sel] * s2_base + p2_strand[nn[sel]]
                # min tier per unique (point, strand): lexsort then first-hit
                order = np.lexsort((tier[sel], key))
                k, tr = key[order], tier[sel][order]
                keep = np.ones(len(k), dtype=bool)
                keep[1:] = k[1:] != k[:-1]
                tiered_keys.append(k[keep])
                tiered_tiers.append(tr[keep])

    ratios = matched.sum(axis=1) / n_points
    strand_ratios: List[Optional[float]] = [None] * n_th
    if compute_strand_consistency:
        if nested:
            # chunks cover disjoint owner ranges, so keys stay unique globally
            all_keys = (
                np.concatenate(tiered_keys) if tiered_keys
                else np.empty(0, dtype=np.int64)
            )
            all_tiers = (
                np.concatenate(tiered_tiers) if tiered_tiers
                else np.empty(0, dtype=np.int8)
            )
            for t in range(n_th):
                keys_t = all_keys[all_tiers <= t]
                strand_ratios[t] = _strand_consistency_score(
                    p1_strand, [keys_t] if keys_t.size else [], s2_base
                )
        else:
            for t in range(n_th):
                strand_ratios[t] = _strand_consistency_score(
                    p1_strand, vote_keys[t], s2_base
                )
    return ratios.astype(np.float64), strand_ratios


def pct_matched_points(
    p1: HairEvalData,
    p2: HairEvalData,
    dist_th: float,
    angle_th: float,
    bidirectional: bool = False,
    compute_strand_consistency: bool = False,
    chunk: int = 200_000,
) -> Tuple[float, Optional[float]]:
    """Fraction of p1 points with a (distance, angle)-matched point in p2;
    optionally the strand-consistency score (loss/metrics.py:12-85).
    Single-threshold wrapper over pct_matched_points_multi."""
    ratios, strand_ratios = pct_matched_points_multi(
        p1, p2, [dist_th], [angle_th], bidirectional,
        compute_strand_consistency, chunk,
    )
    return float(ratios[0]), strand_ratios[0]


def compute_metrics(
    pred: HairEvalData,
    gt: HairEvalData,
    dist_ths: List[float] = DEFAULT_DIST_THS,
    angle_ths: List[float] = DEFAULT_ANGLE_THS,
    metrics: List[str] = ("precision", "recall", "f1", "strand_consistency"),
    bidirectional: bool = False,
    processes: Optional[int] = None,
    return_table: bool = False,
):
    """Metric dict keyed like the reference (suffix "(b)" when bidirectional),
    values = arrays over thresholds; plus the threshold labels.

    With return_table=True additionally returns a printable table (the
    reference eval.py:56-59 expects this but metrics.py never implemented it —
    fixed here)."""
    del processes  # single-CPU host: algorithmic sharing beats a Pool here
    compute_sc = (
        "strand_consistency" in metrics
        and pred.points_id_to_strand_id is not None
        and gt.points_id_to_strand_id is not None
    )
    thresholds = [f"{d}m&{a}°" for d, a in zip(dist_ths, angle_ths)]
    dist_ths, angle_ths = list(dist_ths), list(angle_ths)
    out: Dict[str, list] = {m: [] for m in metrics}
    if "precision" in metrics:
        p_arr, _ = pct_matched_points_multi(
            pred, gt, dist_ths, angle_ths, bidirectional, False
        )
        out["precision"] = list(p_arr)
    if "recall" in metrics:
        r_arr, sc_list = pct_matched_points_multi(
            gt, pred, dist_ths, angle_ths, bidirectional, compute_sc
        )
        out["recall"] = list(r_arr)
        if compute_sc:
            out["strand_consistency"] = sc_list
    if "f1" in metrics and "precision" in metrics and "recall" in metrics:
        for p, r in zip(out["precision"], out["recall"]):
            out["f1"].append(2 * p * r / (p + r) if (p + r) > 0 else 0.0)

    suffix = "(b)" if bidirectional else ""
    final = {
        (k + suffix): np.asarray(v) for k, v in out.items() if len(v)
    }
    if return_table:
        return final, thresholds, format_metric_table(final, thresholds)
    return final, thresholds


def format_metric_table(metric_dict: Dict[str, np.ndarray], thresholds: List[str]) -> str:
    name_w = max(len(k) for k in metric_dict) if metric_dict else 8
    header = " " * (name_w + 2) + "  ".join(f"{t:>14}" for t in thresholds)
    lines = [header]
    for k, v in metric_dict.items():
        lines.append(f"{k:<{name_w}}  " + "  ".join(f"{x:>14.4f}" for x in v))
    return "\n".join(lines)
