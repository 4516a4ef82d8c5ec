"""Greedy strand-endpoint merge candidate search and the Stage-II loop
(counterpart of hairgs_tpu/topo/merge.py).

Parity target: scene/hair_gaussian_model.py:1205-1362
(compute_endpoint_pair_to_merge): ball-query strand tips within the distance
threshold, filter by segment-direction anti-alignment, sort all candidate
pairs by distance and greedily keep first-occurrence, non-complementary
pairs. The greedy pass is order-dependent by design; replicated exactly.
Also the Stage-II driver loop (merge.py:114-166): merge until no
candidates.

The search and the greedy filter run in the native library; the cKDTree
loop and `_remove_complementary_rows` are their numpy oracles, run only
when a caller passes `native=False`.
"""

import numpy as np
from scipy.spatial import cKDTree

from hairgs_tpu_torch import telemetry


def compute_endpoint_pair_to_merge(model, st=None, native: bool = True,
                                   info=None, dist_th=None,
                                   angle_th=None) -> np.ndarray:
    """Candidate pairs at the model's current thresholds, in merge order;
    `st` is a host mirror to search instead of a fresh pull. `info` and the
    thresholds let the async topology worker search a snapshot with its
    launch-time strands info and thresholds instead of the live model's."""
    from hairgs_tpu_torch.topo.graph_ops import HairHostState

    cfg = model.training_args
    dist_th = model.merge_dist_th if dist_th is None else dist_th
    angle_th = model.merge_angle_th if angle_th is None else angle_th
    dir_th = np.cos(np.deg2rad(angle_th))
    if st is None:
        st = HairHostState(model)
    if info is None:
        info = model.strands_info

    # strand endpoints (appear once), restricted to foreground segments
    degree = np.bincount(st.pairs.ravel())
    in_fg = np.zeros(degree.shape[0], dtype=bool)
    in_fg[st.pairs[st.foreground_mask()].ravel()] = True
    strand_endpoint_id = np.flatnonzero((degree == 1) & in_fg)
    if strand_endpoint_id.shape[0] == 0:
        return np.zeros((0, 2), dtype=np.int64)

    # direction of the segment owning each endpoint, endpoint -> complementary
    comp, _ = st.get_complementary(strand_endpoint_id)
    d = st.endpoints[comp] - st.endpoints[strand_endpoint_id]
    d = d / np.linalg.norm(d, axis=1, keepdims=True)

    pts = st.endpoints[strand_endpoint_id]
    strand_comp = info.strand_endpoint_id_to_complementary

    if native:
        from hairgs_tpu_torch.native import (
            greedy_complementary_filter,
            merge_candidates,
        )

        sel_p1, sel_p2, dists = merge_candidates(
            pts, d, float(dist_th), float(dir_th),
            bool(cfg.bidirectional_merge),
            strand_endpoint_id, strand_comp[strand_endpoint_id],
        )
        if sel_p1.size == 0:
            return np.zeros((0, 2), dtype=np.int64)
        order = np.argsort(dists, kind="stable")
        pairs = np.stack([sel_p1[order], sel_p2[order]], axis=1)
        pairs = st.remove_duplicate_endpoint_rows(pairs)
        return pairs[greedy_complementary_filter(pairs, strand_comp)]

    tree = cKDTree(pts)
    neighbor_lists = tree.query_ball_point(pts, r=dist_th, workers=-1,
                                           return_sorted=True)

    sel_p1, sel_p2, dists = [], [], []
    n = strand_endpoint_id.shape[0]
    for i in range(n):
        nn = np.asarray(neighbor_lists[i])
        gid = strand_endpoint_id[i]
        nn_gid = strand_endpoint_id[nn]
        keep = (nn_gid != strand_comp[gid]) & (nn_gid != gid)
        nn = nn[keep]
        if nn.size == 0:
            continue
        dots = d[nn] @ (-d[i])
        if cfg.bidirectional_merge:
            dots = np.abs(dots)
        nn = nn[dots >= dir_th]
        if nn.size == 0:
            continue
        nd = np.linalg.norm(pts[i] - pts[nn], axis=1)
        for j in range(nn.size):
            sel_p1.append(gid)
            sel_p2.append(strand_endpoint_id[nn[j]])
            dists.append(nd[j])

    if not sel_p1:
        return np.zeros((0, 2), dtype=np.int64)

    order = np.argsort(np.asarray(dists), kind="stable")
    pairs = np.stack([np.asarray(sel_p1)[order], np.asarray(sel_p2)[order]], axis=1)
    pairs = st.remove_duplicate_endpoint_rows(pairs)
    pairs = _remove_complementary_rows(pairs, strand_comp)
    return pairs


def _remove_complementary_rows(pairs: np.ndarray, comp_map: np.ndarray) -> np.ndarray:
    """Sequential greedy conflict filter (hair_gaussian_model.py:1236-1255):
    once a pair is accepted, both partners' strand complementaries are
    disabled for subsequent rows."""
    disabled = np.zeros(int(comp_map.max()) + 2, dtype=bool)
    keep = np.ones(pairs.shape[0], dtype=bool)
    for i in range(pairs.shape[0]):
        e1, e2 = pairs[i]
        if disabled[e1] or disabled[e2]:
            keep[i] = False
        else:
            disabled[comp_map[e1]] = True
            disabled[comp_map[e2]] = True
    return pairs[keep]


def stage2_merge_loop(model, max_iterations: int, callback=None,
                      native: bool = True, viz_callback=None) -> int:
    """Stage-II merging driver (merge.py:114-166): repeatedly find + merge
    candidate pairs until none remain. The merge thresholds stay at their
    init values (the reference never calls update_learning_rate here).

    callback(i, n_merged, times) gets the iteration's wall seconds, from
    its spans: `candidates` (the search alone) and `total` (the whole
    iteration, a topology event). viz_callback(i, pairs)
    fires before the merge is applied (the pairs index the pre-merge
    endpoints): the hook for the merge-progress plots (merge.py:118-158)."""
    from hairgs_tpu_torch.topo.graph_ops import HairHostState
    from hairgs_tpu_torch.topo.strands import compute_strands_info

    iterations = 0
    for i in range(1, max_iterations + 1):
        with telemetry.span(telemetry.TOPO_EVENT) as event:
            st = HairHostState(model)
            with telemetry.span(telemetry.TOPO_MERGE_SEARCH) as search:
                pairs = compute_endpoint_pair_to_merge(model, st=st, native=native)
            if pairs.shape[0] == 0:
                break
            if viz_callback is not None:
                viz_callback(i, pairs)
            st.merge_endpoint_pairs(pairs)
            st.install()
            # the mirror holds what install() wrote: no second pull
            compute_strands_info(model, arrays=st.as_arrays(), native=native)
        iterations = i
        if callback is not None:
            callback(i, pairs.shape[0], dict(candidates=search.seconds, total=event.seconds))
    return iterations
