"""Host-side strand-graph topology operations for the hair model
(counterpart of hairgs_tpu/topo/graph_ops.py).

Parity target: scene/hair_gaussian_model.py —
- cat_segments / prune_segments with index compaction (l.534-617)
- merge_endpoint_pairs (l.619-706)
- split/clone/merge_collapsed/prune strategies + densification (l.788-1077)
- merging (l.1079-1096), growing (l.1098-1203), reset_opacity (l.1364-1371)
- clean_gaussians (l.1502-1515)

These run on numpy between train steps, on the live rows pulled to the host,
or (`compute_topology_update`, `apply_topology_update`) on a snapshot on a
worker thread while training goes on (topo/async_events.py).
Adam moments ride along on the device: surviving rows keep their moments,
new rows start at zero — matching _cat/_prune_tensor_in_optimizer
(l.482-532). No strategy draws a random number.
"""

import time
from typing import Dict, NamedTuple

import numpy as np
import torch

from hairgs_tpu_torch.core.maths import MIN_VAL
from hairgs_tpu_torch.models.gaussian import FG_BIN_TH, OPACITY_TH

SEG_KEYS = ("features_dc", "features_rest", "opacity", "mask", "width")


class HairHostState:
    """Mutable host mirror of a HairModel's arenas during a topology pass.

    The Adam moments are not pulled: every moment mutation of the
    reference surgery here is "keep this row" or "new row starts at zero"
    (_cat/_prune_tensor_in_optimizer, l.482-532; the opacity reset zeroes
    its plane on the device), so the state tracks gather-or-zero index maps
    (`ep_src`, `seg_src`) and install() applies them on the device.

    `arrays` hands in a just-installed host mirror to skip the pull
    (densify -> merge in the same topology event); `stats` likewise hands
    in densification statistics pulled beforehand (the async snapshot).
    """

    def __init__(self, model, arrays=None, stats=None):
        from hairgs_tpu_torch.core.hostsync import sliced_pull

        self.model = model
        if arrays is None:
            arrays = model.host_arrays()
        self.endpoints = arrays["endpoints"]
        self.pairs = arrays["endpoint_pairs"].astype(np.int64)
        self.seg = {k: arrays[k] for k in SEG_KEYS}
        self.ep_src = np.arange(self.endpoints.shape[0], dtype=np.int64)
        self.seg_src = np.arange(self.pairs.shape[0], dtype=np.int64)
        ns = model.num_segments
        self.stats = stats if stats is not None else sliced_pull({
            "max_radii2d": (model.stats.max_radii2d, ns),
            "xyz_grad_accum": (model.stats.xyz_grad_accum, ns),
            "denom": (model.stats.denom, ns),
        })
        self.strand_root_idx = (
            np.array(model.strand_root_endpoint_idx)
            if model.strand_root_endpoint_idx is not None
            else np.zeros(0, dtype=np.int64)
        )

    def as_arrays(self):
        """host_arrays()-shaped dict view of the current mirror (valid after
        install(): identical to the device content, no pull needed)."""
        out = dict(self.seg)
        out["endpoints"] = self.endpoints
        out["endpoint_pairs"] = self.pairs
        return out

    # -- activations ------------------------------------------------------

    def opacity_act(self):
        return 1.0 / (1.0 + np.exp(-self.seg["opacity"][:, 0]))

    def mask_act(self):
        return 1.0 / (1.0 + np.exp(-self.seg["mask"][:, 0]))

    def scaling(self):
        p = self.endpoints[self.pairs]
        norm = np.linalg.norm(p[:, 1] - p[:, 0], axis=-1, keepdims=True)
        sx = np.clip(norm / 2.0 * self.model.dist_to_scale_factor, MIN_VAL, None)
        syz = np.exp(np.repeat(self.seg["width"], 2, axis=1))
        return np.concatenate([sx, syz], axis=1)

    def seg_lengths(self):
        p = self.endpoints[self.pairs]
        return np.linalg.norm(p[:, 1] - p[:, 0], axis=-1)

    def foreground_mask(self):
        return (self.opacity_act() >= OPACITY_TH) & (self.mask_act() >= FG_BIN_TH)

    # -- structural primitives -------------------------------------------

    def cat_segments(self, new_pairs, new_endpoints, new_seg: Dict[str, np.ndarray]):
        """Append segments + endpoints; new moments zero; stats reset for ALL
        segments (reference cat_segments, l.554-580)."""
        self.pairs = np.concatenate([self.pairs, new_pairs.astype(np.int64)], axis=0)
        self.endpoints = np.concatenate(
            [self.endpoints, new_endpoints.astype(np.float32)], axis=0
        )
        self.ep_src = np.concatenate(
            [self.ep_src, np.full(new_endpoints.shape[0], -1, np.int64)]
        )
        for k in SEG_KEYS:
            self.seg[k] = np.concatenate(
                [self.seg[k], new_seg[k].astype(self.seg[k].dtype)], axis=0)
        self.seg_src = np.concatenate(
            [self.seg_src, np.full(new_pairs.shape[0], -1, np.int64)]
        )
        ns = self.pairs.shape[0]
        self.stats = {
            "max_radii2d": np.zeros(ns, np.float32),
            "xyz_grad_accum": np.zeros((ns, 1), np.float32),
            "denom": np.zeros((ns, 1), np.float32),
        }

    def prune_segments(self, prune_mask: np.ndarray):
        """Remove segments; drop now-unreferenced endpoints; compact indices
        (reference prune_segments, l.582-617)."""
        keep = ~prune_mask
        self.pairs = self.pairs[keep]
        ep_keep = np.zeros(self.endpoints.shape[0], dtype=bool)
        if self.pairs.size:
            ep_keep[self.pairs.ravel()] = True
        old_indices = np.unique(self.pairs) if self.pairs.size else np.zeros(0, np.int64)
        mapping = np.zeros(
            (int(old_indices.max()) + 1) if old_indices.size else 1, dtype=np.int64
        )
        mapping[old_indices] = np.arange(old_indices.shape[0])
        if self.pairs.size:
            self.pairs = mapping[self.pairs]
        # strand roots that survived keep their (remapped) indices
        if self.strand_root_idx.size:
            root_alive = ep_keep[self.strand_root_idx]
            self.strand_root_idx = mapping[self.strand_root_idx[root_alive]]
        self.endpoints = self.endpoints[ep_keep]
        self.ep_src = self.ep_src[ep_keep]
        for k in SEG_KEYS:
            self.seg[k] = self.seg[k][keep]
        self.seg_src = self.seg_src[keep]
        self.stats = {k: v[keep] for k, v in self.stats.items()}

    def get_row_indices(self, endpoint_id: np.ndarray):
        """Row of endpoint_pairs containing each endpoint (last wins for
        doubly-referenced endpoints; l.728-750)."""
        mapping = -np.ones(int(self.pairs.max()) + 1, dtype=np.int64)
        rows = np.arange(self.pairs.shape[0])
        mapping[self.pairs[:, 0]] = rows
        mapping[self.pairs[:, 1]] = rows
        return mapping[endpoint_id]

    def get_complementary(self, endpoint_id: np.ndarray):
        rows = self.get_row_indices(endpoint_id)
        sel = self.pairs[rows]
        comp = np.where(sel[:, 1] == endpoint_id, sel[:, 0], sel[:, 1])
        return comp, rows

    def remove_duplicate_endpoint_rows(self, idx_pairs: np.ndarray, return_mask=False):
        """Keep rows where both entries are first occurrences in the flattened
        list (l.711-726)."""
        flat = idx_pairs.ravel()
        mask = np.zeros(flat.shape[0], dtype=bool)
        _, first_idx = np.unique(flat, return_index=True)
        mask[first_idx] = True
        mask = mask.reshape(-1, 2)
        row_mask = mask[:, 0] & mask[:, 1]
        if return_mask:
            return idx_pairs[row_mask], row_mask
        return idx_pairs[row_mask]

    def merge_endpoint_pairs(self, idx_pairs: np.ndarray):
        """Merge endpoint pairs into midpoint joints, re-linking their
        segments (l.619-706)."""
        if idx_pairs.shape[0] == 0:
            return
        pos = self.endpoints[idx_pairs]  # (N,2,3)
        comp1, rows1 = self.get_complementary(idx_pairs[:, 0])
        comp2, rows2 = self.get_complementary(idx_pairs[:, 1])
        new_endpoints = 0.5 * pos[:, 1] + 0.5 * pos[:, 0]
        base = int(self.pairs.max()) + 1
        new_idx = np.arange(new_endpoints.shape[0]) + base
        ep_map = np.arange(max(self.endpoints.shape[0], base))
        ep_map[idx_pairs[:, 0]] = new_idx
        ep_map[idx_pairs[:, 1]] = new_idx
        seg1 = np.stack([ep_map[comp1], new_idx], axis=1)
        seg2 = np.stack([new_idx, ep_map[comp2]], axis=1)
        new_pairs = np.concatenate([seg1, seg2], axis=0)
        new_seg = {
            k: np.concatenate([self.seg[k][rows1], self.seg[k][rows2]], axis=0)
            for k in SEG_KEYS
        }
        self.cat_segments(new_pairs, new_endpoints, new_seg)
        prune = np.zeros(self.pairs.shape[0], dtype=bool)
        prune[rows1] = True
        prune[rows2] = True
        self.prune_segments(prune)

    # -- write back -------------------------------------------------------

    def install(self, carry_values: bool = False):
        """Write the mirror back. carry_values: surviving rows keep their
        current device values (HairModel.install carry_param_values); only
        new rows take the mirror's."""
        m = self.model
        step = int(m.opt_state.step) if m.opt_state is not None else 0
        m.install(self.endpoints, self.pairs, self.seg,
                  moment_maps=(self.ep_src, self.seg_src, frozenset()),
                  step=step, carry_param_values=carry_values)
        m.strand_root_endpoint_idx = self.strand_root_idx
        # install() zeroed the stats; restore the surviving values
        cap_s = m.graph.endpoint_pairs.shape[0]
        ns = self.pairs.shape[0]

        def pad(v):
            out = np.zeros((cap_s,) + v.shape[1:], dtype=np.float32)
            out[:ns] = v
            return torch.tensor(out, device=m.device)

        m.stats = m.stats._replace(
            max_radii2d=pad(self.stats["max_radii2d"]),
            xyz_grad_accum=pad(self.stats["xyz_grad_accum"]),
            denom=pad(self.stats["denom"]),
        )


# --------------------------------------------------------------------------
# strategies
# --------------------------------------------------------------------------

def _split_strategy(st: HairHostState, grads, scene_extent, cfg, info):
    """l.828-912: split long / high-gradient large segments at their midpoint."""
    split_threshold = cfg.percent_dense * scene_extent
    n = st.pairs.shape[0]
    padded_grad = np.zeros(n, dtype=np.float32)
    padded_grad[: grads.shape[0]] = grads.squeeze(-1)
    scaling = st.scaling()
    sel = (padded_grad >= cfg.densify_grad_threshold) & (
        scaling.max(axis=1) > split_threshold
    )
    long_mask = st.seg_lengths() >= st.model.max_segment_length
    sel = sel | long_mask
    sel = sel & (st.mask_act() > 0.25)
    info["split"] = int(sel.sum())
    if not sel.any():
        return
    mid = st.endpoints[st.pairs[sel]].mean(axis=1)  # midpoint (l.862)
    base = int(st.pairs.max()) + 1
    new_idx = np.arange(mid.shape[0]) + base
    orig = st.pairs[sel]
    seg1 = np.stack([orig[:, 0], new_idx], axis=1)
    seg2 = np.stack([new_idx, orig[:, 1]], axis=1)
    new_pairs = np.concatenate([seg1, seg2], axis=0)
    new_seg = {k: np.tile(st.seg[k][sel], (2,) + (1,) * (st.seg[k].ndim - 1))
               for k in SEG_KEYS}
    st.cat_segments(new_pairs, mid, new_seg)
    prune = np.concatenate([sel, np.zeros(2 * sel.sum(), dtype=bool)])
    st.prune_segments(prune)


def _clone_strategy(st: HairHostState, grads, scene_extent, cfg, info):
    """l.914-966: duplicate small high-gradient segments as disconnected
    copies (both endpoints cloned)."""
    split_threshold = cfg.percent_dense * scene_extent
    sel = (np.linalg.norm(grads, axis=-1) >= cfg.densify_grad_threshold) & (
        st.scaling().max(axis=1) <= split_threshold
    )
    info["clone"] = int(sel.sum())
    if not sel.any():
        return
    new_eps = st.endpoints[st.pairs[sel]].reshape(-1, 3)  # (2N,3)
    base = int(st.pairs.max()) + 1
    new_idx = (np.arange(new_eps.shape[0]) + base).reshape(-1, 2)
    new_seg = {k: st.seg[k][sel] for k in SEG_KEYS}
    st.cat_segments(new_idx, new_eps, new_seg)


def _merge_collapsed_segments_v2(st: HairHostState, info):
    """l.968-1017 with the id spaces kept straight: each round (a) drops
    mergeable collapsed/bg segments, (b) welds their two endpoints by
    rewriting references, (c) compacts."""
    info["merge_collapsed"] = 0
    while True:
        lengths = st.seg_lengths()
        collapsed = lengths < MIN_VAL
        bg = ~st.foreground_mask()
        mask = collapsed | bg
        collapsed_ids = st.pairs[mask]
        ids, counts = np.unique(st.pairs, return_counts=True)
        non_unique = ids[counts != 1]
        merge_ok = (
            np.all(np.isin(collapsed_ids, non_unique), axis=1)
            if collapsed_ids.size
            else np.zeros(0, dtype=bool)
        )
        midx = np.where(mask)[0]
        mask[:] = False
        mask[midx[merge_ok]] = True
        to_merge = collapsed_ids[merge_ok]
        if to_merge.shape[0]:
            to_merge, non_dup = st.remove_duplicate_endpoint_rows(to_merge, return_mask=True)
            sel_rows = midx[merge_ok]
            mask[:] = False
            mask[sel_rows[non_dup]] = True
        num = to_merge.shape[0]
        if num == 0:
            break
        # weld BEFORE pruning so old endpoint ids stay valid, then prune +
        # compact (net effect identical to the reference's prune-then-map,
        # because pruned rows are exactly the welded segments)
        weld = np.arange(int(st.pairs.max()) + 1)
        weld[to_merge[:, 1]] = to_merge[:, 0]
        st.pairs = weld[st.pairs]
        st.prune_segments(mask)
        info["merge_collapsed"] += num


def _prune_strategy(st: HairHostState, extent, max_screen_size, cfg, info,
                    avoid_connected=False):
    """l.1019-1077: prune collapsed / transparent / oversized segments,
    optionally only at strand ends or in the background."""
    prune = st.seg_lengths() < MIN_VAL
    info["prune_collapsed"] = int(prune.sum())
    low_opa = st.opacity_act() < OPACITY_TH
    info["prune_low_opacity"] = int(low_opa.sum())
    prune = prune | low_opa
    if max_screen_size and extent != 0.0:
        big_ws = st.scaling().max(axis=1) > 0.1 * extent
        info["prune_big_ws"] = int(big_ws.sum())
        prune = prune | big_ws
    if avoid_connected and prune.sum() != 0:
        ids, counts = np.unique(st.pairs, return_counts=True)
        unique = ids[counts == 1]
        is_end_segment = np.any(np.isin(st.pairs, unique), axis=1)
        is_not_fg = st.mask_act() < FG_BIN_TH
        allowed = is_end_segment | is_not_fg
        info["prune_avoided"] = int(prune.sum() - (prune & allowed).sum())
        prune = prune & allowed
    total = int(prune.sum())
    info["prune_total"] = total
    if 0 < total < st.pairs.shape[0]:
        st.prune_segments(prune)


# --------------------------------------------------------------------------
# public entry points (operate on a HairModel)
# --------------------------------------------------------------------------

def _sync(model):
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)


def hair_densification(model, extent, max_screen_size, training_info=None,
                       return_arrays=False):
    """One densification step: clone, split, weld collapsed, prune
    (hair_gaussian_model.py:788-817), then refresh strands info.

    With return_arrays=True also returns the post-install host mirror so a
    merge in the same topology event skips its pull.

    Phase wall times land in densification_info as t_pull/t_strategies/
    t_install/t_walk (seconds, each phase's device work finished)."""
    from hairgs_tpu_torch.topo.strands import compute_strands_info

    t0 = time.perf_counter()
    st = HairHostState(model)
    t_pull = time.perf_counter()
    with np.errstate(invalid="ignore", divide="ignore"):
        grads = st.stats["xyz_grad_accum"] / st.stats["denom"]
    grads = np.nan_to_num(grads, nan=0.0, posinf=0.0)
    info = {}
    _clone_strategy(st, grads, extent, model.training_args, info)
    _split_strategy(st, grads, extent, model.training_args, info)
    _merge_collapsed_segments_v2(st, info)
    _prune_strategy(st, extent, max_screen_size, model.training_args, info,
                    avoid_connected=True)
    t_strat = time.perf_counter()
    st.install()
    _sync(model)
    t_install = time.perf_counter()
    arrays = st.as_arrays()
    compute_strands_info(model, arrays=arrays)
    t_walk = time.perf_counter()
    info.update(
        t_pull=round(t_pull - t0, 3),
        t_strategies=round(t_strat - t_pull, 3),
        t_install=round(t_install - t_strat, 3),
        t_walk=round(t_walk - t_install, 3),
    )
    if training_info is not None:
        training_info.densification_info.update(info)
    return (info, arrays) if return_arrays else info


def hair_merging(model, training_info=None, arrays=None):
    """Greedy endpoint merging (l.1079-1096).

    `arrays`: post-install host mirror from a densification in the same
    topology event (model.strands_info is then already fresh)."""
    from hairgs_tpu_torch.topo.merge import compute_endpoint_pair_to_merge
    from hairgs_tpu_torch.topo.strands import compute_strands_info

    t0 = time.perf_counter()
    if arrays is None:
        st = HairHostState(model)
        compute_strands_info(model, arrays=st.as_arrays())
    else:
        st = HairHostState(model, arrays=arrays)
    t_prep = time.perf_counter()
    pairs = compute_endpoint_pair_to_merge(model, st=st)
    t_cand = time.perf_counter()
    if training_info is not None:
        training_info.densification_info["merge"] = int(pairs.shape[0])
    st.merge_endpoint_pairs(pairs)
    st.install()
    compute_strands_info(model, arrays=st.as_arrays())
    _sync(model)
    t_end = time.perf_counter()
    if training_info is not None:
        training_info.densification_info.update(
            t_merge_prep=round(t_prep - t0, 3),
            t_merge_candidates=round(t_cand - t_prep, 3),
            t_merge_apply=round(t_end - t_cand, 3),
        )
    return pairs.shape[0]


def hair_growing(model, training_info=None, growth_length: float = 0.002):
    """Extend strand tips along the averaged direction of the last few
    segments (l.1098-1203). The reference crashes here on a missing argument
    (cat_segments called with 6 of 7 args, l.1187-1194) and never runs it by
    default (growth_interval 100000 > iterations); implemented correctly."""
    from hairgs_tpu_torch.topo.strands import compute_strands_info

    cfg = model.training_args
    info = model.strands_info
    st = HairHostState(model)
    max_len = cfg.num_points_strand
    navg = cfg.growth_averaging_points
    new_pairs, new_eps = [], []
    new_seg = {k: [] for k in SEG_KEYS}
    counter = 0
    total_eps = st.endpoints.shape[0]
    # the strands info walks the foreground segments as they were at the
    # last topology event: a tip there may go on into a background segment.
    # Growing from it would give its endpoint a third segment, and the walk
    # fails once that segment turns foreground, so only endpoints of one
    # segment grow
    degree = np.bincount(st.pairs.ravel(), minlength=total_eps)
    for seq, rows in zip(info.list_strands, info.list_strands_segments_id):
        if seq.shape[0] >= max_len or degree[seq[-1, 1]] != 1:
            continue
        tip = st.endpoints[seq[-1, 1]]
        k = min(seq.shape[0], navg)
        segs = seq[-k:]
        rids = rows[-k:]
        dirs = st.endpoints[segs[:, 1]] - st.endpoints[segs[:, 0]]
        norms = np.linalg.norm(dirs, axis=1)
        okm = norms >= MIN_VAL
        if not okm.any():
            continue
        dirs = dirs[okm] / norms[okm][:, None]
        rids = rids[okm]
        avg_dir = dirs.mean(axis=0)
        new_pos = tip + avg_dir * growth_length
        new_pairs.append([seq[-1, 1], total_eps + counter])
        new_eps.append(new_pos)
        for kkey in SEG_KEYS:
            new_seg[kkey].append(st.seg[kkey][rids].mean(axis=0))
        counter += 1
    if counter:
        st.cat_segments(
            np.array(new_pairs, dtype=np.int64),
            np.array(new_eps, dtype=np.float32),
            {k: np.array(v, dtype=np.float32) for k, v in new_seg.items()},
        )
        st.install()
    if training_info is not None:
        training_info.densification_info["grow"] = counter
    compute_strands_info(model)
    return counter


def hair_reset_opacity(model):
    """opacity <- inverse_sigmoid(min(opacity, 0.01)); opacity moments zeroed
    (reference reset_opacity + optimizer surgery, l.1364-1371). On the
    device: the reset is elementwise on one plane with no topology change."""
    p = model.params
    capped = torch.clamp(torch.sigmoid(p.opacity), max=0.01)
    new = torch.log(capped) - torch.log1p(-capped)
    active = model.graph.seg_active[:, None]
    model.params = p._replace(opacity=torch.where(active, new, p.opacity))
    if model.opt_state is not None:
        model.opt_state = model.opt_state._replace(
            mu=model.opt_state.mu._replace(
                opacity=torch.zeros_like(model.opt_state.mu.opacity)),
            nu=model.opt_state.nu._replace(
                opacity=torch.zeros_like(model.opt_state.nu.opacity)),
        )


# --------------------------------------------------------------------------
# async topology events (opt-in via --async_topology, topo/async_events.py)
# --------------------------------------------------------------------------


class TopologyUpdate(NamedTuple):
    """A computed topology event waiting to be installed."""

    st: HairHostState
    info: Dict
    strands_info: object  # StrandsInfo of the topology after the update


def compute_topology_update(model, *, arrays, stats, densify, merge,
                            extent=None, max_screen_size=None,
                            merge_dist_th=None, merge_angle_th=None):
    """A densify and/or merge event computed on a host snapshot, without
    installing it: the strategy sequence of hair_densification and
    hair_merging. apply_topology_update installs it later; surviving rows
    then take their live device values (the snapshot decides the topology
    and the new rows' values). Safe on a worker thread: it reads the
    snapshot and the model's constant fields only."""
    from hairgs_tpu_torch.topo.merge import compute_endpoint_pair_to_merge
    from hairgs_tpu_torch.topo.strands import compute_strands_info

    st = HairHostState(model, arrays=arrays, stats=stats)
    info = {}
    if densify:
        with np.errstate(invalid="ignore", divide="ignore"):
            grads = st.stats["xyz_grad_accum"] / st.stats["denom"]
        grads = np.nan_to_num(grads, nan=0.0, posinf=0.0)
        _clone_strategy(st, grads, extent, model.training_args, info)
        _split_strategy(st, grads, extent, model.training_args, info)
        _merge_collapsed_segments_v2(st, info)
        _prune_strategy(st, extent, max_screen_size, model.training_args, info,
                        avoid_connected=True)
    if merge:
        mid_info = compute_strands_info(model, arrays=st.as_arrays(), store=False)
        pairs = compute_endpoint_pair_to_merge(
            model, st=st, info=mid_info, dist_th=merge_dist_th,
            angle_th=merge_angle_th)
        info["merge"] = int(pairs.shape[0])
        st.merge_endpoint_pairs(pairs)
    strands_info = compute_strands_info(model, arrays=st.as_arrays(), store=False)
    return TopologyUpdate(st=st, info=info, strands_info=strands_info)


def apply_topology_update(model, update: TopologyUpdate, training_info=None):
    """Install a TopologyUpdate between train steps. Surviving rows keep
    their current device parameters and Adam moments (gather maps); new
    rows take the snapshot's values. The statistics take the update's
    values (any cat resets them in the reference, so the steps run during
    the flight only shorten the next accumulation window)."""
    _sync(model)  # time the install alone: the queued steps finish first
    t0 = time.perf_counter()
    update.st.install(carry_values=True)
    model.strands_info = update.strands_info
    _sync(model)
    update.info["t_apply"] = round(time.perf_counter() - t0, 3)
    if training_info is not None:
        training_info.densification_info.update(update.info)


def clean_hair_gaussians(model, avoid_connected: bool = True):
    """Remove background/transparent segments, optionally only at strand ends
    (l.1502-1515)."""
    st = HairHostState(model)
    prune = ~st.foreground_mask()
    if avoid_connected:
        ids, counts = np.unique(st.pairs, return_counts=True)
        unique = ids[counts == 1]
        seg_to_prune = st.pairs[prune]
        is_unique = np.isin(seg_to_prune, unique)
        is_end = is_unique[:, 0] | is_unique[:, 1]
        pidx = np.where(prune)[0]
        prune[:] = False
        prune[pidx[is_end]] = True
    st.prune_segments(prune)
    st.install()
