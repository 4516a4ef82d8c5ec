"""Sort-based (Gaussian, tile) pair binning (counterpart of
hairgs_tpu/render/binning.py): the chunk-aligned paged pair table of the
kernel path (`bin_gaussians_sorted`) and the dense per-tile table of the
XLA path (`bin_gaussians`).

Every Gaussian gets a fixed budget of `max_tiles_per_gaussian` (tile, depth)
slots; one stable sort over the fused [tile | quantized depth] key orders
all slots; per-tile ranges come from `searchsorted`. In the paged table each
tile's list is padded to a multiple of the compositor chunk, so every tile
owns its page and the backward writes per-slot gradients with no atomics.

The JAX package's scatters drop out-of-range indices (`mode="drop"`) and its
`searchsorted` returns P for trailing empty tiles; torch raises on such
indices, so they are masked explicitly here.
"""

from typing import NamedTuple

import numpy as np
import torch


class SortedBinning(NamedTuple):
    paged_src: torch.Tensor  # (P_pad,) int32: slot -> flat pair idx (P = pad)
    inv_paged: torch.Tensor  # (P,) int32: flat pair idx -> slot
    starts: torch.Tensor  # (num_tiles,) int32, chunk-aligned
    counts: torch.Tensor  # (num_tiles,) int32 true counts (capped)
    overflow_pairs: torch.Tensor  # () int32 dropped by per-gaussian budget
    overflow_tiles: torch.Tensor  # () int32 beyond the per-tile cap
    overflow_capacity: torch.Tensor  # () int32 dropped by pair_capacity
    pairs_demand: torch.Tensor  # () int32 chunk-padded slots the view needs


def _tile_min_power(xy, conic, tx, ty, tile_size):
    """Exact minimum of q = 0.5 a dx^2 + b dx dy + 0.5 c dy^2 over each
    candidate tile's pixel box (+-0.5 px slack): 0 when the center lies
    inside, else the best of the four clamped edge minima."""
    a = conic[:, 0:1]
    b = conic[:, 1:2]
    c = conic[:, 2:3]
    a_s = torch.clamp(a, min=1e-12)
    c_s = torch.clamp(c, min=1e-12)
    lx = (tx * tile_size).to(torch.float32) - 0.5 - xy[:, 0:1]
    hx = lx + tile_size
    ly = (ty * tile_size).to(torch.float32) - 0.5 - xy[:, 1:2]
    hy = ly + tile_size

    def q(dx, dy):
        return 0.5 * (a * dx * dx + c * dy * dy) + b * dx * dy

    def edge_x(dx_e):  # fixed dx, optimize dy
        dy = torch.minimum(torch.maximum(-b * dx_e / c_s, ly), hy)
        return q(dx_e, dy)

    def edge_y(dy_e):  # fixed dy, optimize dx
        dx = torch.minimum(torch.maximum(-b * dy_e / a_s, lx), hx)
        return q(dx, dy_e)

    inside = (lx <= 0.0) & (hx >= 0.0) & (ly <= 0.0) & (hy >= 0.0)
    q_edges = torch.minimum(
        torch.minimum(edge_x(lx), edge_x(hx)),
        torch.minimum(edge_y(ly), edge_y(hy)),
    )
    return torch.where(inside, torch.zeros_like(q_edges), q_edges)


PROBE_MULT = 4  # rect cells tested per budget slot (see _expand_pairs)


def _expand_pairs(rect, valid, grid_w, grid_h, max_tiles_per_gaussian,
                  xy=None, conic=None, q_cut=None, tile_size=16):
    """Each Gaussian's candidate (tile, slot) pairs, (N, r_max) int32 tile
    ids with `num_tiles` as the sentinel, and the count of lost pairs.

    With xy + conic + q_cut, tiles whose box minimum exponent exceeds
    q_cut = ln(opa / alpha_min) are dropped (exact: every pixel there fails
    the alpha gate), and the budget keeps the first r_max PASSING cells of a
    PROBE_MULT * r_max probe window."""
    r_max = max_tiles_per_gaussian
    num_tiles = grid_w * grid_h
    dev = rect.device
    rw = rect[:, 2] - rect[:, 0]
    rh = rect[:, 3] - rect[:, 1]
    count = rw * rh
    rw_safe = torch.clamp(rw, min=1)
    use_cull = xy is not None and conic is not None and q_cut is not None
    r_probe = r_max * PROBE_MULT if use_cull else r_max
    r = torch.arange(r_probe, dtype=torch.int32, device=dev)
    tx = rect[:, 0:1] + torch.remainder(r[None, :], rw_safe[:, None])
    ty = rect[:, 1:2] + torch.div(r[None, :], rw_safe[:, None], rounding_mode="floor")
    pair_ok = valid[:, None] & (r[None, :] < count[:, None])
    if use_cull:
        q_min = _tile_min_power(xy, conic, tx, ty, tile_size)
        pair_ok = pair_ok & (q_min <= q_cut[:, None] + 1e-4)
    tile_probe = torch.where(pair_ok, ty * grid_w + tx,
                             torch.full_like(tx, num_tiles))
    if r_probe > r_max:
        # first r_max passing cells: passing cells score above failing ones,
        # each tier in increasing-cell order (distinct scores, so the
        # descending top-k order is unique)
        score = torch.where(pair_ok, r_probe - r, -1 - r)
        _, sel = torch.topk(score, r_max, dim=1, largest=True, sorted=True)
        tile = torch.gather(tile_probe, 1, sel)
        n_passing = torch.sum(pair_ok, dim=1, dtype=torch.int32)
        # untested cells beyond the window count at the window's pass rate
        n_tested = torch.clamp(torch.clamp(count, max=r_probe), min=1)
        pass_rate = n_passing.to(torch.float32) / n_tested.to(torch.float32)
        est_untested = torch.round(
            torch.clamp(count - r_probe, min=0).to(torch.float32) * pass_rate
        ).to(torch.int32)
        lost = torch.clamp(n_passing - r_max, min=0) + est_untested
    else:
        tile = tile_probe
        lost = torch.clamp(count - r_max, min=0)
    overflow_pairs = torch.sum(torch.where(valid, lost, torch.zeros_like(lost)),
                               dtype=torch.int32)
    return tile, overflow_pairs


def paged_capacity(n: int, max_tiles_per_gaussian: int, num_tiles: int,
                   chunk: int) -> int:
    """Static upper bound: every pair plus < chunk of per-tile padding, plus
    one spare chunk of always-zero slots (target of culled pairs)."""
    return n * max_tiles_per_gaussian + (num_tiles + 1) * chunk


def compact_capacity(pair_capacity: int, n: int, max_tiles_per_gaussian: int,
                     num_tiles: int, chunk: int) -> int:
    """Paged-table size for a requested pair budget, rounded up to the chunk
    and including the trailing spare zero chunk."""
    cap = min(int(pair_capacity),
              paged_capacity(n, max_tiles_per_gaussian, num_tiles, chunk))
    return max(((cap + chunk - 1) // chunk) * chunk, 2 * chunk)


def _page_tiles(counts, chunk, p_pad, pair_capacity):
    """Chunk-aligned paging plus optional capacity truncation; counts must
    already be capped at max_pairs_per_tile."""
    padded_counts = ((counts + chunk - 1) // chunk) * chunk
    padded_starts = torch.cat([
        torch.zeros(1, dtype=torch.int32, device=counts.device),
        torch.cumsum(padded_counts, 0, dtype=torch.int32)[:-1]])
    pairs_demand = (padded_starts[-1] + padded_counts[-1] + chunk).to(torch.int32)
    overflow_capacity = torch.zeros((), dtype=torch.int32, device=counts.device)
    if pair_capacity > 0:
        # the last chunk is the reserved always-zero target of culled pairs;
        # tiles whose page spills past it are truncated
        content_cap = p_pad - chunk
        allowed = torch.clamp(content_cap - padded_starts, min=0)
        new_counts = torch.minimum(counts, allowed)
        overflow_capacity = torch.sum(counts - new_counts, dtype=torch.int32)
        counts = new_counts
        padded_starts = torch.clamp(padded_starts, max=content_cap)
    return counts, padded_starts, overflow_capacity, pairs_demand


def _quantize_depth(depth, num_tiles):
    """The canonical compositing-order key: quantized view depth with as
    many levels as fit beside the tile id in an int32. Both frameworks and
    both binning paths must sort this same key: depth near-ties then fall
    back to stable Gaussian-index order."""
    depth_bits = max(1, min(23, int(np.floor(np.log2(2**31 / (num_tiles + 1))))))
    levels = (1 << depth_bits) - 1
    d = depth.detach()
    dq = (torch.clamp(d / (d + 1.0), 0.0, 1.0) * levels).to(torch.int32)
    return dq, levels


def bin_gaussians_sorted(rect, depth, valid, grid_w: int, grid_h: int,
                         max_tiles_per_gaussian: int, max_pairs_per_tile: int,
                         chunk: int, xy=None, conic=None, q_cut=None,
                         tile_size: int = 16,
                         pair_capacity: int = 0) -> SortedBinning:
    """Sort-based binning emitting the chunk-aligned paged layout; same
    contract and the same integer results as the JAX function."""
    dev = rect.device
    n = rect.shape[0]
    r_max = max_tiles_per_gaussian
    num_tiles = grid_w * grid_h
    p = n * r_max
    if pair_capacity > 0:
        p_pad = compact_capacity(pair_capacity, n, r_max, num_tiles, chunk)
    else:
        p_pad = paged_capacity(n, r_max, num_tiles, chunk)

    dq, levels = _quantize_depth(depth, num_tiles)
    tile, overflow_pairs = _expand_pairs(
        rect, valid, grid_w, grid_h, r_max,
        xy=xy, conic=conic, q_cut=q_cut, tile_size=tile_size)

    # fused int32 key; at 3969 tiles (1000 px) the largest key is ~2.08e9,
    # which still fits
    key = tile * (levels + 1) + dq[:, None]
    sorted_key, perm = torch.sort(key.reshape(-1), stable=True)
    perm = perm.to(torch.int32)
    sorted_tile = torch.div(sorted_key, levels + 1, rounding_mode="floor")

    tile_ids = torch.arange(num_tiles, dtype=sorted_tile.dtype, device=dev)
    starts = torch.searchsorted(sorted_tile, tile_ids, side="left").to(torch.int32)
    ends = torch.searchsorted(sorted_tile, tile_ids, side="right").to(torch.int32)
    counts = ends - starts
    overflow_tiles = torch.sum(torch.clamp(counts - max_pairs_per_tile, min=0),
                               dtype=torch.int32)
    counts = torch.clamp(counts, max=max_pairs_per_tile)

    counts, padded_starts, overflow_capacity, pairs_demand = _page_tiles(
        counts, chunk, p_pad, pair_capacity)

    # per-sorted-position tile constants via segment-delta cumsums; starts of
    # empty tiles coincide, so the deltas must accumulate. A start equal to
    # P (trailing empty tiles) lands in one extra slot that is cut off: the
    # drop of the JAX scatter, with no host-side mask.
    scatter_at = starts.long()

    def segment_table(values):
        deltas = torch.cat([values[:1], values[1:] - values[:-1]])
        buf = torch.zeros(p + 1, dtype=torch.int32, device=dev)
        buf.index_add_(0, scatter_at, deltas)
        return torch.cumsum(buf[:p], 0, dtype=torch.int32)

    sp = torch.arange(p, dtype=torch.int32, device=dev)
    starts_at = segment_table(starts)
    counts_at = segment_table(counts)
    pad_at = segment_table(padded_starts - starts)
    offset_in_tile = sp - starts_at
    valid_sorted = (sorted_tile < num_tiles) & (offset_in_tile < counts_at)
    dest = sp + pad_at

    # invalid positions write into one extra slot that is cut off
    paged_src = torch.full((p_pad + 1,), p, dtype=torch.int32, device=dev)
    drop_at = torch.full_like(dest, p_pad)
    paged_src[torch.where(valid_sorted & (dest < p_pad), dest, drop_at).long()] = perm
    paged_src = paged_src[:p_pad]
    # culled pairs target the final spare chunk (always zero in the grads)
    inv_paged = torch.zeros(p, dtype=torch.int32, device=dev)
    inv_paged[perm.long()] = torch.where(
        valid_sorted, dest, torch.full_like(dest, p_pad - chunk))

    return SortedBinning(
        paged_src=paged_src, inv_paged=inv_paged, starts=padded_starts,
        counts=counts, overflow_pairs=overflow_pairs,
        overflow_tiles=overflow_tiles, overflow_capacity=overflow_capacity,
        pairs_demand=pairs_demand)


class Binning(NamedTuple):
    """Dense per-tile layout of the XLA path (`composite`)."""

    gather_idx: torch.Tensor  # (num_tiles, K) int32 Gaussian indices
    pair_valid: torch.Tensor  # (num_tiles, K) bool
    tile_counts: torch.Tensor  # (num_tiles,) int32 true counts (untruncated)
    overflow_pairs: torch.Tensor  # () int32 dropped by per-gaussian budget
    overflow_tiles: torch.Tensor  # () int32 beyond max_pairs_per_tile


def bin_gaussians(rect, depth, valid, grid_w: int, grid_h: int,
                  max_tiles_per_gaussian: int, max_pairs_per_tile: int,
                  xy=None, conic=None, q_cut=None,
                  tile_size: int = 16) -> Binning:
    """Sort-based binning into a dense (num_tiles, max_pairs_per_tile)
    table: each tile's list in [tile | quantized depth] order, the nearest
    max_pairs_per_tile kept. Same contract and integer results as the JAX
    function (hairgs_tpu/render/binning.py:417-471)."""
    dev = rect.device
    n = rect.shape[0]
    r_max = max_tiles_per_gaussian
    num_tiles = grid_w * grid_h

    tile, overflow_pairs = _expand_pairs(
        rect, valid, grid_w, grid_h, r_max,
        xy=xy, conic=conic, q_cut=q_cut, tile_size=tile_size)
    dq, levels = _quantize_depth(depth, num_tiles)
    # the JAX sort is stable and lexicographic on (tile, dq) over the
    # Gaussian-major flat order; dq < levels + 1, so one stable sort of the
    # fused key gives the same order. int64: no width to check
    key = tile.to(torch.int64) * (levels + 1) + dq.to(torch.int64)[:, None]
    sorted_key, perm = torch.sort(key.reshape(-1), stable=True)
    sorted_tile = torch.div(sorted_key, levels + 1, rounding_mode="floor")
    sorted_gid = torch.div(perm, r_max, rounding_mode="floor").to(torch.int32)

    tile_ids = torch.arange(num_tiles, dtype=sorted_tile.dtype, device=dev)
    starts = torch.searchsorted(sorted_tile, tile_ids, side="left").to(torch.int32)
    ends = torch.searchsorted(sorted_tile, tile_ids, side="right").to(torch.int32)
    counts = ends - starts

    k = torch.arange(max_pairs_per_tile, dtype=torch.int32, device=dev)
    idx = torch.clamp(starts[:, None] + k[None, :], 0, n * r_max - 1)
    gather_idx = sorted_gid[idx.long()]
    pair_valid = k[None, :] < torch.clamp(counts, max=max_pairs_per_tile)[:, None]
    overflow_tiles = torch.sum(torch.clamp(counts - max_pairs_per_tile, min=0),
                               dtype=torch.int32)
    return Binning(gather_idx=gather_idx, pair_valid=pair_valid,
                   tile_counts=counts, overflow_pairs=overflow_pairs,
                   overflow_tiles=overflow_tiles)


class _GatherPairs(torch.autograd.Function):
    """packed[paged_src // r_max] with a gather-only backward: slot
    gradients are gathered back per pair (inv_paged) and reduced over each
    Gaussian's r_max slots in float32; no scatter."""

    @staticmethod
    def forward(ctx, packed, paged_src, inv_paged, r_max):
        ctx.save_for_backward(inv_paged)
        ctx.r_max = r_max
        ctx.n_plus_1 = packed.shape[0]
        return packed[(paged_src // r_max).long()]

    @staticmethod
    def backward(ctx, g):
        (inv_paged,) = ctx.saved_tensors
        n = ctx.n_plus_1 - 1
        per_pair = g[inv_paged.long()]  # culled pairs hit zero slots
        per_gauss = per_pair.reshape(n, ctx.r_max, -1).to(torch.float32).sum(dim=1)
        d_packed = torch.cat(
            [per_gauss.to(g.dtype),
             torch.zeros((1, per_gauss.shape[1]), dtype=g.dtype, device=g.device)])
        return d_packed, None, None, None


def gather_pairs(packed, paged_src, inv_paged, r_max):
    """Paged pair table (P_pad, PACK) from the per-Gaussian packed table
    (N+1, PACK) whose last row is zero (the source of padding slots)."""
    return _GatherPairs.apply(packed, paged_src, inv_paged, r_max)


class _PermuteRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, fwd_idx, bwd_idx):
        ctx.save_for_backward(bwd_idx)
        ctx.n_rows = rows.shape[0]
        return rows[fwd_idx]

    @staticmethod
    def backward(ctx, g):
        (bwd_idx,) = ctx.saved_tensors
        back = g[bwd_idx]
        pad = ctx.n_rows - back.shape[0]
        if pad > 0:
            back = torch.cat([back, back.new_zeros((pad,) + back.shape[1:])])
        return back, None, None


def permute_rows(rows, fwd_idx, bwd_idx):
    """rows[fwd_idx] whose backward is a gather, g[bwd_idx], instead of
    autograd's scatter-add (binning.py:380-406 of the JAX package; the
    depth-slab render selects its rows with it).

    fwd_idx and bwd_idx are mutually inverse over the real entries; padding
    entries on either side point at zero rows or slots, and the cotangent
    of `rows` gets zero rows appended up to rows' length. On a permutation
    it equals autograd's index_add bit for bit: every row receives exactly
    one cotangent row."""
    return _PermuteRows.apply(rows, fwd_idx, bwd_idx)
