"""Per-tile front-to-back compositing over the chunk-aligned paged pair
table (counterpart of hairgs_tpu/render/pallas_composite.py's
`composite_pairs` custom VJP and its two Pallas kernels).

Two planes per pair slot: an 8-row f32 geometry plane [x, y, conic_a,
conic_b, conic_c, opacity, aux0, aux1] and a C_pad-row feature plane. The
forward composites each 16x16 tile over its own page; the backward walks the
page back to front and writes per-slot gradients into that tile's own slots
(no atomics). The aux rows receive the photometric-only viewspace gradients
(densification statistics) from a second cotangent, so one backward serves
both the parameter gradients and the statistics.

Chunk semantics (a property of the reference, reproduced as it is): inside a
chunk a pair is live while the transmittance prefix over ALL pairs of the
chunk stays >= T_EPS; at the chunk's end T is multiplied by the live pairs'
(1 - alpha) only, so a pixel that tripped the latch starts again at the next
chunk from its frozen T. `chunk` is therefore part of the function, not only
a schedule. Besides the transmittance at each chunk's start (`tstarts`) the
forward records each pixel's latch slot per chunk (`latch`, int16, -1 for
none), and the kernel backward starts each chunk from it and from the
transmittance after the chunk instead of running the chunk forward again;
the plain backward keeps that rerun as the specification.

The feature plane is float32 or bfloat16 (`RasterConfig.feat_bf16`, as in
pallas_composite.py:103-113): a bf16 feature is widened to float32 where it
is read and every sum stays float32; the backward writes d_feat in the
plane's dtype, each slot's float32 sum rounded once to nearest-even. The
gates, alpha, T and the latch touch no feature, so T, `tstarts` and
`latch` of a bf16 plane equal those of the f32 plane bit for bit.

On a CUDA tensor each pass launches its hand-written kernel
(csrc/composite_fwd.cu, csrc/composite_bwd.cu; one C entry point per
feature dtype) or raises; on a CPU tensor it runs the plain PyTorch version
below, which walks the slots in the same order with the same float32
operations, the pixel sums of the backward included, so on the card the
two agree bit for bit. The kernels skip, per warp, the pairs whose
alpha >= alpha_min ellipse misses the warp's pixel rows (`warp_reach_plain`
is that test), which changes no sum.
"""

import ctypes

import torch

from hairgs_tpu_torch import kernels

ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4
ALPHA_MAX = 0.99
GEO_ROWS = 8  # x, y, a, b, c, opacity, aux0, aux1
KERNEL_TILE = 16  # the kernels run one thread per pixel of a 16x16 tile
WARP = 32
MAX_KERNEL_CHANNELS = 8
FEAT_DTYPES = {torch.float32: "", torch.bfloat16: "_bf16"}

# launches of each hand-written kernel, per feature dtype; a wrapper adds
# one where it launches. The backward without the statistics rows (its
# other template instance) counts under its own "_nostats" key
launches = {"composite_fwd": 0, "composite_bwd": 0,
            "composite_fwd_bf16": 0, "composite_bwd_bf16": 0,
            "composite_bwd_nostats": 0, "composite_bwd_bf16_nostats": 0}


def reset_launches():
    for k in launches:
        launches[k] = 0


def pack_geo_rows(xy, conic, opacity, aux=None):
    """Per-Gaussian geometry rows (N, 8) f32: [x, y, a, b, c, opacity, aux0,
    aux1]. The forward never reads the aux rows; the backward writes the
    photometric-only viewspace gradients there."""
    n = xy.shape[0]
    if aux is None:
        aux = torch.zeros((n, 2), dtype=xy.dtype, device=xy.device)
    return torch.cat([xy[:, 0:1], xy[:, 1:2], conic, opacity[:, None], aux], dim=1)


def pad_feat_rows(features, feat_bf16: bool):
    """Feature plane (N, C_pad), C padded up to a multiple of 8, cast to
    bf16 when asked (8 bf16 values are 16 bytes)."""
    pad = (-features.shape[1]) % 8
    if pad:
        features = torch.nn.functional.pad(features, (0, pad))
    if feat_bf16:
        features = features.to(torch.bfloat16)
    return features


# ---------------------------------------------------------------- plain


def _pixel_coords(nt, grid_w, tile_size, device):
    t = torch.arange(nt, device=device)
    p = torch.arange(tile_size * tile_size, device=device)
    px = ((t % grid_w) * tile_size)[:, None] + (p % tile_size)[None, :]
    py = ((t // grid_w) * tile_size)[:, None] + (p // tile_size)[None, :]
    return px.to(torch.float32), py.to(torch.float32)


def _slot_quantities(geo, slot, inmask, px, py, alpha_min):
    """alpha, G, ok, dx, dy and the conic/opacity of one slot per tile
    (NT tiles x PIX pixels), exactly as the kernels compute them."""
    g = geo[:, slot]  # (8, NT)
    xg, yg, a, b, c, opa = (g[r][:, None] for r in range(6))
    dx = xg - px
    dy = yg - py
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    G = torch.exp(power)
    alpha = torch.clamp(opa * G, max=ALPHA_MAX)
    ok = (power <= 0.0) & (alpha >= alpha_min) & inmask[:, None]
    alpha = torch.where(ok, alpha, torch.zeros_like(alpha))
    return alpha, G, ok, dx, dy, a, b, c, opa


def _slots_in_chunk(counts_host, j, chunk):
    """The most slots any tile has in chunk j (a host-side loop bound)."""
    left = [min(chunk, max(0, c - j * chunk)) for c in counts_host]
    return max(left, default=0)


def composite_pairs_fwd_plain(geo, feat, starts, counts, grid_w, tile_size,
                              chunk, max_chunks, num_channels,
                              alpha_min=ALPHA_MIN):
    """Plain PyTorch forward: a loop over chunks and their slots,
    vectorised over tiles and pixels. Returns out (NT, PIX, C), trans
    (NT, PIX), tstarts (NT * max_chunks, PIX), the transmittance at the
    start of every chunk j < ceil(count / chunk) (zero elsewhere), and
    latch (NT * max_chunks, PIX) int16: for every chunk that runs, the slot
    (within the chunk) of the first pair whose gate passes but would take
    the pixel below T_EPS, after which the pixel is out for the rest of the
    chunk; -1 for none and for chunks that do not run."""
    dev = geo.device
    nt = starts.shape[0]
    pix = tile_size * tile_size
    p_pad = geo.shape[1]
    px, py = _pixel_coords(nt, grid_w, tile_size, dev)
    T = torch.ones((nt, pix), dtype=torch.float32, device=dev)
    acc = torch.zeros((nt, pix, num_channels), dtype=torch.float32, device=dev)
    tstarts = torch.zeros((nt, max_chunks, pix), dtype=torch.float32, device=dev)
    latch = torch.full((nt, max_chunks, pix), -1, dtype=torch.int16, device=dev)
    nch = (counts + chunk - 1) // chunk
    done = torch.zeros(nt, dtype=torch.bool, device=dev)
    counts_host = counts.tolist()
    n_chunks = max([(c + chunk - 1) // chunk for c in counts_host], default=0)
    for j in range(n_chunks):
        act = j < nch
        tstarts[:, j] = torch.where(act[:, None], T, torch.zeros_like(T))
        run = act & ~done
        t_run = T
        alive = run[:, None].expand(nt, pix)
        for k in range(_slots_in_chunk(counts_host, j, chunk)):
            pos = j * chunk + k
            inmask = run & (pos < counts)
            slot = torch.clamp(starts + pos, max=p_pad - 1).long()
            alpha, _, ok, *_ = _slot_quantities(geo, slot, inmask, px, py, alpha_min)
            t_next = t_run * (1.0 - alpha)
            trip = alive & ok & (t_next < T_EPS)
            latch[:, j] = torch.where(trip, k, latch[:, j])
            alive = alive & ~trip
            w = torch.where(alive, alpha * t_run, torch.zeros_like(alpha))
            f = feat[:num_channels, slot].T.to(torch.float32)  # (NT, C)
            acc = acc + w[..., None] * f[:, None, :]
            t_run = torch.where(alive, t_next, t_run)
        T = t_run
        done = done | (act & (T.amax(dim=1) < T_EPS))
    return (acc, T, tstarts.reshape(nt * max_chunks, pix),
            latch.reshape(nt * max_chunks, pix))


def _rerun_chunk(geo, starts, counts, t_start, act, j, n_slots, px, py, chunk,
                 alpha_min):
    """The backward's specification of chunk j's forward: from the chunk's
    start transmittance, whether each pixel is still live at each slot, and
    the transmittance after its last live pair."""
    nt, pix = t_start.shape
    p_pad = geo.shape[1]
    t_cur = t_start
    alive = act[:, None].expand(nt, pix)
    alive_at, ok_at = [], []
    for k in range(n_slots):
        pos = j * chunk + k
        inmask = act & (pos < counts)
        slot = torch.clamp(starts + pos, max=p_pad - 1).long()
        alpha, _, ok, *_ = _slot_quantities(geo, slot, inmask, px, py, alpha_min)
        t_next = t_cur * (1.0 - alpha)
        alive = alive & (t_next >= T_EPS)
        alive_at.append(alive)
        ok_at.append(ok)
        t_cur = torch.where(alive, t_next, t_cur)
    return alive_at, ok_at, t_cur


def rerun_latch_plain(geo, starts, counts, tstarts, trans, grid_w, tile_size,
                      chunk, max_chunks, alpha_min=ALPHA_MIN):
    """What the plain backward's rerun finds for every chunk that the
    clamped counts keep: the slot at which it drops each pixel (the first
    slot whose gate passes though the pixel is no longer live, -1 for none)
    and the transmittance after the chunk, as (NT * max_chunks, PIX)
    planes (-1 and 0 elsewhere). The forward's latch plane and its
    tstarts[j + 1] (or the final T after the last chunk) must equal them:
    the kernel backward starts each chunk from those instead."""
    dev = geo.device
    nt = starts.shape[0]
    pix = tile_size * tile_size
    counts = clamp_counts_to_live_chunks(counts, tstarts, chunk, max_chunks)
    px, py = _pixel_coords(nt, grid_w, tile_size, dev)
    ts = tstarts.reshape(nt, max_chunks, pix)
    drop = torch.full((nt, max_chunks, pix), -1, dtype=torch.int16, device=dev)
    t_after = torch.zeros((nt, max_chunks, pix), dtype=torch.float32, device=dev)
    nch = (counts + chunk - 1) // chunk
    counts_host = counts.tolist()
    n_chunks = max([(c + chunk - 1) // chunk for c in counts_host], default=0)
    for j in range(n_chunks):
        act = j < nch
        alive_at, ok_at, t_cur = _rerun_chunk(
            geo, starts, counts, ts[:, j], act, j,
            _slots_in_chunk(counts_host, j, chunk), px, py, chunk, alpha_min)
        for k in reversed(range(len(alive_at))):
            drop[:, j] = torch.where(ok_at[k] & ~alive_at[k], k, drop[:, j])
        t_after[:, j] = torch.where(act[:, None], t_cur, torch.zeros_like(t_cur))
    return drop.reshape(nt * max_chunks, pix), t_after.reshape(nt * max_chunks, pix)


def composite_pairs_bwd_plain(geo, feat, starts, counts, tstarts, latch,
                              trans, g_out, g_photo, g_trans, grid_w,
                              tile_size, chunk, max_chunks, num_channels,
                              with_stats, alpha_min=ALPHA_MIN):
    """Plain PyTorch backward. `counts` are already clamped to the chunks
    the forward ran. g_out is the total-loss cotangent (NT, PIX, C), g_photo
    the photometric-only one (read only with_stats), g_trans (NT, PIX).
    Returns d_geo (8, P_pad) [dx, dy, da, db, dc, dopa, dx2, dy2] and d_feat
    (C_pad, P_pad) in the feature plane's dtype, each slot written by its
    own tile.

    The arithmetic is the kernel's, step for step: the transmittance before
    a pair is recovered by dividing by (1 - alpha) on the way back, f . g
    is summed channel by channel, and the 256 pixels of a tile are summed
    as the kernel sums them (`_block_sum`). As the specification, it runs
    each chunk forward again from `tstarts` to find the live pairs and the
    transmittance after them; the forward's `latch` plane, from which the
    kernel starts instead, is not read here."""
    del latch
    dev = geo.device
    nt = starts.shape[0]
    pix = tile_size * tile_size
    p_pad = geo.shape[1]
    px, py = _pixel_coords(nt, grid_w, tile_size, dev)
    d_geo = torch.zeros_like(geo)
    d_feat = torch.zeros_like(feat)
    ts = tstarts.reshape(nt, max_chunks, pix)
    nch = (counts + chunk - 1) // chunk
    counts_host = counts.tolist()
    n_chunks = max([(c + chunk - 1) // chunk for c in counts_host], default=0)
    # the suffix carry starts at T_final * g_T; the photometric carry at 0
    carry = trans * g_trans
    carry2 = torch.zeros_like(carry)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for j in reversed(range(n_chunks)):
        act = j < nch
        n_slots = _slots_in_chunk(counts_host, j, chunk)
        # forward again from the chunk's start: the latch at each slot and
        # the transmittance after the last live pair
        alive_at, _, t_cur = _rerun_chunk(geo, starts, counts, ts[:, j], act, j,
                                          n_slots, px, py, chunk, alpha_min)
        for k in reversed(range(n_slots)):
            pos = j * chunk + k
            inmask = act & (pos < counts)
            slot = torch.clamp(starts + pos, max=p_pad - 1).long()
            alpha, G, ok, dx, dy, a, b, c, opa = _slot_quantities(
                geo, slot, inmask, px, py, alpha_min)
            use = alive_at[k] & ok
            one_minus = 1.0 - alpha
            t_excl = torch.where(use, t_cur / one_minus, t_cur)
            w = torch.where(use, alpha * t_excl, zero)
            f = feat[:num_channels, slot].T.to(torch.float32)  # (NT, C)

            def geo_grads(g, carry):
                fdotg = g[:, :, 0] * f[:, None, 0]
                for ch in range(1, num_channels):
                    fdotg = fdotg + g[:, :, ch] * f[:, None, ch]
                dalpha = torch.where(use, t_excl * fdotg - carry / one_minus, zero)
                dpower = torch.where(use, opa * G * dalpha, zero)
                return fdotg, dalpha, dpower

            fdotg, dalpha, dpower = geo_grads(g_out, carry)
            rows = [
                dpower * (-(a * dx + b * dy)),
                dpower * (-(c * dy + b * dx)),
                dpower * (-0.5 * dx * dx),
                dpower * (-dx * dy),
                dpower * (-0.5 * dy * dy),
                torch.where(use, G * dalpha, zero),
            ]
            carry = carry + w * fdotg
            if with_stats:
                fdotg2, _, dpower2 = geo_grads(g_photo, carry2)
                rows += [dpower2 * (-(a * dx + b * dy)),
                         dpower2 * (-(c * dy + b * dx))]
                carry2 = carry2 + w * fdotg2
            else:
                rows += [torch.zeros_like(dpower)] * 2
            rows = _block_sum(torch.stack(rows, dim=2))  # (NT, 8)
            d_f = _block_sum(g_out * w[..., None])  # (NT, C)
            t_cur = t_excl
            sel = slot[inmask]
            d_geo[:, sel] = rows.T[:, inmask]
            d_feat[:num_channels, sel] = d_f.T[:, inmask].to(d_feat.dtype)
    return d_geo, d_feat


def _block_sum(v):
    """Sum over the pixel axis (axis 1, 256 pixels) in the backward
    kernel's order: a butterfly over the 32 lanes of each warp (lane 0's
    value of the xor-shuffle tree), then the 8 warp partials added in turn
    to 0."""
    x = v.reshape(v.shape[0], v.shape[1] // WARP, WARP, *v.shape[2:])
    half = WARP // 2
    while half:
        x = x[:, :, :half] + x[:, :, half:2 * half]
        half //= 2
    s = torch.zeros_like(x[:, 0, 0])
    for w in range(x.shape[1]):
        s = s + x[:, w, 0]
    return s


def warp_reach_plain(geo_cols, tx0, ty0, alpha_min=ALPHA_MIN):
    """The kernels' per-warp cull predicate (csrc/composite_common.cuh::
    warp_reach), in float64: for pairs with geometry columns geo_cols
    (>= 6, n) [x, y, a, b, c, opacity] in tiles whose first pixel is
    (tx0, ty0) (n,), an (n,) int mask whose bit w is set when the pair's
    alpha >= alpha_min ellipse may reach pixel rows 2w and 2w+1 of the
    tile. A cleared bit means every pixel of those rows fails the fp32
    gate of `_slot_quantities`: the bound 2 ln(opacity / alpha_min) on the
    quadratic form is widened for the rounding of its fp32 terms and of
    expf. Opacity below alpha_min: no warp; a position or conic that is not
    finite, or a conic not positive definite to 1e-12 of a c: every warp."""
    alpha_min = torch.tensor(alpha_min, dtype=torch.float32).item()  # as the kernels take it
    x, y, a, b, c, opa = (geo_cols[r].to(torch.float64) for r in range(6))
    tx0 = torch.as_tensor(tx0, dtype=torch.float64, device=x.device)
    ty0 = torch.as_tensor(ty0, dtype=torch.float64, device=x.device)
    last = KERNEL_TILE - 1.0
    none = ~(opa >= alpha_min) | (not alpha_min <= ALPHA_MAX)
    finite = (torch.isfinite(x) & torch.isfinite(y) & torch.isfinite(a)
              & torch.isfinite(b) & torch.isfinite(c))
    zero = torch.zeros_like(a)
    a, b, c = (torch.where(finite, v, zero) for v in (a, b, c))
    det = a * c - b * b
    definite = finite & (a > 0) & (c > 0) & (det > 1e-12 * a * c)
    safe_det = torch.where(definite, det, torch.ones_like(det))
    q = torch.log(torch.clamp(opa, min=alpha_min) / alpha_min)
    dx0 = torch.where(finite, x, zero) - tx0
    dy0 = torch.where(finite, y, zero) - ty0
    big_x = torch.maximum(dx0.abs(), (dx0 - last).abs())
    big_y = torch.maximum(dy0.abs(), (dy0 - last).abs())
    s = a * big_x * big_x + c * big_y * big_y + 2.0 * b.abs() * big_x * big_y
    r = (2.0 * q + 1e-5) * (1.0 + 1e-6) + 2.0**-17 * s
    ex = torch.sqrt(torch.clamp(r * c / safe_det, min=0)) * (1.0 + 1e-3) + 1e-3
    ey = torch.sqrt(torch.clamp(r * a / safe_det, min=0)) * (1.0 + 1e-3) + 1e-3
    cols = torch.ceil(torch.clamp(dx0 - ex, min=0.0)) <= torch.floor(
        torch.clamp(dx0 + ex, max=last))
    lo = torch.ceil(torch.clamp(dy0 - ey, min=0.0))
    hi = torch.floor(torch.clamp(dy0 + ey, max=last))
    rows = cols & (lo <= hi)
    w_lo = (torch.clamp(lo, 0, last).long() >> 1)
    w_hi = (torch.clamp(hi, 0, last).long() >> 1)
    strip = ((1 << (w_hi + 1)) - 1) & ~((1 << w_lo) - 1)
    mask = torch.where(rows, strip, torch.zeros_like(strip))
    mask = torch.where(definite, mask, torch.full_like(mask, 0xFF))
    return torch.where(none, torch.zeros_like(mask), mask)


# ---------------------------------------------------------------- kernels


def _c_function(lib_name, name, n_ptr, n_int, n_float):
    lib = kernels.load(lib_name)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_float] * n_float + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(t, name, shape, dtype, device):
    if t.device != device or t.dtype != dtype or not t.is_contiguous() \
            or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: expected a contiguous {dtype} tensor of shape "
            f"{tuple(shape)} on {device}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device} (contiguous={t.is_contiguous()})")


def _check_common(geo, feat, starts, counts, tile_size, num_channels):
    dev = geo.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA compositor takes CUDA tensors, got {dev}")
    if tile_size != KERNEL_TILE:
        raise ValueError(f"the CUDA compositor needs tile_size {KERNEL_TILE}")
    if not 1 <= num_channels <= MAX_KERNEL_CHANNELS:
        raise ValueError(f"the CUDA compositor takes 1..{MAX_KERNEL_CHANNELS} "
                         f"channels, got {num_channels}")
    p_pad = geo.shape[1]
    nt = starts.shape[0]
    _check(geo, "geo_rows", (GEO_ROWS, p_pad), torch.float32, dev)
    if feat.dtype not in FEAT_DTYPES:
        raise ValueError(f"feat_rows: float32 or bfloat16, got {feat.dtype}")
    _check(feat, "feat_rows", (feat.shape[0], p_pad), feat.dtype, dev)
    if feat.shape[0] < num_channels:
        raise ValueError("feat_rows has fewer rows than num_channels")
    _check(starts, "starts", (nt,), torch.int32, dev)
    _check(counts, "counts", (nt,), torch.int32, dev)
    return dev, nt, p_pad, FEAT_DTYPES[feat.dtype]


def composite_pairs_fwd_cuda(geo, feat, starts, counts, grid_w, tile_size,
                             chunk, max_chunks, num_channels,
                             alpha_min=ALPHA_MIN):
    """Launches csrc/composite_fwd.cu (entry point composite_fwd or
    composite_fwd_bf16, by the feature dtype); same contract as the plain
    forward."""
    dev, nt, p_pad, suffix = _check_common(geo, feat, starts, counts,
                                           tile_size, num_channels)
    pix = tile_size * tile_size
    name = "composite_fwd" + suffix
    fn = _c_function("composite_fwd", name, 8, 7, 1)
    out = torch.empty((nt, pix, num_channels), dtype=torch.float32, device=dev)
    trans = torch.empty((nt, pix), dtype=torch.float32, device=dev)
    tstarts = torch.zeros((nt * max_chunks, pix), dtype=torch.float32, device=dev)
    latch = torch.full((nt * max_chunks, pix), -1, dtype=torch.int16, device=dev)
    err = fn(geo.data_ptr(), feat.data_ptr(), starts.data_ptr(),
             counts.data_ptr(), out.data_ptr(), trans.data_ptr(),
             tstarts.data_ptr(), latch.data_ptr(), nt, p_pad, grid_w, chunk,
             max_chunks, num_channels, feat.shape[0], alpha_min,
             torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    launches[name] += 1
    return out, trans, tstarts, latch


def composite_pairs_bwd_cuda(geo, feat, starts, counts, tstarts, latch, trans,
                             g_out, g_photo, g_trans, grid_w, tile_size,
                             chunk, max_chunks, num_channels, with_stats,
                             alpha_min=ALPHA_MIN):
    """Launches csrc/composite_bwd.cu (entry point composite_bwd or
    composite_bwd_bf16); same contract as the plain backward, but each
    chunk starts from the forward's latch plane and tstarts. d_feat has
    the feature plane's dtype."""
    dev, nt, p_pad, suffix = _check_common(geo, feat, starts, counts,
                                           tile_size, num_channels)
    pix = tile_size * tile_size
    _check(tstarts, "tstarts", (nt * max_chunks, pix), torch.float32, dev)
    _check(latch, "latch", (nt * max_chunks, pix), torch.int16, dev)
    _check(trans, "trans", (nt, pix), torch.float32, dev)
    _check(g_out, "g_out", (nt, pix, num_channels), torch.float32, dev)
    _check(g_photo, "g_photo", (nt, pix, num_channels), torch.float32, dev)
    _check(g_trans, "g_trans", (nt, pix), torch.float32, dev)
    name = "composite_bwd" + suffix
    fn = _c_function("composite_bwd", name, 12, 8, 1)
    d_geo = torch.zeros_like(geo)
    d_feat = torch.zeros_like(feat)
    err = fn(geo.data_ptr(), feat.data_ptr(), starts.data_ptr(),
             counts.data_ptr(), tstarts.data_ptr(), latch.data_ptr(),
             trans.data_ptr(), g_out.data_ptr(), g_photo.data_ptr(),
             g_trans.data_ptr(), d_geo.data_ptr(), d_feat.data_ptr(), nt, p_pad,
             grid_w, chunk, max_chunks, num_channels, feat.shape[0],
             int(bool(with_stats)), alpha_min,
             torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    launches[name if with_stats else name + "_nostats"] += 1
    return d_geo, d_feat


def blocks_per_sm(name, num_channels, chunk, bf16=False, with_stats=True):
    """Resident blocks per SM of kernel `name` ("composite_fwd" or
    "composite_bwd") at these settings, as the CUDA occupancy calculator
    gives it for the kernel's registers and shared memory."""
    lib = kernels.load(name)
    fn = getattr(lib, name + "_blocks_per_sm")
    blocks = ctypes.c_int(0)
    args = [num_channels, int(bf16)] + ([int(with_stats)] if name == "composite_bwd" else [])
    err = fn(*(ctypes.c_int(a) for a in args + [chunk]), ctypes.byref(blocks))
    if err:
        raise RuntimeError(f"{name} occupancy query failed: CUDA error {err}")
    return blocks.value


def _dispatch(t, plain, cuda):
    if t.device.type == "cuda":
        return cuda
    if t.device.type == "cpu":
        return plain
    raise ValueError(f"no compositor for device {t.device}")


def composite_pairs_fwd(geo, feat, starts, counts, grid_w, tile_size, chunk,
                        max_chunks, num_channels, alpha_min=ALPHA_MIN):
    """The kernel on a CUDA tensor, the plain version on a CPU tensor."""
    fn = _dispatch(geo, composite_pairs_fwd_plain, composite_pairs_fwd_cuda)
    return fn(geo, feat, starts, counts, grid_w, tile_size, chunk, max_chunks,
              num_channels, alpha_min)


def composite_pairs_bwd(geo, feat, starts, counts, tstarts, latch, trans, g_out,
                        g_photo, g_trans, grid_w, tile_size, chunk,
                        max_chunks, num_channels, with_stats,
                        alpha_min=ALPHA_MIN):
    """The kernel on a CUDA tensor, the plain version on a CPU tensor."""
    fn = _dispatch(geo, composite_pairs_bwd_plain, composite_pairs_bwd_cuda)
    return fn(geo, feat, starts, counts, tstarts, latch, trans, g_out, g_photo,
              g_trans, grid_w, tile_size, chunk, max_chunks, num_channels,
              with_stats, alpha_min)


def clamp_counts_to_live_chunks(counts, tstarts, chunk, max_chunks):
    """The backward's per-tile counts: chunk j ran iff its start
    transmittance still had a live pixel (pallas_composite.py:613-626)."""
    nt = counts.shape[0]
    chunk_live = tstarts.reshape(nt, max_chunks, -1).amax(dim=2) >= T_EPS
    j_ids = torch.arange(max_chunks, device=counts.device)[None, :]
    nchunks = (counts + chunk - 1) // chunk
    live_chunks = torch.sum(chunk_live & (j_ids < nchunks[:, None]), dim=1,
                            dtype=torch.int32)
    return torch.minimum(counts, live_chunks * chunk)


class _CompositePairs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, geo_rows, feat_rows, starts, counts, grid_w, tile_size,
                chunk, max_chunks, num_channels, with_stats, alpha_min):
        geo = geo_rows.contiguous()
        feat = feat_rows.contiguous()
        out, trans, tstarts, latch = composite_pairs_fwd(
            geo, feat, starts, counts, grid_w, tile_size, chunk, max_chunks,
            num_channels, alpha_min)
        ctx.save_for_backward(geo, feat, starts, counts, tstarts, latch, trans)
        ctx.cfg = (grid_w, tile_size, chunk, max_chunks, num_channels,
                   with_stats, alpha_min)
        ctx.set_materialize_grads(False)
        return out, out.clone(), trans

    @staticmethod
    def backward(ctx, g_aux, g_photo, g_trans):
        geo, feat, starts, counts, tstarts, latch, trans = ctx.saved_tensors
        (grid_w, tile_size, chunk, max_chunks, num_channels, with_stats,
         alpha_min) = ctx.cfg
        if g_aux is None and g_photo is None and g_trans is None:
            return (None,) * 11
        nt, pix = trans.shape
        zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32,
                                           device=geo.device)
        if g_photo is None:
            g_photo = zeros(nt, pix, num_channels)
        g_out = g_photo if g_aux is None else g_aux + g_photo
        if g_trans is None:
            g_trans = zeros(nt, pix)
        counts = clamp_counts_to_live_chunks(counts, tstarts, chunk, max_chunks)
        d_geo, d_feat = composite_pairs_bwd(
            geo, feat, starts, counts, tstarts, latch, trans, g_out.contiguous(),
            g_photo.contiguous(), g_trans.contiguous(), grid_w, tile_size,
            chunk, max_chunks, num_channels, with_stats, alpha_min)
        return (d_geo, d_feat) + (None,) * 9


def composite_pairs(geo_rows, feat_rows, starts, counts, grid_w, grid_h,
                    tile_size, chunk, max_chunks, num_channels,
                    with_stats=True, alpha_min=ALPHA_MIN):
    """Tile compositing over the paged pair table.

    geo_rows (8, P_pad) f32; feat_rows (C_pad, P_pad) f32 or bf16; starts
    (chunk-aligned page offsets) and counts (NT,) int32. Returns
    (out, out_photo, trans): out and out_photo hold the same values
    (NT, PIX, C). Compute photometric losses from out_photo and everything
    else from out; the backward then uses the sum of both cotangents for the
    parameter gradients and out_photo's alone for the aux-row viewspace
    gradients. A cotangent that is never produced counts as zeros.
    """
    del grid_h  # the tile count comes from starts
    return _CompositePairs.apply(geo_rows, feat_rows, starts, counts, grid_w,
                                 tile_size, chunk, max_chunks, num_channels,
                                 with_stats, alpha_min)
