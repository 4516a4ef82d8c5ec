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
a schedule.

The feature plane is float32 or bfloat16 (`RasterConfig.feat_bf16`, as in
pallas_composite.py:103-113): a bf16 feature is widened to float32 where it
is read and every sum stays float32; the backward writes d_feat in the
plane's dtype, each slot's float32 sum rounded once to nearest-even. The
gates, alpha, T and the latch touch no feature, so T and `tstarts` of a
bf16 plane equal those of the f32 plane bit for bit.

On a CUDA tensor each pass launches its hand-written kernel
(csrc/composite_fwd.cu, csrc/composite_bwd.cu; one C entry point per
feature dtype) or raises; on a CPU tensor it runs the plain PyTorch version
below, which walks the slots in the same order with the same float32
operations, the pixel sums of the backward included, so on the card the
two agree bit for bit.
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
# one where it launches
launches = {"composite_fwd": 0, "composite_bwd": 0,
            "composite_fwd_bf16": 0, "composite_bwd_bf16": 0}


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
    (NT, PIX) and tstarts (NT * max_chunks, PIX), the transmittance at the
    start of every chunk j < ceil(count / chunk) (zero elsewhere)."""
    dev = geo.device
    nt = starts.shape[0]
    pix = tile_size * tile_size
    p_pad = geo.shape[1]
    px, py = _pixel_coords(nt, grid_w, tile_size, dev)
    T = torch.ones((nt, pix), dtype=torch.float32, device=dev)
    acc = torch.zeros((nt, pix, num_channels), dtype=torch.float32, device=dev)
    tstarts = torch.zeros((nt, max_chunks, pix), dtype=torch.float32, device=dev)
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
            alpha, *_ = _slot_quantities(geo, slot, inmask, px, py, alpha_min)
            t_next = t_run * (1.0 - alpha)
            alive = alive & (t_next >= T_EPS)
            w = torch.where(alive, alpha * t_run, torch.zeros_like(alpha))
            f = feat[:num_channels, slot].T.to(torch.float32)  # (NT, C)
            acc = acc + w[..., None] * f[:, None, :]
            t_run = torch.where(alive, t_next, t_run)
        T = t_run
        done = done | (act & (T.amax(dim=1) < T_EPS))
    return acc, T, tstarts.reshape(nt * max_chunks, pix)


def composite_pairs_bwd_plain(geo, feat, starts, counts, tstarts, trans,
                              g_out, g_photo, g_trans, grid_w, tile_size,
                              chunk, max_chunks, num_channels, with_stats,
                              alpha_min=ALPHA_MIN):
    """Plain PyTorch backward. `counts` are already clamped to the chunks
    the forward ran. g_out is the total-loss cotangent (NT, PIX, C), g_photo
    the photometric-only one (read only with_stats), g_trans (NT, PIX).
    Returns d_geo (8, P_pad) [dx, dy, da, db, dc, dopa, dx2, dy2] and d_feat
    (C_pad, P_pad) in the feature plane's dtype, each slot written by its
    own tile.

    The arithmetic is the kernel's, step for step: the transmittance before
    a pair is recovered by dividing by (1 - alpha) on the way back, f . g
    is summed channel by channel, and the 256 pixels of a tile are summed
    as the kernel sums them (`_block_sum`)."""
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
        t_cur = ts[:, j]
        alive = act[:, None].expand(nt, pix)
        alive_at = []
        for k in range(n_slots):
            pos = j * chunk + k
            inmask = act & (pos < counts)
            slot = torch.clamp(starts + pos, max=p_pad - 1).long()
            alpha, *_ = _slot_quantities(geo, slot, inmask, px, py, alpha_min)
            t_next = t_cur * (1.0 - alpha)
            alive = alive & (t_next >= T_EPS)
            alive_at.append(alive)
            t_cur = torch.where(alive, t_next, t_cur)
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
    fn = _c_function("composite_fwd", name, 7, 7, 1)
    out = torch.empty((nt, pix, num_channels), dtype=torch.float32, device=dev)
    trans = torch.empty((nt, pix), dtype=torch.float32, device=dev)
    tstarts = torch.zeros((nt * max_chunks, pix), dtype=torch.float32, device=dev)
    err = fn(geo.data_ptr(), feat.data_ptr(), starts.data_ptr(),
             counts.data_ptr(), out.data_ptr(), trans.data_ptr(),
             tstarts.data_ptr(), nt, p_pad, grid_w, chunk, max_chunks,
             num_channels, feat.shape[0], alpha_min,
             torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    launches[name] += 1
    return out, trans, tstarts


def composite_pairs_bwd_cuda(geo, feat, starts, counts, tstarts, trans,
                             g_out, g_photo, g_trans, grid_w, tile_size,
                             chunk, max_chunks, num_channels, with_stats,
                             alpha_min=ALPHA_MIN):
    """Launches csrc/composite_bwd.cu (entry point composite_bwd or
    composite_bwd_bf16); same contract as the plain backward. d_feat has
    the feature plane's dtype."""
    dev, nt, p_pad, suffix = _check_common(geo, feat, starts, counts,
                                           tile_size, num_channels)
    pix = tile_size * tile_size
    _check(tstarts, "tstarts", (nt * max_chunks, pix), torch.float32, dev)
    _check(trans, "trans", (nt, pix), torch.float32, dev)
    _check(g_out, "g_out", (nt, pix, num_channels), torch.float32, dev)
    _check(g_photo, "g_photo", (nt, pix, num_channels), torch.float32, dev)
    _check(g_trans, "g_trans", (nt, pix), torch.float32, dev)
    name = "composite_bwd" + suffix
    fn = _c_function("composite_bwd", name, 11, 8, 1)
    d_geo = torch.zeros_like(geo)
    d_feat = torch.zeros_like(feat)
    err = fn(geo.data_ptr(), feat.data_ptr(), starts.data_ptr(),
             counts.data_ptr(), tstarts.data_ptr(), trans.data_ptr(),
             g_out.data_ptr(), g_photo.data_ptr(), g_trans.data_ptr(),
             d_geo.data_ptr(), d_feat.data_ptr(), nt, p_pad, grid_w, chunk,
             max_chunks, num_channels, feat.shape[0], int(bool(with_stats)),
             alpha_min, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    launches[name] += 1
    return d_geo, d_feat


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


def composite_pairs_bwd(geo, feat, starts, counts, tstarts, trans, g_out,
                        g_photo, g_trans, grid_w, tile_size, chunk,
                        max_chunks, num_channels, with_stats,
                        alpha_min=ALPHA_MIN):
    """The kernel on a CUDA tensor, the plain version on a CPU tensor."""
    fn = _dispatch(geo, composite_pairs_bwd_plain, composite_pairs_bwd_cuda)
    return fn(geo, feat, starts, counts, tstarts, trans, g_out, g_photo,
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
        out, trans, tstarts = composite_pairs_fwd(
            geo, feat, starts, counts, grid_w, tile_size, chunk, max_chunks,
            num_channels, alpha_min)
        ctx.save_for_backward(geo, feat, starts, counts, tstarts, trans)
        ctx.cfg = (grid_w, tile_size, chunk, max_chunks, num_channels,
                   with_stats, alpha_min)
        ctx.set_materialize_grads(False)
        return out, out.clone(), trans

    @staticmethod
    def backward(ctx, g_aux, g_photo, g_trans):
        geo, feat, starts, counts, tstarts, trans = ctx.saved_tensors
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
            geo, feat, starts, counts, tstarts, trans, g_out.contiguous(),
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
