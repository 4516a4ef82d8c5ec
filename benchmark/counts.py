"""The yardstick's arithmetic: the card's peaks, and the operations and
bytes that the Stage-I step needs for given inputs, counted from shapes and
from the data (the compositor's gates), never from what an implementation
launches.

The compositor counts are frozen copies of the rule that the repository's
kernel table uses (16 fp32 operations per pair-pixel for the gates; 19 more
per passing pair-pixel in the forward, 7 of them the channel sums; 100 more
in the backward with the statistics rows, 4 fewer without).
"""

import torch

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
GATE_OPS = 16
FWD_PASS_OPS = 19
BWD_PASS_OPS = 100
PIX = 256
SSIM_TAPS = 11
SSIM_MAPS = 5  # mu1, mu2, E[x^2], E[y^2], E[xy]
SSIM_PIXEL_OPS = 20  # the SSIM map from the five filtered values
LOSS_PIXEL_OPS = 80  # L1 (3 ch), BCE, orientation (3x3 product, norm, atan2, fold)
PREPROCESS_OPS = 300  # per Gaussian: rotation, covariances, EWA, conic, features
ADAM_OPS = 12  # per parameter element
STATS_OPS = 8  # per Gaussian: the viewspace-gradient norm, max radius, count
BACKWARD_FACTOR = 2  # a backward costs twice its forward (SSIM, losses, preprocess)


def bound_ms(bytes_, ops):
    """The least time the card could take: the larger of bytes over the
    HBM rate and fp32 operations over the fp32 peak; and which bounds."""
    t_bytes = bytes_ / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def table_sizes(counts, chunk):
    """(tiles, pairs in the tiles' lists, chunks those lists fill)."""
    nchunks = (counts + chunk - 1) // chunk
    return counts.shape[0], int(counts.sum()), int(nchunks.sum())


def fwd_ops(C, gates):
    n_all, n_pass = gates
    return n_all * GATE_OPS + n_pass * (FWD_PASS_OPS - 7 + C)


def bwd_ops(gates, stats=True):
    n_all, n_pass = gates
    return n_all * GATE_OPS + n_pass * (BWD_PASS_OPS - (0 if stats else 4))


def fwd_bound_ms(counts, chunk, C, gates, feat_bytes=4):
    """Reads geometry rows 0-5 and the C feature rows of every pair in the
    tiles' lists and the tile tables; writes the image, T and each run
    chunk's start transmittance."""
    nt, pairs, chunks = table_sizes(counts, chunk)
    bytes_ = (4 * (pairs * 6 + 2 * nt + nt * PIX * (C + 1) + chunks * PIX)
              + feat_bytes * pairs * C)
    return bound_ms(bytes_, fwd_ops(C, gates))


def bwd_bound_ms(counts, chunk, C, gates, feat_bytes=4, stats=True):
    """Reads geometry rows 0-5 and the C feature rows of every pair, the
    tile tables, each chunk's start transmittance, T, the two image
    cotangents and g_T; writes the 8 (6 without stats) geometry and C
    feature gradients of those pairs."""
    nt, pairs, chunks = table_sizes(counts, chunk)
    rows = 8 if stats else 6
    bytes_ = (4 * (pairs * 6 + 2 * nt + chunks * PIX + nt * PIX * (2 + 2 * C)
                   + pairs * rows) + 2 * feat_bytes * pairs * C)
    return bound_ms(bytes_, bwd_ops(gates, stats))


def live_slots(starts, counts):
    """Slot index and tile of every pair the tiles' lists hold."""
    dev = starts.device
    c = counts.long()
    excl = torch.cumsum(c, 0) - c
    within = torch.arange(int(c.sum()), device=dev) - torch.repeat_interleave(excl, c)
    slot = torch.repeat_interleave(starts.long(), c) + within
    tile = torch.repeat_interleave(torch.arange(starts.shape[0], device=dev), c)
    return slot, tile


def gate_counts(geo, starts, counts, grid_w, alpha_min=1.0 / 255.0, batch=1 << 15):
    """(pair, pixel) combinations of the tiles' lists, and how many pass
    the alpha gates (power <= 0, alpha >= alpha_min): the work these
    inputs need. geo: the (8, P) geometry plane [x, y, a, b, c, opacity,
    ...]."""
    dev = geo.device
    slot, tile = live_slots(starts, counts)
    p = torch.arange(PIX, device=dev)
    n_pass = 0
    for i in range(0, slot.numel(), batch):
        g = geo[:, slot[i:i + batch]]
        t = tile[i:i + batch, None]
        dx = g[0][:, None] - ((t % grid_w) * 16 + p % 16).float()
        dy = g[1][:, None] - ((t // grid_w) * 16 + p // 16).float()
        power = (-0.5 * (g[2][:, None] * dx * dx + g[4][:, None] * dy * dy)
                 - g[3][:, None] * dx * dy)
        alpha = torch.clamp(g[5][:, None] * torch.exp(power), max=0.99)
        n_pass += int(((power <= 0.0) & (alpha >= alpha_min)).sum())
    return slot.numel() * PIX, n_pass


def step_ops(compositor_ops, pixels, splats, parameters):
    """fp32 operations of one training iteration: the compositor passes
    (`compositor_ops`, from the gates), SSIM as a separable 11-tap filter
    of five maps per channel, the per-pixel losses, preprocess per splat
    (Gaussian or strand segment), their backwards, the statistics, and Adam
    per parameter element (15 per Gaussian: xyz 3, SH DC 3, scaling 3,
    rotation 4, opacity 1, mask 1). Integer work (binning, sorting) is not
    counted."""
    ssim = 3 * (SSIM_MAPS * 2 * SSIM_TAPS * 2 + SSIM_PIXEL_OPS)
    per_pixel = (ssim + LOSS_PIXEL_OPS) * (1 + BACKWARD_FACTOR)
    per_splat = PREPROCESS_OPS * (1 + BACKWARD_FACTOR) + STATS_OPS
    return (compositor_ops + pixels * per_pixel + splats * per_splat
            + parameters * ADAM_OPS)
