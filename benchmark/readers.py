"""The per-layer readers. Each file under metrics/ binds one of these to its
metric's name (a quantity split by the end-to-end metric it moves, as
`.stage1` and `.stage3`, binds the same reader in each file); a reader
returns the value, or None where it finds nothing to read."""

import torch

from benchmark import counts

REPS = 20  # launches each compositor pass is timed over


def topology_share(ctx):
    """The share of the measured window's wall time spent in topology
    events (densification; a strand graph's merges), summed from the
    `topology_ms` that `training()` times around each event (a synchronise
    before and after), in %."""
    ms = sum(r.topology_ms for r in ctx.logger.rows if r.topology_ms is not None)
    return 100.0 * ms * 1e-3 / ctx.window_s


def launches_per_it(ctx):
    """Device operations (kernels, copies, sets) of the profiled stretch,
    per iteration."""
    if ctx.trace.launches == 0:
        return None
    return ctx.trace.launches / ctx.traced_its


def device_idle(ctx):
    """1 - (device-busy seconds per iteration in the profiled stretch) /
    (wall seconds per iteration of the unprofiled stretch that ends the
    window, as long as the profiled one), in %. The busy time is the union
    of the device's operations in the trace; the wall time is not the
    profiled one, which the profiler inflates, and not the whole window's,
    whose model is smaller."""
    if ctx.trace.busy_s <= 0:
        return None
    busy_per_it = ctx.trace.busy_s / ctx.traced_its
    return 100.0 * (1.0 - busy_per_it / ctx.tail_s_per_it)


def _ms(fn):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(REPS):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / REPS


def composite_roofline(ctx):
    """The share of their bound that the two compositor passes reach on the
    pair table of view 0 built from the model state at the window's end:
    (forward bound + backward bound) / (forward ms + backward ms), each pass
    timed with CUDA events over REPS launches, in %. The bounds come from
    counts.py, counted from the inputs (the gates), not from the kernels."""
    from hairgs_tpu_torch.render import composite_pairs as cp

    if ctx.device.type != "cuda":
        return None
    geo, feat, starts, counts_, grid_w, C = ctx.table(0)
    rc = ctx.raster()
    max_chunks = rc.max_pairs_per_tile // rc.chunk
    stats = rc.viewspace_stats
    common = (grid_w, rc.tile_size, rc.chunk, max_chunks, C)
    out, trans, tstarts, latch = cp.composite_pairs_fwd(
        geo, feat, starts, counts_, *common, rc.alpha_min)
    t_fwd = _ms(lambda: cp.composite_pairs_fwd(geo, feat, starts, counts_, *common,
                                               rc.alpha_min))
    live = cp.clamp_counts_to_live_chunks(counts_, tstarts, rc.chunk, max_chunks)
    g = torch.Generator(device=geo.device).manual_seed(ctx.seed % 2**63)
    nt = starts.shape[0]
    g_out, g_photo = (torch.randn((nt, counts.PIX, C), generator=g, device=geo.device)
                      for _ in range(2))
    g_trans = torch.randn((nt, counts.PIX), generator=g, device=geo.device)
    t_bwd = _ms(lambda: cp.composite_pairs_bwd(
        geo, feat, starts, live, tstarts, latch, trans, g_out, g_photo, g_trans,
        *common, stats, rc.alpha_min))
    gates = counts.gate_counts(geo, starts, counts_, grid_w, rc.alpha_min)
    gates_bwd = counts.gate_counts(geo, starts, live, grid_w, rc.alpha_min)
    if gates[1] == 0:
        return None
    bound = (counts.fwd_bound_ms(counts_, rc.chunk, C, gates)[0]
             + counts.bwd_bound_ms(live, rc.chunk, C, gates_bwd, stats=stats)[0])
    return 100.0 * bound / (t_fwd + t_bwd)


def step_mfu(ctx):
    """The fp32 operations one iteration needs, averaged over the capture's
    views from the model after the profiled stretch (counts.step_ops: the
    compositor's gates from each view's pair table, SSIM, the per-pixel
    losses, preprocess per splat, the statistics and Adam per parameter
    element), over the wall seconds per iteration of the unprofiled stretch
    that ends the window, over the card's fp32 peak (67 TFLOP/s at 700 W),
    in %."""
    rc = ctx.raster()
    total = 0.0
    n_views = len(ctx.cameras)
    for v in range(n_views):
        geo, _, starts, counts_, grid_w, C = ctx.table(v)
        gates = counts.gate_counts(geo, starts, counts_, grid_w, rc.alpha_min)
        comp = counts.fwd_ops(C, gates) + counts.bwd_ops(gates, rc.viewspace_stats)
        cam = ctx.cameras[v]
        total += counts.step_ops(comp, cam["width"] * cam["height"], ctx.splats,
                                 ctx.parameters)
    if total <= 0:
        return None
    return 100.0 * (total / n_views) / ctx.tail_s_per_it / counts.PEAK_FP32_FLOP_PER_S
