#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU.

Builds the compositor kernels from `hairgs_tpu_torch/csrc/`, holds each one
against its plain PyTorch version on the card, drives the Stage-I train step
at bench width (100k Gaussians, 999x1000, 4 ring cameras) through
`make_gaussian_train_step`, checks that the step went through both kernels,
and prints the kernels' times beside their bounds and beside the same
sources built with FMA contraction. Exits non-zero on any
failure, and when no CUDA device is present.

    python3 chip_smoke.py

The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and fp32 (non-tensor) FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
# fp32 operations per (pair, pixel), counted from the kernels' arithmetic.
# Every pair of a tile's list meets every pixel of the tile in the gates:
# offsets, the quadratic form, exp, the opacity product, the clamp and the
# two tests (16). A pair-pixel that passes the gates costs the forward 19
# more (latch test, weight, T update, 7 channel sums) and the backward with
# stats 100 more (latch test, T recovery, two f.g dots, dalpha, dpower, 8
# geometry and 7 feature gradients, two carries, and its share of the block
# sum of 15 values).
GATE_OPS = 16
FWD_PASS_OPS = 19
BWD_PASS_OPS = 100
PIX = 256
FMA = "_fma"  # suffix of the libraries built with FMA contraction (phase 6)
FWD_GATE = 1e-3  # image / transmittance max abs error
BWD_GATE = 5e-3  # gradient max abs error relative to max |plain|
# gradient error in the L2 norm relative to ||plain||: the kernel and its
# plain version differ only in the order of the 256-pixel sums, which
# leaves about 1e-7 of the typical value
BWD_REL_L2_GATE = 1e-5


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() over reps launches, timed with CUDA events
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compositor_inputs(scene, cam_idx, cfg):
    """(geo_rows, feat_rows, starts, counts, binning) of one bench view, as
    the train step builds them."""
    from hairgs_tpu_torch.models.gaussian import gaussian_render_inputs
    from hairgs_tpu_torch.render.renderer import paged_pair_table

    cam = scene.cams[cam_idx]
    with torch.no_grad():
        inputs = gaussian_render_inputs(scene.params, cam.cam_center, 0)
        _, binning, geo, feat = paged_pair_table(
            cam, **inputs, cov3d_precomp=None, active=scene.active,
            mean2d_offset=None, scale_modifier=1.0, width=scene.width,
            height=scene.height, config=cfg)
    return geo, feat, binning.starts, binning.counts, binning


def check_forward(name, geo, feat, starts, counts, grid_w, chunk, max_chunks, C):
    from hairgs_tpu_torch.render import composite_pairs as cp

    args = (geo, feat, starts, counts, grid_w, 16, chunk, max_chunks, C)
    k_out, k_t, k_ts = cp.composite_pairs_fwd_cuda(*args)
    p_out, p_t, p_ts = cp.composite_pairs_fwd_plain(*args)
    torch.cuda.synchronize()
    nch = (counts + chunk - 1) // chunk
    live = (torch.arange(max_chunks, device=geo.device)[None, :] < nch[:, None])
    live = live.reshape(-1, 1).expand(-1, PIX).reshape(k_ts.shape)
    errs = {
        "image": (k_out - p_out).abs().max().item(),
        "T": (k_t - p_t).abs().max().item(),
        "tstarts": ((k_ts - p_ts).abs() * live).max().item(),
        "tstarts_dead_nonzero": (k_ts * ~live).abs().max().item(),
    }
    finite = bool(torch.isfinite(k_out).all() and torch.isfinite(k_t).all())
    print(f"  forward {name}: max abs err {errs} finite={finite}")
    if not finite or max(errs.values()) >= FWD_GATE:
        fail(f"forward kernel disagrees with its plain version on {name}")
    return errs["image"], (k_out, k_t, k_ts)


def grad_gate(k, p):
    """(passes, max abs err, relative L2 err) of gradient plane k against
    its plain version p: max abs err < BWD_GATE * max|p| and
    ||k - p|| < BWD_REL_L2_GATE * ||p||."""
    err = (k - p).abs().max().item()
    rel = ((k - p).norm() / p.norm().clamp(min=1e-30)).item()
    ok = bool(torch.isfinite(k).all()) and rel < BWD_REL_L2_GATE and \
        err < BWD_GATE * max(p.abs().max().item(), 1e-12)
    return ok, err, rel


def bwd_cotangents(nt, C, seed, device):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return tuple(torch.randn(shape, generator=g).to(device)
                 for shape in ((nt, PIX, C), (nt, PIX, C), (nt, PIX)))


def check_backward(name, geo, feat, starts, counts, fwd, grid_w, chunk,
                   max_chunks, C, seed, plant_faults=False):
    """Both gradient planes of the kernel against the plain version, with
    and without stats. With plant_faults, also shows that the gate fails
    two wrong gradients made from the plain version: one that drops the
    carry's start T_final * g_T, and one with the aux rows swapped for the
    total-loss rows 0-1."""
    from hairgs_tpu_torch.render import composite_pairs as cp

    _, trans, tstarts = fwd
    g_out, g_photo, g_trans = bwd_cotangents(starts.shape[0], C, seed, geo.device)
    cnt = cp.clamp_counts_to_live_chunks(counts, tstarts, chunk, max_chunks)
    slot, _ = live_slots(starts, cnt)
    worst = 0.0
    for stats in (True, False):
        args = (geo, feat, starts, cnt, tstarts, trans, g_out, g_photo,
                g_trans, grid_w, 16, chunk, max_chunks, C, stats)
        k_geo, k_feat = cp.composite_pairs_bwd_cuda(*args)
        p_geo, p_feat = cp.composite_pairs_bwd_plain(*args)
        torch.cuda.synchronize()
        for plane, k, p, rows in (("d_geo", k_geo, p_geo, 8 if stats else 6),
                                  ("d_feat", k_feat, p_feat, C)):
            ok, err, rel = grad_gate(k, p)
            worst = max(worst, err)
            print(f"  backward {name} stats={stats} {plane}: max abs err "
                  f"{err:.3e}, rel L2 err {rel:.3e}; plain max|.| "
                  f"{p.abs().max().item():.3e}, median|.| over the {rows} "
                  f"rows of the {slot.numel()} live slots "
                  f"{p[:rows, slot].abs().median().item():.3e}")
            if not ok:
                fail(f"backward kernel disagrees on {name} {plane} stats={stats}")
        if not stats and k_geo[6:].abs().max().item() != 0.0:
            fail("backward without stats wrote the aux rows")
        if stats and plant_faults:
            no_carry0 = cp.composite_pairs_bwd_plain(
                *args[:8], torch.zeros_like(g_trans), *args[9:])[0]
            swapped = p_geo[[0, 1, 2, 3, 4, 5, 0, 1]]
            for fault, wrong in (("carry start T_final*g_T dropped", no_carry0),
                                 ("aux rows swapped for rows 0-1", swapped)):
                ok, err, rel = grad_gate(wrong, p_geo)
                print(f"  planted fault ({fault}): d_geo max abs err {err:.3e}"
                      f", rel L2 err {rel:.3e}; gate fails it: {not ok}")
                if ok:
                    fail(f"the backward gate passes a planted fault: {fault}")
    return worst


def latch_fixture(device):
    """One tile, 8 slots centred on pixel (0,0), opacities [.99,.99,.99,0,
    .5,0,0,0]: the latch trips in the first chunk and starts again in the
    next, so pixel 0 gets 0.005 of the second colour with chunk 4 and none
    with chunk 8."""
    from hairgs_tpu_torch.render import composite_pairs as cp

    k = 8
    geo = torch.zeros((8, k), device=device)
    geo[2] = 50.0
    geo[4] = 50.0
    geo[5] = torch.tensor([0.99, 0.99, 0.99, 0, 0.5, 0, 0, 0], device=device)
    feat = torch.zeros((8, k), device=device)
    feat[0, :3] = 1.0
    feat[1, 4] = 1.0
    starts = torch.zeros(1, dtype=torch.int32, device=device)
    counts = torch.full((1,), k, dtype=torch.int32, device=device)
    for chunk, expect in ((4, 0.005), (8, 0.0)):
        args = (geo, feat, starts, counts, 1, 16, chunk, k // chunk, 3)
        k_out = cp.composite_pairs_fwd_cuda(*args)[0]
        p_out = cp.composite_pairs_fwd_plain(*args)[0]
        got = k_out[0, 0, 1].item()
        print(f"  latch fixture chunk={chunk}: pixel 0 = "
              f"{k_out[0, 0].tolist()} (plain {p_out[0, 0].tolist()})")
        if abs(got - expect) > 1e-6 or (k_out - p_out).abs().max().item() > 1e-6:
            fail(f"latch fixture chunk={chunk}: got {got}, expected {expect}")


def live_slots(starts, counts):
    """Slot index and tile of every pair the tiles' lists hold (k < count)."""
    dev = starts.device
    c = counts.long()
    excl = torch.cumsum(c, 0) - c
    within = torch.arange(int(c.sum()), device=dev) - torch.repeat_interleave(excl, c)
    slot = torch.repeat_interleave(starts.long(), c) + within
    tile = torch.repeat_interleave(torch.arange(starts.shape[0], device=dev), c)
    return slot, tile


def gate_counts(geo, starts, counts, grid_w, alpha_min=1.0 / 255.0,
                batch=1 << 15):
    """(pair, pixel) combinations of the tiles' lists, and how many of them
    pass the alpha gates (power <= 0, alpha >= alpha_min): the work this
    view's data needs. The latch is not applied, so for pixels that latched
    the counts include pairs the function skips."""
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


def bound_ms(bytes_, ops):
    """The least time the card could take: the larger of bytes over the HBM
    rate and fp32 operations over the fp32 peak; and which one bounds."""
    t_bytes = bytes_ / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def table_sizes(counts, chunk):
    """(tiles, pairs in the tiles' lists, chunks those lists fill)."""
    nchunks = (counts + chunk - 1) // chunk
    return counts.shape[0], int(counts.sum()), int(nchunks.sum())


def fwd_bound_ms(counts, chunk, C, gates):
    """Bytes: reads geometry rows 0-5 (x, y, conic, opacity) and the C
    feature rows of every pair in the tiles' lists, and the tile tables;
    writes the image, T and the start transmittance of every chunk that
    runs (the rest of `tstarts` is the wrapper's zero fill)."""
    nt, pairs, chunks = table_sizes(counts, chunk)
    bytes_ = 4 * (pairs * (6 + C) + 2 * nt + nt * PIX * (C + 1) + chunks * PIX)
    n_all, n_pass = gates
    return bound_ms(bytes_, n_all * GATE_OPS + n_pass * FWD_PASS_OPS)


def bwd_bound_ms(cnt, chunk, C, gates):
    """Bytes: reads geometry rows 0-5 and the C feature rows of every pair
    the clamped counts keep, the tile tables, the start transmittance of
    every chunk that runs, T, the two image cotangents and g_T; writes the
    8 geometry and C feature gradients of those pairs (the other slots are
    the wrapper's zero fill)."""
    nt, pairs, chunks = table_sizes(cnt, chunk)
    bytes_ = 4 * (pairs * (6 + C) + 2 * nt + chunks * PIX + nt * PIX * (2 + 2 * C)
                  + pairs * (8 + C))
    n_all, n_pass = gates
    return bound_ms(bytes_, n_all * GATE_OPS + n_pass * BWD_PASS_OPS)


def check_grads_against_cpu(cfg):
    """Loss and gradients of a small bench scene on the card (kernels) and
    on the CPU (plain versions) from the same state must agree: loss to
    1e-4 relative, every gradient and the viewspace statistic to
    5e-3 x max |cpu| (the gates of scripts/tpu_parity_check.py)."""
    from hairgs_tpu_torch.bench_scene import build_bench_scene
    from hairgs_tpu_torch.models.gaussian import gaussian_render_inputs
    from hairgs_tpu_torch.train.trainer import render_loss_and_grads

    out = {}
    for dev in ("cuda", "cpu"):
        s = build_bench_scene(n_gaussians=3000, width=128, height=96, seed=1,
                              capacity_round=1024, device=dev)
        cam = s.cams[0]
        loss, grads, offset_grad, _ = render_loss_and_grads(
            lambda p: gaussian_render_inputs(p, cam.cam_center, 0), s.params,
            cam, s.active, s.opt_cfg, cfg, s.width, s.height)
        out[dev] = (loss.item(), [g.cpu() for g in grads] + [offset_grad.cpu()])
    (lg, gg), (lc, gc) = out["cuda"], out["cpu"]
    print(f"  small-scene loss: cuda {lg:.7f} cpu {lc:.7f}")
    if not np.isfinite(lg) or abs(lg - lc) > 1e-4 * max(1.0, abs(lc)):
        fail("loss on the card disagrees with the CPU")
    names = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
             "opacity", "mask", "viewspace")
    for name, a, b in zip(names, gg, gc):
        if b.numel() == 0:
            continue
        rel = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-12)
        print(f"    grad {name}: rel err {rel:.3e}")
        if not torch.isfinite(a).all() or rel > BWD_GATE:
            fail(f"gradient of {name} on the card disagrees with the CPU")


def profile_steps(step_fn, state, scene, n_steps=4, top=14):
    """Device time by kernel over n_steps train steps (torch.profiler), and
    the device's busy share of the window's wall time. Prints "not
    measured" when the profiler sees no device activity."""
    from torch.profiler import ProfilerActivity, profile

    params, stats, opt_state = state
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n_steps):
            params, stats, opt_state, _, _ = step_fn(
                params, stats, opt_state, scene.active, scene.cams[i % 4], 100 + i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    if not rows:
        print("  profiler: no device time recorded; breakdown not measured")
        return
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    print(f"  {n_steps} profiled steps: wall {wall_ms / n_steps:.3f} ms/step "
          f"(profiler on), device busy {busy_ms / n_steps:.3f} ms/step "
          f"({100 * busy_ms / wall_ms:.1f}% of wall), {len(rows)} kernel names")
    for name, ms, count in rows[:top]:
        print(f"    {ms / n_steps:8.4f} ms/step {count // n_steps:5d}x/step  "
              f"{name[:90]}")


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on a GPU")
    from hairgs_tpu_torch import kernels
    from hairgs_tpu_torch.bench_scene import build_bench_scene
    from hairgs_tpu_torch.render import composite_pairs as cp
    from hairgs_tpu_torch.render.renderer import RasterConfig
    from hairgs_tpu_torch.train.trainer import make_gaussian_train_step

    t_start = time.perf_counter()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    print("phase 1: build kernels")
    # the shipped libraries, and for phase 6 the same sources built with
    # nvcc's default FMA contraction instead of --fmad=false
    report = kernels.build(verbose=True, variants={
        "": kernels.NVCC_FLAGS,
        FMA: [f for f in kernels.NVCC_FLAGS if f != "--fmad=false"]})
    for name, r in report.items():
        regs = [ln.strip() for ln in r["ptxas"].splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"  {name}: built in {r['seconds']:.1f} s; " + " | ".join(regs[:4]))

    print("phase 2: card")
    smi = smi_line()
    print(smi)
    device = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    cfg = RasterConfig(max_tiles_per_gaussian=16, max_pairs_per_tile=2048,
                       chunk=128, pair_capacity=786432, viewspace_stats=True,
                       alpha_min=1.0 / 255.0)
    chunk = cfg.chunk
    max_chunks = cfg.max_pairs_per_tile // chunk
    C = 7

    print("phase 3: forward kernel against its plain version")
    latch_fixture(device)
    small = build_bench_scene(n_gaussians=4096, width=256, height=256, seed=2,
                              device=device)
    s_in = compositor_inputs(small, 0, cfg)
    _, s_fwd = check_forward("small 256x256", *s_in[:4], 16, chunk, max_chunks, C)
    scene = build_bench_scene(device=device)
    grid_w = (scene.width + 15) // 16
    geo, feat, starts, counts, binning = compositor_inputs(scene, 0, cfg)
    nt = starts.shape[0]
    fwd_err, f_fwd = check_forward("bench view 0", geo, feat, starts, counts,
                                   grid_w, chunk, max_chunks, C)

    print("phase 4: backward kernel against its plain version")
    check_backward("small 256x256", *s_in[:4], s_fwd, 16, chunk, max_chunks,
                   C, seed=3)
    bwd_err = check_backward("bench view 0", geo, feat, starts, counts, f_fwd,
                             grid_w, chunk, max_chunks, C, seed=4,
                             plant_faults=True)

    print("phase 5: the Stage-I train step")
    check_grads_against_cpu(cfg)
    step_fn = make_gaussian_train_step(scene.opt_cfg, cfg, width=scene.width,
                                       height=scene.height,
                                       active_sh_degree=0, device=device)
    params, stats, opt_state = scene.params, scene.stats, scene.opt_state
    cams = scene.cams
    cp.reset_launches()
    for i in range(3):
        params, stats, opt_state, metrics, _ = step_fn(
            params, stats, opt_state, scene.active, cams[i % 4], i + 1)
    torch.cuda.synchronize()
    n_timed = 20
    # host marks after each step, unsynchronised: the host runs ahead of the
    # card only by what the launch queue holds, so their spacing is the
    # per-step time while the step is host-bound
    marks = [time.perf_counter()]
    for i in range(n_timed):
        params, stats, opt_state, metrics, image = step_fn(
            params, stats, opt_state, scene.active, cams[i % 4], i + 4)
        marks.append(time.perf_counter())
    torch.cuda.synchronize()
    dt = time.perf_counter() - marks[0]
    main_launches = dict(cp.launches)
    ms_step = dt / n_timed * 1e3
    median_ms = float(np.median(np.diff(marks))) * 1e3
    loss = metrics["loss"].item()
    print(f"  launches over 23 steps: {main_launches}")
    print(f"  step {ms_step:.3f} ms mean over {n_timed} steps to the final "
          f"synchronize ({n_timed / dt:.3f} it/s), host median {median_ms:.3f} "
          f"ms; loss {loss:.6f}, "
          f"psnr {metrics['psnr'].item():.3f}, overflow_pairs "
          f"{metrics['overflow_pairs'].item()}, overflow_tiles "
          f"{metrics['overflow_tiles'].item()}, overflow_capacity "
          f"{metrics['overflow_capacity'].item()}, pairs_demand "
          f"{metrics['pairs_demand'].item()}")
    if any(v != 23 for v in main_launches.values()):
        fail(f"expected 23 launches of each kernel, got {main_launches}")
    if not np.isfinite(loss) or not all(torch.isfinite(p).all() for p in params):
        fail("non-finite loss or parameters after the train step")
    if tuple(image.shape) != (scene.height, scene.width, 3):
        fail(f"image shape {tuple(image.shape)}")
    profile_steps(step_fn, (params, stats, opt_state), scene)

    print("phase 6: kernel times at one bench view")
    fwd_args = (geo, feat, starts, counts, grid_w, 16, chunk, max_chunks, C)
    _, trans, tstarts = f_fwd
    cnt = cp.clamp_counts_to_live_chunks(counts, tstarts, chunk, max_chunks)
    bwd_args = (geo, feat, starts, cnt, tstarts, trans,
                *bwd_cotangents(nt, C, 5, device), grid_w, 16, chunk,
                max_chunks, C, True)
    # the shipped kernels and their FMA-contracted builds, timed in turns
    turns = {"": ([], []), FMA: ([], [])}
    for suffix in ("", FMA, FMA, ""):
        with kernels.variant(suffix):
            turns[suffix][0].append(
                cuda_ms(lambda: cp.composite_pairs_fwd_cuda(*fwd_args), 20))
            turns[suffix][1].append(
                cuda_ms(lambda: cp.composite_pairs_bwd_cuda(*bwd_args), 20))
    k_fwd_ms, k_bwd_ms = (float(np.mean(t)) for t in turns[""])
    p_fwd_ms = cuda_ms(lambda: cp.composite_pairs_fwd_plain(*fwd_args), 2)
    p_bwd_ms = cuda_ms(lambda: cp.composite_pairs_bwd_plain(*bwd_args), 2)
    fwd_gates = gate_counts(geo, starts, counts, grid_w)
    bwd_gates = gate_counts(geo, starts, cnt, grid_w)
    fb, fb_by = fwd_bound_ms(counts, chunk, C, fwd_gates)
    bb, bb_by = bwd_bound_ms(cnt, chunk, C, bwd_gates)
    _, pairs, chunks = table_sizes(counts, chunk)
    print(f"  pairs {pairs} in {chunks} chunks (kept by the backward "
          f"{cnt.sum().item()}), pairs_demand {binning.pairs_demand.item()}, "
          f"P_pad {geo.shape[1]}; pair-pixels {fwd_gates[0]}, passing the "
          f"gates {fwd_gates[1]} (backward {bwd_gates[1]}); pixels with "
          f"final T < 0.01, the only ones that can have latched: "
          f"{(trans < 0.01).sum().item()} of {trans.numel()}")
    print(f"  composite_fwd {k_fwd_ms:.4f} ms, turns {turns[''][0]} (plain "
          f"{p_fwd_ms:.3f} ms, bound {fb:.4f} ms by {fb_by})")
    print(f"  composite_bwd {k_bwd_ms:.4f} ms, turns {turns[''][1]} (plain "
          f"{p_bwd_ms:.3f} ms, bound {bb:.4f} ms by {bb_by})")
    with kernels.variant(FMA):
        m_out, m_t, _ = cp.composite_pairs_fwd_cuda(*fwd_args)
        m_geo, m_feat = cp.composite_pairs_bwd_cuda(*bwd_args)
    p_out, p_t, _ = cp.composite_pairs_fwd_plain(*fwd_args)
    p_geo, p_feat = cp.composite_pairs_bwd_plain(*bwd_args)
    flips = ((m_t - p_t).abs() > 1e-3 * p_t).sum().item()
    print(f"  with FMA contraction: composite_fwd turns {turns[FMA][0]} ms, "
          f"composite_bwd turns {turns[FMA][1]} ms; against the plain "
          f"version: image max abs err {(m_out - p_out).abs().max().item():.3e}"
          f", T {(m_t - p_t).abs().max().item():.3e}, pixels whose T moved by "
          f"more than 1e-3 of itself (an alpha gate or latch decided "
          f"otherwise) {flips}, "
          f"d_geo (max abs, rel L2) {grad_gate(m_geo, p_geo)[1:]}, d_feat "
          f"{grad_gate(m_feat, p_feat)[1:]}")

    src = "hairgs_tpu_torch/csrc/"
    kernels_line = {"kernels": [
        {"name": "composite_fwd", "route": "cuda", "source": src + "composite_fwd.cu",
         "replaces": "hairgs_tpu/render/pallas_composite.py:153",
         "launches": main_launches["composite_fwd"], "max_abs_err": fwd_err,
         "ms": k_fwd_ms, "plain_ms": p_fwd_ms, "bound_ms": fb,
         "bound_by": fb_by, "library_ms": None},
        {"name": "composite_bwd", "route": "cuda", "source": src + "composite_bwd.cu",
         "replaces": "hairgs_tpu/render/pallas_composite.py:272",
         "launches": main_launches["composite_bwd"], "max_abs_err": bwd_err,
         "ms": k_bwd_ms, "plain_ms": p_bwd_ms, "bound_ms": bb,
         "bound_by": bb_by, "library_ms": None},
    ]}
    print(f"  total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"step_ms": ms_step, "it_per_s": n_timed / dt,
                      "host_median_step_ms": median_ms, "card": smi}))
    print(json.dumps(kernels_line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
