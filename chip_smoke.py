#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU.

Builds the kernels of `hairgs_tpu_torch/csrc/` (both compositor passes, each
with an f32 and a bf16 feature plane, and the precision probe), holds each
one against its plain PyTorch version on the card, drives the Stage-I train
step at bench width (100k Gaussians, 999x1000, 4 ring cameras) through
`make_gaussian_train_step` with an f32 and a bf16 feature plane and with
the 4 views stacked into one step, checks that each run went through its
kernels, holds the kernel path against the XLA path (the port of
scripts/tpu_parity_check.py), runs the precision probe, drives the
Stage-I driver end to end on a USC-scale capture and resumes from its
checkpoint, then runs Stage II (the merge driver), Stage III (the train
driver on the strand graph) and the eval driver on that capture, and
prints the kernels' times beside their bounds. Exits non-zero on any
failure, and when no CUDA device is present.

Phases: 1 build; 2 card; 3-4 the f32 compositor kernels against their plain
versions (the forward's latch plane included), on the latch fixture, on
dense scenes whose pixels latch, on a small scene and on bench view 0; 5 the
f32 train step; 6 f32 kernel times (and the FMA build), the share of
(slot, warp) combinations that pass the gates and that the cull mask keeps,
the chunks per tile, and each kernel's resident blocks per SM; 7 the bf16
feature plane (kernels, then the bf16 train step); 8 view
batches (small scene against the CPU, then the 4 bench views in one step);
9 kernel path against XLA path at 20k Gaussians and 512x512; 10 the
precision probe; 11 the Stage-I driver (`drivers/train.py::training()`,
1000 iterations, six densify events, one opacity reset) on a capture of
10 000 strands x 100 points in 16 views at 1000x1000 that the port's
`generate_dataset` renders on the card with the kernels, and a resume from
its checkpoint; 12 the hair model's loss and gradients on the card against
the CPU (smoothness and magnet terms), the merge driver on phase 11's
model (`drivers/merge.py::main`), 500 Stage-III iterations of
`drivers/train.py::training()` on the merged strands (3 densify events, 5
merges, 1 growth, the densify window closing at 400), a resume, and the
eval driver (`drivers/eval.py::main`) on the final PLY.

    python3 chip_smoke.py

The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import dataclasses
import json
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 (non-tensor) and
# dense TF32 tensor-core FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
PEAK_TF32_FLOP_PER_S = 495e12
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
# gradient error in the L2 norm relative to ||plain||: the plain version
# repeats the kernel's float32 operations in the kernel's order, the
# 256-pixel sums included, so the two should agree to the bit; the gate
# leaves room for rounding
BWD_REL_L2_GATE = 1e-5
# bf16 d_feat: each entry within one bf16 ulp of the plain value,
# |k - p| <= 2^-7 |p| (or both 0). The L2 gate above does not apply to a
# bf16 plane: its rounding alone is ~2^-9 of each value
BF16_ULP = 2.0**-7
# precision probe (phase 10): kernel against float64 on the host
PROBE_FP32_REL = 1e-5
PROBE_TF32_REL = 2e-3
PROBE_ELEM_REL = 1e-6
# kernel against its plain version on the card, relative to max|plain|: a
# wrong mma fragment mapping is off by O(1)
PROBE_PLAIN_REL = 1e-5
# kernel path against XLA path (scripts/tpu_parity_check.py:50-58)
PARITY_IMAGE = 1e-3
PARITY_LOSS_REL = 1e-2
PARITY_GRAD_REL = 5e-3
DENSE_PAGE = 512  # slots per tile of dense_scene
GRAD_NAMES = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
              "opacity", "mask")


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def ptxas_summary(report):
    """Registers and spills of the instantiations the bench runs (C = 7
    channels, and the probe), from nvcc's -Xptxas -v report."""
    out, entry, spill = [], None, "?"
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
        elif (m := re.search(r"(\d+) bytes spill stores", line)):
            spill = m.group(1)
        elif entry and ("ILi7E" in entry or "probe" in entry) and \
                (m := re.search(r"Used (\d+) registers", line)):
            args = re.search(r"kernel(I.*?E)Ev", entry)
            out.append(f"{args.group(1) if args else 'probe_kernel'}: "
                       f"{m.group(1)} registers, {spill} B spill stores")
    return out


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
    """The forward kernel against its plain version: image, T, tstarts of
    the chunks that exist and the latch plane (bit for bit). Returns the
    image error and the kernel's (out, trans, tstarts, latch)."""
    from hairgs_tpu_torch.render import composite_pairs as cp

    args = (geo, feat, starts, counts, grid_w, 16, chunk, max_chunks, C)
    k_out, k_t, k_ts, k_lat = cp.composite_pairs_fwd_cuda(*args)
    p_out, p_t, p_ts, p_lat = cp.composite_pairs_fwd_plain(*args)
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
    latch_equal = torch.equal(k_lat, p_lat)
    finite = bool(torch.isfinite(k_out).all() and torch.isfinite(k_t).all())
    print(f"  forward {name}: max abs err {errs} finite={finite}; latch plane "
          f"bit-equal {latch_equal}, latched (pixel, chunk) "
          f"{int((k_lat >= 0).sum())}")
    if not finite or max(errs.values()) >= FWD_GATE or not latch_equal:
        fail(f"forward kernel disagrees with its plain version on {name}")
    return errs["image"], (k_out, k_t, k_ts, k_lat)


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

    _, trans, tstarts, latch = fwd
    g_out, g_photo, g_trans = bwd_cotangents(starts.shape[0], C, seed, geo.device)
    cnt = cp.clamp_counts_to_live_chunks(counts, tstarts, chunk, max_chunks)
    slot, _ = live_slots(starts, cnt)
    worst = 0.0
    for stats in (True, False):
        args = (geo, feat, starts, cnt, tstarts, latch, trans, g_out, g_photo,
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
                *args[:9], torch.zeros_like(g_trans), *args[10:])[0]
            swapped = p_geo[[0, 1, 2, 3, 4, 5, 0, 1]]
            for fault, wrong in (("carry start T_final*g_T dropped", no_carry0),
                                 ("aux rows swapped for rows 0-1", swapped)):
                ok, err, rel = grad_gate(wrong, p_geo)
                print(f"  planted fault ({fault}): d_geo max abs err {err:.3e}"
                      f", rel L2 err {rel:.3e}; gate fails it: {not ok}")
                if ok:
                    fail(f"the backward gate passes a planted fault: {fault}")
    return worst


def latch_fixture(device, bf16=False):
    """One tile, 8 slots centred on pixel (0,0), opacities [.99,.99,.99,0,
    .5,0,0,0]: the latch trips in the first chunk and starts again in the
    next, so pixel 0 gets 0.005 of the second colour with chunk 4 and none
    with chunk 8. Both kernels against their plain versions at both
    chunks; with bf16, then both bf16 kernels (check_bf16)."""
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
        name = f"latch fixture chunk={chunk}"
        _, fwd = check_forward(name, geo, feat, starts, counts, 1, chunk,
                               k // chunk, 3)
        got = fwd[0][0, 0, 1].item()
        print(f"  {name}: pixel 0 = {fwd[0][0, 0].tolist()}, latch slots "
              f"{fwd[3][:, 0].tolist()}")
        if abs(got - expect) > 1e-6:
            fail(f"{name}: got {got}, expected {expect}")
        if bf16:
            check_bf16(name, geo, feat, starts, counts, fwd, 1, chunk,
                       k // chunk, 3, seed=8)
        else:
            check_backward(name, geo, feat, starts, counts, fwd, 1, chunk,
                           k // chunk, 3, seed=8)


def dense_scene(device, seed=0, grid=4, page=DENSE_PAGE, C=7):
    """A grid x grid tile scene whose pixels latch: each tile's page holds
    page // 2 .. page pairs with centres on or near the tile, covariances
    of 1-30 px^2 and opacities 0.9-0.99, in depth order as drawn. Returns
    (geo_rows, feat_rows, starts, counts, grid_w)."""
    rng = np.random.default_rng(seed)
    nt = grid * grid
    n = nt * page
    tile = np.repeat(np.arange(nt), page)
    x = (tile % grid) * 16 + rng.uniform(-6, 22, n)
    y = (tile // grid) * 16 + rng.uniform(-6, 22, n)
    lam = rng.uniform(1, 30, (2, n))
    th = rng.uniform(0, np.pi, n)
    cs, sn = np.cos(th), np.sin(th)
    cxx = lam[0] * cs**2 + lam[1] * sn**2
    cyy = lam[0] * sn**2 + lam[1] * cs**2
    cxy = (lam[0] - lam[1]) * cs * sn
    det = cxx * cyy - cxy**2
    geo = np.zeros((8, n), np.float32)
    geo[:6] = np.stack([x, y, cyy / det, -cxy / det, cxx / det,
                        rng.uniform(0.9, 0.99, n)])
    feat = np.zeros((8, n), np.float32)
    feat[:C] = rng.uniform(0, 1, (C, n))
    starts = np.arange(nt, dtype=np.int32) * page
    counts = rng.integers(page // 2, page + 1, nt).astype(np.int32)
    return (*(torch.tensor(a, device=device) for a in (geo, feat, starts, counts)),
            grid)


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


def warp_shares(geo, starts, counts, grid_w, alpha_min=1.0 / 255.0,
                batch=1 << 14):
    """(slot, warp) combinations of the tiles' lists (8 warps, each a 16x2
    strip), how many of them have a pixel that passes the alpha gates, and
    how many the kernels' cull mask keeps (composite_pairs.warp_reach_plain,
    the predicate in PyTorch). Fails if the mask drops a combination that
    a pixel passes."""
    from hairgs_tpu_torch.render import composite_pairs as cp

    dev = geo.device
    slot, tile = live_slots(starts, counts)
    p = torch.arange(PIX, device=dev)
    touched = kept = 0
    for i in range(0, slot.numel(), batch):
        g = geo[:, slot[i:i + batch]]
        t = tile[i:i + batch]
        tx0, ty0 = ((t % grid_w) * 16).float(), ((t // grid_w) * 16).float()
        dx = g[0][:, None] - (tx0[:, None] + (p % 16).float())
        dy = g[1][:, None] - (ty0[:, None] + (p // 16).float())
        power = (-0.5 * (g[2][:, None] * dx * dx + g[4][:, None] * dy * dy)
                 - g[3][:, None] * dx * dy)
        alpha = torch.clamp(g[5][:, None] * torch.exp(power), max=0.99)
        hit = ((power <= 0.0) & (alpha >= alpha_min)).reshape(-1, 8, 32).any(dim=2)
        mask = cp.warp_reach_plain(g, tx0, ty0, alpha_min)
        keep = (mask[:, None] >> torch.arange(8, device=dev)) & 1 == 1
        if (hit & ~keep).any():
            fail("the cull mask drops a (slot, warp) that passes the gates")
        touched += int(hit.sum())
        kept += int(keep.sum())
    return slot.numel() * 8, touched, kept


def chunk_histogram(counts, chunk):
    """Tiles with 0, 1, 2, ... chunks, and the share of all chunks held by
    tiles with 8 or more."""
    nch = (counts.long() + chunk - 1) // chunk
    heavy = int(nch[nch >= 8].sum()) / max(int(nch.sum()), 1)
    return torch.bincount(nch).tolist(), heavy


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


def fwd_bound_ms(counts, chunk, C, gates, feat_bytes=4):
    """Bytes: reads geometry rows 0-5 (x, y, conic, opacity) and the C
    feature rows (feat_bytes each) of every pair in the tiles' lists, and
    the tile tables; writes the image, T and the start transmittance of
    every chunk that runs (the rest of `tstarts` is the wrapper's zero
    fill)."""
    nt, pairs, chunks = table_sizes(counts, chunk)
    bytes_ = (4 * (pairs * 6 + 2 * nt + nt * PIX * (C + 1) + chunks * PIX)
              + feat_bytes * pairs * C)
    n_all, n_pass = gates
    return bound_ms(bytes_, n_all * GATE_OPS + n_pass * FWD_PASS_OPS)


def bwd_bound_ms(cnt, chunk, C, gates, feat_bytes=4):
    """Bytes: reads geometry rows 0-5 and the C feature rows (feat_bytes
    each) of every pair the clamped counts keep, the tile tables, the start
    transmittance of every chunk that runs, T, the two image cotangents and
    g_T; writes the 8 geometry and C feature gradients of those pairs (the
    other slots are the wrapper's zero fill)."""
    nt, pairs, chunks = table_sizes(cnt, chunk)
    bytes_ = (4 * (pairs * 6 + 2 * nt + chunks * PIX + nt * PIX * (2 + 2 * C)
                   + pairs * 8) + 2 * feat_bytes * pairs * C)
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
    # the largest, and the compositor kernels wherever they rank
    shown = rows[:top] + [r for r in rows[top:] if "composite_" in r[0]]
    for name, ms, count in shown:
        print(f"    {ms / n_steps:8.4f} ms/step {count // n_steps:5d}x/step  "
              f"{name[:90]}")


def check_bf16(name, geo, feat, starts, counts, f32_fwd, grid_w, chunk,
               max_chunks, C, seed):
    """Both kernels on the bf16 feature plane against their plain versions:
    image < FWD_GATE; T, tstarts and the latch plane equal to the f32
    kernels' bit for bit (no feature touches them); d_geo with the f32 gates of grad_gate;
    d_feat in bf16, every entry within one bf16 ulp of the plain value.
    Returns (image error, worst d_feat abs error, the bf16 forward)."""
    from hairgs_tpu_torch.render import composite_pairs as cp

    feat_b = feat.to(torch.bfloat16)
    args = (geo, feat_b, starts, counts, grid_w, 16, chunk, max_chunks, C)
    k_out, k_t, k_ts, k_lat = cp.composite_pairs_fwd_cuda(*args)
    p_out, p_t, _, _ = cp.composite_pairs_fwd_plain(*args)
    torch.cuda.synchronize()
    img_err = (k_out - p_out).abs().max().item()
    t_equal = torch.equal(k_t, f32_fwd[1]) and torch.equal(k_ts, f32_fwd[2]) \
        and torch.equal(k_lat, f32_fwd[3])
    print(f"  forward bf16 {name}: image max abs err {img_err:.3e} (against "
          f"the f32 kernel {(k_out - f32_fwd[0]).abs().max().item():.3e}); T, "
          f"tstarts and latch bit-equal to the f32 kernel's: {t_equal}; T against "
          f"plain {(k_t - p_t).abs().max().item():.3e}")
    if not t_equal or img_err >= FWD_GATE or not torch.isfinite(k_out).all():
        fail(f"bf16 forward kernel disagrees on {name}")
    g_out, g_photo, g_trans = bwd_cotangents(starts.shape[0], C, seed, geo.device)
    cnt = cp.clamp_counts_to_live_chunks(counts, k_ts, chunk, max_chunks)
    worst = 0.0
    for stats in (True, False):
        bargs = (geo, feat_b, starts, cnt, k_ts, k_lat, k_t, g_out, g_photo, g_trans,
                 grid_w, 16, chunk, max_chunks, C, stats)
        k_geo, k_feat = cp.composite_pairs_bwd_cuda(*bargs)
        p_geo, p_feat = cp.composite_pairs_bwd_plain(*bargs)
        torch.cuda.synchronize()
        ok, err, rel = grad_gate(k_geo, p_geo)
        kf, pf = k_feat.float(), p_feat.float()
        beyond = int(((kf - pf).abs() > BF16_ULP * pf.abs()).sum())
        f_err = (kf - pf).abs().max().item()
        worst = max(worst, f_err)
        print(f"  backward bf16 {name} stats={stats}: d_geo max abs err "
              f"{err:.3e}, rel L2 err {rel:.3e}; d_feat ({k_feat.dtype}) max "
              f"abs err {f_err:.3e}, entries beyond one bf16 ulp {beyond}")
        if not ok or k_feat.dtype != torch.bfloat16 or beyond \
                or not torch.isfinite(kf).all():
            fail(f"bf16 backward kernel disagrees on {name} stats={stats}")
    return img_err, worst, (k_out, k_t, k_ts, k_lat)


def run_steps(step_fn, state, active, cam_for, n_warm, n_timed, first_step):
    """n_warm + n_timed train steps; returns (state, metrics, image, mean ms
    of the timed steps to the final synchronize, host median ms)."""
    params, stats, opt_state = state
    for i in range(n_warm):
        params, stats, opt_state, metrics, _ = step_fn(
            params, stats, opt_state, active, cam_for(i), first_step + i)
    torch.cuda.synchronize()
    # host marks after each step, unsynchronised: the host runs ahead of the
    # card only by what the launch queue holds, so their spacing is the
    # per-step time while the step is host-bound
    marks = [time.perf_counter()]
    for i in range(n_warm, n_warm + n_timed):
        params, stats, opt_state, metrics, image = step_fn(
            params, stats, opt_state, active, cam_for(i), first_step + i)
        marks.append(time.perf_counter())
    torch.cuda.synchronize()
    dt = time.perf_counter() - marks[0]
    return ((params, stats, opt_state), metrics, image, dt / n_timed * 1e3,
            float(np.median(np.diff(marks))) * 1e3)


def check_step_outputs(what, params, metrics, image, scene):
    loss = metrics["loss"].item()
    if not np.isfinite(loss) or not all(torch.isfinite(p).all() for p in params):
        fail(f"non-finite loss or parameters after the {what}")
    if tuple(image.shape) != (scene.height, scene.width, 3):
        fail(f"image shape {tuple(image.shape)} after the {what}")
    return loss


def check_batched_against_cpu(cfg, n_views=3):
    """Loss, gradients and statistics of a small bench scene with n_views
    cameras stacked into one batch, on the card (kernels) and on the CPU
    (plain versions), from the same state: loss to 1e-4 relative, every
    gradient, offset gradient and radius to 5e-3 x max |cpu|."""
    from hairgs_tpu_torch.bench_scene import build_bench_scene
    from hairgs_tpu_torch.core.camera import stack_cameras
    from hairgs_tpu_torch.models.gaussian import gaussian_render_inputs
    from hairgs_tpu_torch.train.trainer import _per_view, render_loss_and_grads

    out = []
    for dev in ("cuda", "cpu"):
        s = build_bench_scene(n_gaussians=3000, width=128, height=96, seed=1,
                              capacity_round=1024, device=dev)
        loss, grads, offset_grads, aux = _per_view(
            lambda cam: render_loss_and_grads(
                lambda p: gaussian_render_inputs(p, cam.cam_center, 0),
                s.params, cam, s.active, s.opt_cfg, cfg, s.width, s.height),
            stack_cameras(s.cams[:n_views]))
        out.append((loss.item(), [g.cpu() for g in grads]
                    + [offset_grads.cpu(), aux["radii"].cpu()]))
    (lg, gg), (lc, gc) = out
    print(f"  small batch of {n_views} views: loss cuda {lg:.7f} cpu {lc:.7f}; "
          f"offset gradients {tuple(gg[-2].shape)}, radii {tuple(gg[-1].shape)}")
    if not np.isfinite(lg) or abs(lg - lc) > 1e-4 * max(1.0, abs(lc)):
        fail("batched loss on the card disagrees with the CPU")
    for name, a, b in zip(GRAD_NAMES + ("viewspace", "radii"), gg, gc):
        if b.numel() == 0:
            continue
        rel = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-12)
        print(f"    {name}: rel err {rel:.3e}")
        if not torch.isfinite(a).all() or rel > BWD_GATE:
            fail(f"batched {name} on the card disagrees with the CPU")


def parity_kernel_vs_xla(device):
    """scripts/tpu_parity_check.py:30-61 on the card: one 20k-Gaussian
    512x512 bench view rendered by the kernel path and by the XLA path,
    loss sum(render^2) + 0.5 sum(final_T), images and every parameter
    gradient compared. Returns the forward+backward ms of both paths."""
    from hairgs_tpu_torch.bench_scene import build_bench_scene
    from hairgs_tpu_torch.models.gaussian import gaussian_render_inputs
    from hairgs_tpu_torch.render.renderer import RasterConfig, render

    s = build_bench_scene(n_gaussians=20_000, width=512, height=512,
                          device=device)
    cam = s.cams[0]

    def loss_and_grads(cfg):
        leaves = [t.detach().requires_grad_(True) for t in s.params]
        p = type(s.params)(*leaves)
        out = render(cam, **gaussian_render_inputs(p, cam.cam_center, 0),
                     active=s.active, width=s.width, height=s.height, config=cfg)
        img = out["render"]
        loss = torch.sum(img * img) + 0.5 * torch.sum(out["final_T"])
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.item(), img.detach(), grads

    results, ms = {}, {}
    for use_pallas in (True, False):
        cfg = RasterConfig(max_tiles_per_gaussian=16, max_pairs_per_tile=1024,
                           chunk=128, use_pallas=use_pallas)
        loss_and_grads(cfg)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results[use_pallas] = loss_and_grads(cfg)
        torch.cuda.synchronize()
        ms[use_pallas] = (time.perf_counter() - t0) * 1e3
    (lp, img_p, gp), (lx, img_x, gx) = results[True], results[False]
    img_err = (img_p - img_x).abs().max().item()
    ok = img_err < PARITY_IMAGE and abs(lp - lx) < PARITY_LOSS_REL * max(1.0, abs(lx))
    errs = {}
    for name, a, b in zip(GRAD_NAMES, gp, gx):
        if b is None or b.numel() == 0:
            continue
        errs[name] = (a - b).abs().max().item() / (b.abs().max().item() + 1e-6)
        ok = ok and bool(torch.isfinite(a).all()) and errs[name] < PARITY_GRAD_REL
    print(f"  image max err {img_err:.2e}; loss {lp:.4f} vs {lx:.4f}; grad rel "
          f"errs " + " ".join(f"{k}={v:.1e}" for k, v in errs.items()))
    print(f"  forward+backward: kernel path {ms[True]:.3f} ms, XLA path "
          f"{ms[False]:.3f} ms")
    if not ok:
        fail("kernel path and XLA path disagree (tpu_parity_check gates)")
    return ms


def probe_bound_ms(m, n, k, n_elem):
    """Bytes: A, B, x, al read once, the four outputs written once. Work:
    one fp32 product on the fp32 peak, one TF32 product on the TF32 peak,
    and the 2 n_elem transcendental on the fp32 peak."""
    bytes_ = 4 * (m * k + k * n + 2 * n_elem + 2 * m * n + 2 * n_elem)
    t_bytes = bytes_ / PEAK_BYTES_PER_S * 1e3
    t_ops = (2 * m * n * k / PEAK_FP32_FLOP_PER_S + 2 * m * n * k / PEAK_TF32_FLOP_PER_S
             + 2 * n_elem / PEAK_FP32_FLOP_PER_S) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def check_probe(device):
    """The probe's entry point on the card, its kernel against its plain
    version and float64, and its times. Returns the kernels-line entry."""
    from hairgs_tpu_torch.probes import precision_probe as pp

    pp.reset_launches()
    k_out, l_out, truth, lines = pp.run_probe(device)
    launches = pp.launches["precision_probe"]
    for line in lines:
        print("  " + line)
    g_dot, g_exp, g_l1p = truth
    rels = {"fp32": pp.rel(k_out[0], g_dot), "tf32": pp.rel(k_out[1], g_dot),
            "exp": pp.rel(k_out[2], g_exp), "log1p": pp.rel(k_out[3], g_l1p)}
    t = [torch.tensor(a, device=device) for a in pp.probe_inputs()]
    k_t = pp.probe_cuda(*t)
    p_t = pp.probe_plain(*t)
    torch.cuda.synchronize()
    plain_err = {n: ((a - b).abs().max().item(), b.abs().max().item())
                 for n, a, b in zip(("fp32", "tf32", "exp", "log1p"), k_t, p_t)}
    bits = {n: int((a != b).sum()) for n, a, b in
            zip(("fp32", "tf32", "exp", "log1p"), k_t, p_t)}
    print(f"  kernel rel-vs-f64 {rels}; kernel against plain (max abs err, "
          f"max|plain|) {plain_err}; entries not bit-equal to plain {bits}; "
          f"launches from the entry point {launches}")
    if not (rels["fp32"] < PROBE_FP32_REL and rels["fp32"] < rels["tf32"] < PROBE_TF32_REL
            and rels["exp"] < PROBE_ELEM_REL and rels["log1p"] < PROBE_ELEM_REL):
        fail(f"precision probe outside its gates against float64: {rels}")
    if any(e > PROBE_PLAIN_REL * m for e, m in plain_err.values()):
        fail(f"precision probe kernel disagrees with its plain version: {plain_err}")
    if launches != 1:
        fail(f"the probe's entry point launched the kernel {launches} times")
    ms = cuda_ms(lambda: pp.probe_cuda(*t), 200)
    plain_ms = cuda_ms(lambda: pp.probe_plain(*t), 200)
    lib_ms = cuda_ms(lambda: pp.library_outputs(*t), 200)
    bound, by = probe_bound_ms(256, 128, 128, t[2].numel())
    print(f"  precision_probe {ms:.4f} ms (plain {plain_ms:.4f} ms, library "
          f"{lib_ms:.4f} ms: torch.matmul fp32 and TF32, exp, log1p; bound "
          f"{bound:.6f} ms by {by})")
    return {"name": "precision_probe", "route": "cuda",
            "source": "hairgs_tpu_torch/csrc/precision_probe.cu",
            "replaces": "scripts/mosaic_precision_probe.py:41",
            "launches": launches,
            "max_abs_err": max(e for e, _ in plain_err.values()),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": lib_ms}


# phase 11: the Stage-I driver on a USC-scale scene
USC_STRANDS = 10_000  # scripts/synthesize_usc_sample.py:65-67
USC_POINTS = 100
USC_CAMERAS = 16  # scripts/parse_usc_hairsalon.py:31-32
USC_SIZE = 1000
USC_SUBSAMPLE = 10  # the default init_subsample: 100k initial points
GT_CHUNK = 128
STAGE1_FLAGS = ["--iterations", "1000", "--position_lr_max_steps", "1000",
                "--densify_from_iter", "100", "--densification_interval", "100",
                "--densify_until_iter", "800", "--opacity_reset_interval", "500",
                "--save_frequency", "1000", "--eval_frequency", "1000",
                "--logger", "none"]


class StageRecord:
    """A logger for the driver (logging_utils.Logger's interface) that keeps,
    per logged iteration, the host clock, the loss, the densification event
    and the count, and the last evaluation."""

    def __init__(self):
        self.rows = []
        self.eval = None

    def log(self, info, model):
        self.rows.append(dict(t=time.perf_counter(), it=info.iter, loss=info.loss,
                              dens=dict(info.densification_info),
                              topo_ms=info.topology_ms, count=model.count))
        if info.image_metrics:
            self.eval = (info.eval_metrics, info.eval_thresholds, info.image_metrics)

    def close(self):
        pass


def gt_raster_cfg(device, hair, root):
    """Tables for the GT renders that drop nothing: a sizing pass with a
    deep per-tile cap and the worst-case table (its COLMAP points are the
    strand roots, which changes no render), then the shallowest
    power-of-two cap and the pair_capacity bucket (x1.25, 131072-slot
    granule, as the driver's controller sizes it) that hold every view."""
    from hairgs_tpu_torch.data.synthetic import generate_dataset
    from hairgs_tpu_torch.render.renderer import RasterConfig

    def cfg(max_pairs, capacity):
        return RasterConfig(max_tiles_per_gaussian=16, max_pairs_per_tile=max_pairs,
                            chunk=GT_CHUNK, use_pallas=True, pair_capacity=capacity,
                            viewspace_stats=False)

    sizing = []
    generate_dataset(root, hair, num_cameras=USC_CAMERAS, width=USC_SIZE,
                     height=USC_SIZE, init_points="strand_roots",
                     raster_cfg=cfg(32768, 0), device=device, overflow=sizing)
    worst = {k: max(v[k] for v in sizing) for k in sizing[0]}
    print(f"  sizing pass (max_pairs_per_tile 32768, worst-case table): worst "
          f"over {len(sizing)} views {worst}")
    if worst["overflow_pairs"] or worst["overflow_tiles"]:
        fail(f"the GT sizing pass overflows: {worst}")
    max_pairs = 2048
    while max_pairs < worst["max_tile_count"]:
        max_pairs *= 2
    granule = 131072
    capacity = -(-int(worst["pairs_demand"] * 1.25) // granule) * granule
    return cfg(max_pairs, capacity)


def stage1_driver(device, tmp):
    """Phase 11: generate a USC-scale capture with the port's
    generate_dataset on the card (GT views on the kernel path) in
    `tmp`/scene, run the Stage-I driver's training() on it with
    STAGE1_FLAGS into `tmp`/model, check the run and resume from its
    checkpoint. Returns a summary dict."""
    from argparse import ArgumentParser

    from hairgs_tpu_torch import config
    from hairgs_tpu_torch.data.synthetic import generate_dataset, synthetic_test_hair
    from hairgs_tpu_torch.drivers import train as driver
    from hairgs_tpu_torch.io.dataset import read_colmap_scene_info
    from hairgs_tpu_torch.ops.knn import mean_sq_dist_3nn
    from hairgs_tpu_torch.render import composite_pairs as cp
    from hairgs_tpu_torch.system import safe_state

    configs = (config.ModelConfig, config.OptimizationConfig,
               config.GeneralConfig, config.RuntimeConfig)
    data = f"{tmp}/scene"
    t0 = time.perf_counter()
    hair = synthetic_test_hair(num_strands=USC_STRANDS,
                               points_per_strand=USC_POINTS, seed=0)
    t_hair = time.perf_counter() - t0
    cfg = gt_raster_cfg(device, hair, f"{tmp}/sizing")
    overflow = []
    t1 = time.perf_counter()
    generate_dataset(data, hair, num_cameras=USC_CAMERAS, width=USC_SIZE,
                     height=USC_SIZE, init_subsample=USC_SUBSAMPLE,
                     raster_cfg=cfg, device=device, overflow=overflow)
    t_data = time.perf_counter() - t1
    worst = {k: max(v[k] for v in overflow) for k in overflow[0]}
    print(f"  capture: {hair.verts.shape[0]} vertices, {hair.edges.shape[0]} GT "
          f"segments, {USC_CAMERAS} views at {USC_SIZE}x{USC_SIZE}; strands "
          f"{t_hair:.1f} s, dataset {t_data:.1f} s (kernel path, "
          f"max_pairs_per_tile {cfg.max_pairs_per_tile}, pair_capacity "
          f"{cfg.pair_capacity}, chunk {cfg.chunk}); worst over the views {worst}")
    if worst["overflow_pairs"] or worst["overflow_tiles"] or worst["overflow_capacity"]:
        fail(f"a GT render dropped pairs: {worst}")

    pts = torch.tensor(read_colmap_scene_info(data).points, dtype=torch.float32,
                       device=device)
    mean_sq_dist_3nn(pts)  # warm-up
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    d2 = mean_sq_dist_3nn(pts)
    torch.cuda.synchronize()
    knn_ms = (time.perf_counter() - t2) * 1e3
    print(f"  kNN init (mean_sq_dist_3nn): {knn_ms:.3f} ms for {pts.shape[0]} "
          f"points (median mean sq 3-NN distance {d2.median().item():.3e} m^2)")
    del pts, d2

    parser = ArgumentParser()
    for c in configs:
        config.add_config_args(parser, c)
    argv = ["-s", data, "-m", f"{tmp}/model", *STAGE1_FLAGS]
    args = parser.parse_args(argv)
    driver.prepare_output_path(args)
    record = StageRecord()
    stdout = sys.stdout
    torch.cuda.reset_peak_memory_stats()
    cp.reset_launches()
    try:
        # the driver's own seeding (timestamped stdout until restored)
        safe_state(False, seed=0)
        t3 = time.perf_counter()
        scene, model = driver.training(
            *(config.extract_config(args, c) for c in configs), args,
            logger=record)
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t3
    finally:
        sys.stdout = stdout
    launches = dict(cp.launches)
    peak = torch.cuda.max_memory_allocated()
    print(f"  peak device memory of the run {peak / 2**30:.3f} GiB "
          f"(torch.cuda.max_memory_allocated)")
    summary = check_stage1(record, scene, model, launches, t_train, args,
                           parser.parse_args(argv))
    return dict(summary, dataset_s=t_data, knn_ms=knn_ms,
                gt_max_pairs_per_tile=cfg.max_pairs_per_tile,
                gt_pair_capacity=cfg.pair_capacity, gt_worst=worst,
                peak_gib=peak / 2**30)


def check_stage1(record, scene, model, launches, t_train, args, resume_args):
    """Print phase 11's numbers, fail() on a broken run, and resume from
    the run's checkpoint: a new Scene on the model directory must hold the
    same parameters and render one view bit for bit as the trained model."""
    import random

    from hairgs_tpu_torch.evaluation.metrics import format_metric_table
    from hairgs_tpu_torch.models.gaussian import gaussian_render_inputs
    from hairgs_tpu_torch.render.renderer import RasterConfig, render
    from hairgs_tpu_torch.scene import Scene

    rows = record.rows
    n_steps = rows[-1]["it"]
    n_views = len(scene.get_cameras())
    events = [r for r in rows if r["dens"]]
    print(f"  initial count {rows[0]['count']}; {n_steps} steps in {t_train:.1f} s "
          f"({n_steps / t_train:.3f} it/s over the whole call of training(), "
          f"scene load, evaluations and densification included)")
    for r in events:
        d = r["dens"]
        print(f"  densify at iter {r['it']}: {r['topo_ms']:.1f} ms, clone "
              f"{d['clone']} split {d['split']} prune {d['prune_total']} "
              f"(low opacity {d['prune_low_opacity']}, world size "
              f"{d.get('prune_big_ws', '-')}) -> {r['count']}")
    # step times per stretch between events, from the logger's host clock:
    # the driver reads the metrics every log_interval steps, which drains
    # the launch queue, so a stretch's mean is its throughput
    bounds = [0] + [r["it"] for r in events] + [n_steps]
    stretches = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        dts = [(rows[i]["t"] - rows[i - 1]["t"]) * 1e3 for i in range(lo + 1, hi)]
        if dts:
            stretches.append((lo + 1, hi - 1, float(np.mean(dts)), float(np.median(dts))))
            print(f"  steps {lo + 1}-{hi - 1}: mean {stretches[-1][2]:.3f} ms, "
                  f"median {stretches[-1][3]:.3f} ms")
    losses = [(r["it"], r["loss"]) for r in rows if r["loss"] is not None]
    print(f"  loss at the first sync (iter {losses[0][0]}) {losses[0][1]:.6f}, at "
          f"iter {losses[-1][0]} {losses[-1][1]:.6f}; {len(losses)} syncs")
    print(f"  launches over the run: {launches}")
    metrics, thresholds, image = record.eval
    print("  final strand metrics (on the host, evaluation/metrics.py):")
    for line in format_metric_table(metrics, thresholds).splitlines():
        print("    " + line)
    print(f"  image metrics over the {n_views} views: "
          + ", ".join(f"{k} {v:.4f}" for k, v in image.items()))

    if not all(np.isfinite(loss) for _, loss in losses) or \
            not all(torch.isfinite(p).all() for p in model.params):
        fail("non-finite loss or parameters in the Stage-I run")
    if len(events) != 6:
        fail(f"expected 6 densify events, got {len(events)}")
    if min(r["count"] for r in rows) == 0:
        fail("the Gaussian count fell to 0")
    fwd = launches["composite_fwd"]
    bwd = launches["composite_bwd"] + launches["composite_bwd_nostats"]
    if fwd != n_steps + n_views or bwd != n_steps:
        fail(f"expected {n_steps + n_views} forward and {n_steps} backward "
             f"launches, got {launches}")
    if launches["composite_bwd_nostats"] == 0:
        fail("no backward without stats after the densify window closed")
    if not losses[-1][1] < losses[0][1]:
        fail(f"the loss did not fall: {losses[0]} -> {losses[-1]}")

    random.seed(0)
    again = Scene(resume_args, capacity_round=args.capacity_round)
    if again.loaded_iter != n_steps:
        fail(f"resume loaded iteration {again.loaded_iter}, not {n_steps}")
    same = all(torch.equal(a, b) for a, b in zip(again.gaussians.params, model.params))
    cam = again.get_cameras()[0]
    cfg = RasterConfig(max_tiles_per_gaussian=args.max_tiles_per_gaussian,
                       max_pairs_per_tile=args.max_pairs_per_tile,
                       chunk=args.composite_chunk, use_pallas=True,
                       viewspace_stats=False)
    with torch.no_grad():
        imgs = [render(cam, **gaussian_render_inputs(m.params, cam.cam_center,
                                                     m.active_sh_degree),
                       active=m.active, width=cam.width, height=cam.height,
                       config=cfg)["render"] for m in (model, again.gaussians)]
    equal = torch.equal(*imgs)
    print(f"  resume: loaded iteration {again.loaded_iter}, {again.gaussians.count} "
          f"Gaussians, parameters bit-equal {same}, view render bit-equal {equal}")
    if not (same and equal):
        fail("the resumed model differs from the trained one")
    return dict(steps=n_steps, seconds=t_train, launches=launches,
                stretches=stretches, initial_count=rows[0]["count"],
                final_count=model.count, loss_first=losses[0],
                loss_last=losses[-1], image_metrics=image,
                f1=[float(x) for x in next(v for k, v in metrics.items()
                                           if k.startswith("f1"))])


# phase 12: Stage II -> Stage III -> eval on phase 11's capture
STAGE3_FLAGS = ["--iterations", "500", "--position_lr_max_steps", "500",
                "--densify_from_iter", "50", "--densification_interval", "100",
                "--densify_until_iter", "400", "--merge_interval", "100",
                "--growth_interval", "250", "--growth_max_events", "1",
                "--save_frequency", "500", "--eval_frequency", "500",
                "--logger", "none"]
HAIR_GRAD_NAMES = ("endpoints", "features_dc", "features_rest", "opacity",
                   "mask", "width")


def small_hair_state(n_gaussians=3000):
    """A few thousand segments on the CPU: a small bench scene's Gaussians
    converted by to_hair_model, merged into strands of a few segments with
    wide thresholds; returns (capture() state, bench scene)."""
    from hairgs_tpu_torch.bench_scene import build_bench_scene
    from hairgs_tpu_torch.models.gaussian import GaussianModel
    from hairgs_tpu_torch.topo.merge import stage2_merge_loop

    s = build_bench_scene(n_gaussians=n_gaussians, width=128, height=96, seed=1,
                          capacity_round=1024, device="cpu")
    g = GaussianModel(sh_degree=0, capacity_round=1024, device="cpu")
    g._install({k: v[:n_gaussians].numpy() for k, v in s.params._asdict().items()},
               n_gaussians)
    g.training_setup(s.opt_cfg)
    hair = g.to_hair_model(s.params.xyz[:64].numpy())
    hair.merge_dist_th, hair.merge_angle_th = 0.03, 90.0
    stage2_merge_loop(hair, 20)
    return hair.capture(), s


def hair_grads_against_cpu(cfg):
    """Phase 12, step 1: loss and gradients of a small hair scene on the
    card (kernels) and on the CPU (plain versions) from the same state: the
    render's loss and parameter gradients with the smoothness and the
    magnet terms added, and one make_hair_train_step with each term on.
    Gates of phase 5: loss 1e-4 relative, each gradient and the viewspace
    statistic 5e-3 x max |cpu|."""
    from hairgs_tpu_torch.models.hair import HairModel, hair_render_inputs
    from hairgs_tpu_torch.topo.strands import magnet_indices, smooth_pair_indices
    from hairgs_tpu_torch.train import trainer

    state, s = small_hair_state()
    opt = dataclasses.replace(s.opt_cfg, lambda_magnet=1.0)
    out = {}
    for dev in ("cuda", "cpu"):
        m = HairModel(sh_degree=0, capacity_round=1024, device=dev)
        m.restore(state)
        m.training_setup(opt)
        cam = type(s.cams[0])(*[None if t is None else t.to(dev) for t in s.cams[0]])
        sp, sv = (torch.tensor(a, device=dev) for a in smooth_pair_indices(m.strands_info))
        mag = tuple(torch.tensor(a, device=dev) for a in magnet_indices(m))
        sp, mag = sp.long(), (mag[0].long(), mag[1].long(), mag[2])
        f = m.dist_to_scale_factor
        loss, grads, offset_grad, _ = trainer.render_loss_and_grads(
            lambda p: hair_render_inputs(p, m.graph, cam.cam_center, 0, f),
            m.params, cam, m.graph.seg_active, opt, cfg, s.width, s.height)
        smooth, g_s = trainer._endpoint_term(
            lambda e: trainer.angle_smoothness_loss(e, sp, sv), m.params)
        magnet, g_m = trainer._endpoint_term(
            lambda e: trainer.strand_joints_magnet_loss(e, *mag), m.params)
        losses = [loss.item(), smooth.item(), magnet.item()]
        for use_magnet in (False, True):
            step = trainer.make_hair_train_step(
                opt, cfg, width=s.width, height=s.height, active_sh_degree=0,
                dist_to_scale_factor=f, use_smooth=not use_magnet,
                use_magnet=use_magnet, device=dev)
            metrics = step(m.params, m.graph, m.stats, m.opt_state, cam, 1, sp, sv,
                           magnet_idx=mag)[3]
            losses.append(metrics["loss"].item())
        out[dev] = (losses, [t.cpu() for t in grads] + [g_s.cpu(), g_m.cpu(),
                                                      offset_grad.cpu()])
    (lg, gg), (lc, gc) = out["cuda"], out["cpu"]
    n_seg = int(state["endpoint_pairs"].shape[0])
    print(f"  small hair scene: {n_seg} segments; loss, smoothness, magnet, step "
          f"with smoothness, step with magnet: cuda {lg} cpu {lc}")
    if lc[1] <= 0 or lc[2] <= 0:
        fail("the small hair scene has no smoothness or magnet term")
    for a, b in zip(lg, lc):
        if not np.isfinite(a) or abs(a - b) > 1e-4 * max(1.0, abs(b)):
            fail("a hair loss on the card disagrees with the CPU")
    names = HAIR_GRAD_NAMES + ("smoothness d_endpoints", "magnet d_endpoints",
                               "viewspace")
    for name, a, b in zip(names, gg, gc):
        if b.numel() == 0:
            continue
        rel = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-12)
        print(f"    grad {name}: rel err {rel:.3e}")
        if not torch.isfinite(a).all() or rel > BWD_GATE:
            fail(f"hair gradient {name} on the card disagrees with the CPU")


def stage2_merge(tmp, stage1_f1):
    """Phase 12, step 2: the merge driver on phase 11's model directory.
    Fails if the loop does not converge, the strand count ever rises, the
    segment count changes, or the saved hair PLY does not reload with an
    equal graph. Returns a summary dict."""
    from hairgs_tpu_torch.drivers import merge as merge_driver
    from hairgs_tpu_torch.models.hair import HairModel

    args = merge_driver.build_parser().parse_args(
        ["-s", f"{tmp}/scene", "-m", f"{tmp}/model"])
    t0 = time.perf_counter()
    out = merge_driver.main(args)
    t_merge = time.perf_counter() - t0
    hair, rows = out["hair"], out["rows"]
    segs, eps, strands = out["converted"]
    print(f"  after to_hair_model: {segs} segments, {eps} endpoints, {strands} "
          f"strands; the driver {t_merge:.1f} s")
    for r in rows:
        print(f"  merge iter {r['iteration']}: merged {r['merged']} pairs -> "
              f"{r['strands']} strands, {r['total']:.3f} s (candidate search "
              f"{r['candidates']:.3f} s)")
    metrics, ths = out["metrics"]
    f1 = [float(x) for x in metrics["f1(b)"]]
    print(f"  converged after {out['iterations']} iterations; F1(b) at "
          f"{ths[-1]} {f1[-1]:.4f} after the merge (phase 11: {stage1_f1[-1]:.4f}); "
          f"F1(b) at every threshold {f1}")
    if out["iterations"] >= args.iterations or not rows:
        fail("the Stage-II merge did not converge")
    counts = [strands] + [r["strands"] for r in rows]
    if any(b > a for a, b in zip(counts, counts[1:])):
        fail(f"the strand count rose during the merge: {counts}")
    if any(r["segments"] != segs for r in rows) or hair.num_segments != segs:
        fail("the segment count changed during the merge")
    again = HairModel(sh_degree=hair.sh_degree, capacity_round=hair.capacity_round,
                      device=hair.device)
    again.load_ply(out["path"])
    a, b = again.host_arrays(), hair.host_arrays()
    if not all(np.array_equal(a[k], b[k]) for k in a) or \
            len(again.strands_info.list_strands) != len(hair.strands_info.list_strands):
        fail("the saved hair PLY does not reload with an equal graph")
    return dict(converted=dict(segments=segs, endpoints=eps, strands=strands),
                iterations=out["iterations"],
                rows=[{k: r[k] for k in ("merged", "strands", "total", "candidates")}
                      for r in rows],
                f1=f1, seconds=t_merge)


class HairRecord(StageRecord):
    """StageRecord for the hair model: the loss terms, the topology info,
    the segment and strand counts."""

    def log(self, info, model):
        self.rows.append(dict(t=time.perf_counter(), it=info.iter, loss=info.loss,
                              parts=dict(info.loss_dict or {}),
                              dens=dict(info.densification_info),
                              topo_ms=info.topology_ms, count=model.num_segments,
                              strands=len(model.strands_info.list_strands)))
        if info.image_metrics:
            self.eval = (info.eval_metrics, info.eval_thresholds, info.image_metrics)


def stage3_driver(tmp):
    """Phase 12, step 3: the Stage-III driver on the merged directory, then
    a resume and the eval driver. Returns a summary dict."""
    from argparse import ArgumentParser

    from hairgs_tpu_torch import config
    from hairgs_tpu_torch.drivers import train as driver
    from hairgs_tpu_torch.render import composite_pairs as cp
    from hairgs_tpu_torch.system import safe_state

    configs = (config.ModelConfig, config.OptimizationConfig,
               config.GeneralConfig, config.RuntimeConfig)
    parser = ArgumentParser()
    for c in configs:
        config.add_config_args(parser, c)
    argv = ["-s", f"{tmp}/scene", "-m", f"{tmp}/model", *STAGE3_FLAGS]
    args = parser.parse_args(argv)
    driver.prepare_output_path(args)
    record = HairRecord()
    stdout = sys.stdout
    torch.cuda.reset_peak_memory_stats()
    cp.reset_launches()
    try:
        safe_state(False, seed=0)
        t0 = time.perf_counter()
        scene, model = driver.training(
            *(config.extract_config(args, c) for c in configs), args, logger=record)
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
    finally:
        sys.stdout = stdout
    launches = dict(cp.launches)
    peak = torch.cuda.max_memory_allocated()
    print(f"  peak device memory of the run {peak / 2**30:.3f} GiB")
    summary = check_stage3(record, scene, model, launches, t_train, args)
    summary.update(peak_gib=peak / 2**30,
                   **hair_resume_and_eval(record, scene, model, args,
                                          parser.parse_args(argv)))
    return summary


def check_stage3(record, scene, model, launches, t_train, args):
    """Print the Stage-III run's numbers and fail() on a broken run."""
    from hairgs_tpu_torch.evaluation.metrics import format_metric_table

    rows = record.rows
    start = rows[0]["it"]
    n_steps = rows[-1]["it"] - start
    n_views = len(scene.get_cameras())
    events = [r for r in rows if r["dens"]]
    print(f"  {rows[0]['count']} segments and {rows[0]['strands']} strands at the "
          f"start; {n_steps} steps in {t_train:.1f} s ({n_steps / t_train:.3f} it/s "
          f"over the whole call of training())")
    for r in events:
        times = {k: v for k, v in r["dens"].items() if k.startswith("t_")}
        counts = {k: v for k, v in r["dens"].items() if not k.startswith("t_")}
        print(f"  event at iter {r['it']}: {r['topo_ms']:.1f} ms {times}; {counts} "
              f"-> {r['count']} segments, {r['strands']} strands")
    bounds = [0] + [r["it"] - start for r in events] + [n_steps]
    stretches = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        dts = [(rows[i]["t"] - rows[i - 1]["t"]) * 1e3 for i in range(lo + 1, hi)]
        if dts:
            stretches.append((lo + 1, hi - 1, float(np.mean(dts)), float(np.median(dts))))
            print(f"  steps {lo + 1}-{hi - 1}: mean {stretches[-1][2]:.3f} ms, "
                  f"median {stretches[-1][3]:.3f} ms")
    synced = [r for r in rows if r["loss"] is not None]
    lam = args.lambda_dssim

    def photo(r):
        return (1 - lam) * r["parts"]["l1"] + lam * r["parts"]["dssim"]

    print(f"  photometric loss at the first sync (iter {synced[0]['it']}) "
          f"{photo(synced[0]):.6f}, at iter {synced[-1]['it']} {photo(synced[-1]):.6f}; "
          f"smoothness term {synced[0]['parts']['smooth']:.6f} -> "
          f"{synced[-1]['parts']['smooth']:.6f}; total loss "
          f"{synced[0]['loss']:.6f} -> {synced[-1]['loss']:.6f}")
    print(f"  launches over the run: {launches}")
    metrics, thresholds, image = record.eval
    print("  final strand metrics (on the host, evaluation/metrics.py):")
    for line in format_metric_table(metrics, thresholds).splitlines():
        print("    " + line)
    print(f"  image metrics over the {n_views} views: "
          + ", ".join(f"{k} {v:.4f}" for k, v in image.items()))

    if not all(np.isfinite(r["loss"]) for r in synced) or \
            not all(torch.isfinite(p).all() for p in model.params):
        fail("non-finite loss or parameters in the Stage-III run")
    if not photo(synced[-1]) < photo(synced[0]):
        fail("the photometric loss did not fall in the Stage-III run")
    kinds = {k: sum(1 for r in events if k in r["dens"])
             for k in ("clone", "merge", "grow")}
    if kinds["clone"] < 3 or kinds["merge"] < 4 or kinds["grow"] != 1:
        fail(f"missing topology events: {kinds} (densify, merge, grow)")
    window = args.densify_until_iter - 1
    if launches["composite_fwd"] != n_steps + n_views \
            or launches["composite_bwd"] != window \
            or launches["composite_bwd_nostats"] != n_steps - window:
        fail(f"expected {n_steps + n_views} forward, {window} backward with stats "
             f"and {n_steps - window} without, got {launches}")
    return dict(steps=n_steps, seconds=t_train, launches=launches,
                stretches=stretches, events=len(events), event_kinds=kinds,
                initial_segments=rows[0]["count"], final_segments=model.num_segments,
                final_strands=len(model.strands_info.list_strands),
                photo_first=photo(synced[0]), photo_last=photo(synced[-1]),
                smooth_last=synced[-1]["parts"]["smooth"], image_metrics=image,
                f1=[float(x) for x in metrics["f1(b)"]])


def hair_resume_and_eval(record, scene, model, args, resume_args):
    """Phase 12, steps 4-5: a new Scene on the model directory holds the
    hair parameters and graph bit-equal and renders one view bit-equal;
    the eval driver on the final PLY (with -m) gives the in-training
    evaluation's strand metrics."""
    import random

    from hairgs_tpu_torch.drivers import eval as eval_driver
    from hairgs_tpu_torch.models.hair import HairModel, hair_render_inputs
    from hairgs_tpu_torch.render.renderer import RasterConfig, render
    from hairgs_tpu_torch.scene import Scene

    random.seed(0)
    again = Scene(resume_args, capacity_round=args.capacity_round)
    hm = again.gaussians
    same = isinstance(hm, HairModel) and \
        all(torch.equal(a, b) for a, b in zip(hm.params, model.params)) and \
        all(torch.equal(a, b) for a, b in zip(hm.graph, model.graph))
    cam = again.get_cameras()[0]
    cfg = RasterConfig(max_tiles_per_gaussian=args.max_tiles_per_gaussian,
                       max_pairs_per_tile=args.max_pairs_per_tile,
                       chunk=args.composite_chunk, use_pallas=True,
                       viewspace_stats=False)
    with torch.no_grad():
        imgs = [render(cam, **hair_render_inputs(m.params, m.graph, cam.cam_center,
                                                 m.active_sh_degree,
                                                 m.dist_to_scale_factor),
                       active=m.graph.seg_active, width=cam.width, height=cam.height,
                       config=cfg)["render"] for m in (model, hm)]
    equal = torch.equal(*imgs)
    print(f"  resume: loaded iteration {again.loaded_iter}, {hm.num_segments} "
          f"segments, parameters and graph bit-equal {same}, view render "
          f"bit-equal {equal}")
    if not (same and equal):
        fail("the resumed hair model differs from the trained one")

    ply = f"{args.model_path}/point_cloud/iteration_{again.loaded_iter}/point_cloud.ply"
    t0 = time.perf_counter()
    got = eval_driver.main(["-s", args.source_path, "-p", ply, "-m", args.model_path])
    t_eval = time.perf_counter() - t0
    want = record.eval[0]
    diff = {k: (list(map(float, got[k])), list(map(float, want[k])))
            for k in ("precision(b)", "recall(b)", "f1(b)")}
    print(f"  eval driver ({t_eval:.1f} s): (driver, in training) {diff}")
    if any(a != b for a, b in diff.values()):
        fail("the eval driver's strand metrics differ from the in-training ones")
    return dict(resume_equal=True, eval_driver_s=t_eval)


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on a GPU")
    from hairgs_tpu_torch import kernels
    from hairgs_tpu_torch.bench_scene import build_bench_scene
    from hairgs_tpu_torch.core.camera import stack_cameras
    from hairgs_tpu_torch.render import composite_pairs as cp
    from hairgs_tpu_torch.render.renderer import RasterConfig
    from hairgs_tpu_torch.train.trainer import make_gaussian_train_step

    t_start = time.perf_counter()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    print("phase 1: build kernels")
    # the shipped libraries (each compositor pass with its f32 and bf16
    # entry points, and the precision probe), and for phase 6 the same
    # sources built with nvcc's default FMA contraction instead of
    # --fmad=false; every nvcc process starts at once
    report = kernels.build(verbose=True, variants={
        "": kernels.NVCC_FLAGS,
        FMA: [f for f in kernels.NVCC_FLAGS if f != "--fmad=false"]})
    for name, r in report.items():
        print(f"  {name}: built in {r['seconds']:.1f} s; "
              + " | ".join(ptxas_summary(r["ptxas"])))

    print("phase 2: card")
    smi = smi_line()
    print(smi)
    device = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # use_pallas=True: the paged path, whose passes are the CUDA kernels
    cfg = RasterConfig(max_tiles_per_gaussian=16, max_pairs_per_tile=2048,
                       chunk=128, pair_capacity=786432, viewspace_stats=True,
                       alpha_min=1.0 / 255.0, use_pallas=True)
    chunk = cfg.chunk
    max_chunks = cfg.max_pairs_per_tile // chunk
    C = 7
    f32_names = ("composite_fwd", "composite_bwd")
    bf16_names = ("composite_fwd_bf16", "composite_bwd_bf16")

    print("phase 3: forward kernel against its plain version")
    latch_fixture(device)
    # scenes whose pixels latch (bench view 0 has none), at three chunk
    # sizes: 512 stages more slots than a block has threads and takes more
    # than 48 KB of shared memory in the backward
    dense = {}
    for dchunk in (32, 128, 512):
        d_in = dense_scene(device, seed=dchunk)
        _, d_fwd = check_forward(f"dense latching chunk={dchunk}", *d_in,
                                 dchunk, DENSE_PAGE // dchunk, C)
        dense[dchunk] = (d_in, d_fwd)
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
    for dchunk, (d_in, d_fwd) in dense.items():
        check_backward(f"dense latching chunk={dchunk}", *d_in[:4], d_fwd,
                       d_in[4], dchunk, DENSE_PAGE // dchunk, C, seed=9)
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
    cams = scene.cams
    n_timed = 20
    cp.reset_launches()
    state, metrics, image, ms_step, median_ms = run_steps(
        step_fn, (scene.params, scene.stats, scene.opt_state), scene.active,
        lambda i: cams[i % 4], 3, n_timed, 1)
    main_launches = dict(cp.launches)
    dt = ms_step * n_timed / 1e3
    loss = check_step_outputs("train step", state[0], metrics, image, scene)
    print(f"  launches over 23 steps: {main_launches}")
    print(f"  step {ms_step:.3f} ms mean over {n_timed} steps to the final "
          f"synchronize ({n_timed / dt:.3f} it/s), host median {median_ms:.3f} "
          f"ms; loss {loss:.6f}, "
          f"psnr {metrics['psnr'].item():.3f}, overflow_pairs "
          f"{metrics['overflow_pairs'].item()}, overflow_tiles "
          f"{metrics['overflow_tiles'].item()}, overflow_capacity "
          f"{metrics['overflow_capacity'].item()}, pairs_demand "
          f"{metrics['pairs_demand'].item()}")
    if any(main_launches[k] != 23 for k in f32_names) \
            or any(main_launches[k] != 0 for k in bf16_names):
        fail(f"expected 23 launches of each f32 kernel and none of the bf16 "
             f"ones, got {main_launches}")
    profile_steps(step_fn, state, scene)

    print("phase 6: kernel times at one bench view")
    fwd_args = (geo, feat, starts, counts, grid_w, 16, chunk, max_chunks, C)
    _, trans, tstarts, latch = f_fwd
    cnt = cp.clamp_counts_to_live_chunks(counts, tstarts, chunk, max_chunks)
    cots = bwd_cotangents(nt, C, 5, device)
    bwd_args = (geo, feat, starts, cnt, tstarts, latch, trans, *cots, grid_w,
                16, chunk, max_chunks, C, True)
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
    n_sw, touched, kept = warp_shares(geo, starts, counts, grid_w)
    print(f"  (slot, warp) combinations {n_sw}: some lane passes the gates in "
          f"{touched / n_sw:.4f}, the cull mask keeps {kept / n_sw:.4f}")
    hist, heavy = chunk_histogram(counts, chunk)
    print(f"  chunks per tile (tiles with 0, 1, 2, ... chunks): {hist}; tiles "
          f"with >= 8 chunks hold {heavy:.4f} of the chunks")
    occ = {name: cp.blocks_per_sm(name, C, chunk, bf16=b)
           for name, b in (("composite_fwd", False), ("composite_bwd", False))}
    occ.update({name + "_bf16": cp.blocks_per_sm(name, C, chunk, bf16=True)
                for name in ("composite_fwd", "composite_bwd")})
    print(f"  resident blocks of 256 threads per SM (occupancy calculator, "
          f"C={C}, chunk={chunk}, stats on): {occ}")
    print(f"  composite_fwd {k_fwd_ms:.4f} ms, turns {turns[''][0]} (plain "
          f"{p_fwd_ms:.3f} ms, bound {fb:.4f} ms by {fb_by})")
    print(f"  composite_bwd {k_bwd_ms:.4f} ms, turns {turns[''][1]} (plain "
          f"{p_bwd_ms:.3f} ms, bound {bb:.4f} ms by {bb_by})")
    with kernels.variant(FMA):
        m_out, m_t, _, _ = cp.composite_pairs_fwd_cuda(*fwd_args)
        m_geo, m_feat = cp.composite_pairs_bwd_cuda(*bwd_args)
    p_out, p_t, _, _ = cp.composite_pairs_fwd_plain(*fwd_args)
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
    t_phase = time.perf_counter()

    print("phase 7: bf16 feature plane")
    latch_fixture(device, bf16=True)
    for dchunk, (d_in, d_fwd) in dense.items():
        check_bf16(f"dense latching chunk={dchunk}", *d_in[:4], d_fwd, d_in[4],
                   dchunk, DENSE_PAGE // dchunk, C, seed=10)
    check_bf16("small 256x256", *s_in[:4], s_fwd, 16, chunk, max_chunks, C, seed=6)
    bf_fwd_err, bf_bwd_err, b_fwd = check_bf16(
        "bench view 0", geo, feat, starts, counts, f_fwd, grid_w, chunk,
        max_chunks, C, seed=7)
    feat_b = feat.to(torch.bfloat16)
    bf_fwd_args = (geo, feat_b) + fwd_args[2:]
    bf_bwd_args = (geo, feat_b) + bwd_args[2:]
    kb_fwd_ms = cuda_ms(lambda: cp.composite_pairs_fwd_cuda(*bf_fwd_args), 20)
    kb_bwd_ms = cuda_ms(lambda: cp.composite_pairs_bwd_cuda(*bf_bwd_args), 20)
    pb_fwd_ms = cuda_ms(lambda: cp.composite_pairs_fwd_plain(*bf_fwd_args), 1)
    pb_bwd_ms = cuda_ms(lambda: cp.composite_pairs_bwd_plain(*bf_bwd_args), 1)
    fbb, fbb_by = fwd_bound_ms(counts, chunk, C, fwd_gates, feat_bytes=2)
    bbb, bbb_by = bwd_bound_ms(cnt, chunk, C, bwd_gates, feat_bytes=2)
    print(f"  composite_fwd_bf16 {kb_fwd_ms:.4f} ms (plain {pb_fwd_ms:.3f} ms, "
          f"bound {fbb:.4f} ms by {fbb_by}); composite_bwd_bf16 "
          f"{kb_bwd_ms:.4f} ms (plain {pb_bwd_ms:.3f} ms, bound {bbb:.4f} ms "
          f"by {bbb_by})")
    step_b = make_gaussian_train_step(
        scene.opt_cfg, dataclasses.replace(cfg, feat_bf16=True),
        width=scene.width, height=scene.height, active_sh_degree=0,
        device=device)
    cp.reset_launches()
    state_b, metrics_b, image_b, ms_step_b, median_b = run_steps(
        step_b, (scene.params, scene.stats, scene.opt_state), scene.active,
        lambda i: cams[i % 4], 3, n_timed, 1)
    bf16_launches = dict(cp.launches)
    loss_b = check_step_outputs("bf16 train step", state_b[0], metrics_b,
                                image_b, scene)
    print(f"  launches over 23 bf16 steps: {bf16_launches}")
    if any(bf16_launches[k] != 23 for k in bf16_names) \
            or any(bf16_launches[k] != 0 for k in f32_names):
        fail(f"expected 23 launches of each bf16 kernel and none of the f32 "
             f"ones, got {bf16_launches}")
    # the two steps again, in turns (f32, bf16, bf16, f32): the step is
    # host-bound and drifts between runs more than the kernels differ
    turn_ms = {"f32": [ms_step], "bf16": [ms_step_b]}
    for name, fn in (("bf16", step_b), ("f32", step_fn)):
        turn_ms[name].append(run_steps(
            fn, (scene.params, scene.stats, scene.opt_state), scene.active,
            lambda i: cams[i % 4], 1, n_timed, 1)[3])
    print(f"  bf16 step {ms_step_b:.3f} ms mean over {n_timed} steps (host "
          f"median {median_b:.3f} ms) beside the f32 step of phase 5, "
          f"{ms_step:.3f} ms (host median {median_ms:.3f} ms); loss "
          f"{loss_b:.6f} (f32 {loss:.6f}); in turns f32, bf16, bf16, f32: "
          f"{turn_ms['f32'][0]:.3f}, {turn_ms['bf16'][0]:.3f}, "
          f"{turn_ms['bf16'][1]:.3f}, {turn_ms['f32'][1]:.3f} ms")

    print("phase 8: view batches")
    check_batched_against_cpu(cfg)
    batch = stack_cameras(cams)
    n_views, n_warm_b, n_timed_b = len(cams), 2, 5
    cp.reset_launches()
    state_v, metrics_v, image_v, ms_batch, median_v = run_steps(
        step_fn, (scene.params, scene.stats, scene.opt_state), scene.active,
        lambda i: batch, n_warm_b, n_timed_b, 1)
    batch_launches = dict(cp.launches)
    loss_v = check_step_outputs("batched train step", state_v[0], metrics_v,
                                image_v, scene)
    n_steps_b = n_warm_b + n_timed_b
    print(f"  launches over {n_steps_b} steps of {n_views} views: "
          f"{batch_launches}")
    print(f"  batched step {ms_batch:.3f} ms mean over {n_timed_b} steps "
          f"({ms_batch / n_views:.3f} ms per view; host median "
          f"{median_v:.3f} ms); loss {loss_v:.6f}, pairs_demand "
          f"{metrics_v['pairs_demand'].item()}, overflow_capacity "
          f"{metrics_v['overflow_capacity'].item()}")
    if any(batch_launches[k] != n_views * n_steps_b for k in f32_names):
        fail(f"expected {n_views} launches of each kernel per batched step, "
             f"got {batch_launches} over {n_steps_b} steps")

    print("phase 9: kernel path against the XLA path "
          "(scripts/tpu_parity_check.py)")
    parity_kernel_vs_xla(device)

    print("phase 10: precision probe")
    probe_entry = check_probe(device)
    print(f"  phases 7-10: {time.perf_counter() - t_phase:.1f} s")

    # phase 12 continues from phase 11's capture and model directory
    tmp_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_stages_")
    tmp = tmp_dir.name
    print("phase 11: the Stage-I driver on a USC-scale scene")
    t_phase = time.perf_counter()
    stage1 = stage1_driver(device, tmp)
    print(f"  phase 11: {time.perf_counter() - t_phase:.1f} s")

    print("phase 12: Stage II, Stage III and evaluation on phase 11's capture")
    t_phase = time.perf_counter()
    hair_grads_against_cpu(cfg)
    stage2 = stage2_merge(tmp, stage1["f1"])
    stage3 = stage3_driver(tmp)
    tmp_dir.cleanup()
    print(f"  phase 12: {time.perf_counter() - t_phase:.1f} s")

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
        {"name": "composite_fwd_bf16", "route": "cuda",
         "source": src + "composite_fwd.cu",
         "replaces": "hairgs_tpu/render/pallas_composite.py:153",
         "launches": bf16_launches["composite_fwd_bf16"],
         "max_abs_err": bf_fwd_err, "ms": kb_fwd_ms, "plain_ms": pb_fwd_ms,
         "bound_ms": fbb, "bound_by": fbb_by, "library_ms": None},
        {"name": "composite_bwd_bf16", "route": "cuda",
         "source": src + "composite_bwd.cu",
         "replaces": "hairgs_tpu/render/pallas_composite.py:272",
         "launches": bf16_launches["composite_bwd_bf16"],
         "max_abs_err": bf_bwd_err, "ms": kb_bwd_ms, "plain_ms": pb_bwd_ms,
         "bound_ms": bbb, "bound_by": bbb_by, "library_ms": None},
        probe_entry,
    ]}
    print(f"  total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"step_ms": ms_step, "it_per_s": n_timed / dt,
                      "host_median_step_ms": median_ms,
                      "bf16_step_ms": ms_step_b, "batched_step_ms": ms_batch,
                      "stage1_driver": stage1, "stage2_merge": stage2,
                      "stage3_driver": stage3, "card": smi}))
    print(json.dumps(kernels_line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
