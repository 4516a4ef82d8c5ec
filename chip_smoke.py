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
driver on the strand graph) and the eval driver on that capture, then the
rest of the training and data paths on those models (device metrics,
async topology events, the render driver, the Gabor bank, the USC parse
driver, the 2D grid), the reference pipelines (phases 15-16) and the
NeRSemble and USC data paths (phase 17), and prints the kernels' times
beside their bounds. Exits non-zero on any failure, and when no CUDA device
is present.

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
eval driver (`drivers/eval.py::main`) on the final PLY; both drivers' first
evaluation on the device; 13 `compute_metrics_device` on phases 11-12's
final models against the host oracle, 500 Stage-III iterations with
`--async_topology` from the merged model beside the synchronous run, the
render driver (`drivers/render.py`, all five types on the hair model,
type 0 on the Gaussian one; one view of the C = 7 and of the C = 3 forward
against the plain version), `generate_dataset(orientation_source="gabor")`
at 16 x 1000^2 (a crop on the card against the CPU), the USC parse driver
on a sample written by drivers/synthesize_usc_sample.py, and the 2D grid
(`visualization.py`); 14 the parallel paths of `parallel/` with ranks that
share the one card over gloo (correctness and collective counts, no
scaling): the slab render at k = 2 and 4 against one render of the
depth-permuted rows; the view-parallel Stage-I step over 2 ranks and the
slab step over 1 x 2 and 2 x 2 ranks against one process; the view step
through NCCL at world size 1; the train driver under torchrun
(`--view_batch 4` and `--gauss_shard 2`, 200 Stage-I iterations, and 100
Stage-III iterations with `--view_batch 2`) against one process, its ranks
bit-equal after every topology event; a 2-rank sharded checkpoint; and
`drivers/convert_output.py` on phase 12's final PLY. Each rank is a child
process (`--rank-case`, or torchrun's) with its own timeout; 15 the
reference pipeline of scripts/run_reference_schedule.sh through
`drivers/pipeline.py`, each stage a child process, on its seed-0 scene (150
strands x 24 points, 16 views at 512x512, written on the card, no GT render
dropping a pair): the scene, the first 5000 iterations of Stage I's
reference schedule and the merge run beside phases 11-14 (the whole 30 000
would not fit the time limit); then the eval driver on the merged PLY
against the merge's own evaluation, Stage II.5 (the grow driver and the
eval driver on its output), the npz checkpoints of the Gaussian and the
hair model as bit-equal resumes, the merge driver's `--clean`, Stage III's
first 1000 iterations and the eval driver on its last PLY; 16 the 1000x1000
recipe of scripts/run_reference_schedule_1k.sh through
`drivers/pipeline.py --recipe 1k` beside phases 11-15 (the scene, Stage I's
first 10 000 iterations under antialiasing at alpha_min 1e-5 with the frozen
64-tile budget, the merge, Stage II.5 and its eval, Stage III's first 500
with async topology events, the final eval, the growth of the final model
and its eval), then (a) both compositor kernels (the backward with and
without stats) against their plain versions at a 1000x1000 view of its
Stage-I model under antialiasing at alpha_min 1e-5, with their times,
passing pair-pixels, cull shares and bounds, (b) the antialiased step's
gradients on the card against the CPU, (c) the grow driver on the card
against the CPU, (d) each eval driver's metrics against those printed for
the same strands (the checkpoint's, on the host); 17 beside phases 11-16,
as child processes: (a) a NeRSemble-layout capture made from the
reference scene at 1000x1000 (16 views as JPEGs, alpha and facer
segmentation maps at 2000x2000, synthetic FLAME pickles at FLAME's sizes),
`drivers/parse_nersemble.py` on the card and on the CPU (held to each
other), the Stage-I driver for 1000 iterations on the card's parse (the
FLAME vertices its initial points), the Gabor bank's ms per view and the
forward kernel against its plain version at a view of that model; (b)
`drivers/pipeline.py --recipe usc` (scripts/usc_dress_rehearsal.sh: a
sample of 10 000 strands x 100 points, the USC parse at 16 x 1000^2 on the
card, 500 Stage-I iterations, the eval driver at ~990k GT points).

    python3 chip_smoke.py
    python3 chip_smoke.py --phase15 30000 [S]   # phase 15 alone, the whole
    # Stage-I schedule held to the JAX chain's quality; with S, the whole
    # Stage-III schedule afterwards until S seconds after the start
    python3 chip_smoke.py --phase16 30000 [S]   # phase 16 alone, the whole
    # Stage-I schedule, then the whole Stage-III schedule until S seconds
    # after the start; quality recorded, not gated
    python3 chip_smoke.py --phase17             # phase 17 alone

The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import dataclasses
import json
import re
import shutil
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


def cuda_ms(fn, reps, warm=True):
    """Mean milliseconds of fn() over reps launches, timed with CUDA events
    after one warm-up call (none without `warm`)."""
    if warm:
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
    return pair_table(scene.params, scene.active, scene.cams[cam_idx], scene.width,
                      scene.height, cfg)


def pair_table(params, active, cam, width, height, cfg, sh_degree=0):
    """(geo_rows, feat_rows, starts, counts, binning) of a Gaussian model's
    view, as the train step builds them."""
    from hairgs_tpu_torch.models.gaussian import gaussian_render_inputs
    from hairgs_tpu_torch.render.renderer import paged_pair_table

    with torch.no_grad():
        inputs = gaussian_render_inputs(params, cam.cam_center, sh_degree)
        _, binning, geo, feat = paged_pair_table(
            cam, **inputs, cov3d_precomp=None, active=active,
            mean2d_offset=None, scale_modifier=1.0, width=width,
            height=height, config=cfg)
    return geo, feat, binning.starts, binning.counts, binning


def check_forward(name, geo, feat, starts, counts, grid_w, chunk, max_chunks, C,
                  alpha_min=1.0 / 255.0):
    """The forward kernel against its plain version: image, T, tstarts of
    the chunks that exist and the latch plane (bit for bit). Returns the
    image error and the kernel's (out, trans, tstarts, latch)."""
    from hairgs_tpu_torch.render import composite_pairs as cp

    args = (geo, feat, starts, counts, grid_w, 16, chunk, max_chunks, C, alpha_min)
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
                   max_chunks, C, seed, plant_faults=False, alpha_min=1.0 / 255.0):
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
                g_trans, grid_w, 16, chunk, max_chunks, C, stats, alpha_min)
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
    # FWD_PASS_OPS counts 7 channel sums: one per channel
    return bound_ms(bytes_, n_all * GATE_OPS + n_pass * (FWD_PASS_OPS - 7 + C))


def bwd_bound_ms(cnt, chunk, C, gates, feat_bytes=4, stats=True):
    """Bytes: reads geometry rows 0-5 and the C feature rows (feat_bytes
    each) of every pair the clamped counts keep, the tile tables, the start
    transmittance of every chunk that runs, T, the two image cotangents and
    g_T; writes the 8 geometry (6 without stats) and C feature gradients of
    those pairs (the other slots are the wrapper's zero fill). Without
    stats a passing pair-pixel costs 4 operations less (two aux gradients
    and their shares of the block sum)."""
    nt, pairs, chunks = table_sizes(cnt, chunk)
    rows = 8 if stats else 6
    bytes_ = (4 * (pairs * 6 + 2 * nt + chunks * PIX + nt * PIX * (2 + 2 * C)
                   + pairs * rows) + 2 * feat_bytes * pairs * C)
    n_all, n_pass = gates
    return bound_ms(bytes_, n_all * GATE_OPS + n_pass * (BWD_PASS_OPS - 2 * (8 - rows)))


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


def probe_device_ms(fn, reps):
    """Mean device time per call of the probe kernel over reps calls, from
    the profiler's device activity (the CUDA-event time of cuda_ms holds the
    host's work of each call as well); "not measured" without any."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    probe = [r for r in rows if "probe" in r[0]]
    if not probe:
        return f"not measured (device rows {rows[:4]})"
    return round(sum(r[1] for r in probe) / reps, 6)


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
    device_ms = probe_device_ms(lambda: pp.probe_cuda(*t), 200)
    print(f"  precision_probe {ms:.4f} ms per call between CUDA events around the "
          f"Python call, of it {device_ms} ms of kernel time on the device "
          f"(torch.profiler) (plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms: "
          f"torch.matmul fp32 and TF32, exp, log1p; bound {bound:.6f} ms by {by})")
    return {"name": "precision_probe", "route": "cuda",
            "source": "hairgs_tpu_torch/csrc/precision_probe.cu",
            "replaces": "scripts/mosaic_precision_probe.py:41",
            "launches": launches,
            "max_abs_err": max(e for e, _ in plain_err.values()),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": lib_ms, "device_ms": device_ms}


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
    and the count, the last evaluation, and whether the first evaluation
    ran on the device (evaluation/device_metrics.py)."""

    def __init__(self):
        self.rows = []
        self.eval = None
        self.first_eval_on_device = None

    def log(self, info, model):
        self.rows.append(dict(t=time.perf_counter(), it=info.iter, loss=info.loss,
                              dens=dict(info.densification_info),
                              topo_ms=info.topology_ms, count=model.count))
        self._evals(info)

    def _evals(self, info):
        if self.first_eval_on_device is None and info.eval_metrics is not None:
            self.first_eval_on_device = info.eval_on_device
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
    checkpoint. Returns a summary dict, and what phase 13 reuses: the
    trained model, the GT strands of the scene, the strand geometry and
    the GT renders' raster configuration."""
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
    summary = dict(summary, dataset_s=t_data, knn_ms=knn_ms,
                   gt_max_pairs_per_tile=cfg.max_pairs_per_tile,
                   gt_pair_capacity=cfg.pair_capacity, gt_worst=worst,
                   peak_gib=peak / 2**30)
    return summary, dict(model=model, gt=scene.gt, hair=hair, gt_cfg=cfg)


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
    print(f"  first evaluation on the device: {record.first_eval_on_device}")
    if record.first_eval_on_device is not True:
        fail("the Stage-I driver's first evaluation did not take the device path")

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
        self._evals(info)


def run_stage3(tmp, model_dir, extra=()):
    """The Stage-III driver's training() on `model_dir` with STAGE3_FLAGS
    and `extra`; returns (record, scene, model, launches, seconds, args,
    the argv's parser)."""
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
    argv = ["-s", f"{tmp}/scene", "-m", model_dir, *STAGE3_FLAGS, *extra]
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
    return record, scene, model, dict(cp.launches), t_train, args, \
        parser.parse_args(argv)


def stage3_driver(tmp):
    """Phase 12, step 3: the Stage-III driver on the merged directory, then
    a resume and the eval driver. Returns a summary dict, and the record,
    scene and model for phase 13."""
    record, scene, model, launches, t_train, args, resume_args = run_stage3(
        tmp, f"{tmp}/model")
    peak = torch.cuda.max_memory_allocated()
    print(f"  peak device memory of the run {peak / 2**30:.3f} GiB")
    summary = check_stage3(record, scene, model, launches, t_train, args)
    summary.update(peak_gib=peak / 2**30,
                   **hair_resume_and_eval(record, scene, model, args, resume_args))
    return summary, dict(record=record, scene=scene, model=model)


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
    print(f"  first evaluation on the device: {record.first_eval_on_device}")
    if record.first_eval_on_device is not True:
        fail("the Stage-III driver's first evaluation did not take the device path")

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


# phase 13: the rest of the training and data paths on phase 11-12's capture
DEVICE_METRIC_GATE = 1e-3  # |device - host| on every precision, recall, F1
GABOR_CROP = 128
GABOR_INDEX_SHARE = 0.999  # card against CPU, same crop
GABOR_CONF_ERR = 1e-4
RENDER_VIEWS = 16  # USC_CAMERAS
USC_PARSE_FLAGS = ["--orientation", "gabor", "--cameras", "4", "--width", "512",
                   "--height", "512"]


def device_metrics_check(models, gt, smi):
    """Phase 13, step 1: compute_metrics_device on the final models against
    the capture's GT points, held to the host oracle (compute_metrics) on
    the same model; both timed (host clock, the device synchronised)."""
    from hairgs_tpu_torch.evaluation.device_metrics import compute_metrics_device
    from hairgs_tpu_torch.evaluation.eval_data import (
        compute_eval_data_from_gaussian,
        compute_eval_data_from_hair,
        eval_points_device_from_gaussian,
        eval_points_device_from_hair,
    )
    from hairgs_tpu_torch.evaluation.metrics import compute_metrics

    dev = torch.device("cuda")
    gt_pts = torch.tensor(np.asarray(gt.points, np.float32), device=dev)
    gt_dirs = torch.tensor(np.asarray(gt.directions, np.float32), device=dev)
    out = {}
    for name, model in models:
        is_hair = name == "hair"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pts, dirs, valid = (eval_points_device_from_hair(model) if is_hair
                            else eval_points_device_from_gaussian(model))
        got, ths = compute_metrics_device(pts, dirs, gt_pts, gt_dirs,
                                          pred_valid=valid, bidirectional=True)
        torch.cuda.synchronize()
        t_dev = time.perf_counter() - t0
        t1 = time.perf_counter()
        pred = (compute_eval_data_from_hair(model) if is_hair
                else compute_eval_data_from_gaussian(model))
        want, _ = compute_metrics(pred=pred, gt=gt, bidirectional=True)
        t_host = time.perf_counter() - t1
        delta = max(float(np.abs(np.asarray(got[k]) - np.asarray(want[k])).max())
                    for k in got)
        n_valid = int(valid.sum())
        print(f"  device metrics, {name} model ({n_valid} valid of {valid.shape[0]} "
              f"rows, {gt_pts.shape[0]} GT points): device {t_dev:.3f} s, host "
              f"oracle {t_host:.3f} s (strand consistency included); largest "
              f"|device - host| over precision, recall, F1 {delta:.3e}; F1(b) "
              f"device {[round(float(x), 4) for x in got['f1(b)']]}, host "
              f"{[round(float(x), 4) for x in want['f1(b)']]} [{smi}]")
        if not delta <= DEVICE_METRIC_GATE:
            fail(f"device metrics of the {name} model differ from the host "
                 f"oracle by {delta}")
        out[name] = dict(device_s=t_dev, host_s=t_host, max_delta=delta,
                         valid=n_valid, f1=[float(x) for x in got["f1(b)"]])
    return out


def step_ms_between(rows, lo, hi):
    """Mean host ms of the steps lo+1 .. hi-1 (iterations after the run's
    start) from the record's clock."""
    start = rows[0]["it"]
    idx = {r["it"] - start: i for i, r in enumerate(rows)}
    dts = [(rows[idx[i]]["t"] - rows[idx[i] - 1]["t"]) * 1e3
           for i in range(lo + 1, hi) if i in idx and idx[i] > 0]
    return float(np.mean(dts)) if dts else float("nan")


def async_stage3(tmp, sync, smi):
    """Phase 13, step 2: 500 Stage-III iterations with --async_topology
    from the merged model copied before phase 12's run, phase 12's flags
    otherwise; held beside the synchronous run."""
    from hairgs_tpu_torch.topo.async_events import TopologyWorker

    # count the worker's launches and installs (the driver does not)
    counted = {"launch": [], "install": 0}
    launch, poll = TopologyWorker.launch, TopologyWorker.poll

    def counting_launch(self, **kw):
        counted["launch"].append(kw)
        return launch(self, **kw)

    def counting_poll(self, *a, **kw):
        done = poll(self, *a, **kw)
        counted["install"] += done
        return done

    TopologyWorker.launch, TopologyWorker.poll = counting_launch, counting_poll
    try:
        record, scene, model, launches, t_train, args, _ = run_stage3(
            tmp, f"{tmp}/model_async", ("--async_topology",))
    finally:
        TopologyWorker.launch, TopologyWorker.poll = launch, poll
    rows = record.rows
    start = rows[0]["it"]
    n_steps = rows[-1]["it"] - start
    n_views = len(scene.get_cameras())
    # the worker's launches: densify every 100 after 50 until 400, merge
    # every 100 (STAGE3_FLAGS); growth at 250 stays synchronous
    launch_its = list(range(100, n_steps + 1, 100))
    installs = [r for r in rows if "t_async_pull" in r["dens"]]
    print(f"  {n_steps} steps in {t_train:.1f} s ({n_steps / t_train:.3f} it/s over "
          f"the whole call of training(); synchronous run "
          f"{sync['steps'] / sync['seconds']:.3f} it/s) [{smi}]")
    for r in installs:
        d = r["dens"]
        times = {k: d[k] for k in ("t_async_pull", "t_async_compute", "t_apply")}
        counts = {k: v for k, v in d.items() if not k.startswith("t_")}
        print(f"  installed at iter {r['it'] - start}: {times}; {counts} -> "
              f"{r['count']} segments, {r['strands']} strands")
    synced = [r for r in rows if r["loss"] is not None]
    lam = args.lambda_dssim
    photo = (1 - lam) * synced[-1]["parts"]["l1"] + lam * synced[-1]["parts"]["dssim"]
    flights = []
    sync_rows = sync["rows"]
    for launch, r in zip(launch_its, installs):
        inst = r["it"] - start
        flights.append(dict(launch=launch, install=inst,
                            step_ms=step_ms_between(rows, launch, inst),
                            sync_step_ms=step_ms_between(sync_rows, launch, inst)))
        print(f"  flight {launch} -> {inst}: step {flights[-1]['step_ms']:.3f} ms "
              f"while out; the synchronous run's steps {launch + 1}-{inst - 1}: "
              f"{flights[-1]['sync_step_ms']:.3f} ms")
    bounds = [0] + [r["it"] - start for r in rows if r["dens"]] + [n_steps]
    stretches = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        if hi - lo > 1:
            stretches.append((lo + 1, hi - 1, step_ms_between(rows, lo, hi)))
            print(f"  steps {lo + 1}-{hi - 1}: mean {stretches[-1][2]:.3f} ms")
    metrics, _, _ = record.eval
    f1 = [float(x) for x in metrics["f1(b)"]]
    print(f"  final loss {synced[-1]['loss']:.6f} (synchronous "
          f"{sync['loss_last']:.6f}); photometric {photo:.6f} (synchronous "
          f"{sync['photo_last']:.6f}); F1(b) at 4 mm, 90 deg {f1[-1]:.4f} "
          f"(synchronous {sync['f1'][-1]:.4f}); {model.num_segments} segments, "
          f"{len(model.strands_info.list_strands)} strands; launches {launches}")
    if not all(np.isfinite(r["loss"]) for r in synced) or \
            not all(torch.isfinite(p).all() for p in model.params):
        fail("non-finite loss or parameters in the async Stage-III run")
    print(f"  worker launches {len(counted['launch'])} "
          f"({[(k['densify'], k['merge']) for k in counted['launch']]}, "
          f"(densify, merge)), installs {counted['install']}")
    if len(counted["launch"]) != len(launch_its) \
            or counted["install"] != len(counted["launch"]):
        fail(f"{len(counted['launch'])} async events launched (expected at "
             f"{launch_its}), {counted['install']} installed")
    window = args.densify_until_iter - 1
    if launches["composite_fwd"] != n_steps + n_views \
            or launches["composite_bwd"] != window \
            or launches["composite_bwd_nostats"] != n_steps - window:
        fail(f"unexpected launches in the async Stage-III run: {launches}")
    return dict(steps=n_steps, seconds=t_train, launches=launches,
                events=[{k: r["dens"][k] for k in ("t_async_pull", "t_async_compute",
                                                   "t_apply")} for r in installs],
                flights=flights, stretches=stretches, loss_last=synced[-1]["loss"],
                photo_last=photo, f1=f1, final_segments=model.num_segments)


def count_c(name_counts):
    """A wrapper of composite_pairs_fwd_cuda that also counts its launches
    by channel count (the kernel's own counter does not split them)."""
    from hairgs_tpu_torch.render import composite_pairs as cp

    inner = cp.composite_pairs_fwd_cuda

    def wrapped(*args, **kw):
        c = args[8] if len(args) > 8 else kw["num_channels"]
        name_counts[c] = name_counts.get(c, 0) + 1
        return inner(*args, **kw)

    return inner, wrapped


def view_inputs(model, cam, mask_type):
    """The renderer's inputs for one view as the render driver builds them:
    the model's channels, or the foreground indicator as 3 channels."""
    from hairgs_tpu_torch.drivers.render import FG_BIN_TH
    from hairgs_tpu_torch.models.hair import hair_render_inputs

    inputs = hair_render_inputs(model.params, model.graph, cam.cam_center,
                                model.active_sh_degree, model.dist_to_scale_factor)
    if mask_type:
        fg = (torch.sigmoid(model.params.mask[:, 0]) >= FG_BIN_TH) & \
            model.graph.seg_active
        inputs = dict(inputs, features=fg.to(torch.float32)[:, None].repeat(1, 3))
    return inputs


def render_driver_check(tmp, hair_scene, smi):
    """Phase 13, step 3: the render driver, all five types, on phase 12's
    final hair model and type 0 on phase 11's Gaussian model; the PNGs
    counted; one view of type 0 (C = 7) and type 2 (C = 3) of the hair
    model held against the plain forward."""
    import glob

    from hairgs_tpu_torch.config import RuntimeConfig
    from hairgs_tpu_torch.drivers import render as render_driver
    from hairgs_tpu_torch.render import composite_pairs as cp
    from hairgs_tpu_torch.render.renderer import RasterConfig, paged_pair_table

    by_c = {}
    inner, wrapped = count_c(by_c)
    cp.reset_launches()
    cp.composite_pairs_fwd_cuda = wrapped
    try:
        t0 = time.perf_counter()
        hair_times = render_driver.main(["-s", f"{tmp}/scene", "-m", f"{tmp}/model"])
        t_hair = time.perf_counter() - t0
        hair_launches = dict(cp.launches)
        c3_launches = by_c.get(3, 0)
        gauss_times = render_driver.main(["-s", f"{tmp}/scene", "-m",
                                          f"{tmp}/model_gauss", "-t", "0"])
        launches = dict(cp.launches)
    finally:
        cp.composite_pairs_fwd_cuda = inner
    n_hair = len(glob.glob(f"{tmp}/model/render/**/*.png", recursive=True))
    n_gauss = len(glob.glob(f"{tmp}/model_gauss/render/**/*.png", recursive=True))
    for label, times in (("hair", hair_times), ("Gaussian", gauss_times)):
        for t, v in times.items():
            print(f"  render driver, {label} model, {t}: {1e3 * v['render_s'] / v['views']:.3f} "
                  f"ms per view rendering, {1e3 * v['total_s'] / v['views']:.3f} ms "
                  f"with the PNG writes [{smi}]")
    print(f"  PNGs: {n_hair} (hair), {n_gauss} (Gaussian); launches {launches}, "
          f"C = 3 forward launches {c3_launches}; hair driver {t_hair:.1f} s")
    if n_hair != 5 * 2 * RENDER_VIEWS or n_gauss != 2 * RENDER_VIEWS:
        fail(f"expected {10 * RENDER_VIEWS} and {2 * RENDER_VIEWS} PNGs, got "
             f"{n_hair} and {n_gauss}")
    if hair_launches["composite_fwd"] != 5 * RENDER_VIEWS \
            or launches["composite_fwd"] != 6 * RENDER_VIEWS \
            or c3_launches != 2 * RENDER_VIEWS \
            or any(v for k, v in launches.items() if k != "composite_fwd"):
        fail(f"unexpected render launches: {launches}, C = 3: {c3_launches}")

    # one view of each instance against the plain forward, as the driver
    # renders it (its RasterConfig from the flags' defaults)
    rt = RuntimeConfig()
    cfg = RasterConfig(max_tiles_per_gaussian=rt.max_tiles_per_gaussian,
                       max_pairs_per_tile=rt.max_pairs_per_tile,
                       chunk=rt.composite_chunk, use_pallas=True,
                       alpha_min=rt.alpha_min)
    model = hair_scene["model"]
    cam = hair_scene["scene"].get_cameras()[0]
    grid_w = (cam.width + 15) // 16
    max_chunks = cfg.max_pairs_per_tile // cfg.chunk
    checks = {}
    for mask_type, C in ((False, 7), (True, 3)):
        with torch.no_grad():
            _, binning, geo, feat = paged_pair_table(
                cam, **view_inputs(model, cam, mask_type), cov3d_precomp=None,
                active=model.graph.seg_active, mean2d_offset=None,
                scale_modifier=1.0, width=cam.width, height=cam.height, config=cfg)
        starts, counts = binning.starts, binning.counts
        args = (geo, feat, starts, counts, grid_w, 16, cfg.chunk, max_chunks, C)
        k_out, k_t, _, _ = cp.composite_pairs_fwd_cuda(*args)
        p_out, p_t, _, _ = cp.composite_pairs_fwd_plain(*args)
        torch.cuda.synchronize()
        err = max((k_out - p_out).abs().max().item(), (k_t - p_t).abs().max().item())
        ms = cuda_ms(lambda: cp.composite_pairs_fwd_cuda(*args), 20)
        plain_ms = cuda_ms(lambda: cp.composite_pairs_fwd_plain(*args), 1)
        gates = gate_counts(geo, starts, counts, grid_w)
        bound, bound_by = fwd_bound_ms(counts, cfg.chunk, C, gates)
        print(f"  forward C = {C} at hair view 0: image and T max abs err "
              f"{err:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
              f"{bound:.4f} ms by {bound_by}; pairs {int(counts.sum())}, "
              f"pair-pixels passing the gates {gates[1]} of {gates[0]} [{smi}]")
        if not err < FWD_GATE or not torch.isfinite(k_out).all():
            fail(f"the C = {C} forward disagrees with its plain version")
        checks[C] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                         bound_by=bound_by)
    return dict(hair=hair_times, gaussian=gauss_times, launches=launches,
                c3_launches=c3_launches, png=(n_hair, n_gauss), checks=checks)


def gabor_check(tmp, keep, smi):
    """Phase 13, step 4: generate_dataset(orientation_source="gabor") on
    phase 11's strands with phase 11's GT raster configuration (kernel
    path, 16 views at 1000^2), the Gabor bank timed per view; then the
    card's estimate_orientation_field against the CPU's on a crop."""
    from PIL import Image

    from hairgs_tpu_torch.data import vision
    from hairgs_tpu_torch.data.synthetic import generate_dataset

    per_view = []
    inner = vision.estimate_orientation_field

    def timed(image, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(image, *a, **k)
        torch.cuda.synchronize()
        per_view.append((time.perf_counter() - t0) * 1e3)
        return out

    vision.estimate_orientation_field = timed
    try:
        t0 = time.perf_counter()
        root = generate_dataset(f"{tmp}/gabor", keep["hair"], num_cameras=USC_CAMERAS,
                                width=USC_SIZE, height=USC_SIZE,
                                init_subsample=USC_SUBSAMPLE, raster_cfg=keep["gt_cfg"],
                                orientation_source="gabor", device="cuda")
        t_data = time.perf_counter() - t0
    finally:
        vision.estimate_orientation_field = inner
    rgb = np.asarray(Image.open(f"{root}/images/image_1.png"))
    h0 = (rgb.shape[0] - GABOR_CROP) // 2
    w0 = (rgb.shape[1] - GABOR_CROP) // 2
    crop = np.ascontiguousarray(rgb[h0:h0 + GABOR_CROP, w0:w0 + GABOR_CROP])
    t_card, t_cpu = [], []
    outs = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        outs[dev] = [t.cpu().numpy() for t in vision.estimate_orientation_field(
            torch.tensor(crop, device=dev))]
        (t_card if dev == "cuda" else t_cpu).append(time.perf_counter() - t0)
    same = outs["cuda"][0] == outs["cpu"][0]
    conf_err = float(np.abs(outs["cuda"][1] - outs["cpu"][1])[same].max())
    orient = np.asarray(Image.open(f"{root}/orientations/image_1_orientation.png"))
    print(f"  Gabor dataset: {len(per_view)} views, {t_data:.1f} s in all; the "
          f"Gabor bank {np.mean(per_view):.3f} ms per view (min "
          f"{min(per_view):.3f}, max {max(per_view):.3f}) [{smi}]; view 1's "
          f"orientation map has {int((orient > 0).sum())} nonzero pixels")
    print(f"  {GABOR_CROP}x{GABOR_CROP} crop, card against CPU: orientation index "
          f"equal on {same.mean():.6f} of the pixels, confidence max abs error "
          f"{conf_err:.3e} where it is")
    if len(per_view) != USC_CAMERAS or same.mean() < GABOR_INDEX_SHARE \
            or not conf_err <= GABOR_CONF_ERR:
        fail("the Gabor bank on the card disagrees with the CPU")
    return dict(views=len(per_view), ms_per_view=float(np.mean(per_view)),
                dataset_s=t_data, crop_index_share=float(same.mean()),
                crop_conf_err=conf_err)


def usc_parse_check(tmp, smi):
    """Phase 13, step 5: a USC sample written by the port's
    drivers/synthesize_usc_sample.py (numpy only; the USC format has 10000
    strands, of which 90% are 1-vertex stubs here: ~1000 strands of 100
    points), then the parse driver with Gabor orientations."""
    import os

    from hairgs_tpu_torch.drivers import parse_usc_hairsalon, synthesize_usc_sample
    from hairgs_tpu_torch.io.dataset import read_colmap_scene_info

    usc = f"{tmp}/usc"
    print("  ", end="")
    synthesize_usc_sample.main(["--out", usc, "--num_strands", "10000",
                                "--stub_fraction", "0.9", "--seed", "0"])
    t0 = time.perf_counter()
    written = parse_usc_hairsalon.main(["-d", usc, "-o", f"{tmp}/usc_scene",
                                        *USC_PARSE_FLAGS])
    t_parse = time.perf_counter() - t0
    scene = written[0]
    counts = {sub: len(os.listdir(os.path.join(scene, sub)))
              for sub in ("images", "masks", "orientations")}
    info = read_colmap_scene_info(scene)
    print(f"  parse driver {USC_PARSE_FLAGS}: {t_parse:.1f} s [{smi}]; files "
          f"{counts}; COLMAP scene: {len(info.cameras)} cameras, "
          f"{info.points.shape[0]} points")
    if counts != {"images": 4, "masks": 4, "orientations": 8} \
            or len(info.cameras) != 4 or info.points.shape[0] == 0 \
            or not all(os.path.exists(os.path.join(scene, f)) for f in (
                "hair_eval_data.npz", "head_reconstruction_data.npz")):
        fail("the USC parse driver wrote an incomplete scene")
    return dict(seconds=t_parse, cameras=len(info.cameras),
                points=int(info.points.shape[0]))


def grid_check(hair_scene):
    """Phase 13, step 6: the 2D grid of phase 12's hair model, its views
    rendered with the kernel path."""
    from hairgs_tpu_torch.render import composite_pairs as cp
    from hairgs_tpu_torch.render.renderer import RasterConfig
    from hairgs_tpu_torch.visualization import (
        create_subplots_from_dict,
        render_image_dict_from_cameras,
    )

    cams = hair_scene["scene"].get_cameras()
    cfg = RasterConfig(max_tiles_per_gaussian=16, max_pairs_per_tile=2048,
                       chunk=128, use_pallas=True)
    cp.reset_launches()
    t0 = time.perf_counter()
    images = render_image_dict_from_cameras(hair_scene["model"], cams, config=cfg)
    grid = create_subplots_from_dict(images, 1920, 1080)
    t_grid = time.perf_counter() - t0
    print(f"  2D grid of {len(images)} images: shape {grid.shape}, {t_grid:.2f} s, "
          f"launches {dict(cp.launches)}")
    if grid.shape != (1080, 1920, 3) or len(images) != 2 * RENDER_VIEWS \
            or cp.launches["composite_fwd"] != RENDER_VIEWS or not grid.any():
        fail("the 2D grid is wrong")
    return dict(images=len(images), seconds=t_grid)


# phase 14: the parallel paths (parallel/) on the one card. Ranks share the
# card over gloo (NCCL refuses two ranks on one device), so this checks
# correctness and counts collectives; it measures no scaling
P14_TIMEOUT = 300  # seconds for each child process: a hung collective fails
P14_RTOL, P14_ATOL = 1e-3, 1e-5  # step tolerances of tests/test_parallel.py
P14_LOSS_REL = 1e-4
# Adam's first moments (0.1 x the merged gradient): max abs err within
# BWD_GATE x max |ref|, and the step's relative tolerance in L2. The
# kernels' 1e-5 L2 gate does not hold between the slab and the one-table
# steps: the L1 loss's gradient flips sign at a value where the image's
# rounding (the fold's, below 1e-6) crosses the target, and each flip moves
# the colour gradient of every Gaussian under that pixel by its weight x
# 2 / (values in the batch), so a few flips give ~1e-4 in L2 (step 1 counts
# them). A fault of the gradients' scale moves the L2 error by 0.5 or more
P14_MU_REL = P14_RTOL
DRIVER_LOSS_REL = 0.02  # the driver runs' loss at their last sync
P14_SLABS = (2, 4)
# tiles per Gaussian of phase 14's tables: at the bench's 16, view 1 drops 5
# pairs (overflow_pairs) in every render, and a comparison is defined only
# where no render drops any
P14_MAX_TILES = 32
P14_STAGE1 = ["--iterations", "200", "--position_lr_max_steps", "200",
              "--densify_from_iter", "50", "--densification_interval", "100",
              "--densify_until_iter", "150", "--save_frequency", "200",
              "--eval_frequency", "200", "--logger", "none", "--view_batch", "4"]
P14_STAGE3 = ["--iterations", "100", "--position_lr_max_steps", "100",
              "--save_frequency", "100", "--eval_frequency", "100",
              "--view_batch", "2"]


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_concurrently(cmds, env, tmp, timeout=P14_TIMEOUT):
    """Run the commands {name: argv} at once, each in its own session with
    its output in a file; kill a session still running at the timeout.
    Returns {name: (returncode, output)}."""
    import os
    import signal

    procs = {}
    for name, cmd in cmds.items():
        with open(f"{tmp}/{name}.log", "w") as log:
            procs[name] = subprocess.Popen(cmd, env=env, stdout=log,
                                           stderr=subprocess.STDOUT,
                                           start_new_session=True)
    deadline = time.perf_counter() + timeout
    out = {}
    for name, p in procs.items():
        try:
            p.wait(timeout=max(1.0, deadline - time.perf_counter()))
        except subprocess.TimeoutExpired:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()
        with open(f"{tmp}/{name}.log") as f:
            out[name] = (p.returncode, f.read())
    return out


def spawn_ranks(world, case, args, tmp, backend=None):
    """`world` children of this script, one rank each of a process group on
    the card (torchrun's environment, one intra-op thread, P14_TIMEOUT
    each); fail() when any fails. Returns the ranks' results."""
    import os

    out = tempfile.mkdtemp(prefix=f"{case}_", dir=tmp)
    with open(f"{out}/args.json", "w") as f:
        json.dump(dict(args, out=out, backend=backend), f)
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
               WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--rank-case", case, f"{out}/args.json"],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
        for r in range(world)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=P14_TIMEOUT)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            outs.append(p.communicate()[0] + f"\n[killed after {P14_TIMEOUT} s]")
    for q in procs:
        q.wait()
    if any(p.returncode for p in procs):
        for r, o in enumerate(outs):
            print(f"  --- rank {r} of {case} (exit {procs[r].returncode}):\n{o[-3000:]}")
        fail(f"phase 14: a rank of {case} failed")
    return [torch.load(f"{out}/rank{r}.pt") for r in range(world)]


def p14_save_state(scene, cfg, path):
    """The bench scene's initial state, cameras and tables for the ranks."""
    torch.save(dict(
        params=scene.params._asdict(), stats=scene.stats._asdict(),
        mu=scene.opt_state.mu._asdict(), nu=scene.opt_state.nu._asdict(),
        step=scene.opt_state.step, active=scene.active,
        cams=[c._asdict() for c in scene.cams], opt=dataclasses.asdict(scene.opt_cfg),
        raster=dataclasses.asdict(cfg), width=scene.width, height=scene.height), path)


def p14_load_state(path):
    from hairgs_tpu_torch.config import OptimizationConfig
    from hairgs_tpu_torch.core.camera import Camera, stack_cameras
    from hairgs_tpu_torch.models.gaussian import GaussianParams, GaussianStats
    from hairgs_tpu_torch.optim import AdamState
    from hairgs_tpu_torch.render.renderer import RasterConfig

    st = torch.load(path, map_location="cuda")
    state = (GaussianParams(**st["params"]), GaussianStats(**st["stats"]),
             AdamState(GaussianParams(**st["mu"]), GaussianParams(**st["nu"]), st["step"]))
    batch = stack_cameras([Camera(**c) for c in st["cams"]])
    return (state, st["active"], batch, OptimizationConfig(**st["opt"]),
            RasterConfig(**st["raster"]), st["width"], st["height"])


def param_checksum(params):
    """The float bits summed as integers: equal exactly when every bit is,
    but for changes that cancel."""
    return int(torch.stack([p.contiguous().view(torch.int32).to(torch.int64).sum()
                            for p in params]).sum())


def rank_step(a):
    """One rank of phase 14 steps 2-4: the view-parallel (gauss 1) or slab
    Stage-I step from the bench scene's initial state on this rank's views;
    the first step's state (with Adam's first moments, 0.1 x the merged
    gradient) and counts, then 2 + 10 steps timed (the
    collectives counted per step) and 5 more with the collectives timed."""
    from hairgs_tpu_torch.parallel.mesh import (
        make_mesh,
        make_shardmap_gaussian_step,
        shard_view_batch,
    )
    from hairgs_tpu_torch.parallel.slab import make_2d_mesh, make_slab_train_step
    from hairgs_tpu_torch.render import composite_pairs as cp

    (params, stats, opt_state), active, batch, opt, cfg, w, h = p14_load_state(a["state"])
    size = dict(width=w, height=h, active_sh_degree=0)
    if a["gauss"] > 1:
        mesh = make_2d_mesh(a["data"], a["gauss"], device="cuda")
        step = make_slab_train_step("gaussian", opt, cfg, mesh=mesh, **size)
    else:
        mesh = make_mesh(device="cuda")
        step = make_shardmap_gaussian_step(opt, cfg, mesh=mesh, **size)
    local = shard_view_batch(batch, mesh)
    cp.reset_launches()
    mesh.reset_counts()
    p, s, o, m, _ = step(params, stats, opt_state, active, local, 1)
    torch.cuda.synchronize()
    res = dict(params={k: v.cpu() for k, v in p._asdict().items()},
               stats={k: v.cpu() for k, v in s._asdict().items()},
               mu={k: v.cpu() for k, v in o.mu._asdict().items()},
               metrics={k: float(v) for k, v in m.items()}, checksum=param_checksum(p),
               launches=dict(cp.launches), counts=dict(mesh.counts), coords=mesh.coords,
               views=int(local.world_view.shape[0]))

    def steps(n, first):
        nonlocal p, s, o
        for i in range(n):
            p, s, o, _, _ = step(p, s, o, active, local, first + i)

    steps(2, 2)
    torch.cuda.synchronize()
    mesh.reset_counts()
    t0 = time.perf_counter()
    steps(10, 4)
    torch.cuda.synchronize()
    res["step_ms"] = (time.perf_counter() - t0) / 10 * 1e3
    res["per_step"] = {op: (c / 10, b / 10) for op, (c, b) in mesh.counts.items()}
    mesh.timing = True
    mesh.reset_counts()
    t0 = time.perf_counter()
    steps(5, 14)
    res["timed_step_ms"] = (time.perf_counter() - t0) / 5 * 1e3
    res["collective_ms"] = mesh.ms / 5
    return res


def rank_checkpoint(a):
    """Phase 14 step 6: each rank saves half of the bench model's arenas
    (parameters and Adam moments) and the replicated Adam step counter,
    then reloads into a fresh template; returns whether it is bit-equal."""
    import torch.distributed as dist

    from hairgs_tpu_torch.parallel.multihost import (
        RowShard,
        load_sharded_state,
        save_sharded_state,
    )

    (params, _, opt_state), *_ = p14_load_state(a["state"])
    rank, world = dist.get_rank(), dist.get_world_size()
    n = params.xyz.shape[0]
    half = n // world
    lo = rank * half

    def tree(fill):
        return {group: {k: RowShard(tuple(v.shape), lo, fill(v[lo:lo + half]))
                        for k, v in t._asdict().items()}
                for group, t in (("params", params), ("mu", opt_state.mu),
                                 ("nu", opt_state.nu))} | {
            "adam_step": fill(opt_state.step.reshape(1))}

    state = tree(lambda t: t)
    d = a["dir"]
    save_sharded_state(d, state, step=7)
    dist.barrier()
    loaded, step = load_sharded_state(d, tree(torch.zeros_like))
    equal = all(torch.equal(x.block, y.block)
                for g in ("params", "mu", "nu")
                for x, y in zip(state[g].values(), loaded[g].values()))
    equal = equal and torch.equal(state["adam_step"], loaded["adam_step"])
    import os

    return dict(equal=equal, step=step, files=sorted(os.listdir(d)),
                bytes=os.path.getsize(f"{d}/shard_{rank}.npz"))


RANK_CASES = {"step": rank_step, "checkpoint": rank_checkpoint}


def rank_main(case, args_path):
    """A child of phase 14: one rank, run by spawn_ranks."""
    import torch.distributed as dist

    from hairgs_tpu_torch.parallel.mesh import init_distributed

    torch.set_num_threads(1)
    with open(args_path) as f:
        a = json.load(f)
    init_distributed("cuda", a["backend"])
    result = RANK_CASES[case](a)
    torch.save(result, f"{a['out']}/rank{dist.get_rank()}.pt")
    dist.destroy_process_group()


def depth_tie_tiles(cam, inputs, active, cfg, width, height):
    """Tiles of one view holding two pairs with equal [tile | quantized
    depth] keys: where the unsharded order falls back to the row index."""
    from hairgs_tpu_torch.render.binning import _expand_pairs, _quantize_depth
    from hairgs_tpu_torch.render.preprocess import preprocess

    ts = cfg.tile_size
    grid_w, grid_h = (width + ts - 1) // ts, (height + ts - 1) // ts
    num_tiles = grid_w * grid_h
    prep = preprocess(inputs["means3d"], inputs["scales"], inputs["rotations"], cam,
                      width, height, ts, active=active, opacity=inputs["opacity"],
                      alpha_min=cfg.alpha_min)
    opa = torch.where(prep.valid, inputs["opacity"], torch.zeros_like(inputs["opacity"]))
    q_cut = torch.log(torch.clamp(opa, min=1e-12) / cfg.alpha_min)
    dq, levels = _quantize_depth(prep.depth, num_tiles)
    tile, _ = _expand_pairs(prep.rect, prep.valid, grid_w, grid_h,
                            cfg.max_tiles_per_gaussian, xy=prep.xy, conic=prep.conic,
                            q_cut=q_cut, tile_size=ts)
    key = (tile.long() * (levels + 1) + dq[:, None].long()).reshape(-1)
    key = torch.sort(key[tile.reshape(-1) < num_tiles]).values
    dup = key[1:] == key[:-1]
    return int(torch.unique(torch.div(key[1:][dup], levels + 1,
                                      rounding_mode="floor")).numel())


def slab_render_check(scene, cfg):
    """Phase 14, step 1: render_gauss_sharded at k = 2 and 4 on every bench
    view against one render of the depth-permuted rows (the same
    compositing order): image and T within FWD_GATE, radii equal, no
    overflow; the gradients of view 0 through the fold within the kernel
    gates. The difference from the original-order render and the tiles
    with quantized-depth ties are printed, not gated."""
    from hairgs_tpu_torch.models.gaussian import GaussianParams, gaussian_render_inputs
    from hairgs_tpu_torch.parallel.slab import _depth_slab_permutation, render_gauss_sharded
    from hairgs_tpu_torch.render import composite_pairs as cp
    from hairgs_tpu_torch.render.renderer import render

    size = dict(width=scene.width, height=scene.height, config=cfg)
    over = ("overflow_pairs", "overflow_tiles", "overflow_capacity")
    worst = {k: [0.0, 0.0, 0.0] for k in P14_SLABS}  # image, T, original order
    low_t, ties = [], []
    flips = {k: [] for k in P14_SLABS}  # per view: values whose L1 sign flips
    cp.reset_launches()
    with torch.no_grad():
        for v, cam in enumerate(scene.cams):
            inputs = gaussian_render_inputs(scene.params, cam.cam_center, 0)
            perm, _ = _depth_slab_permutation(inputs["means3d"], scene.active,
                                              cam.world_view)
            ref = render(cam, **{k: x[perm] for k, x in inputs.items()},
                         active=scene.active[perm], **size)
            orig = render(cam, **inputs, active=scene.active, **size)
            low_t.append(int((ref["final_T"] < 0.01).sum()))
            ties.append(depth_tie_tiles(cam, inputs, scene.active, cfg,
                                        scene.width, scene.height))
            for k in P14_SLABS:
                got = render_gauss_sharded(cam, **inputs, active=scene.active,
                                           num_slabs=k, **size)
                if any(int(r[key]) for r in (got, ref) for key in over):
                    fail(f"phase 14 step 1: an overflow in view {v}: slabs (k={k}) "
                         f"{ {key: int(got[key]) for key in over} }, one table "
                         f"{ {key: int(ref[key]) for key in over} }")
                if not torch.equal(got["radii"], orig["radii"]):
                    fail(f"phase 14 step 1: radii differ at k={k}")
                errs = ((got["render"] - ref["render"]).abs().max().item(),
                        (got["final_T"] - ref["final_T"]).abs().max().item(),
                        (got["render"] - orig["render"]).abs().max().item())
                worst[k] = [max(a, b) for a, b in zip(worst[k], errs)]
                flips[k].append(int(((got["render"][..., :3] - cam.image).sign()
                                     != (ref["render"][..., :3] - cam.image).sign()).sum()))
    fwd_launches = dict(cp.launches)
    # gradients through the fold, view 0, against the permuted render
    cam = scene.cams[0]
    target = torch.rand((scene.height, scene.width, 7), device=cam.world_view.device,
                        generator=torch.Generator(cam.world_view.device).manual_seed(5))

    def grads(fn):
        p = GaussianParams(*[t.detach().requires_grad_(True) for t in scene.params])
        img = fn(gaussian_render_inputs(p, cam.cam_center, 0))["render"]
        torch.mean((img - target) ** 2).backward()
        return [t.grad for t in p]

    def permuted(inputs):
        perm, _ = _depth_slab_permutation(inputs["means3d"], scene.active, cam.world_view)
        return render(cam, **{k: x[perm] for k, x in inputs.items()},
                      active=scene.active[perm], **size)

    g_ref = grads(permuted)
    cp.reset_launches()
    grad_err = {}
    for k in P14_SLABS:
        g_k = grads(lambda inputs: render_gauss_sharded(
            cam, **inputs, active=scene.active, num_slabs=k, **size))
        errs = [grad_gate(a, b) for a, b in zip(g_k, g_ref) if b.numel()]
        grad_err[k] = (max(e[1] for e in errs), max(e[2] for e in errs))  # abs, L2
        if not all(e[0] for e in errs):
            fail(f"phase 14 step 1: gradients at k={k} outside the kernel gates {errs}")
    bwd_launches = dict(cp.launches)
    for k in P14_SLABS:
        print(f"  slab render k={k} (4 views): image max abs err {worst[k][0]:.3e}, "
              f"T {worst[k][1]:.3e} against the permuted render; against the "
              f"original order {worst[k][2]:.3e} (not gated); view-0 gradients "
              f"max abs err {grad_err[k][0]:.3e}, relative L2 {grad_err[k][1]:.3e}")
    print(f"  tiles with a quantized-depth tie per view {ties} of "
          f"{((scene.width + 15) // 16) * ((scene.height + 15) // 16)}; pixels with T "
          f"< 0.01 (where a slab's stop test can differ) {low_t}; values whose L1 "
          f"sign against the view's image flips, per view {flips}; launches: forward "
          f"pass {fwd_launches}, gradients {bwd_launches}")
    if any(max(w[:2]) > FWD_GATE for w in worst.values()):
        fail(f"phase 14 step 1: slab render outside {FWD_GATE}: {worst}")
    if fwd_launches["composite_fwd"] == 0 or bwd_launches["composite_bwd"] == 0:
        fail(f"phase 14 step 1: the kernels did not run: {fwd_launches} {bwd_launches}")
    return dict(image_err={k: w[0] for k, w in worst.items()},
                t_err={k: w[1] for k, w in worst.items()},
                original_order_err={k: w[2] for k, w in worst.items()},
                grad_err=grad_err, tie_tiles=ties, low_t_pixels=low_t, l1_flips=flips,
                launches=dict(fwd=fwd_launches, grads=bwd_launches))


def p14_gate(what, ranks, ref, fold_ref=None):
    """Each rank's first step against the oracle `ref` = (params, stats,
    metrics, Adam first moments): the loss; the first moments, 0.1 x the
    merged gradient, within BWD_GATE x max|ref| and P14_MU_REL in L2, which
    a fault in the gradients' scale or merge fails (one Adam step moves a
    parameter by about lr x sign(g) and hides it); every parameter and
    statistic at rtol
    P14_RTOL, atol P14_ATOL, against `fold_ref` when given; and the ranks'
    parameters bit-equal to each other. Returns the first moments' worst
    (max abs err, max |ref|, relative L2) of each plane over the ranks."""
    p_ref, s_ref, m_ref, mu_ref = ref
    if fold_ref is not None:
        p_ref, s_ref = fold_ref[:2]
    loss_ref = float(m_ref["loss"])
    mu_err = {}
    for r, res in enumerate(ranks):
        if abs(res["metrics"]["loss"] - loss_ref) > P14_LOSS_REL * abs(loss_ref):
            fail(f"phase 14 {what}: rank {r} loss {res['metrics']['loss']} against "
                 f"{loss_ref}")
        for group, tree in (("params", p_ref), ("stats", s_ref)):
            for name, want in tree._asdict().items():
                got, want = res[group][name], want.cpu()
                bad = (got - want).abs() > P14_ATOL + P14_RTOL * want.abs()
                if bad.any():
                    fail(f"phase 14 {what}: rank {r} {group}/{name}: {int(bad.sum())} "
                         f"entries outside rtol {P14_RTOL} atol {P14_ATOL}, largest "
                         f"{(got - want).abs().max().item():.3e}")
        for name, want in mu_ref._asdict().items():
            if not want.numel():
                continue
            got, want = res["mu"][name], want.cpu()
            err = (got - want).abs().max().item()
            rel = ((got - want).norm() / want.norm().clamp(min=1e-30)).item()
            if not (torch.isfinite(got).all() and rel < P14_MU_REL
                    and err < BWD_GATE * max(want.abs().max().item(), 1e-12)):
                fail(f"phase 14 {what}: rank {r} first moment of {name}: max abs err "
                     f"{err:.3e} (gate {BWD_GATE} x max |ref| "
                     f"{want.abs().max().item():.3e}), relative L2 {rel:.3e} (gate "
                     f"{P14_MU_REL})")
            worst = mu_err.get(name, (0.0, 0.0, 0.0))
            mu_err[name] = (max(worst[0], err), want.abs().max().item(),
                            max(worst[2], rel))
        if res["launches"]["composite_fwd"] == 0 or res["launches"]["composite_bwd"] == 0:
            fail(f"phase 14 {what}: rank {r} launched no kernel: {res['launches']}")
    if len({res["checksum"] for res in ranks}) != 1 or not all(
            torch.equal(ranks[0]["params"][k], res["params"][k])
            for res in ranks[1:] for k in ranks[0]["params"]):
        fail(f"phase 14 {what}: the ranks' parameters differ")
    print(f"  {what}: gated; first moments (max abs err, max |ref|, relative L2) "
          f"{ {k: tuple(float(f'{x:.3e}') for x in v) for k, v in mu_err.items()} }")
    return mu_err


def p14_report(what, ranks):
    per = ranks[0]["per_step"]
    calls = sum(c for c, _ in per.values())
    nbytes = sum(b for _, b in per.values())
    print(f"  {what}: step ms per rank {[round(r['step_ms'], 3) for r in ranks]} "
          f"(10 steps after 2); per step per rank {calls:g} collective calls, "
          f"{nbytes / 1e6:.3f} MB ({ {op: (c, round(b / 1e6, 3)) for op, (c, b) in per.items()} }), "
          f"{[round(r['collective_ms'], 3) for r in ranks]} ms inside them (timed "
          f"steps {[round(r['timed_step_ms'], 3) for r in ranks]} ms); launches of "
          f"the first step {ranks[0]['launches']}")
    return dict(step_ms=[r["step_ms"] for r in ranks], calls=calls, bytes=nbytes,
                by_op=per, collective_ms=[r["collective_ms"] for r in ranks],
                timed_step_ms=[r["timed_step_ms"] for r in ranks],
                launches=ranks[0]["launches"])


def parse_driver(out):
    """What a driver run prints: the loss at each report, the count after
    each topology event, the per-rank launches, the replica checks. The
    ranks' lines may interleave, even within a line, so each record is
    matched on its own."""
    import ast

    losses = {int(m.group(1)): float(m.group(2))
              for m in re.finditer(r"iter\s+(\d+)\s+loss ([-+.\deE]+)", out)}
    events = [(int(m.group(1)), int(m.group(2)))
              for m in re.finditer(r"\[densify\] iter (\d+): \{[^{}]*\} -> (\d+) ", out)]
    launches = {int(m.group(1)): ast.literal_eval(m.group(2))
                for m in re.finditer(r"\[kernels\] rank (\d+) launches (\{[^{}]*\})", out)}
    checks = [(int(m.group(1)), int(m.group(2)))
              for m in re.finditer(r"iter (\d+): parameters bit-equal on \d+ ranks "
                                   r"\(checksum (-?\d+)\)", out)]
    its = re.search(r"Training completed in (\S+)s \((\S+) it/s", out)
    return dict(losses=losses, events=events, launches=launches, checks=checks,
                seconds=float(its.group(1)), it_s=float(its.group(2)))


def slab_oracle_driver(k, argv):
    """The one-process oracle of the `--gauss_shard k` runs: the train
    driver with each step's render replaced by render_gauss_sharded with k
    slabs in turn on the card, which has the ranks' compositing order and
    fold (the unsharded order differs at depth ties, and densification
    reads the gradients it gives)."""
    import functools

    from hairgs_tpu_torch.drivers import train as driver
    from hairgs_tpu_torch.parallel.slab import render_gauss_sharded
    from hairgs_tpu_torch.train import trainer

    trainer.make_gaussian_train_step = functools.partial(
        trainer.make_gaussian_train_step,
        render_fn=functools.partial(render_gauss_sharded, num_slabs=k))
    driver.main(argv)


def driver_cmd(argv, ranks, slabs=0):
    """drivers/train.py under torchrun (`ranks` > 1), alone, or alone with
    `slabs` slabs in turn (slab_oracle_driver)."""
    cmd = [sys.executable]
    if ranks > 1:
        cmd += ["-m", "torch.distributed.run", "--nnodes", "1", "--nproc_per_node",
                str(ranks), "--master_addr", "127.0.0.1", "--master_port",
                str(free_port())]
    if slabs:
        return cmd + [__file__, "--slab-oracle", str(slabs), *argv]
    return cmd + ["-m", "hairgs_tpu_torch.drivers.train", *argv]


def driver_runs(cmds, tmp):
    """The driver commands {name: argv} at once; fail() on a non-zero exit.
    Returns {name: parse_driver's dict}."""
    import os

    outs = run_concurrently(cmds, dict(os.environ, OMP_NUM_THREADS="1"), tmp)
    for name, (rc, out) in outs.items():
        if rc:
            print(out[-6000:])
            fail(f"phase 14: the driver run {name} failed ({rc})")
    return {name: parse_driver(out) for name, (_, out) in outs.items()}


def driver_compare(what, one, two, n_ranks):
    """The n-rank run against the one-process run: every rank checked the
    replicas bit-equal after every topology event and at the end, every
    rank's counts after the events equal the one-process run's, the loss at
    the last report within DRIVER_LOSS_REL, every rank's kernels ran. The
    ranks' lines interleave in any order, so they are counted, not read in
    order."""
    from collections import Counter

    events = Counter(two["events"])
    if sorted(events) != sorted(one["events"]) or set(events.values()) != {n_ranks}:
        fail(f"phase 14 {what}: counts after the events {two['events']} against "
             f"{one['events']}")
    checks = {}
    for it, checksum in two["checks"]:
        checks.setdefault(it, []).append(checksum)
    want = {it for it, _ in one["events"]} | {max(one["losses"])}
    # an event at the last iteration is checked twice
    if set(checks) != want or any(len(v) % n_ranks or len(set(v)) != 1
                                  for v in checks.values()):
        fail(f"phase 14 {what}: replica checks {checks}, expected at {sorted(want)}")
    last = max(one["losses"])
    if abs(two["losses"][last] - one["losses"][last]) > DRIVER_LOSS_REL * abs(
            one["losses"][last]):
        fail(f"phase 14 {what}: loss at {last} {two['losses'][last]} against "
             f"{one['losses'][last]}")
    for r in range(n_ranks):
        got = two["launches"].get(r, {})
        if not got.get("composite_fwd") or not got.get("composite_bwd"):
            fail(f"phase 14 {what}: rank {r} launched no kernel: {got}")
    print(f"  {what}: {n_ranks} ranks {two['it_s']:.3f} it/s ({two['seconds']:.1f} s; "
          f"one process {one['it_s']:.3f} it/s, the runs sharing the card); loss at {last} "
          f"{two['losses'][last]:.5f} against {one['losses'][last]:.5f}; counts after "
          f"the events {one['events']}; replicas bit-equal at {sorted(checks)}; "
          f"launches per rank {two['launches']}")
    return dict(it_s=two["it_s"], one_it_s=one["it_s"], loss=two["losses"][last],
                one_loss=one["losses"][last], events=one["events"],
                checks=sorted(checks), launches=two["launches"])


def parallel_steps(scene, cfg, tmp):
    """Phase 14, steps 2-4 and 6: the parallel Stage-I steps in child
    ranks against one process, and the sharded checkpoint."""
    import functools

    from hairgs_tpu_torch.parallel.mesh import build_mesh
    from hairgs_tpu_torch.parallel.slab import make_slab_train_step, render_gauss_sharded
    from hairgs_tpu_torch.train.trainer import make_gaussian_train_step

    res = {}
    state_path = f"{tmp}/p14_state.pt"
    p14_save_state(scene, cfg, state_path)
    state, active, batch, opt, rcfg, w, h = p14_load_state(state_path)
    size = dict(width=w, height=h, active_sh_degree=0)

    def oracle(step):
        p, s, o, m, _ = step(*state, active, batch, 1)
        torch.cuda.synchronize()
        return p, s, m, o.mu

    plain = oracle(make_gaussian_train_step(opt, rcfg, device="cuda", **size))
    # the slab steps' oracle: the 1 x 1 slab step, one table of the
    # depth-permuted rows (their compositing order, no fold), for the loss
    # and the gradients. Two things differ with the fold, so the parameters
    # and statistics are held to one process rendering the same 2 slabs in
    # turn (the fold's arithmetic), and their difference from the 1 x 1
    # step is printed: after Adam's first step a parameter moves by
    # lr x g / (|g| + 1e-15), so where |g| is near 1e-15 a rounding of g
    # moves it by up to lr; and the viewspace gradients of the statistics
    # leave out the transmittance cotangent (the compositor's photometric
    # rows start at 0), which a slab's T receives from the slabs behind it
    # (a property of the reference, ROADMAP Queue 3)
    slab1 = oracle(make_slab_train_step("gaussian", opt, rcfg,
                                        mesh=build_mesh([[0]], device="cuda"), **size))
    slab2 = oracle(make_gaussian_train_step(
        opt, rcfg, device="cuda", **size,
        render_fn=functools.partial(render_gauss_sharded, num_slabs=2)))
    # what the fold alone moves, in one process
    fold_mu = {k: ((a - b).norm() / b.norm().clamp(min=1e-30)).item()
               for (k, a), b in zip(slab2[3]._asdict().items(), slab1[3]) if b.numel()}
    print(f"  one process, 2 slabs in turn against the 1 x 1 slab step: first moments "
          f"relative L2 { {k: f'{v:.3e}' for k, v in fold_mu.items()} }")
    res["fold_mu_rel"] = fold_mu
    args = dict(state=state_path)
    view = spawn_ranks(2, "step", dict(args, data=2, gauss=1), tmp)
    what = "view-parallel step, 2 gloo ranks x 2 views"
    mu_err = p14_gate(what, view, plain)
    res["view_step"] = dict(p14_report(what, view), mu_err=mu_err)
    for data, gauss in ((1, 2), (2, 2)):
        what = f"slab step ({data} x {gauss}, {data * gauss} gloo ranks)"
        ranks = spawn_ranks(data * gauss, "step", dict(args, data=data, gauss=gauss), tmp)
        mu_err = p14_gate(what, ranks, slab1, fold_ref=slab2)
        rep = dict(p14_report(what, ranks), mu_err=mu_err)
        gathers = ranks[0]["counts"].get("all_gather", (0, 0))
        rep["gather_mb_per_view"] = gathers[1] / max(gathers[0], 1) / 1e6
        for name, ref in (("slab1", slab1), ("plain", plain)):
            diff = {}
            for k, v in ref[0]._asdict().items():
                if not v.numel():
                    continue
                d = (ranks[0]["params"][k] - v.cpu()).abs()
                at = int(d.argmax())
                diff[k] = (d.max().item(), int((d > P14_ATOL + P14_RTOL
                                                 * v.cpu().abs()).sum()),
                           10 * abs(ref[3]._asdict()[k].reshape(-1)[at].item()))
            rep[f"{name}_diff"] = diff
            rep[f"{name}_stats_diff"] = {
                k: ((ranks[0]["stats"][k] - v.cpu()).abs().max().item(),
                    int(((ranks[0]["stats"][k] - v.cpu()).abs()
                         > P14_ATOL + P14_RTOL * v.cpu().abs()).sum()),
                    ((ranks[0]["stats"][k] - v.cpu()).norm()
                     / v.cpu().norm().clamp(min=1e-30)).item())
                for k, v in ref[1]._asdict().items()}
        print(f"    gathers of the first step {gathers} ({rep['gather_mb_per_view']:.3f} "
              f"MB per view per rank); not gated, (largest parameter difference, "
              f"entries outside the step gate, the oracle's |g| there) from the "
              f"1 x 1 slab step {rep['slab1_diff']} and from the plain unsharded "
              f"step {rep['plain_diff']}; (largest statistic difference, entries "
              f"outside, relative L2) from the 1 x 1 slab step "
              f"{rep['slab1_stats_diff']} and from the plain step "
              f"{rep['plain_stats_diff']}")
        res[f"slab_step_{data}x{gauss}"] = rep
    nccl = spawn_ranks(1, "step", dict(args, data=1, gauss=1), tmp, backend="nccl")
    what = "NCCL view step, world size 1"
    mu_err = p14_gate(what, nccl, plain)
    res["nccl_step"] = dict(p14_report(what, nccl), mu_err=mu_err)

    ckpt = spawn_ranks(2, "checkpoint", dict(args, dir=f"{tmp}/p14_ckpt"), tmp)
    if not all(r["equal"] for r in ckpt) or ckpt[0]["files"] != [
            "manifest.json", "shard_0.npz", "shard_1.npz"]:
        fail(f"phase 14 step 6: the sharded checkpoint is not bit-equal: {ckpt}")
    print(f"  sharded checkpoint: 2 ranks, bit-equal on reload; files "
          f"{ckpt[0]['files']}, {[r['bytes'] for r in ckpt]} bytes per shard")
    res["checkpoint"] = dict(bytes=[r["bytes"] for r in ckpt])
    return res


def parallel_drivers(tmp, merged_dir):
    """Phase 14, step 5: the train driver under torchrun against one
    process, on phase 11's capture (Stage I) and phase 12's merged model
    (Stage III)."""
    res = {}
    scene_dir = f"{tmp}/scene"
    # the runs share the card and the host's cores at once: their it/s are
    # printed but compare nothing
    runs = driver_runs({name: driver_cmd(
        ["-s", scene_dir, "-m", f"{tmp}/p14_{name}", *P14_STAGE1, *extra, "--ip", ""],
        ranks, slabs) for name, ranks, slabs, extra in (
            ("one", 1, 0, ()), ("one_slabs", 1, 2, ()), ("view", 2, 0, ()),
            ("slab", 2, 0, ("--gauss_shard", "2")))}, tmp)
    res["driver_view"] = driver_compare("Stage-I driver, --view_batch 4", runs["one"],
                                        runs["view"], 2)
    res["driver_slab"] = driver_compare("Stage-I driver, --gauss_shard 2 (against "
                                        "one process, 2 slabs in turn)",
                                        runs["one_slabs"], runs["slab"], 2)
    last = max(runs["one"]["losses"])
    res["driver_slab"]["unsharded"] = dict(events=runs["one"]["events"],
                                           loss=runs["one"]["losses"][last])
    # the loss is also held to the unsharded one-process run; the counts
    # after densification are not (its order at depth ties and the slab
    # statistics, ROADMAP Queue 3, keep other Gaussians)
    got, want = runs["slab"]["losses"][last], runs["one"]["losses"][last]
    if abs(got - want) > DRIVER_LOSS_REL * abs(want):
        fail(f"phase 14: the --gauss_shard 2 run's loss at {last} {got} against the "
             f"unsharded run's {want}")
    print(f"    against the unsharded one-process run: loss at {last} {got:.5f} "
          f"against {want:.5f} (gated); counts after the events (not gated) "
          f"{runs['slab']['events'][:1]} against {runs['one']['events']}; one process "
          f"with 2 slabs: loss {runs['one_slabs']['losses'][last]:.5f}")
    for name in ("one", "two"):
        shutil.copytree(merged_dir, f"{tmp}/p14_hair_{name}")
    runs.update(driver_runs({f"hair_{name}": driver_cmd(
        ["-s", scene_dir, "-m", f"{tmp}/p14_hair_{name}", *STAGE3_FLAGS, *P14_STAGE3,
         "--ip", ""], ranks) for name, ranks in (("one", 1), ("two", 2))}, tmp))
    res["driver_hair"] = driver_compare("Stage-III driver, --view_batch 2",
                                        runs["hair_one"], runs["hair_two"], 2)
    return res


def parallel_paths(scene, cfg, tmp, merged_dir, final_ply):
    """Phase 14: the parallel paths on the one card (steps 1-6 of the
    module docstring, and convert_output on phase 12's final PLY)."""
    import os

    from hairgs_tpu_torch.drivers import convert_output

    cfg = dataclasses.replace(cfg, max_tiles_per_gaussian=P14_MAX_TILES)
    seconds = {}
    t0 = time.perf_counter()
    res = {"slab_render": slab_render_check(scene, cfg)}
    seconds["slab_render"] = time.perf_counter() - t0
    res.update(parallel_steps(scene, cfg, tmp))
    seconds["steps"] = time.perf_counter() - t0 - sum(seconds.values())
    res.update(parallel_drivers(tmp, merged_dir))
    seconds["drivers"] = time.perf_counter() - t0 - sum(seconds.values())
    res["seconds"] = seconds
    print(f"  seconds: {seconds}")
    out = convert_output.main(["-i", final_ply, "-t", "gs", "--edges",
                               "-o", f"{tmp}/p14_strands.ply"])
    with open(out, "rb") as f:
        header = f.read(400).decode("ascii", "ignore")
    if "element edge" not in header:
        fail(f"convert_output wrote no edge PLY: {header[:200]}")
    print(f"  convert_output: {os.path.getsize(out)} bytes from {final_ply}")
    return res


# phase 15: the reference pipeline (scripts/run_reference_schedule.sh) on its
# seed-0 scene, through drivers/pipeline.py, each stage a child process
P15_COMMON = ["--max_tiles_per_gaussian", "64", "--capacity_round", "65536",
              "--eval_frequency", "10000"]  # run_reference_schedule.sh:29
P15_FULL = 30000  # the reference schedule's Stage I (iterations' default)
# this script's Stage I: the first 5000 iterations of the same schedule,
# since the whole of it does not fit the script's time limit beside phases
# 1-14 and phase 16 (PERF.md §4); `--phase15 30000` runs it whole, with the
# gates
P15_STAGE1 = 5000
P15_STAGE3 = 1000  # Stage III's first iterations, every cadence at its default
P15_STRETCH = 3000  # it/s per stretch of one opacity-reset interval
P15_VIEWS = 16
P15_SEGMENTS = 150 * 23
# the JAX package's chain on this scene (TPU v5e; quality only): after the
# merge, BASELINE.md:340 (round 5); Stage I at 30 000, BASELINE.md:40;
# Stage III's first 1000 iterations, BASELINE.md:42 (round-2 code)
JAX_MERGED = {"precision(b)": 0.4380, "recall(b)": 0.6159, "f1(b)": 0.5120,
              "strands": 48044}
JAX_STAGE1_PSNR = 21.57
JAX_III_1K = {"f1(b)": 0.393, "recall(b)": 0.799}
# Stage II.5 on the merged model, BASELINE.md:341 (round 5; round 4 from
# an older checkpoint, :231-236: f1 0.5310, consistency +0.061)
JAX_GROWN = {"f1(b)": 0.5359, "strand_consistency(b)": 0.2354}
# the gates at the full Stage I: five times the spread of the two JAX chains
# on this scene (BASELINE.md:40-41 against :340: 0.006 in F1, 2.7% in strands)
P15_GATES = {"f1(b)": 0.03, "precision(b)": 0.04, "recall(b)": 0.04}
P15_STRANDS_REL = 0.15
P15_PSNR_MIN = JAX_STAGE1_PSNR - 0.5
# Stage II.5 against JAX's on this scene (round 5 0.5359, round 4 0.5310;
# strand consistency gains 0.063 and 0.061): F1 within about five times
# that spread, the consistency gain at least half JAX's, and growth may
# not cost F1
P15_GROW_F1 = (0.506, 0.566)
P15_GROW_SC_GAIN = 0.03
P15_GROW_F1_DROP = 0.005
STAMP = re.compile(r" \[\d\d/\d\d \d\d:\d\d:\d\d\]$")  # safe_state's suffix


class Stamped:
    """`cmd` started from the repo root in its own session, its output read
    line by line on a thread into `log` and into a list of (host clock,
    line without safe_state's time stamp). The session is killed at the
    timeout, and at exit if it still runs (a fail() elsewhere)."""

    def __init__(self, cmd, log, timeout):
        import atexit
        import os
        import threading

        self.cmd, self.lines, self.killed = cmd, [], False
        self.t0 = time.perf_counter()
        self.p = subprocess.Popen(cmd, env=dict(os.environ, PYTHONUNBUFFERED="1"),
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True, start_new_session=True,
                                  cwd=os.path.dirname(os.path.abspath(__file__)))
        self.reader = threading.Thread(target=self._read, args=(log,), daemon=True)
        self.reader.start()
        self.timer = threading.Timer(timeout, self._kill, args=(True,))
        self.timer.daemon = True
        self.timer.start()
        atexit.register(self._kill)

    def _read(self, log):
        with open(log, "w") as f:
            for line in self.p.stdout:
                f.write(line)
                f.flush()
                self.lines.append((time.perf_counter(),
                                   STAMP.sub("", line.rstrip("\n"))))

    def _kill(self, timed_out=False):
        import os
        import signal

        if self.p.poll() is None:
            self.killed |= timed_out
            os.killpg(self.p.pid, signal.SIGKILL)

    def pause(self, pause=True):
        """Stop (or continue) the session, so that a timing elsewhere has
        the card to itself."""
        import os
        import signal

        if self.p.poll() is None:
            os.killpg(self.p.pid, signal.SIGSTOP if pause else signal.SIGCONT)
            time.sleep(1.0 if pause else 0.0)  # its queued kernels drain

    def wait(self):
        """(exit code, or None when killed at the timeout, lines)."""
        self.reader.join()
        self.p.wait()
        self.timer.cancel()
        self.seconds = time.perf_counter() - self.t0
        return (None if self.killed else self.p.returncode), self.lines


def run_stamped(cmd, log, timeout):
    return Stamped(cmd, log, timeout).wait()


def wait_pipeline(run, name, tag, may_stop=False):
    """Wait for a pipeline run and return its sections; fail() on a
    non-zero exit unless `may_stop` (a run cut at its timeout)."""
    rc, lines = run.wait()
    print(f"  [{name}] {'sh -c ...' if run.cmd[0] == 'sh' else ' '.join(run.cmd[3:])}: "
          f"exit {rc} after {run.seconds:.1f} s")
    if rc != 0 and not may_stop:
        print("\n".join(line for _, line in lines[-40:]))
        fail(f"{tag}: the pipeline run {name} failed ({rc})")
    return pipeline_sections(lines)


def literal(text):
    """A printed dict of numbers, numpy scalars' reprs included."""
    import ast

    return ast.literal_eval(re.sub(r"np\.\w+\(([^()]*)\)", r"\1", text))


def pipeline_sections(lines):
    """The pipeline's output cut at its '=== title ===' lines: {stage:
    [(t, line)]}, the scene's stage named 'scene'."""
    from hairgs_tpu_torch.drivers.pipeline import TITLES

    names = {f"=== {t} ===": s for s, t in TITLES.items()}
    out, cur = {}, None
    for t, line in lines:
        if line.startswith("=== Generating"):
            cur = "scene"
        elif line in names:
            cur = names[line]
        if cur is not None:
            out.setdefault(cur, []).append((t, line))
    return out


def metric_table(lines):
    """(metrics {name: [value per threshold]}, thresholds) of the last table
    printed by format_metric_table."""
    metrics, ths = {}, None
    for _, line in lines:
        if "m&" in line and line.startswith(" "):
            ths, metrics = line.split(), {}
        elif ths and (m := re.match(r"^(\S+\(b\)|\S+)\s+((?:-?[\d.]+\s*){%d})$" % len(ths),
                                    line)):
            metrics[m.group(1)] = [float(x) for x in m.group(2).split()]
    return metrics, ths


def parse_train(sec):
    """A train stage's printed record: events, resets, progress points,
    evaluations, overflow warnings, controller changes, launches, it/s."""
    r = dict(events=[], resets=[], progress=[], evals={}, images={}, warns=[],
             raster=[], launches=None, completed=None, start=None)
    for t, line in sec:
        if (m := re.match(r"^\[densify\] iter (\d+): (\{.*\}) -> (\d+) (\w+)"
                          r"(?:, (\d+) strands)? in ([\d.]+) ms$", line)):
            r["events"].append(dict(it=int(m.group(1)), info=literal(m.group(2)),
                                    size=int(m.group(3)), strands=m.group(5) and
                                    int(m.group(5)), ms=float(m.group(6))))
        elif (m := re.match(r"^\[densify\] iter (\d+): opacity reset$", line)):
            r["resets"].append(int(m.group(1)))
        elif (m := re.match(r"^iter\s+(\d+)\s+loss ([\d.]+)\s+psnr ([-\d.]+)\s+prims (\d+)",
                            line)):
            r["progress"].append((int(m.group(1)), t, float(m.group(2)), int(m.group(4))))
        elif (m := re.match(r"^\[eval\] iter (\d+): (\d+) (\w+)(?:, (\d+) strands)?; "
                            r"strands at (\S+) \((\w+)\): (.*)$", line)):
            vals = dict(zip(m.group(7).split()[::2], map(float, m.group(7).split()[1::2])))
            r["evals"][int(m.group(1))] = dict(size=int(m.group(2)), unit=m.group(3),
                                               strands=m.group(4) and int(m.group(4)),
                                               on=m.group(6), **vals)
        elif (m := re.match(r"^\[eval\] iter (\d+): (psnr .*)$", line)):
            p = m.group(2).split()
            r["images"][int(m.group(1))] = dict(zip(p[::2], map(float, p[1::2])))
        elif (m := re.match(r"^\[warn\] iter (\d+): \d+ binning overflows \((\d+) "
                            r"pair-budget, (\d+) tile-cap, (\d+) capacity\)", line)):
            r["warns"].append(tuple(int(g) for g in m.groups()))
        elif (m := re.match(r"^\[raster\] iter (\d+): (.*)$", line)):
            r["raster"].append((int(m.group(1)), m.group(2)))
        elif (m := re.match(r"^\[kernels\] rank 0 launches (\{.*\})$", line)):
            r["launches"] = literal(m.group(1))
        elif (m := re.match(r"^Training completed in ([\d.]+)s \(([\d.]+) it/s", line)):
            r["completed"] = (float(m.group(1)), float(m.group(2)))
        elif (m := re.match(r"^Loaded (\w+) from PLY at iteration (\d+)", line)):
            r["start"] = int(m.group(2))
    return r


def stretch_rates(progress, stretch):
    """it/s over each stretch of `stretch` iterations, from the host clock
    of the progress lines (one per 100 iterations, each after a sync)."""
    out = []
    pts = {it: t for it, t, _, _ in progress}
    its = sorted(pts)
    for lo in range(0, its[-1] if its else 0, stretch):
        a = min((i for i in its if i >= max(lo, its[0])), default=None)
        b = max((i for i in its if i <= lo + stretch), default=None)
        if a is not None and b is not None and b > a:
            out.append((a, b, (b - a) / (pts[b] - pts[a])))
    return out


def report_train(what, r, n_steps, views, evals_expected, full_window, tag="phase 15"):
    """Print a train stage's record and fail() on a broken one; returns its
    summary."""
    start = r["start"] or 0
    if r["completed"] is None:
        fail(f"{tag}: {what} did not complete")
    events = [e for e in r["events"]]
    print(f"  {what}: {n_steps} iterations from {start} in {r['completed'][0]:.1f} s "
          f"({r['completed'][1]:.2f} it/s over the run); {len(events)} topology events, "
          f"opacity resets at {r['resets']}")
    rates = stretch_rates(r["progress"], P15_STRETCH)
    print("  it/s per stretch (host clock between the 100-iteration prints): "
          + ", ".join(f"{a}-{b} {x:.2f}" for a, b, x in rates))
    for it, e in sorted(r["evals"].items()):
        img = r["images"].get(it, {})
        print(f"  evaluation at {it}: {e['size']} {e['unit']}"
              f"{'' if not e['strands'] else ', %d strands' % e['strands']}; strands "
              f"({e['on']}) " + ", ".join(f"{k} {e[k]:.4f}" for k in e
                                        if k.endswith("(b)"))
              + ("; " + ", ".join(f"{k} {v:.3f}" for k, v in img.items()) if img else ""))
    warns = r["warns"]
    print(f"  pair-table overflows at the syncs: {len(warns)} syncs with any, "
          f"{sum(w[1] for w in warns)} pair-budget, {sum(w[2] for w in warns)} tile-cap, "
          f"{sum(w[3] for w in warns)} capacity; controller changes {r['raster']}")
    print(f"  launches {r['launches']}")
    la = r["launches"] or {}
    fwd, bwd = la.get("composite_fwd", 0), la.get("composite_bwd", 0)
    nostats = la.get("composite_bwd_nostats", 0)
    if fwd != n_steps + views * evals_expected or bwd + nostats != n_steps:
        fail(f"{tag}: {what} expected {n_steps + views * evals_expected} forward and "
             f"{n_steps} backward launches, got {la}")
    if full_window and nostats == 0:
        fail(f"{tag}: {what} ran no backward without stats after the window closed")
    if not all(np.isfinite(p[2]) for p in r["progress"]):
        fail(f"{tag}: {what} printed a non-finite loss")
    return dict(start=start, steps=n_steps, seconds=r["completed"][0],
                it_per_s=r["completed"][1], stretches=rates, events=len(events),
                resets=r["resets"], evals=r["evals"], images=r["images"],
                overflow_syncs=len(warns), launches=la,
                peak_size=max((e["size"] for e in events), default=None))


def checkpoint_resumes(data, dirs, tmp):
    """Phase 15, step 3: npz checkpoints on the card, the Gaussian model's
    (save_checkpoint / load_checkpoint) from the Stage-I PLY and the hair
    model's (save_checkpoint / restore) from the merged PLY: three train
    steps, a checkpoint, a new model restored from it holding every array
    of capture() bit-equal, and the next three steps from both with the
    first one's loss bit-equal (the largest parameter difference after the
    three is printed)."""
    import os
    import random
    from argparse import Namespace

    from hairgs_tpu_torch.config import OptimizationConfig
    from hairgs_tpu_torch.models.gaussian import GaussianModel
    from hairgs_tpu_torch.models.hair import HairModel
    from hairgs_tpu_torch.render.renderer import RasterConfig
    from hairgs_tpu_torch.scene import Scene
    from hairgs_tpu_torch.topo.strands import smooth_pair_indices
    from hairgs_tpu_torch.train.trainer import (
        make_gaussian_train_step,
        make_hair_train_step,
    )

    op = OptimizationConfig()
    cfg = RasterConfig(max_tiles_per_gaussian=64, max_pairs_per_tile=2048, chunk=128,
                       use_pallas=True)
    out = {}
    for what, path in dirs.items():
        random.seed(0)
        scene = Scene(Namespace(source_path=data, model_path=path, images="images",
                                resolution=-1, sh_degree=0, data_device="cuda",
                                eval=False), shuffle=False, capacity_round=65536)
        cams, m = scene.get_cameras(), scene.gaussians
        m.training_setup(op)
        hair = isinstance(m, HairModel)
        common = dict(width=cams[0].width, height=cams[0].height,
                      active_sh_degree=m.active_sh_degree,
                      spatial_lr_scale=m.spatial_lr_scale, device="cuda")
        if hair:
            sp, sv = (torch.tensor(a.astype(np.int64) if a.dtype != np.bool_ else a,
                                   device="cuda")
                      for a in smooth_pair_indices(m.strands_info))
            step = make_hair_train_step(
                op, cfg, dist_to_scale_factor=m.dist_to_scale_factor, **common)

            def run(model, i):
                *state, metrics, _ = step(model.params, model.graph, model.stats,
                                          model.opt_state, cams[i], i, sp, sv)
                model.params, model.stats, model.opt_state = state
                return metrics["loss"].item()
        else:
            step = make_gaussian_train_step(op, cfg, **common)

            def run(model, i):
                *state, metrics, _ = step(model.params, model.stats, model.opt_state,
                                          model.active, cams[i], i)
                model.params, model.stats, model.opt_state = state
                return metrics["loss"].item()
        for i in range(1, 4):
            run(m, i)
        ck = f"{tmp}/{what}.npz"
        m.save_checkpoint(ck)
        again = (HairModel if hair else GaussianModel)(
            sh_degree=0, spatial_lr_scale=m.spatial_lr_scale, capacity_round=65536,
            device="cuda")
        if hair:
            again.restore(dict(np.load(ck)))
        else:
            again.load_checkpoint(ck)
        again.training_setup(op)
        a, b = m.capture(), again.capture()
        # every array bit-equal; the 0-d scalars (step, SH degree, the
        # spatial scale, a Python float once restored) equal in value
        differ = sorted(set(a) ^ set(b)) + [
            f"{k} ({a[k].dtype}{list(a[k].shape)}, {b[k].dtype}{list(b[k].shape)}, "
            f"NaN {int(np.isnan(a[k]).sum()) if a[k].dtype.kind == 'f' else 0})"
            for k in sorted(set(a) & set(b))
            if not ((a[k].dtype == b[k].dtype or a[k].ndim == 0) and np.array_equal(
                a[k], b[k], equal_nan=a[k].dtype.kind == "f"))]
        same = not differ
        la = [run(m, i) for i in range(4, 7)]
        lb = [run(again, i) for i in range(4, 7)]
        diff = max((x - y).abs().max().item() for x, y in zip(m.params, again.params)
                   if x.numel())
        size = m.num_segments if hair else m.count
        print(f"  {what} checkpoint ({size} rows, {len(a)} arrays, "
              f"{os.path.getsize(ck) / 2**20:.1f} MiB): restored state bit-equal {same}"
              f"{'' if same else ' (differ: %s)' % differ}; "
              f"resumed losses {la} against {lb}; largest parameter difference after "
              f"three steps {diff:.3e}")
        if not same or la[0] != lb[0]:
            fail(f"phase 15: the {what} checkpoint is not a bit-equal resume")
        out[what] = dict(rows=size, state_equal=same, losses=(la, lb), param_diff=diff)
        del scene, m, again
    torch.cuda.empty_cache()
    return out


def p15_logs():
    """Phase 15's log directory: $CHIP_SMOKE_LOGS, or _runs/phase15 of the
    checkout (git-ignored)."""
    import os

    logs = os.environ.get("CHIP_SMOKE_LOGS") or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "_runs", "phase15")
    os.makedirs(logs, exist_ok=True)
    return logs


def p15_pipeline_cmd(tmp, argv, dst=None):
    return [sys.executable, "-m", "hairgs_tpu_torch.drivers.pipeline", "-s",
            f"{tmp}/syn150/data", "-m", dst or f"{tmp}/syn150/model", *argv]


def start_phase15(tmp, n1):
    """Phase 15, step 1 started in the background: the pipeline writes the
    scene, runs Stage I for n1 iterations and the merge."""
    return Stamped(p15_pipeline_cmd(tmp, ["--synthetic", "--stages", "stage1,merge",
                                          *P15_COMMON, "--iterations", str(n1)]),
                   f"{p15_logs()}/stage1_merge.log", 300 + 0.15 * n1)


def launch_line(lines):
    """The launch counts a child printed ("[kernels] launches {...}")."""
    return next((literal(line.split(" ", 2)[2]) for line in lines
                 if line.startswith("[kernels] launches")), {})


def report_scene(lines, size=512, tag="phase 15"):
    """Print the reference scene's record and fail() unless it is the
    reference scene with every GT render on the forward kernel and, at
    512x512, none dropping a pair; returns the GT renders' launches and
    their worst overflow counters."""
    lines = [line for _, line in lines]
    m = next(re.match(r"^dataset done: \S+ (\d+) GT segments; worst over (\d+) "
                      r"views (\{.*\})$", line)
             for line in lines if line.startswith("dataset done"))
    launches = launch_line(lines)
    worst = literal(m.group(3))
    print(f"  scene: {m.group(1)} GT segments, {m.group(2)} views at {size}x{size}; worst "
          f"over the views {worst}; launches {launches}")
    if int(m.group(1)) != P15_SEGMENTS or int(m.group(2)) != P15_VIEWS:
        fail(f"{tag}: the scene is not the reference scene: {m.groups()}")
    # generate_dataset's default tables are the reference's; at 1000x1000
    # the drops are recorded, not gated (JAX renders with the same tables)
    if size == 512 and (worst["overflow_pairs"] or worst["overflow_tiles"]
                        or worst["overflow_capacity"]):
        fail(f"{tag}: a GT render dropped pairs: {worst}")
    if launches.get("composite_fwd") != P15_VIEWS:
        fail(f"{tag}: the GT renders did not run the forward kernel: {launches}")
    return launches, worst


def report_merge(lines, tag="phase 15"):
    """Print the merge stage's record (iterations, seconds, strands, the
    metric table) and fail() if it merged nothing; returns (summary,
    metrics, thresholds)."""
    rows = [re.match(r"^merge iter (\d+): merged (\d+) endpoint pairs -> (\d+) segments, "
                     r"(\d+) strands \(([\d.]+) s, candidates ([\d.]+) s\)", line)
            for _, line in lines]
    rows = [tuple(float(g) for g in r.groups()) for r in rows if r]
    metrics, ths = metric_table(lines)
    conv, conv_strands = next((int(x.group(1)), int(x.group(2))) for _, line in lines
                              if (x := re.match(r"^Converted to hair model: (\d+) "
                                                r"segments, (\d+) strands", line)))
    iters = next(int(x.group(1)) for _, line in lines
                 if (x := re.match(r"^Merging converged after (\d+) iterations", line)))
    strands = int(rows[-1][3]) if rows else conv_strands
    print(f"  merge: {conv} segments in {conv_strands} strands converted, {iters} "
          f"iterations, {sum(r[4] for r in rows):.1f} s (s per iteration "
          f"{[r[4] for r in rows]}, of it the candidate search {[r[5] for r in rows]}), "
          f"{strands} strands left (JAX {JAX_MERGED['strands']})")
    for k, v in metrics.items():
        print(f"    {k:<22} " + "  ".join(f"{t} {x:.4f}" for t, x in zip(ths, v)))
    if not rows:
        fail(f"{tag}: the merge merged nothing")
    return dict(converted=conv, iterations=iters, strands=strands,
                seconds=sum(r[4] for r in rows), metrics=metrics, thresholds=ths), \
        metrics, ths


def report_grow(secs, name, tag):
    """Print a growth step's record (the grow driver's section `name` and
    the eval driver's on its output, `name`_eval) and fail() unless it grew
    segments and the eval driver's table equals the one the grow driver
    printed for the same checkpoint; returns its summary."""
    lines = [line for _, line in secs[name]]
    grown = [int(m.group(1)) for line in lines
             if (m := re.match(r"^growth event \d+: \+(\d+) tip segments", line))]
    joined = [int(m.group(1)) for line in lines
              if (m := re.match(r"^  of them in the recomputed strands info: (\d+)", line))]
    strands = next(((int(m.group(1)), int(m.group(2))) for line in lines
                    if (m := re.match(r"^merge pass: (\d+) -> (\d+) strands", line))), None)
    branching = next(int(m.group(1)) for line in lines if (m := re.match(
        r"^strands whose tip goes on into another segment \(not grown\): (\d+)", line)))
    loaded = next((int(m.group(1)), int(m.group(2))) for line in lines if (m := re.match(
        r"^loaded iteration_\d+: (\d+) segments, (\d+) strands$", line)))
    printed, ths = metric_table(secs[name])
    got, _ = metric_table(secs[name + "_eval"])
    launches = launch_line([line for _, line in secs[name + "_eval"]])
    at = {k: v[-1] for k, v in got.items()}
    print(f"  {name}: {loaded[0]} segments in {loaded[1]} strands walked on load; new "
          f"segments per event {grown} (in the strands info walked after "
          f"each: {joined}), merge pass strands {strands}, "
          f"tips that go on into another segment (not grown; JAX grows them) {branching}; "
          f"eval driver at {ths[-1]}: " + ", ".join(f"{k} {v:.4f}" for k, v in at.items())
          + f"; equal to the grow driver's table {got == printed}; launches {launches}")
    if not grown or grown[0] == 0 or got != printed:
        fail(f"{tag}: the growth step {name} grew nothing, or its eval disagrees")
    return dict(loaded=loaded, grown=grown, joined=joined, strands=strands,
                branching_tips=branching, metrics=at, launches=launches)


def report_trajectory(secs, merged_it):
    """Print Stage III's run at the reference schedule (cut at its time
    limit or not): the iteration reached, each evaluation, the densify peak,
    each topology phase's seconds, the segments every 1000 iterations and
    the it/s per stretch; returns them."""
    s3 = parse_train(secs.get("stage3", []))
    reached = max([p[0] for p in s3["progress"]], default=0)
    print(f"  Stage III reference schedule: reached iteration {reached} of 30000 "
          f"(from {merged_it})")
    for it, e in sorted(s3["evals"].items()):
        print(f"    evaluation at {it}: {e}")
    peak = max(s3["events"], key=lambda e: e["size"], default=None)
    if peak:
        print(f"    densify peak {peak['size']} segments at {peak['it']}")
    phases = {}
    for e in s3["events"]:
        for k, v in e["info"].items():
            if k.startswith("t_"):
                phases.setdefault(k, []).append(v)
    print(f"    event seconds by phase (mean, max over {len(s3['events'])} events): "
          + ", ".join(f"{k} {np.mean(v):.3f} {np.max(v):.3f}" for k, v in phases.items()))
    sizes = [(p[0], p[3]) for p in s3["progress"] if p[0] % 1000 == 0]
    print(f"    segments every 1000 iterations: {sizes}")
    rates = stretch_rates(s3["progress"], P15_STRETCH)
    print("    it/s per stretch: " + ", ".join(f"{a}-{b} {x:.2f}" for a, b, x in rates))
    return dict(reached=reached, evals=s3["evals"],
                peak=peak and (peak["size"], peak["it"]),
                phases={k: (float(np.mean(v)), float(np.max(v)))
                        for k, v in phases.items()},
                sizes=sizes, stretches=rates, completed=s3["completed"],
                eval=metric_table(secs.get("eval", []))[0])


def reference_pipeline(tmp, n1, full_stage3_s=0, started=None):
    """Phase 15: run_reference_schedule.sh through drivers/pipeline.py on
    its seed-0 scene (150 strands x 24 points, 16 views at 512x512, written
    on the card): Stage I for `n1` iterations of the reference schedule and
    the merge; the eval driver on the merged PLY against the merge's own
    evaluation; the npz checkpoints of both models and the merge driver's
    --clean; the first P15_STAGE3 iterations of Stage III and the eval
    driver on its last PLY. At n1 = 30000 the merged model is held to the
    JAX chain's quality (P15_GATES); with `full_stage3_s` (a function
    returning the seconds left) the whole Stage III schedule then runs from
    a copy of the merged model for at most that long. `started`: step 1 as
    start_phase15 started it.
    Logs under p15_logs(). Returns a record."""
    import os

    logs = p15_logs()
    data, model = f"{tmp}/syn150/data", f"{tmp}/syn150/model"
    rec = dict(stage1_iterations=n1, stage1_beside_phases_11_14=started is not None)

    def pipe(name, argv=None, timeout=None, dst=model, may_stop=False, run=None):
        run = run or Stamped(p15_pipeline_cmd(tmp, argv, dst), f"{logs}/{name}.log",
                             timeout)
        return wait_pipeline(run, name, "phase 15", may_stop)

    # step 1: the scene, Stage I and the merge
    secs = pipe("stage1_merge", run=started or start_phase15(tmp, n1))
    gt_launches, _ = report_scene(secs["scene"])
    s1 = parse_train(secs["stage1"])
    n_evals1 = -(-n1 // 10000)
    rec["stage1"] = report_train("Stage I", s1, n1, P15_VIEWS, n_evals1, n1 >= 27000)
    want_events = len([i for i in range(600, min(n1, 26999) + 1, 100)])
    want_resets = [i for i in range(3000, min(n1, 26999) + 1, 3000)]
    if rec["stage1"]["events"] != want_events or s1["resets"] != want_resets:
        fail(f"phase 15: Stage I ran {rec['stage1']['events']} densify events and "
             f"resets {s1['resets']}, expected {want_events} and {want_resets}")
    for i in sorted({0, 1, 2, len(s1["events"]) - 2, len(s1["events"]) - 1}):
        if not 0 <= i < len(s1["events"]):
            continue
        e, d = s1["events"][i], s1["events"][i]["info"]
        print(f"    densify at {e['it']}: {e['ms']:.1f} ms, clone {d.get('clone')} split "
              f"{d.get('split')} prune {d.get('prune_total')} -> {e['size']}")
    final1 = rec["stage1"]["images"][n1]
    rec["stage1"]["final"] = dict(final1, count=rec["stage1"]["evals"][n1]["size"])

    rec["merge"], merged, ths = report_merge(secs["merge"])
    strands = rec["merge"]["strands"]
    merged_it = n1 + max(rec["merge"]["iterations"], 1)  # the merge driver's save

    # step 2: the eval driver on the merged PLY (the pipeline's eval stage
    # takes the last checkpoint)
    secs = pipe("eval_merged", ["--stages", "eval"], 900)
    got, _ = metric_table(secs["eval"])
    eval_launches = [launch_line([line for _, line in secs["eval"]])]
    print(f"  eval driver on iteration {merged_it}: equal to the merge's evaluation "
          f"{got == merged}")
    if got != merged:
        fail(f"phase 15: the eval driver's metrics {got} differ from the merge's {merged}")

    # the gates against the JAX chain at the full Stage I
    at = {k: v[-1] for k, v in merged.items()}
    comp = {k: (at[k], JAX_MERGED[k]) for k in P15_GATES}
    comp["strands"] = (strands, JAX_MERGED["strands"])
    comp["stage1_psnr"] = (final1["psnr"], JAX_STAGE1_PSNR)
    print(f"  against the JAX chain at {ths[-1]} (port, JAX): {comp}; Stage I ssim "
          f"{final1.get('ssim')}, masked_psnr {final1.get('masked_psnr')} (JAX at 30000: "
          f"0.932, 8.67)")
    misses = [k for k, lim in P15_GATES.items() if abs(at[k] - JAX_MERGED[k]) > lim]
    if abs(strands - JAX_MERGED["strands"]) > P15_STRANDS_REL * JAX_MERGED["strands"]:
        misses.append("strands")
    if final1["psnr"] < P15_PSNR_MIN:
        misses.append("stage1_psnr")
    # step 2b: Stage II.5 on the merged model (the pipeline's grow stage),
    # held to JAX's Stage II.5 on this scene at the full Stage I
    secs = pipe("grow", ["--stages", "grow"], 900)
    rec["grow"] = report_grow(secs, "grow", "phase 15")
    eval_launches.append(rec["grow"]["launches"])
    g = rec["grow"]["metrics"]
    sc0 = at["strand_consistency(b)"]
    grow_misses = [k for k, ok in (
        ("grow_f1", P15_GROW_F1[0] <= g["f1(b)"] <= P15_GROW_F1[1]),
        ("grow_sc", g["strand_consistency(b)"] >= sc0 + P15_GROW_SC_GAIN),
        ("grow_f1_vs_merged", g["f1(b)"] >= at["f1(b)"] - P15_GROW_F1_DROP)) if not ok]
    print(f"  Stage II.5 (port, JAX round 5): f1(b) ({g['f1(b)']:.4f}, "
          f"{JAX_GROWN['f1(b)']}), strand consistency ({g['strand_consistency(b)']:.4f}, "
          f"{JAX_GROWN['strand_consistency(b)']}); merged f1 {at['f1(b)']:.4f}, strand "
          f"consistency {sc0:.4f}; gates f1 in {P15_GROW_F1}, consistency >= merged + "
          f"{P15_GROW_SC_GAIN}, f1 >= merged - {P15_GROW_F1_DROP}: "
          f"{'held' if not grow_misses else 'missed ' + str(grow_misses)}")
    misses += grow_misses
    rec["against_jax"] = dict(values=comp, misses=misses, gated=n1 == P15_FULL)
    print(f"  gates {'held' if not misses else 'missed: ' + str(misses)}"
          f"{'' if n1 == P15_FULL else ' (reported only: Stage I cut to %d)' % n1}")
    if n1 == P15_FULL and misses:
        rec["gate_fail"] = misses
    if full_stage3_s:
        shutil.copytree(model, f"{model}_full3")
        # the scene and the Stage-I and merged PLYs, for CPU comparisons
        keep = os.path.join(logs, "syn150")
        shutil.rmtree(keep, ignore_errors=True)
        shutil.copytree(data, f"{keep}/data")
        for it in (n1, merged_it):
            shutil.copytree(f"{model}/point_cloud/iteration_{it}",
                            f"{keep}/model/point_cloud/iteration_{it}")

    # step 3: the npz checkpoints of both models and the merge's --clean
    clean = f"{tmp}/syn150/clean"
    os.makedirs(f"{clean}/point_cloud")
    shutil.copytree(f"{model}/point_cloud/iteration_{n1}",
                    f"{clean}/point_cloud/iteration_{n1}")
    rec["checkpoints"] = checkpoint_resumes(data, {"gaussian": clean, "hair": model}, tmp)
    cmd = [sys.executable, "-m", "hairgs_tpu_torch.drivers.merge", "-s", data, "-m", clean,
           "--clean"]
    rc, lines = run_stamped(cmd, f"{logs}/merge_clean.log", 900)
    cleaned = next((int(x.group(1)) for _, line in lines
                    if (x := re.match(r"^Cleaned to (\d+) foreground", line))), None)
    c_iters = next((int(x.group(1)) for _, line in lines
                    if (x := re.match(r"^Merging converged after (\d+)", line))), None)
    c_metrics, _ = metric_table(lines)
    print(f"  merge --clean: exit {rc}; {cleaned} of {rec['stage1']['final']['count']} "
          f"Gaussians kept, {c_iters} iterations; f1(b) at {ths[-1]} "
          f"{c_metrics.get('f1(b)', [None])[-1]} (without --clean {at['f1(b)']:.4f})")
    if rc != 0 or not cleaned or cleaned > rec["stage1"]["final"]["count"] or not c_metrics:
        fail("phase 15: the merge driver's --clean failed")
    rec["clean"] = dict(kept=cleaned, iterations=c_iters, metrics=c_metrics)

    # step 4: Stage III's first iterations and the eval driver on its last PLY
    secs = pipe("stage3_eval", ["--stages", "stage3,eval", *P15_COMMON,
                                "--iterations", str(P15_STAGE3)], 900)
    s3 = parse_train(secs["stage3"])
    rec["stage3"] = report_train("Stage III", s3, P15_STAGE3, P15_VIEWS, 1, False)
    if s3["start"] != merged_it:
        fail(f"phase 15: Stage III started from {s3['start']}, not {merged_it}")
    kinds = {k: sum(1 for e in s3["events"] if k in e["info"]) for k in ("clone", "merge")}
    end = s3["evals"][merged_it + P15_STAGE3]
    print(f"  Stage III events {kinds}; at {merged_it + P15_STAGE3}: f1(b) "
          f"{end['f1(b)']:.4f}, recall(b) {end['recall(b)']:.4f}, precision(b) "
          f"{end['precision(b)']:.4f} (JAX after its first 1000: f1 {JAX_III_1K['f1(b)']}, "
          f"recall {JAX_III_1K['recall(b)']}; reported, not gated)")
    for e in [s3["events"][i] for i in sorted({0, len(s3["events"]) - 1})
              if s3["events"]]:
        print(f"    event at {e['it']}: {e['ms']:.1f} ms "
              + str({k: v for k, v in e["info"].items() if k.startswith("t_")})
              + f" -> {e['size']} segments, {e['strands']} strands")
    ev, _ = metric_table(secs["eval"])
    eval_launches.append(launch_line([line for _, line in secs["eval"]]))
    last = {k: round(v[-1], 4) for k, v in ev.items() if k in end}
    print(f"  eval driver on iteration {merged_it + P15_STAGE3}: {last}, Stage III's "
          f"final evaluation {({k: end[k] for k in last})}")
    if kinds["clone"] < 1 or kinds["merge"] < 1 or \
            any(end[k] != v for k, v in last.items()):
        fail("phase 15: Stage III missed an event, or the eval driver disagrees with "
             "its final evaluation")
    rec["stage3"]["events_by_kind"] = kinds
    runs = [gt_launches, rec["stage1"]["launches"], rec["stage3"]["launches"],
            *eval_launches]
    rec["launches"] = {k: sum(r.get(k, 0) for r in runs)
                       for k in ("composite_fwd", "composite_bwd", "composite_bwd_nostats")}
    print(f"  launches over phase 15's children (scene, Stage I, three evaluations, "
          f"Stage III): {rec['launches']}")
    if any(v == 0 for k, v in rec["launches"].items()
           if k != "composite_bwd_nostats" or n1 >= 27000):
        fail(f"phase 15: a kernel of the path was never launched: {rec['launches']}")

    if full_stage3_s:
        secs = pipe("stage3_full", ["--stages", "stage3,eval", *P15_COMMON],
                    max(60.0, full_stage3_s()), dst=f"{model}_full3", may_stop=True)
        rec["stage3_full"] = report_trajectory(secs, merged_it)
    return rec


def phase15_alone(n1, budget_s):
    """`python3 chip_smoke.py --phase15 N [S]`: build the kernels and run
    phase 15 alone with N Stage-I iterations (30000: the whole reference
    schedule, held to the JAX chain's gates) and, with S > 0, the whole
    Stage-III schedule afterwards until S seconds after the start (less a
    minute for the rest)."""
    from hairgs_tpu_torch import kernels

    t0 = time.perf_counter()
    for name, r in kernels.build().items():
        print(f"  {name}: built in {r['seconds']:.1f} s")
    smi = smi_line()
    print(smi)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_p15_") as tmp:
        rec = reference_pipeline(tmp, n1, budget_s and (
            lambda: budget_s - 60 - (time.perf_counter() - t0)))
    print(f"  total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"phase15": rec}, default=str))
    print(smi)
    if rec.get("gate_fail"):
        fail(f"phase 15: the port misses the JAX chain's quality: {rec['gate_fail']}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


# phase 16: the 1000x1000 recipe (scripts/run_reference_schedule_1k.sh)
# through drivers/pipeline.py --recipe 1k, each stage a child process
P16_SIZE = 1000
P16_ALPHA_MIN = 1e-5  # the recipe's --alpha_min
# this script's cut: Stage I's first 10 000 iterations and Stage III's
# first 500; `--phase16 30000 S` runs Stage I whole. At 1000x1000 the
# recipe's Stage I grows from 360 Gaussians to 553 by 2000, all of them
# background (the merge converts no strand and its metrics raise, in JAX
# too); at 10 000 it holds 40 910 with foreground strands (PERF.md §6)
P16_STAGE1 = 10000
P16_STAGE3 = 500
P16_RESERVE_S = 300  # --phase16 N S: the eval stage after Stage III is cut


def p16_pipeline_cmd(tmp, argv):
    """The 1k recipe's pipeline, its train stages at the driver's defaults:
    the in-training evaluations on the device, the final one on the host."""
    return [sys.executable, "-m", "hairgs_tpu_torch.drivers.pipeline", "--recipe", "1k",
            "-s", f"{tmp}/syn150_1k/data", "-m", f"{tmp}/syn150_1k/model", *argv]


def start_phase16(tmp, n1, n3):
    """Phase 16's chain started in the background: the scene, Stage I for
    n1 iterations, the merge and Stage II.5; then Stage III for n3
    iterations and the eval stage (final eval, growth, its eval)."""
    import shlex

    a = p16_pipeline_cmd(tmp, ["--stages", "stage1,merge,grow", "--iterations", str(n1)])
    b = p16_pipeline_cmd(tmp, ["--stages", "stage3,eval", "--iterations", str(n3)])
    return Stamped(["sh", "-c", f"{shlex.join(a)} && {shlex.join(b)}"],
                   f"{p15_logs()}/p16_chain.log", 900 + 0.2 * n1 + 0.5 * n3)


def aa_kernel_check(data, model_dir, n1, tmp):
    """Phase 16 (a): both compositor kernels (the backward with and
    without stats) against their plain versions at view 0 of the Stage-I
    model at 1000x1000, under antialiasing at alpha_min 1e-5 with the
    recipe's tables; their times (CUDA events, 20 launches; the plain
    versions one call each), the pair-pixels that pass the gates (and at
    1/255 for comparison), the cull's shares and the bounds. Returns the
    kernels line's numbers."""
    from argparse import Namespace

    from hairgs_tpu_torch.render import composite_pairs as cp
    from hairgs_tpu_torch.render.renderer import RasterConfig
    from hairgs_tpu_torch.scene import Scene

    one = f"{tmp}/p16_stage1"
    shutil.copytree(f"{model_dir}/point_cloud/iteration_{n1}",
                    f"{one}/point_cloud/iteration_{n1}")
    scene = Scene(Namespace(source_path=data, model_path=one, images="images",
                            resolution=-1, sh_degree=0, data_device="cuda", eval=False),
                  shuffle=False, capacity_round=131072)
    m, cam = scene.gaussians, scene.get_cameras()[0]
    w, h = cam.width, cam.height
    cfg = RasterConfig(max_tiles_per_gaussian=64, max_pairs_per_tile=2048, chunk=128,
                       antialiasing=True, alpha_min=P16_ALPHA_MIN, use_pallas=True)
    geo, feat, starts, counts, binning = pair_table(m.params, m.active, cam, w, h, cfg,
                                                    m.active_sh_degree)
    grid_w, chunk, mc, C = (w + 15) // 16, cfg.chunk, cfg.max_pairs_per_tile // cfg.chunk, 7
    name = f"phase 16 view 0 ({w}x{h}, antialiasing, alpha_min {P16_ALPHA_MIN:g})"
    _, pairs, chunks = table_sizes(counts, chunk)
    print(f"  {name}: {m.count} Gaussians, {pairs} pairs in {chunks} chunks, fullest "
          f"tile {int(counts.max())}; overflow pairs {int(binning.overflow_pairs)}, "
          f"tiles {int(binning.overflow_tiles)}, capacity {int(binning.overflow_capacity)}")
    fwd_err, fwd = check_forward(name, geo, feat, starts, counts, grid_w, chunk, mc, C,
                                 alpha_min=P16_ALPHA_MIN)
    bwd_err = check_backward(name, geo, feat, starts, counts, fwd, grid_w, chunk, mc, C,
                             seed=16, alpha_min=P16_ALPHA_MIN)
    _, trans, tstarts, latch = fwd
    cnt = cp.clamp_counts_to_live_chunks(counts, tstarts, chunk, mc)
    cots = bwd_cotangents(starts.shape[0], C, 17, geo.device)
    fargs = (geo, feat, starts, counts, grid_w, 16, chunk, mc, C, P16_ALPHA_MIN)

    def bargs(stats):
        return (geo, feat, starts, cnt, tstarts, latch, trans, *cots, grid_w, 16, chunk,
                mc, C, stats, P16_ALPHA_MIN)

    fg = gate_counts(geo, starts, counts, grid_w, alpha_min=P16_ALPHA_MIN)
    bg = gate_counts(geo, starts, cnt, grid_w, alpha_min=P16_ALPHA_MIN)
    fg255 = gate_counts(geo, starts, counts, grid_w)
    n_sw, touched, kept = warp_shares(geo, starts, counts, grid_w, alpha_min=P16_ALPHA_MIN)
    print(f"  pair-pixels {fg[0]}: passing the gates at alpha_min {P16_ALPHA_MIN:g} "
          f"{fg[1]} (backward {bg[1]}), at 1/255 {fg255[1]}; (slot, warp) combinations "
          f"{n_sw}: some lane passes in {touched / n_sw:.4f}, the cull keeps "
          f"{kept / n_sw:.4f}; pixels with final T < 0.01 {int((trans < 0.01).sum())} "
          f"of {trans.numel()}")
    out = {}
    for key, run, plain, (bound, by) in (
            ("composite_fwd", lambda: cp.composite_pairs_fwd_cuda(*fargs),
             lambda: cp.composite_pairs_fwd_plain(*fargs), fwd_bound_ms(counts, chunk, C, fg)),
            ("composite_bwd", lambda: cp.composite_pairs_bwd_cuda(*bargs(True)),
             lambda: cp.composite_pairs_bwd_plain(*bargs(True)),
             bwd_bound_ms(cnt, chunk, C, bg)),
            ("composite_bwd_nostats", lambda: cp.composite_pairs_bwd_cuda(*bargs(False)),
             lambda: cp.composite_pairs_bwd_plain(*bargs(False)),
             bwd_bound_ms(cnt, chunk, C, bg, stats=False))):
        ms = cuda_ms(run, 20)
        plain_ms = cuda_ms(plain, 1, warm=False)
        out[key] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                        max_abs_err=fwd_err if key == "composite_fwd" else bwd_err)
        print(f"  {key} at alpha_min {P16_ALPHA_MIN:g}: {ms:.4f} ms (plain {plain_ms:.3f} "
              f"ms, one call), bound {bound:.4f} ms by {by}, {bound / ms:.1%} of it")
    del scene, m, geo, feat, fwd
    torch.cuda.empty_cache()
    return dict(out, pairs=pairs, pair_pixels=fg[0], passing=fg[1], passing_bwd=bg[1],
                passing_at_1_255=fg255[1], warp_touched=touched / n_sw, warp_kept=kept / n_sw)


def grow_card_against_cpu(data, model_dir, post_merge, tmp, pipeline_out):
    """Phase 16 (c): the grow driver on the card and on the CPU from the
    same post-merge checkpoint: new segments per event and the strands
    after the merge pass equal, endpoints within 1e-5, the graphs equal;
    and the card's result equal to the pipeline's grown_postmerge."""
    import os

    from hairgs_tpu_torch.drivers import grow_and_save
    from hairgs_tpu_torch.io.ply import load_hair_ply

    res = {dev: grow_and_save.main(["-s", data, "-m", model_dir, "--base_iter",
                                    str(post_merge), "--out", f"{tmp}/p16_grow_{dev}",
                                    "--data_device", dev])
           for dev in ("cuda", "cpu")}
    a, b = (load_hair_ply(res[d]["path"], 0)[0] for d in ("cuda", "cpu"))
    it_dir = os.path.basename(os.path.dirname(res["cuda"]["path"]))
    c = load_hair_ply(os.path.join(pipeline_out, "point_cloud", it_dir, "point_cloud.ply"),
                      0)[0]
    err = float(np.abs(a["endpoints"] - b["endpoints"]).max())
    graph = np.array_equal(a["endpoint_pairs"], b["endpoint_pairs"])
    as_pipeline = all(np.array_equal(a[k], c[k]) for k in a)
    r = {d: {k: res[d][k] for k in ("grown", "strands", "branching_tips")}
         for d in res}
    print(f"  grow driver on the card {r['cuda']} and on the CPU {r['cpu']}: endpoints max "
          f"abs err {err:.3e}, graphs equal {graph}; the card's PLY equal to the "
          f"pipeline's {as_pipeline}")
    if r["cuda"] != r["cpu"] or err > 1e-5 or not graph or not as_pipeline:
        fail("phase 16: the grow driver on the card disagrees with the CPU or the pipeline")
    return dict(r["cuda"], endpoint_err=err)


def recipe_1k(tmp, n1, n3=P16_STAGE3, full_stage3_s=0, started=None):
    """Phase 16: run_reference_schedule_1k.sh through drivers/pipeline.py
    --recipe 1k on the seed-0 scene at 1000x1000 (written on the card; the
    GT renders' drops printed): Stage I for n1 iterations under the
    recipe's flags (the pairs truncated at each sync printed), the merge,
    Stage II.5 and its eval; then (a) the kernels at a view of the Stage-I
    model under antialiasing at alpha_min 1e-5, (b) the antialiased step's
    gradients on the card against the CPU, (c) the grow driver on the card
    against the CPU; Stage III for n3 iterations (or, with `full_stage3_s`,
    its whole schedule until that many seconds are left, less
    P16_RESERVE_S) with async topology events, the final eval, the growth
    of the final model and its eval, (d) each eval driver's metrics equal
    to those printed for the same checkpoint. `started`: the whole chain as
    start_phase16 started it (checks (a)-(c) then run after it). Returns a
    record."""
    import os

    from hairgs_tpu_torch.render.renderer import RasterConfig

    logs = p15_logs()
    root = f"{tmp}/syn150_1k"
    data, model = f"{root}/data", f"{root}/model"
    tag = "phase 16"
    rec = dict(stage1_iterations=n1)

    def pipe(name, argv, timeout, may_stop=False):
        return wait_pipeline(Stamped(p16_pipeline_cmd(tmp, argv), f"{logs}/{name}.log",
                                     timeout), name, tag, may_stop)

    if started is None:
        secs = pipe("p16_stage1", ["--stages", "stage1", "--iterations", str(n1)],
                    900 + 0.15 * n1)
    else:
        secs = wait_pipeline(started, "p16_chain", tag)
    gt_launches, rec["gt_overflow"] = report_scene(secs["scene"], P16_SIZE, tag)
    s1 = parse_train(secs["stage1"])
    rec["stage1"] = report_train("Stage I", s1, n1, P15_VIEWS, -(-n1 // 10000),
                                 n1 >= 27000, tag)
    sizes = [(p[0], p[3]) for p in s1["progress"] if p[0] % 1000 == 0]
    print(f"  Stage I Gaussians every 1000 iterations: {sizes}; pairs truncated at those "
          f"syncs (iteration, pair-budget, tile-cap, capacity): "
          f"{[w for w in s1['warns'] if w[0] % 1000 == 0]}")
    rec["stage1"]["sizes"] = sizes
    warns = s1["warns"]
    if warns:
        tile, budget = np.array([w[2] for w in warns]), np.array([w[1] for w in warns])
        print(f"  pairs truncated per sync (Stage I, {len(warns)} syncs with any): tile-cap "
              f"mean {tile.mean():.0f} max {tile.max()}, pair-budget mean {budget.mean():.0f} "
              f"max {budget.max()}; the last syncs {warns[-3:]}")
        rec["stage1"]["truncated"] = dict(syncs=len(warns), tile_cap_mean=float(tile.mean()),
                                          tile_cap_max=int(tile.max()),
                                          pair_budget_max=int(budget.max()), last=warns[-3:])
    print("  (a) the kernels under antialiasing at alpha_min 1e-5")
    rec["kernels"] = aa_kernel_check(data, model, n1, tmp)
    print("  (b) the antialiased step's gradients on the card against the CPU")
    check_grads_against_cpu(RasterConfig(
        max_tiles_per_gaussian=16, max_pairs_per_tile=2048, chunk=128,
        pair_capacity=786432, antialiasing=True, alpha_min=P16_ALPHA_MIN,
        use_pallas=True))
    if started is None:
        secs.update(pipe("p16_merge_grow", ["--stages", "merge,grow",
                                            "--iterations", str(n1)], 1800))
    rec["merge"], merged, ths = report_merge(secs["merge"], tag)
    with open(f"{root}/post_merge_iter.txt") as f:
        post_merge = int(f.read())
    rec["merged"] = {k: v[-1] for k, v in merged.items()}
    rec["grow"] = report_grow(secs, "grow", tag)
    print("  (c) the grow driver on the card against the CPU")
    rec["grow_card_cpu"] = grow_card_against_cpu(data, model, post_merge, tmp,
                                                 f"{root}/grown_postmerge")

    full = bool(full_stage3_s)
    if started is None:
        if full:
            secs.update(pipe("p16_stage3_full", ["--stages", "stage3"],
                             max(60.0, full_stage3_s() - P16_RESERVE_S), may_stop=True))
            secs.update(pipe("p16_eval", ["--stages", "eval"], P16_RESERVE_S + 600))
        else:
            secs.update(pipe("p16_stage3_eval", ["--stages", "stage3,eval", "--iterations",
                                                 str(n3)], 900 + 0.5 * n3))
    s3 = parse_train(secs["stage3"])
    if s3["start"] != post_merge:
        fail(f"{tag}: Stage III started from {s3['start']}, not {post_merge}")
    if full:
        rec["stage3"] = report_trajectory(secs, post_merge)
        rec["stage3"]["launches"] = s3["launches"] or {}
    else:
        rec["stage3"] = report_train("Stage III", s3, n3, P15_VIEWS, 1, False, tag)
        if not s3["events"]:
            fail(f"{tag}: Stage III ran no topology event")
    # (d) the final eval against Stage III's evaluation of the same strands
    # on the host. The train driver evaluates the strands info of its last
    # topology event (model.strands_info); the eval driver walks the
    # checkpoint's strands again, as the grow driver does when it loads
    # it (a walk on load equals the walk at an event,
    # tests/test_torch_port_stage23.py). The sets are one when the walk on
    # load counts the event's segments and strands.
    last = max(int(d.split("_")[-1]) for d in os.listdir(f"{model}/point_cloud"))
    rec["grow_final"] = report_grow(secs, "grow_final", tag)
    walked = rec["grow_final"]["loaded"]
    ev, _ = metric_table(secs["eval"])
    got = {k: round(v[-1], 4) for k, v in ev.items()}
    end = s3["evals"].get(last)
    like = end is not None and end["on"] == "host" and (end["size"], end["strands"]) == walked
    print(f"  final eval driver on iteration {last} ({walked[1]} strands walked on load): "
          f"{got}; Stage III's evaluation there "
          f"{end and dict(strands=end['strands'], on=end['on'], **{k: end[k] for k in got if k in end})}")
    if not like:
        print("  not the same strands on the host: the in-training evaluation read the "
              "strands info of an earlier topology event, or ran on the device")
        if not full:
            fail(f"{tag}: Stage III's final evaluation is not of the checkpoint's strands")
    elif any(end[k] != v for k, v in got.items() if k in end):
        fail(f"{tag}: the final eval driver disagrees with Stage III's evaluation")
    rec["final"] = dict(iteration=last, metrics=got, strands_walked=walked[1],
                        strands_evaluated=end and end["strands"], same_strands=like)
    eval_launches = [launch_line([line for _, line in secs[k]])
                     for k in ("grow_eval", "eval", "grow_final_eval")]
    keys = ("composite_fwd", "composite_bwd", "composite_bwd_nostats")
    rec["aa_launches"] = {k: rec["stage1"]["launches"].get(k, 0)
                          + rec["stage3"]["launches"].get(k, 0) for k in keys}
    rec["launches"] = {k: rec["aa_launches"][k] + sum(r.get(k, 0) for r in [
        gt_launches, *eval_launches]) for k in keys}
    print(f"  launches over phase 16's children: {rec['launches']}; of them in the train "
          f"stages (antialiasing, alpha_min 1e-5) {rec['aa_launches']}")
    if any(rec["aa_launches"][k] == 0 for k in keys[:2]):
        fail(f"{tag}: a kernel of the path was never launched: {rec['aa_launches']}")
    rec["stage_seconds"] = {m.group(1): float(m.group(3)) for sec in secs.values()
                            for _, line in sec if (m := re.match(
                                r"^\[pipeline\] (\w+) exited (\S+) after ([\d.]+) s$", line))}
    print("  wall seconds by child process: "
          + ", ".join(f"{k} {v:.1f}" for k, v in rec["stage_seconds"].items()))
    return rec


def phase16_alone(n1, budget_s):
    """`python3 chip_smoke.py --phase16 N [S]`: build the kernels and run
    phase 16 alone with N Stage-I iterations (30000: the recipe's whole
    Stage I) and, with S > 0, the whole Stage-III schedule afterwards until
    S seconds after the start, less P16_RESERVE_S for the final eval and
    growth; quality is recorded, not gated."""
    from hairgs_tpu_torch import kernels

    t0 = time.perf_counter()
    for name, r in kernels.build().items():
        print(f"  {name}: built in {r['seconds']:.1f} s")
    smi = smi_line()
    print(smi)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_p16_") as tmp:
        rec = recipe_1k(tmp, n1, full_stage3_s=budget_s and (
            lambda: budget_s - 60 - (time.perf_counter() - t0)))
    print(f"  total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"phase16": rec}, default=str))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


# phase 17: the NeRSemble capture path (drivers/parse_nersemble.py, then the
# Stage-I driver on the parsed scene) and the USC dress rehearsal
# (drivers/pipeline.py --recipe usc), as child processes beside phases 11-16
P17_SIZE = 1000  # the seed-0 reference scene at 1000x1000, 16 views
P17_VIEWS = 16
P17_PID = "017"
P17_SERIAL = 222200000  # a NeRSemble camera serial: this + the COLMAP id
# FLAME 2023's sizes: vertices, joints, shape and expression components
FLAME_SIZES = dict(verts=5023, joints=5, shape=300, expression=100)
P17_STAGE1 = [*STAGE1_FLAGS, "--ip", ""]
P17_CPU_THREADS = 4  # the CPU parse's torch threads (the children share 8 cores)
P17_MARK = "### phase 17 step "
P17_CONF_STEP = 1  # the confidence maps' gate: 1 of 255 where the orientation agrees
P17_ORIENT_SHARE = 0.99


def write_flame_assets(root, center, radii, seed=0):
    """Synthetic FLAME pickles at FLAME 2023's sizes (the licensed model is
    not in the repository): a template of points spread evenly over an
    ellipsoid (`center`, `radii`), its convex hull as the faces, small
    random shape, expression and pose blend shapes, random skinning, the
    scalp mask the template's upper fifth; and a tracked fit of frame 0.
    Returns (model path, mask path, tracked fit)."""
    import os
    import pickle

    from scipy.spatial import ConvexHull

    rng = np.random.default_rng(seed)
    n, j = FLAME_SIZES["verts"], FLAME_SIZES["joints"]
    i = np.arange(n) + 0.5
    phi, theta = np.arccos(1 - 2 * i / n), np.pi * (1 + 5 ** 0.5) * i
    unit = np.stack([np.cos(theta) * np.sin(phi), np.cos(phi),
                     np.sin(theta) * np.sin(phi)], axis=1)
    jr = np.abs(rng.normal(size=(j, n)))
    w = np.abs(rng.normal(size=(n, j)))
    model = {
        "v_template": center + unit * radii,
        "shapedirs": rng.normal(size=(n, 3, FLAME_SIZES["shape"] + FLAME_SIZES["expression"]))
        * 1e-4,
        "posedirs": rng.normal(size=(n, 3, 9 * (j - 1))) * 1e-4,
        "J_regressor": jr / jr.sum(axis=1, keepdims=True),
        "weights": w / w.sum(axis=1, keepdims=True),
        "kintree_table": np.stack([np.array([0, 0, 1, 1, 1]), np.arange(j)]),
        "f": ConvexHull(unit).simplices.astype(np.int64),
    }
    paths = (os.path.join(root, "flame2023.pkl"), os.path.join(root, "FLAME_masks.pkl"))
    with open(paths[0], "wb") as f:
        pickle.dump(model, f)
    with open(paths[1], "wb") as f:
        pickle.dump({"scalp": np.nonzero(unit[:, 1] > 0.6)[0]}, f)
    fit = dict(shape=rng.normal(size=(1, FLAME_SIZES["shape"])),
               expression=rng.normal(size=(1, FLAME_SIZES["expression"])),
               neck=rng.normal(size=(1, 3)) * 0.01, eyes=rng.normal(size=(1, 6)) * 0.01,
               rotation=rng.normal(size=(1, 3)) * 0.01, translation=np.zeros((1, 3)),
               scale=np.array([[1.0]]))
    return paths[0], paths[1], fit


def write_nersemble_capture(tmp):
    """Phase 17 (a), step 1: the reference scene at 1000x1000 (written on
    the card, in `tmp`/scene) made into a NeRSemble-layout capture of
    participant 017 in `tmp`/raw: its views as images-2x JPEGs (quality 95),
    its render masks as alpha maps at twice the resolution (each pixel
    repeated 2x2, so that the parser's resize runs), a facer segmentation
    at that resolution (class 14 where the mask is at least 128, else 0),
    camera_params.json with the intrinsics doubled (the parser halves them)
    and each view's world-to-camera pose, the synthetic FLAME pickles around
    the hair and a tracked fit."""
    import json
    import os

    from PIL import Image

    from hairgs_tpu_torch.drivers.pipeline import write_reference_scene
    from hairgs_tpu_torch.io.colmap import (
        qvec2rotmat,
        read_extrinsics_binary,
        read_intrinsics_binary,
    )
    from hairgs_tpu_torch.io.dataset import read_colmap_scene_info

    scene, raw = f"{tmp}/scene", f"{tmp}/raw"
    write_reference_scene(scene, "cuda", P17_SIZE)
    t0 = time.perf_counter()
    cams = read_intrinsics_binary(f"{scene}/sparse/0/cameras.bin")
    images = read_extrinsics_binary(f"{scene}/sparse/0/images.bin")
    f_px, cx, cy = next(iter(cams.values())).params
    if any(list(c.params) != [f_px, cx, cy] for c in cams.values()):
        fail("phase 17: the reference scene's cameras do not share their intrinsics")
    part = f"{raw}/{P17_PID}"
    frame = f"{part}/sequences/EXP-1-head/timesteps/frame_00000"
    for sub in ("images-2x", "alpha_map", "facer_segmentation_masks"):
        os.makedirs(f"{frame}/{sub}", exist_ok=True)
    os.makedirs(f"{part}/calibration", exist_ok=True)
    w2c = {}
    for img in images.values():
        name = str(P17_SERIAL + img.id)
        e = np.eye(4)
        e[:3, :3], e[:3, 3] = qvec2rotmat(img.qvec), img.tvec
        w2c[name] = e.tolist()
        with Image.open(f"{scene}/images/{img.name}") as im:
            im.convert("RGB").save(f"{frame}/images-2x/cam_{name}.jpg", quality=95)
        with Image.open(f"{scene}/masks/{img.name}") as im:
            mask = np.asarray(im.convert("L")).repeat(2, axis=0).repeat(2, axis=1)
        Image.fromarray(mask).save(f"{frame}/alpha_map/cam_{name}.png")
        Image.fromarray(np.where(mask >= 128, 14, 0).astype(np.uint8)).save(
            f"{frame}/facer_segmentation_masks/segmentation_cam_{name}.png")
    k2 = [[2 * f_px, 0, 2 * cx], [0, 2 * f_px, 2 * cy], [0, 0, 1]]
    with open(f"{part}/calibration/camera_params.json", "w") as f:
        json.dump({"intrinsics": k2, "world_2_cam": w2c}, f)
    pts = read_colmap_scene_info(scene).points
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    model_path, mask_path, fit = write_flame_assets(raw, (lo + hi) / 2, (hi - lo) / 2)
    track = f"{part}/sequences/EXP-1-head/annotations/tracking/FLAME2023_v2"
    os.makedirs(track, exist_ok=True)
    np.savez(f"{track}/tracked_flame_params.npz", **fit)
    print(f"capture: {len(images)} views at {P17_SIZE}x{P17_SIZE} (alpha and segmentation "
          f"at {2 * P17_SIZE}x{2 * P17_SIZE}), FLAME {FLAME_SIZES}, written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def start_phase17(tmp):
    """Phase 17's children started in the background, one after the other:
    the capture, the parser on the card and on the CPU, the Stage-I driver
    on the card's parse, the USC recipe's pipeline. Each is announced by a
    P17_MARK line."""
    import os
    import shlex

    raw = f"{tmp}/raw"
    parse = [sys.executable, "-m", "hairgs_tpu_torch.drivers.parse_nersemble", "-r", raw,
             "-i", P17_PID, "--flame_model_path", f"{raw}/flame2023.pkl",
             "--flame_mask_path", f"{raw}/FLAME_masks.pkl"]
    steps = [
        ("capture", [sys.executable, os.path.abspath(__file__), "--nersemble-capture", tmp]),
        ("parse_cuda", [*parse, "-o", f"{tmp}/parsed_cuda", "--device", "cuda"]),
        ("parse_cpu", ["env", f"OMP_NUM_THREADS={P17_CPU_THREADS}", *parse, "-o",
                       f"{tmp}/parsed_cpu", "--device", "cpu"]),
        ("stage1", [sys.executable, "-m", "hairgs_tpu_torch.drivers.train", "-s",
                    f"{tmp}/parsed_cuda/{P17_PID}", "-m", f"{tmp}/nersemble_model",
                    *P17_STAGE1]),
        ("usc", [sys.executable, "-m", "hairgs_tpu_torch.drivers.pipeline", "--recipe",
                 "usc", "-s", f"{tmp}/usc/dataset/00001", "-m", f"{tmp}/usc/model"]),
    ]
    script = " && ".join(f"echo '{P17_MARK}{name}' && {shlex.join(cmd)}"
                         for name, cmd in steps) + f" && echo '{P17_MARK}end'"
    return Stamped(["sh", "-c", script], f"{p15_logs()}/p17_chain.log", 1100)


def p17_sections(lines):
    """{step: [(t, line)]} of phase 17's chain, and each step's seconds
    (between its mark and the next)."""
    secs, marks = {}, []
    for t, line in lines:
        if line.startswith(P17_MARK):
            marks.append((line[len(P17_MARK):], t))
            secs[marks[-1][0]] = []
        elif marks:
            secs[marks[-1][0]].append((t, line))
    return secs, {a[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])}


def compare_parses(card, cpu):
    """The card's parse against the CPU's (tests/test_torch_port_nersemble.py's
    gates): images and masks pixel for pixel, the orientation maps equal on
    P17_ORIENT_SHARE of the pixels and the confidence maps within
    P17_CONF_STEP where they are, the COLMAP files and head_mesh.ply byte
    for byte, the npz within 1e-6. Returns the worst orientation share."""
    import os

    from PIL import Image

    def px(d, sub, f):
        with Image.open(os.path.join(d, sub, f)) as im:
            return np.asarray(im).astype(np.int16)

    shares, bad = [], []
    for f in sorted(os.listdir(os.path.join(card, "images"))):
        for sub in ("images", "masks"):
            if not np.array_equal(px(card, sub, f), px(cpu, sub, f)):
                bad.append(f"{sub}/{f}")
        stem = f[:-4]
        oa, ob = (px(d, "orientations", f"{stem}_orientation.png") for d in (card, cpu))
        ca, cb = (px(d, "orientations", f"{stem}_confidence.png") for d in (card, cpu))
        same = oa == ob
        shares.append(float(same.mean()))
        if shares[-1] < P17_ORIENT_SHARE or np.abs(ca - cb)[same].max() > P17_CONF_STEP:
            bad.append(f"orientations/{stem}")
    for f in ("sparse/0/cameras.bin", "sparse/0/images.bin", "sparse/0/points3D.bin",
              "head_mesh.ply"):
        with open(os.path.join(card, f), "rb") as a, open(os.path.join(cpu, f), "rb") as b:
            if a.read() != b.read():
                bad.append(f)
    a, b = (np.load(os.path.join(d, "head_reconstruction_data.npz")) for d in (card, cpu))
    for k in a.files:
        if a[k].shape != b[k].shape or np.abs(a[k] - b[k]).max() > 1e-6:
            bad.append(f"head_reconstruction_data.npz:{k}")
    print(f"  card against CPU: {len(shares)} views; orientation maps equal on "
          f"{min(shares):.6f}-{max(shares):.6f} of the pixels; outside the gates: {bad}")
    if bad or len(shares) != P17_VIEWS:
        fail("phase 17: the parse on the card disagrees with the CPU's")
    return min(shares)


def gabor_ms_per_view(parsed):
    """The Gabor bank's ms per view on the card (180 angles, the parser's
    default) over the parsed background-removed images, host clock around
    each synchronised call after one warm-up view."""
    import os

    from PIL import Image

    from hairgs_tpu_torch.data.vision import estimate_orientation_field

    names = sorted(os.listdir(f"{parsed}/images"))
    ims = []
    for f in names:
        with Image.open(f"{parsed}/images/{f}") as im:
            ims.append(torch.from_numpy(np.array(im)).cuda())
    estimate_orientation_field(ims[0])
    ms = []
    for im in ims:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        estimate_orientation_field(im)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.mean(ms)), ms


def nersemble_kernel_check(data, model_dir):
    """Phase 17 (a): the forward kernel against its plain version at view 0
    of the Stage-I model on the parsed capture, with the tables the driver
    ended with (its cfg_args); its time (CUDA events, 20 launches; the plain
    version one call) and bound, as phase 16 (a)."""
    from argparse import Namespace

    from hairgs_tpu_torch.config import load_cfg_args
    from hairgs_tpu_torch.render import composite_pairs as cp
    from hairgs_tpu_torch.render.renderer import RasterConfig
    from hairgs_tpu_torch.scene import Scene

    scene = Scene(Namespace(source_path=data, model_path=model_dir, images="images",
                            resolution=-1, sh_degree=0, data_device="cuda", eval=False),
                  shuffle=False)
    stored = load_cfg_args(model_dir)
    m, cam = scene.gaussians, scene.get_cameras()[0]
    w, h = cam.width, cam.height
    cfg = RasterConfig(max_tiles_per_gaussian=stored.max_tiles_per_gaussian,
                       max_pairs_per_tile=stored.max_pairs_per_tile,
                       chunk=stored.composite_chunk, use_pallas=True)
    geo, feat, starts, counts, binning = pair_table(m.params, m.active, cam, w, h, cfg,
                                                    m.active_sh_degree)
    grid_w, chunk, mc, C = (w + 15) // 16, cfg.chunk, cfg.max_pairs_per_tile // cfg.chunk, 7
    name = f"phase 17 NeRSemble view 0 ({w}x{h})"
    _, pairs, chunks = table_sizes(counts, chunk)
    print(f"  {name}: {m.count} Gaussians, {pairs} pairs in {chunks} chunks, tables "
          f"{cfg.max_tiles_per_gaussian} tiles per Gaussian, {cfg.max_pairs_per_tile} pairs "
          f"per tile, chunk {chunk}; overflow pairs {int(binning.overflow_pairs)}, tiles "
          f"{int(binning.overflow_tiles)}")
    err, _ = check_forward(name, geo, feat, starts, counts, grid_w, chunk, mc, C)
    fargs = (geo, feat, starts, counts, grid_w, 16, chunk, mc, C)
    ms = cuda_ms(lambda: cp.composite_pairs_fwd_cuda(*fargs), 20)
    plain_ms = cuda_ms(lambda: cp.composite_pairs_fwd_plain(*fargs), 1, warm=False)
    gates = gate_counts(geo, starts, counts, grid_w)
    bound, by = fwd_bound_ms(counts, chunk, C, gates)
    print(f"  composite_fwd at {name}: {ms:.4f} ms (plain {plain_ms:.3f} ms, one call), "
          f"bound {bound:.4f} ms by {by}, {bound / ms:.1%} of it; pair-pixels {gates[0]}, "
          f"passing {gates[1]}")
    del scene, m, geo, feat
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                pairs=pairs, pair_pixels=gates[0], passing=gates[1])


def nersemble_path(tmp, secs, dur, smi):
    """Phase 17 (a) from the chain's record: the capture, the parse on the
    card against the CPU's, the Gabor bank's ms per view, the Stage-I
    driver on the parsed scene, the forward kernel at one of its views."""
    tag = "phase 17"
    print("  " + next(line for _, line in secs["capture"] if line.startswith("capture:")))
    out = {}
    for dev in ("cuda", "cpu"):  # the parser's own lines (warnings share the stream)
        lines = [line.replace(f"{tmp}/parsed_{dev}", "OUT") for _, line in secs[f"parse_{dev}"]]
        out[dev] = [line for line in lines if line.startswith((
            "OUT", "parsed ", "landmark ", "missing ", "Masks failed", "Images failed",
            "no folder"))]
    print(f"  parser on the card: {dur['parse_cuda']:.1f} s wall for {P17_VIEWS} views "
          f"({dur['parse_cuda'] / P17_VIEWS:.2f} s per view, the process's start-up "
          f"included); on the CPU ({P17_CPU_THREADS} threads): {dur['parse_cpu']:.1f} s "
          f"[{smi}]; printed {out['cuda']}")
    if out["cuda"] != out["cpu"] or out["cuda"][-1:] != ["parsed 1/1 participants"]:
        fail(f"{tag}: the parsers printed {out['cuda']} on the card, {out['cpu']} on the CPU")
    card, cpu = (f"{tmp}/parsed_{d}/{P17_PID}" for d in ("cuda", "cpu"))
    share = compare_parses(card, cpu)
    gabor_ms, per_view = gabor_ms_per_view(card)
    print(f"  Gabor bank (180 angles, {P17_SIZE}x{P17_SIZE}) on the card: {gabor_ms:.2f} ms "
          f"per view (min {min(per_view):.2f}, max {max(per_view):.2f}) [{smi}]")
    s1 = parse_train(secs["stage1"])
    rec = report_train("Stage I on the parsed capture", s1, 1000, P17_VIEWS, 1, False, tag)
    peak = next(float(m.group(1)) for _, line in secs["stage1"] if (m := re.match(
        r"^\[memory\] rank 0 peak ([\d.]+) GiB", line)))
    psnr = s1["images"][1000]["psnr"]
    print(f"  Stage I on the parsed capture: {rec['it_per_s']:.2f} it/s, final PSNR {psnr:.3f}, "
          f"peak device memory {peak:.3f} GiB, {dur['stage1']:.1f} s wall [{smi}]")
    kernel = nersemble_kernel_check(card, f"{tmp}/nersemble_model")
    return dict(parse_s=dur["parse_cuda"], parse_s_per_view=dur["parse_cuda"] / P17_VIEWS,
                parse_cpu_s=dur["parse_cpu"], orientation_share=share, gabor_ms=gabor_ms,
                stage1=rec, psnr=psnr, peak_gib=peak, kernel=kernel)


def usc_rehearsal(tmp, secs, smi):
    """Phase 17 (b) from the chain's record: drivers/pipeline.py --recipe
    usc (the sample, the parse at 16 x 1000^2 on the card, Stage I for 500
    iterations, the eval driver on its last PLY): seconds per step, the GT
    renders' launches and drops, Stage I's it/s and truncated pairs, the
    eval's seconds and F1 table."""
    import os

    tag = "phase 17"
    run = f"{tmp}/usc"
    sec = pipeline_sections(secs["usc"])
    if set(sec) != {"sample", "parse", "stage1", "eval"} or not os.path.exists(
            f"{run}/done.txt"):
        fail(f"{tag}: the USC recipe ran {sorted(sec)}")
    seconds = {m.group(1): float(m.group(3)) for _, line in secs["usc"] if (m := re.match(
        r"^\[pipeline\] (\w+) exited (\S+) after ([\d.]+) s$", line))}
    sample = next(line for _, line in sec["sample"] if line.startswith("wrote "))
    parsed = next(m for _, line in sec["parse"] if (m := re.match(
        r"^sample 1: dataset written to \S+ \((\d+) GT segments\); worst over (\d+) views "
        r"(\{.*\})$", line)))
    gt_launches = launch_line([line for _, line in sec["parse"]])
    print(f"  USC recipe [{smi}]: seconds per step {seconds}; {sample}; the parse: "
          f"{parsed.group(1)} GT segments in {parsed.group(2)} views at 1000x1000, worst "
          f"drops over the views {literal(parsed.group(3))} (generate_dataset's default "
          f"tables, as the reference's), launches {gt_launches}")
    if gt_launches.get("composite_fwd") != P17_VIEWS:
        fail(f"{tag}: the USC parse's GT renders did not run the forward kernel: "
             f"{gt_launches}")
    s1 = parse_train(sec["stage1"])
    rec = report_train("USC Stage I", s1, 500, P17_VIEWS, 2, False, tag)
    warns = s1["warns"]
    print(f"  USC Stage I: {rec['it_per_s']:.2f} it/s; pairs truncated (iteration, pair-"
          f"budget, tile-cap, capacity) at the syncs with any: {warns}")
    metrics, ths = metric_table(sec["eval"])
    ev_launches = launch_line([line for _, line in sec["eval"]])
    print(f"  eval driver (host metrics, {sample.split('(')[1].split(')')[0]}): "
          f"{seconds['eval']:.1f} s; launches {ev_launches}")
    for k, v in metrics.items():
        print(f"    {k:<22} " + "  ".join(f"{t} {x:.4f}" for t, x in zip(ths, v)))
    if not metrics or not all(np.isfinite(x) for v in metrics.values() for x in v) \
            or ev_launches.get("composite_fwd") != P17_VIEWS:
        fail(f"{tag}: the USC recipe's evaluation is incomplete")
    return dict(seconds=seconds, gt_segments=int(parsed.group(1)),
                gt_drops=literal(parsed.group(3)), gt_launches=gt_launches, stage1=rec,
                truncated=warns, eval_s=seconds["eval"], metrics={k: v[-1] for k, v in
                                                                 metrics.items()},
                eval_launches=ev_launches)


def phase17(tmp, started, smi):
    """Phase 17: wait for its chain (start_phase17), then (a) and (b)."""
    rc, lines = started.wait()
    chain_s = lines[-1][0] - started.t0 if lines else 0.0
    print(f"  [p17_chain] exit {rc}, its last line {chain_s:.1f} s after its start")
    if rc != 0:
        print("\n".join(line for _, line in lines[-40:]))
        fail(f"phase 17: the chain failed ({rc})")
    secs, dur = p17_sections(lines)
    print(f"  wall seconds by step: " + ", ".join(f"{k} {v:.1f}" for k, v in dur.items()))
    print("  (a) the NeRSemble capture path")
    rec = dict(chain_s=chain_s, steps=dur, nersemble=nersemble_path(tmp, secs, dur, smi))
    print("  (b) the USC dress rehearsal (drivers/pipeline.py --recipe usc)")
    rec["usc"] = usc_rehearsal(tmp, secs, smi)
    return rec


def phase17_alone():
    """`python3 chip_smoke.py --phase17`: build the kernels and run phase 17
    alone."""
    from hairgs_tpu_torch import kernels

    t0 = time.perf_counter()
    for name, r in kernels.build().items():
        print(f"  {name}: built in {r['seconds']:.1f} s")
    smi = smi_line()
    print(smi)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_p17_") as tmp:
        rec = phase17(tmp, start_phase17(tmp), smi)
    print(f"  total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"phase17": rec}, default=str))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on a GPU")
    if sys.argv[1:2] == ["--rank-case"]:
        return rank_main(*sys.argv[2:4])
    if sys.argv[1:2] == ["--slab-oracle"]:
        return slab_oracle_driver(int(sys.argv[2]), sys.argv[3:])
    if sys.argv[1:2] == ["--phase15"]:
        return phase15_alone(int(sys.argv[2]), float(sys.argv[3]) if sys.argv[3:] else 0)
    if sys.argv[1:2] == ["--phase16"]:
        return phase16_alone(int(sys.argv[2]), float(sys.argv[3]) if sys.argv[3:] else 0)
    if sys.argv[1:2] == ["--phase17"]:
        return phase17_alone()
    if sys.argv[1:2] == ["--nersemble-capture"]:
        return write_nersemble_capture(sys.argv[2])
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
    probe_device_ms = probe_entry.pop("device_ms")
    print(f"  phases 7-10: {time.perf_counter() - t_phase:.1f} s")

    # phase 15's scene, Stage I and merge run as children beside phases
    # 11-14 (the whole script would not fit its time limit otherwise); the
    # kernel times of the kernels line are taken before, but for phase 13's
    # C = 3 forward, during which the children are stopped
    p15_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_p15_")
    p15_run = start_phase15(p15_dir.name, P15_STAGE1)
    print(f"phase 15 started: the scene, Stage I ({P15_STAGE1} of {P15_FULL} "
          f"iterations) and the merge through drivers/pipeline.py, beside phases 11-14")
    p16_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_p16_")
    p16_run = start_phase16(p16_dir.name, P16_STAGE1, P16_STAGE3)
    print(f"phase 16 started: the 1k recipe through drivers/pipeline.py --recipe 1k "
          f"(Stage I {P16_STAGE1}, Stage III {P16_STAGE3} iterations), beside phases 11-15")
    p17_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_p17_")
    p17_run = start_phase17(p17_dir.name)
    print("phase 17 started: a NeRSemble-layout capture, its parse on the card and on the "
          "CPU, Stage I on it, and drivers/pipeline.py --recipe usc, beside phases 11-16")

    # phase 12 continues from phase 11's capture and model directory
    tmp_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_stages_")
    tmp = tmp_dir.name
    print("phase 11: the Stage-I driver on a USC-scale scene")
    t_phase = time.perf_counter()
    stage1, keep1 = stage1_driver(device, tmp)
    # phase 13 renders this Gaussian model with the render driver
    shutil.copytree(f"{tmp}/model", f"{tmp}/model_gauss")
    print(f"  phase 11: {time.perf_counter() - t_phase:.1f} s")

    print("phase 12: Stage II, Stage III and evaluation on phase 11's capture")
    t_phase = time.perf_counter()
    hair_grads_against_cpu(cfg)
    stage2 = stage2_merge(tmp, stage1["f1"])
    # phase 13's async run and phase 14's Stage-III runs start from the same
    # merged model
    shutil.copytree(f"{tmp}/model", f"{tmp}/model_async")
    shutil.copytree(f"{tmp}/model", f"{tmp}/model_merged")
    stage3, keep3 = stage3_driver(tmp)
    print(f"  phase 12: {time.perf_counter() - t_phase:.1f} s")

    print("phase 13: device metrics, async Stage III, the render driver, the "
          "Gabor bank, the USC parse driver and the 2D grid")
    t_phase = time.perf_counter()
    phase13 = {"device_metrics": device_metrics_check(
        [("gaussian", keep1["model"]), ("hair", keep3["model"])], keep1["gt"], smi)}
    synced = [r for r in keep3["record"].rows if r["loss"] is not None]
    phase13["async_stage3"] = async_stage3(
        tmp, dict(stage3, rows=keep3["record"].rows, loss_last=synced[-1]["loss"]), smi)
    # the render driver's kernel times (the kernels line's C = 3 entry)
    # without phase 15's Stage I on the card
    for run in (p15_run, p16_run, p17_run):
        run.pause()
    phase13["render_driver"] = render_driver_check(tmp, keep3, smi)
    for run in (p15_run, p16_run, p17_run):
        run.pause(False)
    phase13["gabor"] = gabor_check(tmp, keep1, smi)
    phase13["usc_parse"] = usc_parse_check(tmp, smi)
    phase13["grid"] = grid_check(keep3)
    print(f"  phase 13: {time.perf_counter() - t_phase:.1f} s")

    print("phase 14: the parallel paths (view-parallel and depth-slab steps, the "
          "driver under torchrun, sharded checkpoints) on the one card")
    t_phase = time.perf_counter()
    from hairgs_tpu_torch.scene import search_for_max_iteration

    final_ply = (f"{tmp}/model/point_cloud/iteration_"
                 f"{search_for_max_iteration(f'{tmp}/model/point_cloud')}/point_cloud.ply")
    phase14 = parallel_paths(scene, cfg, tmp, f"{tmp}/model_merged", final_ply)
    tmp_dir.cleanup()
    print(f"  phase 14: {time.perf_counter() - t_phase:.1f} s")

    print(f"phase 15: the reference pipeline through drivers/pipeline.py (Stage I "
          f"{P15_STAGE1} of {P15_FULL} iterations)")
    t_phase = time.perf_counter()
    del scene
    torch.cuda.empty_cache()
    phase15 = reference_pipeline(p15_dir.name, P15_STAGE1, started=p15_run)
    p15_dir.cleanup()
    print(f"  phase 15: {time.perf_counter() - t_phase:.1f} s after phase 14, "
          f"{p15_run.seconds:.1f} s of step 1 beside phases 11-14")

    print(f"phase 16: the 1k recipe through drivers/pipeline.py --recipe 1k (Stage I "
          f"{P16_STAGE1}, Stage III {P16_STAGE3} iterations)")
    t_phase = time.perf_counter()
    phase16 = recipe_1k(p16_dir.name, P16_STAGE1, P16_STAGE3, started=p16_run)
    p16_dir.cleanup()
    print(f"  phase 16: {time.perf_counter() - t_phase:.1f} s after phase 15, "
          f"{p16_run.seconds:.1f} s of its chain beside phases 11-15")
    aa = phase16["kernels"]

    print("phase 17: the NeRSemble capture path and the USC dress rehearsal "
          "(drivers/pipeline.py --recipe usc)")
    t_phase = time.perf_counter()
    phase17_rec = phase17(p17_dir.name, p17_run, smi)
    p17_dir.cleanup()
    print(f"  phase 17: {time.perf_counter() - t_phase:.1f} s after phase 16, "
          f"{phase17_rec['chain_s']:.1f} s of its chain beside phases 11-16")
    ner = phase17_rec["nersemble"]

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
        {"name": "composite_fwd_c3", "route": "cuda", "source": src + "composite_fwd.cu",
         "replaces": "hairgs_tpu/render/pallas_composite.py:153",
         "launches": phase13["render_driver"]["c3_launches"],
         **phase13["render_driver"]["checks"][3], "library_ms": None},
        probe_entry,
        *({"name": f"{k}_aa", "route": "cuda", "source": src + k + ".cu",
           "replaces": "hairgs_tpu/render/pallas_composite.py:"
                       + ("153" if k == "composite_fwd" else "272"),
           "launches": phase16["aa_launches"][k],
           **{f: aa[k][f] for f in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                    "bound_by")},
           "library_ms": None} for k in ("composite_fwd", "composite_bwd")),
        {"name": "composite_fwd_nersemble", "route": "cuda",
         "source": src + "composite_fwd.cu",
         "replaces": "hairgs_tpu/render/pallas_composite.py:153",
         "launches": ner["stage1"]["launches"]["composite_fwd"],
         **{f: ner["kernel"][f] for f in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                          "bound_by")},
         "library_ms": None},
    ]}
    print(f"  total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"step_ms": ms_step, "it_per_s": n_timed / dt,
                      "host_median_step_ms": median_ms,
                      "bf16_step_ms": ms_step_b, "batched_step_ms": ms_batch,
                      "stage1_driver": stage1, "stage2_merge": stage2,
                      "stage3_driver": stage3, "phase13": phase13,
                      "phase14": phase14, "phase15": phase15, "phase16": phase16,
                      "phase17": phase17_rec,
                      "probe_device_ms": probe_device_ms, "card": smi},
                     default=str))
    print(json.dumps(kernels_line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
