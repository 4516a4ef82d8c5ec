"""What each piece of the compositor kernels' design buys, on one card.

Builds patched copies of csrc/ beside the shipped libraries, each with one
piece of the design taken out, and times both compositor passes of every
copy against the shipped ones in turns (shipped, copies, copies in reverse,
shipped) at bench view 0 (bench_scene.build_bench_scene, f32 plane, stats
on). A copy that computes the same function is held to the shipped kernels
bit for bit; the timing-only copies compute something else and say so.

    python3 -m hairgs_tpu_torch.probes.compositor_ablation

Needs a CUDA card and nvcc; exits non-zero without them.
"""

import json
import shutil
import subprocess
import sys

import numpy as np
import torch

from hairgs_tpu_torch import kernels

_WALK = "unsigned bits = warp_slots(st.mask, k0, n, lane, warp);"

# name -> (what is taken out, same function?, [(file, old, new), ...])
VARIANTS = {
    "no_cull": (
        "the warp masks: every pair reaches every warp", True,
        [("composite_common.cuh",
          "st.mask[i] = warp_reach(x, y, a, b, c, o, tx0, ty0, alpha_min);",
          "st.mask[i] = 0xff;")]),
    "xor_trees": (
        "the transposed butterfly: one 5-step xor tree per value", True,
        [("composite_bwd.cu",
          "const float s = __any_sync(FULL, use) ? warp_sum16(v, lane) : 0.0f;",
          "float s = 0.0f;\n"
          "        if (__any_sync(FULL, use)) {\n"
          "          for (int i = 0; i < NV; ++i) {\n"
          "            float x = v[i];\n"
          "            for (int off = 16; off > 0; off >>= 1)\n"
          "              x += __shfl_xor_sync(FULL, x, off);\n"
          "            if (((lane >> 1) & 15) == i) s = x;\n"
          "          }\n"
          "        }")]),
    "no_walk": (
        "the warps' walk over their slots (timing only: what is left is the "
        "staging, the plane writes and the wrappers' allocations)", False,
        [(f, _WALK, "unsigned bits = 0u & warp_slots(st.mask, k0, n, lane, warp);")
         for f in ("composite_fwd.cu", "composite_bwd.cu")]),
}


def _patched_sources(name, patches):
    d = kernels.BUILD_DIR / "ablation" / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(kernels.CSRC_DIR, d)
    for fname, old, new in patches:
        text = (d / fname).read_text()
        if old not in text:
            raise RuntimeError(f"{name}: {fname} no longer holds {old!r}")
        (d / fname).write_text(text.replace(old, new))
    return d


def _bench_view(device):
    from hairgs_tpu_torch.bench_scene import build_bench_scene
    from hairgs_tpu_torch.models.gaussian import gaussian_render_inputs
    from hairgs_tpu_torch.render.renderer import RasterConfig, paged_pair_table

    cfg = RasterConfig(max_tiles_per_gaussian=16, max_pairs_per_tile=2048,
                       chunk=128, pair_capacity=786432, viewspace_stats=True,
                       alpha_min=1.0 / 255.0, use_pallas=True)
    scene = build_bench_scene(device=device)
    cam = scene.cams[0]
    with torch.no_grad():
        _, b, geo, feat = paged_pair_table(
            cam, **gaussian_render_inputs(scene.params, cam.cam_center, 0),
            cov3d_precomp=None, active=scene.active, mean2d_offset=None,
            scale_modifier=1.0, width=scene.width, height=scene.height, config=cfg)
    grid_w = (scene.width + 15) // 16
    return geo, feat, b.starts, b.counts, grid_w, cfg.chunk, \
        cfg.max_pairs_per_tile // cfg.chunk


def _ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main():
    if not torch.cuda.is_available():
        print("compositor_ablation: no CUDA device", file=sys.stderr)
        sys.exit(1)
    from hairgs_tpu_torch.render import composite_pairs as cp

    names = ("composite_fwd", "composite_bwd", "precision_probe")
    kernels.build(names)
    for name, (_, _, patches) in VARIANTS.items():
        kernels.build(names, variants={"_" + name: kernels.NVCC_FLAGS},
                      src_dir=_patched_sources(name, patches))
    device = torch.device("cuda")
    geo, feat, starts, counts, grid_w, chunk, max_chunks = _bench_view(device)
    c = 7
    fwd_args = (geo, feat, starts, counts, grid_w, 16, chunk, max_chunks, c)
    fwd = cp.composite_pairs_fwd_cuda(*fwd_args)
    cnt = cp.clamp_counts_to_live_chunks(counts, fwd[2], chunk, max_chunks)
    g = torch.Generator(device="cpu").manual_seed(5)
    nt = starts.shape[0]
    cots = [torch.randn(s, generator=g).to(device)
            for s in ((nt, 256, c), (nt, 256, c), (nt, 256))]
    bwd_args = (geo, feat, starts, cnt, fwd[2], fwd[3], fwd[1], *cots, grid_w,
                16, chunk, max_chunks, c, True)
    bwd = cp.composite_pairs_bwd_cuda(*bwd_args)
    order = [""] + ["_" + n for n in VARIANTS]
    times = {s: [] for s in order}
    for suffix in order + order[::-1]:
        with kernels.variant(suffix):
            times[suffix].append((_ms(lambda: cp.composite_pairs_fwd_cuda(*fwd_args)),
                                  _ms(lambda: cp.composite_pairs_bwd_cuda(*bwd_args))))
            if suffix and VARIANTS[suffix[1:]][1]:
                same = all(torch.equal(a, b) for a, b in zip(
                    cp.composite_pairs_fwd_cuda(*fwd_args) + cp.composite_pairs_bwd_cuda(*bwd_args),
                    fwd + bwd))
                if not same:
                    print(f"compositor_ablation: {suffix[1:]} changed the "
                          f"function", file=sys.stderr)
                    sys.exit(1)
    out = {}
    for suffix in order:
        f, b = (float(np.mean([t[i] for t in times[suffix]])) for i in range(2))
        name = suffix[1:] or "shipped"
        out[name] = {"fwd_ms": f, "bwd_ms": b,
                     "fwd_turns": [t[0] for t in times[suffix]],
                     "bwd_turns": [t[1] for t in times[suffix]]}
        print(f"{name}: composite_fwd {f:.4f} ms, composite_bwd {b:.4f} ms"
              + (f" (without {VARIANTS[name][0]})" if suffix else ""))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(json.dumps({"card": smi.stdout.strip(), "ablation": out}))


if __name__ == "__main__":
    main()
