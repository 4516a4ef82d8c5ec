"""Port parity, the render driver: hairgs_tpu_torch.drivers.render against
the root render.py on the same model directories (a Stage-I Gaussian fit
and, after the merge driver, its hair model) on the CPU, both on the XLA
path; and its `screen_theta` and `orientation_map_to_vis` against
render.py's.

Tolerances: the same PNG files for all five types, each pixel within 1 of
255 (the two renderers round the last bits of a colour differently);
`screen_theta` and `orientation_map_to_vis` bit-equal.
"""

import os
import random
import shutil
import sys
from argparse import ArgumentParser

import numpy as np
import pytest
import torch
from PIL import Image

CONFIGS = ("ModelConfig", "OptimizationConfig", "GeneralConfig", "RuntimeConfig")
COMMON = ["--data_device", "cpu", "--logger", "none", "--max_tiles_per_gaussian", "8",
          "--max_pairs_per_tile", "128", "--composite_chunk", "16",
          "--capacity_round", "256"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers, and the
    idle OpenMP threads of a torch pool spin on cores the others need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _parser(config_module, extra=()):
    p = ArgumentParser()
    for name in CONFIGS:
        config_module.add_config_args(p, getattr(config_module, name))
    for flag in extra:
        p.add_argument(flag, action="store_true")
    return p


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    """The 64 px scene of tests/test_pipeline.py, a 4-iteration Stage-I
    directory written by JAX's train.py and a copy that JAX's merge.py
    turned into a hair model."""
    import merge as jmerge
    import train as jtrain
    from hairgs_tpu import config
    from hairgs_tpu_torch.data.synthetic import generate_dataset, synthetic_test_hair
    from hairgs_tpu_torch.render.renderer import RasterConfig

    root = tmp_path_factory.mktemp("render_driver")
    hair = synthetic_test_hair(num_strands=20, points_per_strand=8, seed=1)
    source = generate_dataset(
        str(root / "data"), hair, num_cameras=3, width=64, height=64,
        cam_z=0.35, init_points="gt_hair_verts", init_subsample=3,
        raster_cfg=RasterConfig(max_tiles_per_gaussian=8, max_pairs_per_tile=128,
                                chunk=16), device="cpu")
    gauss = str(root / "gaussian")
    args = _parser(config).parse_args(
        ["-s", source, "-m", gauss, "--iterations", "4", "--save_frequency", "4",
         "--eval_frequency", "4", "--ip", "", *COMMON])
    jtrain.prepare_output_path(args)
    stdout = sys.stdout
    try:
        random.seed(0)
        np.random.seed(0)
        jtrain.training(*(config.extract_config(args, getattr(config, c))
                          for c in CONFIGS), args)
        hair_dir = str(root / "hair")
        shutil.copytree(gauss, hair_dir)
        jmerge.main(_parser(config, ("--clean",)).parse_args(
            ["-s", source, "-m", hair_dir, *COMMON, "--merge_dist_th_init", "0.02",
             "--merge_angle_th_init", "60"]))
    finally:
        sys.stdout = stdout
    return {"source": source, "gaussian": gauss, "hair": hair_dir}


def _pngs(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs if f.endswith(".png"))


@pytest.mark.parametrize("kind", ["gaussian", "hair"])
def test_render_driver_matches_jax(model_dirs, kind, tmp_path):
    import render as jrender
    from hairgs_tpu import config as jc
    from hairgs_tpu_torch.drivers import render as trender

    source = model_dirs["source"]
    out = {}
    for package in ("jax", "torch"):
        path = str(tmp_path / package)
        shutil.copytree(model_dirs[kind], path)
        # every flag has a default, which get_combined_args prefers to the
        # stored cfg_args (in both packages): the scene and sizes are given
        argv = ["-s", source, "-m", path, *COMMON]
        stdout = sys.stdout
        try:
            if package == "jax":
                parser = jrender.ArgumentParser()
                for name in CONFIGS[:3]:
                    jc.add_config_args(parser, getattr(jc, name))
                parser.add_argument("--skip_train", action="store_true")
                parser.add_argument("--skip_test", action="store_true")
                parser.add_argument("--type", "-t", type=int, default=-1)
                jc.add_config_args(parser, jc.RuntimeConfig)
                jrender.render_sets(jc.get_combined_args(parser, argv))
            else:
                times = trender.main(argv)
        finally:
            sys.stdout = stdout
        out[package] = os.path.join(path, "render")
    assert list(times) == ["rgb", "mask_foreground", "mask_other",
                           "orientation_map", "rgb_foreground"]
    files = _pngs(out["torch"])
    assert files == _pngs(out["jax"]) and len(files) == 5 * 2 * 3
    for f in files:
        a = np.asarray(Image.open(os.path.join(out["jax"], f)), np.int16)
        b = np.asarray(Image.open(os.path.join(out["torch"], f)), np.int16)
        assert a.shape == b.shape == (64, 64, 3), f
        assert np.abs(a - b).max() <= 1, f
    # the foreground type rendered a cleaned copy, not the model itself
    assert any(np.asarray(Image.open(os.path.join(out["torch"], f))).any()
               for f in files if "/rgb_foreground/" in f)


def test_screen_theta_and_hsv_vis_match_jax():
    import render as jrender
    from hairgs_tpu_torch.drivers import render as trender

    rng = np.random.default_rng(3)
    o_world = rng.normal(0, 1, (24, 20, 3)).astype(np.float32)
    o_world[0, :3] = 0.0  # no orientation: the MIN_VAL guards
    wv = np.eye(4, dtype=np.float32)
    wv[:3, :3] = np.linalg.qr(rng.normal(0, 1, (3, 3)))[0]
    theta = trender.screen_theta(o_world, wv)
    np.testing.assert_array_equal(theta, jrender.screen_theta(o_world, wv))
    conf = rng.uniform(0, 1, theta.shape).astype(np.float32)
    conf[::3, ::4] = 1.0  # the reference's quirk: these go black
    vis = trender.orientation_map_to_vis(theta, conf)
    np.testing.assert_array_equal(vis, jrender.orientation_map_to_vis(theta, conf))
    assert not vis[::3, ::4].any() and vis.any()
