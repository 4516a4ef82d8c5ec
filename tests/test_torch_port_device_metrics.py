"""Port parity, the in-training metrics on the device: `matched_mask`,
`matched_fraction` and `compute_metrics_device` of
hairgs_tpu_torch.evaluation.device_metrics against hairgs_tpu's on the
cases of tests/test_device_metrics.py, the device point extractors of
evaluation/eval_data.py on the same model state, the driver's
`--device_eval` rule, and a Stage-I driver run whose first evaluation takes
the device path.

Tolerances: matched masks equal; fractions, precision, recall and F1
within 1e-6 (one point of ~400 is 2.5e-3); the extracted points and
directions within 1e-6 and the valid masks equal (the hair extractor: of
JAX's where the strand walk keeps the stored segment order, of the host
converter's set everywhere); the driver's device evaluation within 1e-6
of its host evaluation of the same model.
"""

import random
import sys
from argparse import ArgumentParser

import jax.numpy as jnp
import numpy as np
import pytest
import torch

THRESHOLDS = [(2e-3, 20), (4e-3, 40), (4e-3, 90)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers, and the
    idle OpenMP threads of a torch pool spin on cores the others need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_cloud(n, seed, spread=0.05):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    dirs = rng.normal(0, 1, (n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return pts, dirs


def _both(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("bidir", [False, True])
@pytest.mark.parametrize("dist_th,angle_th", THRESHOLDS)
def test_matched_fraction_matches_jax(dist_th, angle_th, bidir):
    from hairgs_tpu.evaluation.device_metrics import matched_fraction as jfrac
    from hairgs_tpu.evaluation.device_metrics import matched_mask as jmask
    from hairgs_tpu_torch.evaluation.device_metrics import matched_fraction, matched_mask

    # a 4 cm cube: some but not all points match at every threshold
    j, t = _both(*random_cloud(403, 0, 0.02), *random_cloud(517, 1, 0.02))
    fj = float(jfrac(*j, dist_th, angle_th, bidirectional=bidir, q_chunk=128,
                     p_chunk=256))
    ft = float(matched_fraction(*t, dist_th, angle_th, bidirectional=bidir,
                                q_chunk=128, p_chunk=256))
    assert abs(ft - fj) <= 1e-6 and 0.0 < fj < 1.0
    cos_th = np.float32(np.cos(np.deg2rad(angle_th)))
    mj = np.asarray(jmask(*j, jnp.float32(dist_th), jnp.float32(cos_th),
                          bidirectional=bidir, q_chunk=128, p_chunk=256))
    mt = matched_mask(*t, dist_th, cos_th, bidirectional=bidir, q_chunk=100,
                      p_chunk=64).numpy()
    np.testing.assert_array_equal(mt, mj)


def test_validity_masks_exclude_padding():
    from hairgs_tpu.evaluation.device_metrics import matched_fraction as jfrac
    from hairgs_tpu_torch.evaluation.device_metrics import matched_fraction

    p1, d1 = random_cloud(100, 2, 0.02)
    p2, d2 = random_cloud(120, 3, 0.02)
    # pad both clouds with rows that would otherwise match
    pad1 = np.concatenate([p1, p2[:20]])
    padd1 = np.concatenate([d1, d2[:20]])
    v1 = np.concatenate([np.ones(100, bool), np.zeros(20, bool)])
    pad2 = np.concatenate([p2, p1[:30]])
    padd2 = np.concatenate([d2, d1[:30]])
    v2 = np.concatenate([np.ones(120, bool), np.zeros(30, bool)])
    j, t = _both(pad1, padd1, pad2, padd2, v1, v2)
    fj = float(jfrac(*j[:4], 4e-3, 40, valid1=j[4], valid2=j[5],
                     bidirectional=True, q_chunk=64, p_chunk=64))
    ft = float(matched_fraction(*t[:4], 4e-3, 40, valid1=t[4], valid2=t[5],
                                bidirectional=True, q_chunk=64, p_chunk=64))
    assert abs(ft - fj) <= 1e-6


def test_mask_identity_self_match():
    """Every point matches itself. The expanded form rounds a zero distance
    to up to a few 1e-10 (|q|^2 ~ 2e-3 here; torch's matmul rounds q.q with
    FMA where sum(q * q) does not), so the radius is 1e-4 (1e-8 squared),
    not the 1e-6 of tests/test_device_metrics.py, whose square lies below
    that rounding."""
    from hairgs_tpu_torch.evaluation.device_metrics import matched_mask

    p, d = (torch.from_numpy(a) for a in random_cloud(64, 4))
    assert bool(torch.all(matched_mask(p, d, p, d, 1e-4, 0.99, q_chunk=32,
                                       p_chunk=32)))


@pytest.mark.parametrize("bidir", [False, True])
def test_threshold_grid_matches_jax(bidir):
    from hairgs_tpu.evaluation.device_metrics import compute_metrics_device as jcmd
    from hairgs_tpu_torch.evaluation.device_metrics import compute_metrics_device

    j, t = _both(*random_cloud(350, 5, 0.02), *random_cloud(280, 6, 0.02))
    dj, thj = jcmd(*j, bidirectional=bidir, q_chunk=128, p_chunk=128)
    dt, tht = compute_metrics_device(*t, bidirectional=bidir, q_chunk=128,
                                     p_chunk=128)
    assert tht == thj and dt.keys() == dj.keys()
    for k in dj:
        np.testing.assert_allclose(dt[k], dj[k], rtol=0, atol=1e-6, err_msg=k)


def test_gaussian_extractor_matches_jax():
    from hairgs_tpu.evaluation.eval_data import eval_points_device_from_gaussian as jext
    from hairgs_tpu.models.gaussian import GaussianModel as JModel
    from hairgs_tpu_torch.evaluation.eval_data import eval_points_device_from_gaussian
    from hairgs_tpu_torch.models.gaussian import GaussianModel

    rng = np.random.default_rng(11)
    n = 50
    jm = JModel(sh_degree=0, capacity_round=64)
    jm.create_from_pcd(rng.uniform(-0.1, 0.1, (n, 3)).astype(np.float32),
                       rng.uniform(0, 1, (n, 3)).astype(np.float32))
    cap = jm.params.opacity.shape[0]
    # opacities and masks on both sides of their thresholds
    jm.params = jm.params._replace(
        opacity=jnp.asarray(rng.normal(-4.0, 2.0, (cap, 1)).astype(np.float32)),
        mask=jnp.asarray(rng.normal(-1.0, 1.0, (cap, 1)).astype(np.float32)))
    tm = GaussianModel(sh_degree=0, capacity_round=64, device="cpu")
    tm.restore(jm.capture())
    pj, dj, vj = (np.asarray(a) for a in jext(jm))
    pt, dt, vt = (a.numpy() for a in eval_points_device_from_gaussian(tm))
    np.testing.assert_array_equal(vt, vj)
    assert 0 < vj.sum() < n
    np.testing.assert_allclose(pt[vj], pj[vj], rtol=0, atol=1e-6)
    np.testing.assert_allclose(dt[vj], dj[vj], rtol=0, atol=1e-6)


def test_hair_extractor_matches_jax():
    """On strands that the walk runs in their stored order the port's
    extractor equals JAX's; on a random scene, whose walk flips strands to
    start near the scalp, it gives the host converter's point and
    direction set, which JAX's does not (ROADMAP Queue 3)."""
    from hairgs_tpu.evaluation.eval_data import eval_points_device_from_hair as jext
    from hairgs_tpu_torch.evaluation.eval_data import (
        compute_eval_data_from_hair,
        eval_points_device_from_hair,
    )
    from tests.test_torch_port_topo import make_pair, random_scene, two_strands

    jm, tm = make_pair(*two_strands())
    pj, dj, vj = (np.asarray(a) for a in jext(jm))
    pt, dt, vt = (a.numpy() for a in eval_points_device_from_hair(tm))
    np.testing.assert_array_equal(vt, vj)
    assert vj.sum() == 4
    np.testing.assert_allclose(pt[vj], pj[vj], rtol=0, atol=1e-6)
    np.testing.assert_allclose(dt[vj], dj[vj], rtol=0, atol=1e-6)

    def rows(points, dirs):
        a = np.concatenate([points, dirs], axis=1)
        return a[np.lexsort(a.T)]

    eps, pairs, seg = random_scene(3)
    jm, tm = make_pair(eps, pairs, seg=seg, ref_root=[[0.0, 0.0, 0.05]])
    pt, dt, vt = (a.numpy() for a in eval_points_device_from_hair(tm))
    host = compute_eval_data_from_hair(tm)
    assert 0 < vt.sum() == host.points.shape[0] < tm.num_segments
    np.testing.assert_allclose(rows(pt[vt], dt[vt]),
                               rows(host.points, host.directions), rtol=0, atol=1e-6)
    pj, _, vj = (np.asarray(a) for a in jext(jm))
    assert not np.allclose(np.sort(pj[vj], axis=0), np.sort(host.points, axis=0))


@pytest.mark.parametrize("flag,device,want", [
    ("auto", "cpu", False), ("auto", "cuda", True),
    ("true", "cpu", True), ("true", "cuda", True),
    ("false", "cpu", False), ("false", "cuda", False)])
def test_device_eval_rule(flag, device, want):
    from hairgs_tpu_torch.drivers.train import use_device_eval

    assert use_device_eval(flag, torch.device(device)) is want


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    """The fixture scene of tests/test_pipeline.py, written by the port."""
    from hairgs_tpu_torch.data.synthetic import generate_dataset, synthetic_test_hair
    from hairgs_tpu_torch.render.renderer import RasterConfig

    root = tmp_path_factory.mktemp("scene")
    hair = synthetic_test_hair(num_strands=20, points_per_strand=8, seed=1)
    return generate_dataset(
        str(root / "data"), hair, num_cameras=6, width=64, height=64,
        cam_z=0.35, init_points="gt_hair_verts", init_subsample=3,
        raster_cfg=RasterConfig(max_tiles_per_gaussian=8, max_pairs_per_tile=128,
                                chunk=16), device="cpu")


class _EvalRecorder:
    """Keeps each new evaluation (the driver logs the last one on every
    iteration)."""

    def __init__(self):
        self.evals = []
        self._last = None

    def log(self, info, model):
        if info.eval_metrics is not None and info.eval_metrics is not self._last:
            self._last = info.eval_metrics
            self.evals.append((info.iter, info.eval_on_device,
                               {k: np.asarray(v) for k, v in info.eval_metrics.items()}))

    def close(self):
        pass


def test_stage1_driver_first_eval_on_the_device(scene_dir, tmp_path):
    """`--device_eval true` on the CPU: the iteration-0 evaluation takes
    the device path, the final one the host oracle; the first equals the
    host path's evaluation of the same initial model (`--device_eval
    false`) within 1e-6."""
    from hairgs_tpu_torch import config
    from hairgs_tpu_torch.drivers import train as driver

    names = ("ModelConfig", "OptimizationConfig", "GeneralConfig", "RuntimeConfig")
    parser = ArgumentParser()
    for name in names:
        config.add_config_args(parser, getattr(config, name))
    evals = {}
    for flag in ("true", "false"):
        argv = ["-s", scene_dir, "-m", str(tmp_path / flag), "--data_device", "cpu",
                "--iterations", "2", "--position_lr_max_steps", "2",
                "--save_frequency", "2", "--eval_frequency", "2",
                "--logger", "none", "--max_tiles_per_gaussian", "8",
                "--max_pairs_per_tile", "128", "--composite_chunk", "16",
                "--capacity_round", "256", "--device_eval", flag, "--ip", ""]
        args = parser.parse_args(argv)
        driver.prepare_output_path(args)
        rec = _EvalRecorder()
        stdout = sys.stdout
        try:
            random.seed(0)
            np.random.seed(0)
            driver.training(*(config.extract_config(args, getattr(config, n))
                              for n in names), args, logger=rec)
        finally:
            sys.stdout = stdout
        evals[flag] = rec.evals
    assert [(it, dev) for it, dev, _ in evals["true"]] == [(0, True), (2, False)]
    assert [(it, dev) for it, dev, _ in evals["false"]] == [(0, False), (2, False)]
    dev, host = evals["true"][0][2], evals["false"][0][2]
    for k in dev:
        np.testing.assert_allclose(dev[k], host[k], rtol=0, atol=1e-6, err_msg=k)
    assert dev["f1(b)"].max() > 0
    for k in evals["true"][1][2]:
        np.testing.assert_array_equal(evals["true"][1][2][k], evals["false"][1][2][k])
