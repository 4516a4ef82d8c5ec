"""Port parity, the Stage-I driver: the config surface, `Scene`, the camera
schedule and a short training run of hairgs_tpu_torch.drivers.train
against the root train.py on the CPU, on the 64 px scene of
tests/test_pipeline.py.

Tolerances: config fields, defaults and parsed flags equal (but the
documented `data_device` default); the Scene's camera order, extent and
arena equal (the initial log-scales within 1e-5, the kNN rounding); the
camera pops equal; in a 20-iteration run on the XLA path the loss at every
sync within 1e-4 relative up to the first densify event, the densify info
and counts equal at every event, the final parameters within 1e-3 in
relative L2 and the same files written.
"""

import dataclasses
import os
import random
import sys
from argparse import ArgumentParser

import numpy as np
import pytest
import torch

CONFIGS = ("ModelConfig", "OptimizationConfig", "GeneralConfig", "RuntimeConfig")
FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity", "mask")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers, and the
    idle OpenMP threads of a torch pool spin on cores the others need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    """The fixture scene of tests/test_pipeline.py, written by JAX."""
    from hairgs_tpu.data.synthetic import generate_dataset, synthetic_test_hair
    from hairgs_tpu.render.renderer import RasterConfig

    root = tmp_path_factory.mktemp("scene")
    hair = synthetic_test_hair(num_strands=20, points_per_strand=8, seed=1)
    return generate_dataset(
        str(root / "data"), hair, num_cameras=6, width=64, height=64,
        cam_z=0.35, init_points="gt_hair_verts", init_subsample=3,
        raster_cfg=RasterConfig(max_tiles_per_gaussian=8, max_pairs_per_tile=128,
                                chunk=16))


def _parser(config_module):
    p = ArgumentParser()
    for name in CONFIGS:
        config_module.add_config_args(p, getattr(config_module, name))
    return p


def _argv(source, model_path, iterations=20, extra=()):
    return ["-s", source, "-m", model_path, "--data_device", "cpu",
            "--iterations", str(iterations),
            "--position_lr_max_steps", str(iterations),
            "--densify_from_iter", "5", "--densification_interval", "5",
            "--opacity_reset_interval", "100000",
            "--save_frequency", str(iterations),
            "--eval_frequency", str(iterations), "--logger", "none",
            "--max_tiles_per_gaussian", "8", "--max_pairs_per_tile", "128",
            "--composite_chunk", "16", "--capacity_round", "256",
            "--log_interval", "1", *extra]


class _Recorder:
    """A logger that keeps, per logged iteration, the loss, the densify
    info and the count."""

    def __init__(self):
        self.rows = []

    def log(self, info, model):
        self.rows.append((info.iter, info.loss, dict(info.densification_info),
                          model.count))

    def close(self):
        pass


def _run(package, argv, monkeypatch, seed_with_safe_state=False, patches=()):
    """Run one package's Stage-I driver in-process; returns (recorder,
    scene, model)."""
    if package == "jax":
        import train as driver
        from hairgs_tpu import config, logging_utils
        from hairgs_tpu.system import safe_state
    else:
        from hairgs_tpu_torch import config, logging_utils
        from hairgs_tpu_torch.drivers import train as driver
        from hairgs_tpu_torch.system import safe_state
    rec = _Recorder()
    monkeypatch.setattr(logging_utils, "get_logger", lambda args: rec)
    for target, name, value in patches:
        monkeypatch.setattr(target, name, value)
    args = _parser(config).parse_args(argv)
    driver.prepare_output_path(args)
    stdout = sys.stdout
    try:
        if seed_with_safe_state:
            safe_state(False, seed=0)
        else:
            random.seed(0)
            np.random.seed(0)
        scene, model = driver.training(
            *(config.extract_config(args, getattr(config, c)) for c in CONFIGS), args)
    finally:
        sys.stdout = stdout
    return rec, scene, model


def test_config_dataclasses_match_jax():
    from hairgs_tpu import config as jc
    from hairgs_tpu_torch import config as tc

    for name in CONFIGS:
        j, t = getattr(jc, name)(), getattr(tc, name)()
        assert [f.name for f in dataclasses.fields(t)] == \
            [f.name for f in dataclasses.fields(j)], name
        dj, dt = dataclasses.asdict(j), dataclasses.asdict(t)
        if name == "ModelConfig":
            assert (dj.pop("data_device"), dt.pop("data_device")) == ("tpu", "cuda")
        assert dt == dj, name
    assert tc.RuntimeConfig().use_pallas == "auto"


def test_argv_parses_to_the_same_namespace(tmp_path):
    from hairgs_tpu import config as jc
    from hairgs_tpu_torch import config as tc

    argv = _argv("/data/scene", str(tmp_path), extra=(
        "--no-bidirectional_eval", "--feat_bf16", "--view_batch", "2",
        "--use_pallas", "true", "-r", "2", "--no-dma_lookahead"))
    nj, nt = _parser(jc).parse_args(argv), _parser(tc).parse_args(argv)
    assert vars(nt) == vars(nj)
    tc.save_cfg_args(str(tmp_path), nt)
    assert tc.load_cfg_args(str(tmp_path)) == jc.load_cfg_args(str(tmp_path)) == nj
    argv2 = ["-m", str(tmp_path), "--iterations", "7", "--data_device", "cpu"]
    merged = tc.get_combined_args(_parser(tc), argv2)
    assert merged == jc.get_combined_args(_parser(jc), argv2)
    assert merged.iterations == 7 and merged.source_path == ""
    help_text = _parser(tc).format_help()
    assert "ignored" in help_text and "dma_lookahead" in help_text


def test_scene_matches_jax(scene_dir, tmp_path):
    from hairgs_tpu.scene import Scene as JScene
    from hairgs_tpu_torch.scene import Scene

    def args(path):
        return _parser_args(scene_dir, path)

    random.seed(0)
    js = JScene(args(str(tmp_path / "j")), capacity_round=256)
    random.seed(0)
    ts = Scene(args(str(tmp_path / "t")), capacity_round=256)
    assert ts.cameras_extent == js.cameras_extent and ts.loaded_iter == js.loaded_iter == 0
    for ct, cj in zip(ts.get_cameras(), js.get_cameras(), strict=True):
        np.testing.assert_allclose(ct.world_view.numpy(), np.asarray(cj.world_view),
                                   rtol=0, atol=1e-6)
        np.testing.assert_array_equal(ct.image.numpy(), np.asarray(cj.image))
    tm, jm = ts.gaussians, js.gaussians
    assert (tm.count, tm.capacity, tm.spatial_lr_scale) == \
        (jm.count, jm.capacity, jm.spatial_lr_scale)
    for name in FIELDS:
        np.testing.assert_allclose(getattr(tm.params, name).numpy(),
                                   np.asarray(getattr(jm.params, name)),
                                   rtol=1e-5 if name == "scaling" else 0, atol=0,
                                   err_msg=name)
    np.testing.assert_array_equal(ts.gt.points, js.gt.points)
    np.testing.assert_array_equal(tm.ref_strand_root, jm.ref_strand_root)
    for f in ("input.ply", "cameras.json"):
        with open(tmp_path / "j" / f, "rb") as a, open(tmp_path / "t" / f, "rb") as b:
            assert a.read() == b.read(), f


def _parser_args(source, model_path):
    from hairgs_tpu_torch import config as tc

    return _parser(tc).parse_args(_argv(source, model_path))


def test_camera_pops_match_jax(scene_dir, tmp_path, monkeypatch):
    """Under safe_state(seed=0) the first 2 x N cameras each driver trains
    on (recorded by a stand-in step) are the same."""
    import hairgs_tpu.evaluation.image_metrics as jim
    import hairgs_tpu.train.trainer as jtrainer
    import hairgs_tpu_torch.evaluation.image_metrics as tim
    import hairgs_tpu_torch.train.trainer as ttrainer

    def fake_make_step(seen, zeros):
        def make(op, raster_cfg, **kw):
            def step(params, stats, opt_state, active, camera, step):
                seen.append(np.asarray(camera.cam_center).copy())
                metrics = {k: zeros() for k in ("loss", "psnr", "overflow_pairs",
                                                "overflow_tiles", "overflow_capacity",
                                                "pairs_demand")}
                return params, stats, opt_state, metrics, None
            return step
        return make

    import jax.numpy as jnp

    n = 6
    extra = ("--densify_until_iter", "0")
    seen_j, seen_t = [], []
    _run("jax", _argv(scene_dir, str(tmp_path / "j"), 2 * n, extra), monkeypatch,
         seed_with_safe_state=True,
         patches=[(jtrainer, "make_gaussian_train_step",
                   fake_make_step(seen_j, lambda: jnp.zeros(()))),
                  (jim, "evaluate_image_metrics", lambda *a, **k: {})])
    _run("torch", _argv(scene_dir, str(tmp_path / "t"), 2 * n, extra), monkeypatch,
         seed_with_safe_state=True,
         patches=[(ttrainer, "make_gaussian_train_step",
                   fake_make_step(seen_t, lambda: torch.zeros(()))),
                  (tim, "evaluate_image_metrics", lambda *a, **k: {})])
    assert len(seen_j) == len(seen_t) == 2 * n
    np.testing.assert_allclose(np.stack(seen_t), np.stack(seen_j), rtol=0, atol=1e-6)
    # every camera once per pass of the stack
    for half in (seen_t[:n], seen_t[n:]):
        assert len({tuple(np.round(c, 5)) for c in half}) == n


def test_stage1_run_matches_jax(scene_dir, tmp_path, monkeypatch):
    rj, _, mj = _run("jax", _argv(scene_dir, str(tmp_path / "j")), monkeypatch)
    rt, _, mt = _run("torch", _argv(scene_dir, str(tmp_path / "t")), monkeypatch)
    assert [r[0] for r in rt.rows] == [r[0] for r in rj.rows] == list(range(21))
    events = [r[0] for r in rj.rows if r[2]]
    assert events == [10, 15, 20]
    for (it, lj, dj, cj), (_, lt, dt, ct) in zip(rj.rows, rt.rows):
        assert dt == dj and ct == cj, it
        if lj is not None and it <= events[0]:
            assert abs(lt - lj) <= 1e-4 * abs(lj), (it, lt, lj)
    assert mt.count == mj.count > 54
    for name in FIELDS:
        a = np.asarray(getattr(mj.params, name))[: mj.count]
        b = getattr(mt.params, name)[: mt.count].numpy()
        if a.size:
            assert np.linalg.norm(b - a) <= 1e-3 * np.linalg.norm(a), name

    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    assert files(tmp_path / "t") == files(tmp_path / "j")
    assert "point_cloud/iteration_20/point_cloud.ply" in files(tmp_path / "t")


def test_paged_run_densifies_and_resumes(scene_dir, tmp_path, monkeypatch):
    """The port's driver on the paged path (the kernels' plain versions
    here): densify events, the stats rows dropped at the window's end, a
    checkpoint that a new Scene resumes from, and a resumed run."""
    from hairgs_tpu_torch.scene import Scene

    out = str(tmp_path / "paged")
    extra = ("--use_pallas", "true", "--densify_from_iter", "3",
             "--densification_interval", "3", "--densify_until_iter", "8")
    rec, scene, model = _run("torch", _argv(scene_dir, out, 10, extra), monkeypatch)
    assert [r[0] for r in rec.rows if r[2]] == [6]
    assert model.count > 54
    resumed = Scene(_parser_args(scene_dir, out), capacity_round=256)
    assert resumed.loaded_iter == 10 and resumed.gaussians.count == model.count
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(resumed.gaussians.params, name).numpy(),
                                      getattr(model.params, name).numpy(), err_msg=name)
    rec2, _, model2 = _run("torch", _argv(scene_dir, out, 3, extra), monkeypatch)
    assert rec2.rows[0][0] == 10 and rec2.rows[-1][0] == 13
    assert os.path.exists(os.path.join(out, "point_cloud", "iteration_13",
                                       "point_cloud.ply"))
    assert all(torch.isfinite(p).all() for p in model2.params)


def test_unported_branches_raise(scene_dir, tmp_path, monkeypatch):
    """The branches still to port raise naming their ROADMAP item; a
    5-element PLY (Stage II's output), which raised before the hair model
    was ported, now loads as a HairModel."""
    from hairgs_tpu_torch.models.hair import HairModel
    from hairgs_tpu_torch.scene import Scene

    for flags, item in ((("--gauss_shard", "2"), "item 9"),
                        (("--device_eval", "true"), "item 7")):
        with pytest.raises(NotImplementedError, match=f"Queue 1 {item}"):
            _run("torch", _argv(scene_dir, str(tmp_path / item), 2, flags), monkeypatch)
    hair = HairModel(sh_degree=0, capacity_round=64, device="cpu")
    ns = 2
    hair.install(np.array([[0, 0, 0.1], [0, 0.01, 0.1], [0, 0.02, 0.1]], np.float32),
                 np.array([[0, 1], [1, 2]]),
                 dict(features_dc=np.zeros((ns, 1, 3), np.float32),
                      features_rest=np.zeros((ns, 0, 3), np.float32),
                      opacity=np.zeros((ns, 1), np.float32),
                      mask=np.zeros((ns, 1), np.float32),
                      width=np.full((ns, 1), -8.0, np.float32)))
    hair.ref_strand_root = np.zeros((1, 3), np.float32)
    hair.save_ply(str(tmp_path / "hair" / "point_cloud" / "iteration_5" /
                      "point_cloud.ply"))
    scene = Scene(_parser_args(scene_dir, str(tmp_path / "hair")))
    assert isinstance(scene.gaussians, HairModel) and scene.loaded_iter == 5
    assert scene.gaussians.num_segments == 2
    assert len(scene.gaussians.strands_info.list_strands) == 1
