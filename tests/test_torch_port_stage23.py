"""Port parity, Stage II, Stage III and evaluation end to end: the merge
driver, the Stage-III `training()` and the eval driver of hairgs_tpu_torch
against the root merge.py, train.py and eval.py on the CPU, on the 64 px
scene of tests/test_pipeline.py, from one Stage-I PLY that JAX's driver
writes.

Tolerances: the merged graph, strand roots and iteration count equal and
the float planes within 1e-5; in a 15-iteration Stage-III run on the XLA
path (densify and merge every 5, one growth event) the loss at every sync
within 1e-4 relative up to the first topology event, the event info and
the segment and strand counts equal at every event, the final F1 within
1e-3; the eval driver's metric table equal to eval.py's; the same for a
12-iteration run with the topology events on the worker thread.
"""

import os
import random
import shutil
import sys
from argparse import ArgumentParser

import numpy as np
import pytest
import torch

CONFIGS = ("ModelConfig", "OptimizationConfig", "GeneralConfig", "RuntimeConfig")
SEG_KEYS = ("features_dc", "features_rest", "opacity", "mask", "width")
COMMON = ["--data_device", "cpu", "--logger", "none", "--max_tiles_per_gaussian", "8",
          "--max_pairs_per_tile", "128", "--composite_chunk", "16",
          "--capacity_round", "256", "--log_interval", "1"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers, and the
    idle OpenMP threads of a torch pool spin on cores the others need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stage_argv(source, model_path, iterations, extra=()):
    return ["-s", source, "-m", model_path, "--iterations", str(iterations),
            "--position_lr_max_steps", str(iterations), "--densify_from_iter", "4",
            "--densification_interval", "5", "--opacity_reset_interval", "100000",
            "--save_frequency", str(iterations), "--eval_frequency", str(iterations),
            *COMMON, *extra]


def _parser(config_module, merge=False):
    p = ArgumentParser()
    for name in CONFIGS:
        config_module.add_config_args(p, getattr(config_module, name))
    if merge:
        p.add_argument("--clean", action="store_true")
    return p


class _Recorder:
    """A logger that keeps, per logged iteration, the loss, the topology
    info (without its wall times), the segment and strand counts, and the
    last strand metrics."""

    def __init__(self):
        self.rows = []
        self.metrics = None

    def log(self, info, model):
        dens = {k: v for k, v in info.densification_info.items()
                if not k.startswith("t_")}
        size = (model.num_segments, len(model.strands_info.list_strands)) \
            if hasattr(model, "num_segments") else (model.count, 0)
        self.rows.append((info.iter, info.loss, dens, size))
        if info.eval_metrics is not None:
            self.metrics = info.eval_metrics

    def close(self):
        pass


def _train(package, argv, monkeypatch):
    if package == "jax":
        import train as driver
        from hairgs_tpu import config, logging_utils
    else:
        from hairgs_tpu_torch import config, logging_utils
        from hairgs_tpu_torch.drivers import train as driver
    rec = _Recorder()
    monkeypatch.setattr(logging_utils, "get_logger", lambda args: rec)
    args = _parser(config).parse_args(argv)
    driver.prepare_output_path(args)
    stdout = sys.stdout
    try:
        random.seed(0)
        np.random.seed(0)
        scene, model = driver.training(
            *(config.extract_config(args, getattr(config, c)) for c in CONFIGS), args)
    finally:
        sys.stdout = stdout
    return rec, scene, model


@pytest.fixture(scope="module")
def stage1(tmp_path_factory):
    """The fixture scene of tests/test_pipeline.py (made by the port's
    generate_dataset, which tests/test_torch_port_driver.py holds to
    JAX's) and a 12-iteration Stage-I model directory written by JAX's
    driver (densify events at 5 and 10; a capacity bucket the count never
    leaves)."""
    from hairgs_tpu_torch.data.synthetic import generate_dataset, synthetic_test_hair
    from hairgs_tpu_torch.render.renderer import RasterConfig

    root = tmp_path_factory.mktemp("stage23")
    hair = synthetic_test_hair(num_strands=20, points_per_strand=8, seed=1)
    source = generate_dataset(
        str(root / "data"), hair, num_cameras=6, width=64, height=64,
        cam_z=0.35, init_points="gt_hair_verts", init_subsample=3,
        raster_cfg=RasterConfig(max_tiles_per_gaussian=8, max_pairs_per_tile=128,
                                chunk=16), device="cpu")
    model = str(root / "stage1")
    mp = pytest.MonkeyPatch()
    try:
        _train("jax", _stage_argv(source, model, 12, ("--capacity_round", "2048",
                                                         "--densify_grad_threshold", "5e-4")), mp)
    finally:
        mp.undo()
    return source, model


def _merge(package, source, model_path):
    if package == "jax":
        import merge as driver
        from hairgs_tpu import config
    else:
        from hairgs_tpu_torch import config
        from hairgs_tpu_torch.drivers import merge as driver
    # a 64 px fit's segments lie centimetres apart: wide thresholds give
    # several merge iterations
    args = _parser(config, merge=True).parse_args(
        ["-s", source, "-m", model_path, *COMMON, "--merge_dist_th_init", "0.02",
         "--merge_angle_th_init", "60"])
    stdout = sys.stdout
    try:
        return driver.main(args)
    finally:
        sys.stdout = stdout


def _hair_state(ply):
    from hairgs_tpu_torch.io.ply import load_hair_ply

    return load_hair_ply(ply, 0)


@pytest.fixture(scope="module")
def merged(stage1, tmp_path_factory):
    """Both merge drivers on copies of the Stage-I directory."""
    source, model = stage1
    root = tmp_path_factory.mktemp("merged")
    dirs = {}
    for package in ("jax", "torch"):
        dirs[package] = str(root / package)
        shutil.copytree(model, dirs[package])
        out = _merge(package, source, dirs[package])
    return source, dirs, out


def _last_ply(model_path):
    from hairgs_tpu_torch.scene import search_for_max_iteration

    it = search_for_max_iteration(os.path.join(model_path, "point_cloud"))
    return it, os.path.join(model_path, "point_cloud", f"iteration_{it}",
                            "point_cloud.ply")


def test_merge_driver_matches_jax(merged):
    _, dirs, out = merged
    (it_j, ply_j), (it_t, ply_t) = _last_ply(dirs["jax"]), _last_ply(dirs["torch"])
    assert it_t == it_j == 12 + out["iterations"] and out["iterations"] >= 2
    (aj, rj, fj), (at, rt, ft) = _hair_state(ply_j), _hair_state(ply_t)
    np.testing.assert_array_equal(at["endpoint_pairs"], aj["endpoint_pairs"])
    np.testing.assert_array_equal(rt, rj)
    np.testing.assert_array_equal(ft, fj)
    for k in ("endpoints",) + SEG_KEYS:
        np.testing.assert_allclose(at[k], aj[k], rtol=0, atol=1e-5, err_msg=k)
    segs, eps, strands = out["converted"]
    rows = out["rows"]
    assert all(r["strands"] <= strands for r in rows)
    assert [r["strands"] for r in rows] == sorted((r["strands"] for r in rows),
                                                  reverse=True)
    assert all(r["segments"] == segs for r in rows) and out["metrics"] is not None


def test_stage3_run_matches_jax(merged, tmp_path, monkeypatch):
    """Stage III from the merged directories: the Scene dispatches to the
    hair model on both sides."""
    from hairgs_tpu_torch.models.hair import HairModel

    source, dirs, _ = merged
    # short strands and a high gradient threshold keep the graph small; a
    # capacity bucket it never leaves keeps JAX to one compiled step
    extra = ("--merge_interval", "5", "--growth_interval", "10",
             "--growth_max_events", "1", "--num_points_strand", "2",
             "--densify_grad_threshold", "1e-3", "--capacity_round", "2048")
    runs = {}
    for package in ("jax", "torch"):
        path = str(tmp_path / package)
        shutil.copytree(dirs[package], path)
        runs[package] = _train(package, _stage_argv(source, path, 15, extra), monkeypatch)
    (rj, _, mj), (rt, st, mt) = runs["jax"], runs["torch"]
    assert isinstance(mt, HairModel)
    assert [r[0] for r in rt.rows] == [r[0] for r in rj.rows]
    events = [r[0] for r in rj.rows if r[2]]
    assert len(events) == 3 and any("grow" in r[2] for r in rj.rows)
    for (it, lj, dj, sj), (_, lt, dt, s_t) in zip(rj.rows, rt.rows):
        assert dt == dj and s_t == sj, it
        if lj is not None and it <= events[0]:
            assert abs(lt - lj) <= 1e-4 * abs(lj), (it, lt, lj)
    f1 = next(k for k in rj.metrics if k.startswith("f1"))
    np.testing.assert_allclose(rt.metrics[f1], rj.metrics[f1], rtol=0, atol=1e-3)
    assert all(torch.isfinite(p).all() for p in mt.params)
    it, ply = _last_ply(str(tmp_path / "torch"))
    assert it == st.loaded_iter + 15 and os.path.exists(ply)


def test_eval_driver_matches_jax(merged, capsys, monkeypatch):
    """The strand metrics of the final hair PLY: the port's eval driver
    (with -m, which also renders the image metrics) against eval.py."""
    import eval as jeval
    from hairgs_tpu_torch.drivers import eval as teval

    source, dirs, _ = merged
    _, ply = _last_ply(dirs["torch"])
    argv = ["-s", source, "-p", ply]
    monkeypatch.setattr(sys, "argv", ["eval.py", *argv])
    mj = jeval.main()
    out_j = capsys.readouterr().out
    mt = teval.main([*argv, "-m", dirs["torch"], "--data_device", "cpu"])
    out_t = capsys.readouterr().out
    assert mt.keys() == mj.keys()
    for k in mj:
        np.testing.assert_array_equal(mt[k], mj[k], err_msg=k)
    table = [line for line in out_t.splitlines()
             if not line.startswith(("GT loaded", "Loaded", "Head", "image metrics"))]
    assert table == out_j.splitlines()
    im = [line for line in out_t.splitlines() if line.startswith("image metrics")]
    assert len(im) == 1 and "psnr" in im[0] and "ssim" in im[0]


def test_async_topology_on_a_hair_model_raises(merged, tmp_path, monkeypatch):
    """`--async_topology` on a hair model, which raised before
    topo/async_events.py was ported, now trains: a 12-iteration Stage-III
    run of each package's driver with the densify and merge events on the
    worker (launched at 5 and 10, growth at 10). Each launch waits for its
    thread here, so the next step's poll installs it in both packages and
    the runs are comparable; the loss within 1e-4 relative up to the first
    install, the event info and the sizes equal at every iteration, the
    final F1 within 1e-3."""
    from hairgs_tpu.topo import async_events as jae
    from hairgs_tpu_torch.topo import async_events as tae

    for module in (jae, tae):
        launch = module.TopologyWorker.launch

        def launch_and_join(self, *a, _launch=launch, **k):
            _launch(self, *a, **k)
            self._thread.join()

        monkeypatch.setattr(module.TopologyWorker, "launch", launch_and_join)
    source, dirs, _ = merged
    extra = ("--async_topology", "--merge_interval", "5", "--growth_interval",
             "10", "--growth_max_events", "1", "--num_points_strand", "2",
             "--densify_grad_threshold", "1e-3", "--capacity_round", "2048")
    runs = {}
    for package in ("jax", "torch"):
        path = str(tmp_path / package)
        shutil.copytree(dirs[package], path)
        runs[package] = _train(package, _stage_argv(source, path, 12, extra), monkeypatch)
    (rj, _, _), (rt, _, mt) = runs["jax"], runs["torch"]
    assert [r[0] for r in rt.rows] == [r[0] for r in rj.rows]
    start = rj.rows[0][0]
    installs = [r[0] - start for r in rj.rows if "merge" in r[2]]
    assert installs == [6, 11]
    for (it, lj, dj, sj), (_, lt, dt, s_t) in zip(rj.rows, rt.rows):
        assert dt == dj and s_t == sj, it
        if lj is not None and it - start <= installs[0]:
            assert abs(lt - lj) <= 1e-4 * abs(lj), (it, lt, lj)
    f1 = next(k for k in rj.metrics if k.startswith("f1"))
    np.testing.assert_allclose(rt.metrics[f1], rj.metrics[f1], rtol=0, atol=1e-3)
    assert all(torch.isfinite(p).all() for p in mt.params)


def _strands(info):
    return [s.tolist() for s in info.list_strands]


def test_strands_walked_at_an_event_equal_the_checkpoints(merged, tmp_path, monkeypatch):
    """The strands info a Stage-III run ends with, walked in-process at its
    last topology event (at the run's last iteration here), equals the
    strands each package's Scene walks again when it loads the checkpoint
    saved there: the walk on load is the walk at events. After that event
    the in-training evaluations read the event's strands info
    (`model.strands_info`), not the checkpoint's: once a segment leaves the
    foreground (opacity under its threshold, as training does between
    events), the checkpoint's strands differ from the event's and equal a
    fresh walk of the model."""
    from types import SimpleNamespace

    from hairgs_tpu.scene import Scene as JScene
    from hairgs_tpu_torch.models.hair import OPACITY_TH
    from hairgs_tpu_torch.scene import Scene
    from hairgs_tpu_torch.topo.strands import compute_strands_info

    source, dirs, _ = merged
    path = str(tmp_path / "run")
    shutil.copytree(dirs["torch"], path)
    extra = ("--merge_interval", "5", "--num_points_strand", "2",
             "--densify_grad_threshold", "1e-3", "--capacity_round", "2048")
    rec, scene, model = _train("torch", _stage_argv(source, path, 15, extra), monkeypatch)
    end = scene.loaded_iter + 15
    assert max(r[0] for r in rec.rows if r[2]) == end
    args = SimpleNamespace(source_path=source, model_path=path, images="images",
                           resolution=-1, sh_degree=0, data_device="cpu", eval=False)

    def loaded():
        return [_strands(S(args, shuffle=False).gaussians.strands_info)
                for S in (Scene, JScene)]

    at_event = _strands(model.strands_info)
    assert len(at_event) > 1
    assert loaded() == [at_event, at_event]
    # one middle segment of a strand of 3+ leaves the foreground: the
    # checkpoint saved after it splits that strand, the event's info does not
    rows = next(r for r in model.strands_info.list_strands_segments_id if len(r) >= 3)
    opacity = model.params.opacity.clone()
    opacity[int(rows[1])] = float(np.log(OPACITY_TH / 2 / (1 - OPACITY_TH / 2)))
    model.params = model.params._replace(opacity=opacity)
    model.save_ply(os.path.join(path, "point_cloud", f"iteration_{end + 1}",
                                "point_cloud.ply"))
    fresh = _strands(compute_strands_info(model, store=False))
    assert len(fresh) == len(at_event) + 1
    assert loaded() == [fresh, fresh]
