"""Port parity, the whole chain: hairgs_tpu_torch.drivers.pipeline's stages
(Stage I -> merge -> Stage III -> eval) through each port driver's main,
against the root train.py, merge.py and eval.py run as scripts with the
same argv, on the CPU at a tiny size; and the inputs of the reference scene
(run_reference_schedule.sh:15-25) against JAX's.

Tolerances, those of tests/test_torch_port_{driver,stage23}.py: the loss
at every sync within 1e-4 relative up to each train stage's first topology
event, the topology info and the counts equal at every logged iteration,
the merged graph equal and its float planes within 1e-5, the final F1 of
Stage III within 1e-3, the eval driver's metrics equal. The reference
scene's strands are bit-equal, and the COLMAP files (byte for byte) and the
npz data written for its 16 cameras at 512x512 equal; its images are not
rendered here. The scene has 6 cameras, as the fixtures of those files: on
a ring of 4, gradients that vanish by symmetry keep only their rounding,
whose sign Adam's first step turns into +-lr, and the two chains part
after iteration 1 (a property of both packages, ROADMAP Queue 3).
"""

import os
import random
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
TINY = ["--logger", "none", "--max_tiles_per_gaussian", "8", "--max_pairs_per_tile",
        "128", "--composite_chunk", "16", "--capacity_round", "2048",
        "--log_interval", "1", "--opacity_reset_interval", "100000", "--ip", "",
        "--densify_from_iter", "4", "--densification_interval", "5"]
STAGE1 = ["--iterations", "10", "--position_lr_max_steps", "10",
          "--save_frequency", "10", "--eval_frequency", "10", *TINY]
# short strands and a high gradient threshold keep the graph small
STAGE3 = ["--iterations", "8", "--position_lr_max_steps", "8",
          "--save_frequency", "8", "--eval_frequency", "8", "--merge_interval", "5",
          "--num_points_strand", "2", "--densify_grad_threshold", "1e-3",
          "--merge_dist_th_init", "0.02", "--merge_angle_th_init", "60", *TINY]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers, and the
    idle OpenMP threads of a torch pool spin on cores the others need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Recorder:
    """A logger that keeps, per logged iteration, the loss, the topology
    info (without its wall times) and the sizes, and the last strand
    metrics."""

    def __init__(self):
        self.rows = []
        self.metrics = None

    def log(self, info, model):
        dens = {k: v for k, v in info.densification_info.items()
                if not k.startswith("t_")}
        size = ((model.num_segments, len(model.strands_info.list_strands))
                if hasattr(model, "num_segments") else (model.count, 0))
        self.rows.append((info.iter, info.loss, dens, size))
        if info.eval_metrics is not None:
            self.metrics = info.eval_metrics

    def close(self):
        pass


def _run_stage(package, stage, argv, monkeypatch, rec):
    """One stage in-process: the port's driver main, or the root script
    run as __main__ with `argv` (JAX's eval.py has no --data_device)."""
    from hairgs_tpu_torch.drivers import pipeline

    stdout = sys.stdout
    try:
        if package == "torch":
            import importlib

            driver = importlib.import_module(pipeline.stage_module(stage))
            if stage == "merge":
                return driver.main(driver.build_parser().parse_args(argv))
            return driver.main(argv)
        if stage == "eval":
            i = argv.index("--data_device")
            argv = argv[:i] + argv[i + 2:]
        script = {"stage1": "train.py", "stage3": "train.py"}.get(stage, f"{stage}.py")
        monkeypatch.setattr(sys, "argv", [script, *argv])
        if stage == "eval":
            import eval as jeval

            return jeval.main()
        runpy.run_path(str(ROOT / script), run_name="__main__")
    finally:
        sys.stdout = stdout  # safe_state's timestamping wrapper


def _chain(package, scene, out, monkeypatch):
    """The pipeline's four stages for one package, as two pipeline runs
    (`--stages stage1,merge`, then `--stages stage3,eval` with Stage III's
    flags). Returns {stage: recorder or the driver's return value}."""
    import hairgs_tpu.logging_utils as jlog
    import hairgs_tpu_torch.logging_utils as tlog
    from hairgs_tpu_torch.drivers import pipeline

    got = {}
    for stages, flags in (("stage1,merge", STAGE1), ("stage3,eval", STAGE3)):
        args, todo, common = pipeline.parse(
            ["-s", scene, "-m", out, "--stages", stages, "--data_device", "cpu", *flags])
        for stage in todo:
            rec = _Recorder()
            monkeypatch.setattr(jlog if package == "jax" else tlog, "get_logger",
                                lambda args, rec=rec: rec)
            random.seed(0)
            np.random.seed(0)
            res = _run_stage(package, stage, pipeline.stage_argv(stage, args, common),
                             monkeypatch, rec)
            got[stage] = rec if stage.startswith("stage") else res
    return got


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    """A 20-strand scene at 64 px with 6 cameras (the port's
    generate_dataset, held to JAX's in tests/test_torch_port_io.py) and
    both chains on it."""
    from hairgs_tpu_torch.data.synthetic import generate_dataset, synthetic_test_hair
    from hairgs_tpu_torch.render.renderer import RasterConfig

    root = tmp_path_factory.mktemp("pipeline")
    scene = generate_dataset(
        str(root / "data"), synthetic_test_hair(20, 8, seed=0), num_cameras=6,
        width=64, height=64, cam_z=0.35, init_subsample=3,
        raster_cfg=RasterConfig(max_tiles_per_gaussian=8, max_pairs_per_tile=128,
                                chunk=16), device="cpu")
    mp = pytest.MonkeyPatch()
    try:
        out = {p: _chain(p, scene, str(root / p), mp) for p in ("jax", "torch")}
    finally:
        mp.undo()
    return root, out


def _same_run(rj, rt):
    """The train stages' gates: logged iterations, topology info and sizes
    equal everywhere, the loss within 1e-4 relative up to the first event."""
    assert [r[0] for r in rt.rows] == [r[0] for r in rj.rows]
    events = [r[0] for r in rj.rows if r[2]]
    assert events
    for (it, lj, dj, sj), (_, lt, dt, st) in zip(rj.rows, rt.rows):
        assert dt == dj and st == sj, it
        if lj is not None and it <= events[0]:
            assert abs(lt - lj) <= 1e-4 * abs(lj), (it, lt, lj)
    return events


def feed_jax_init_distances(monkeypatch):
    """Give the port's Stage-I init JAX's 3-NN distances. The principal axis
    (`argmax` over three scales, which the kNN init makes equal) is
    discontinuous where scales tie, and the port's distances differ from
    JAX's in the last bits (test_torch_port_model.py bounds them), so on
    some scenes a tie breaks the other way within a few steps and the
    orientation loss parts (ROADMAP, "Properties of the reference")."""
    import jax.numpy as jnp

    import hairgs_tpu_torch.ops.knn as tknn
    from hairgs_tpu.ops.knn import mean_sq_dist_3nn

    monkeypatch.setattr(tknn, "mean_sq_dist_3nn", lambda p, **k: torch.from_numpy(
        np.array(mean_sq_dist_3nn(jnp.asarray(p.cpu().numpy())))))


def test_pipeline_stages_match_jax(chains):
    from hairgs_tpu_torch.drivers import pipeline
    from hairgs_tpu_torch.io.ply import load_hair_ply

    root, out = chains
    (jx, tx) = out["jax"], out["torch"]
    assert _same_run(jx["stage1"], tx["stage1"]) == [5, 10]
    # the merge stage takes the default thresholds (the scripts pass it no
    # flags), under which a 64 px fit's segments, centimetres apart, stay
    # apart; Stage III's flags widen them
    assert tx["merge"]["metrics"] is not None
    merged = 10 + max(tx["merge"]["iterations"], 1)
    (aj, rj, fj), (at, rt, ft) = (
        load_hair_ply(str(root / p / "point_cloud" / f"iteration_{merged}" /
                          "point_cloud.ply"), 0) for p in ("jax", "torch"))
    np.testing.assert_array_equal(at["endpoint_pairs"], aj["endpoint_pairs"])
    np.testing.assert_array_equal(rt, rj)
    np.testing.assert_array_equal(ft, fj)
    for k in ("endpoints", "features_dc", "opacity", "mask", "width"):
        np.testing.assert_allclose(at[k], aj[k], rtol=0, atol=1e-5, err_msg=k)
    events = _same_run(jx["stage3"], tx["stage3"])
    assert events[0] > merged
    assert sum(r[2].get("merge", 0) for r in jx["stage3"].rows) > 0
    f1 = next(k for k in jx["stage3"].metrics if k.startswith("f1"))
    np.testing.assert_allclose(tx["stage3"].metrics[f1], jx["stage3"].metrics[f1],
                               rtol=0, atol=1e-3)
    assert pipeline.last_iteration(str(root / "torch")) == merged + 8
    assert tx["eval"].keys() == jx["eval"].keys()
    for k in jx["eval"]:
        np.testing.assert_array_equal(tx["eval"][k], jx["eval"][k], err_msg=k)


def test_pipeline_argv(tmp_path):
    """The stages' command lines: train flags go to both train stages only,
    the eval stage names the last checkpoint, and a bad --stages raises."""
    from hairgs_tpu_torch.drivers import pipeline

    args, stages, common = pipeline.parse(
        ["-s", "S", "-m", str(tmp_path), "--synthetic", "--iterations", "7"])
    assert stages == list(pipeline.STAGES) and args.synthetic
    assert common == ["--iterations", "7"]
    assert pipeline.stage_argv("stage3", args, common) == [
        "-s", "S", "-m", str(tmp_path), "--iterations", "7", "--data_device", "cuda"]
    assert pipeline.stage_argv("merge", args, common) == [
        "-s", "S", "-m", str(tmp_path), "--data_device", "cuda"]
    for it in (30000, 30017, 9):
        os.makedirs(tmp_path / "point_cloud" / f"iteration_{it}")
    assert pipeline.stage_argv("eval", args, common)[:4] == [
        "-s", "S", "-p", str(tmp_path / "point_cloud" / "iteration_30017" /
                             "point_cloud.ply")]
    assert pipeline.stage_module("stage1") == "hairgs_tpu_torch.drivers.train"
    for bad in ("merge,stage1", "stage2"):
        with pytest.raises(ValueError):
            pipeline.parse(["-s", "S", "-m", "M", "--stages", bad])


def test_reference_scene_inputs_match_jax(tmp_path, monkeypatch):
    """run_reference_schedule.sh's scene without its renders: the strands
    bit-equal, and the COLMAP cameras, images, points and npz data that
    each package's generate_dataset writes for 16 views at 512x512 equal
    byte for byte (the renders stubbed with zeros in both)."""
    import hairgs_tpu.data.synthetic as jsyn
    import hairgs_tpu_torch.data.synthetic as tsyn
    from hairgs_tpu_torch.drivers.pipeline import SYNTHETIC as S

    hj = jsyn.synthetic_test_hair(S["num_strands"], S["points_per_strand"], seed=S["seed"])
    ht = tsyn.synthetic_test_hair(S["num_strands"], S["points_per_strand"], seed=S["seed"])
    assert ht.edges.shape == (150 * 23, 2)
    for f in ht._fields:
        a, b = getattr(ht, f), getattr(hj, f)
        assert type(a) is type(b), f
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f
    hw = (S["height"], S["width"])
    monkeypatch.setattr(jsyn, "render_strand_view",
                        lambda *a, **k: (np.zeros(hw + (3,)), *(np.zeros(hw),) * 3))
    monkeypatch.setattr(tsyn, "_render_strand_channels",
                        lambda *a, **k: (None, None, None))
    monkeypatch.setattr(tsyn, "_view_maps",
                        lambda *a: (np.zeros(hw + (3,)), *(np.zeros(hw),) * 3))
    kw = dict(num_cameras=S["num_cameras"], width=S["width"], height=S["height"])
    jsyn.generate_dataset(str(tmp_path / "j"), hj, **kw)
    tsyn.generate_dataset(str(tmp_path / "t"), ht, device="cpu", **kw)
    for f in ("cameras.bin", "images.bin", "points3D.bin"):
        f = f"sparse/0/{f}"
        assert (tmp_path / "t" / f).read_bytes() == (tmp_path / "j" / f).read_bytes(), f
    for f in ("hair_eval_data.npz", "head_reconstruction_data.npz"):
        (a, b) = (np.load(tmp_path / p / f) for p in ("t", "j"))
        assert sorted(a) == sorted(b), f
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (f, k)
    assert len(os.listdir(tmp_path / "t" / "images")) == 16
