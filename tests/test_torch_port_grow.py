"""Port parity, Stage II.5 and the 1k recipe: hairgs_tpu_torch's grow driver
(`drivers/grow_and_save.py`, through its main) against
scripts/grow_and_save.py (run with runpy and the same argv) on the CPU,
from one tiny post-merge hair checkpoint; and `drivers/pipeline.py
--recipe 1k` against scripts/run_reference_schedule_1k.sh, with no training.

The checkpoint: the 20 strands of synthetic_test_hair(20, 8, seed 0) in
3 mm segments, a fifth of them dropped (pieces whose tips face each other
across a 3 mm gap, which growth closes and the merge pass welds), three
background segments that go on from a piece's tip, and six loose
background segments, saved at iteration 30017 beside a 64 px scene with 6
cameras. The port's growth extends only tips that are an endpoint of one
segment; JAX's also extends the three tips with a background segment
(ROADMAP Queue 3), so JAX's side runs with those strands left out of its
strands info at each event, as tests/test_torch_port_topo.py holds them.

Tolerances: new segments per event, segment and strand counts, the graph
and the strand roots equal; the saved iteration base + events; endpoints
within 1e-6 absolute; the eval driver's metrics on both outputs within
1e-6. The recipe: every stage's argv equal to the shell script's command
line (COMMON, Stage III's extras and the grow and eval lines read from the
script itself), its skip and resume decisions on fake run directories, and
the 1000x1000 scene's COLMAP files and npz data equal to JAX's, byte for
byte (no image rendered).
"""

import os
import re
import runpy
import shlex
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
SCRIPT_1K = ROOT / "scripts" / "run_reference_schedule_1k.sh"
BASE = 30017
SEG_KEYS = ("features_dc", "features_rest", "opacity", "mask", "width")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers, and the
    idle OpenMP threads of a torch pool spin on cores the others need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _logit(u):
    return np.log(u / (1 - u)).astype(np.float32)


def _post_merge_graph(hair, rng):
    """(endpoints, pairs, segment planes, branching tips) of the fixture."""
    eps, pairs, fg = [], [], []
    tips = []
    for pts in hair.verts.reshape(-1, 8, 3).astype(np.float64):
        fine = np.asarray([pts[i] + (pts[i + 1] - pts[i]) * t
                           for i in range(7) for t in (0, .25, .5, .75)] + [pts[7]])
        fine = fine + rng.normal(0, 1e-4, fine.shape)
        keep = rng.uniform(size=len(fine) - 1) > 0.2
        j = 0
        while j < len(keep):  # one piece per run of kept segments
            if not keep[j]:
                j += 1
                continue
            base = len(eps)
            k = j
            while k < len(keep) and keep[k]:
                k += 1
            eps += list(fine[j:k + 1])
            pairs += [[base + i, base + i + 1] for i in range(k - j)]
            fg += [True] * (k - j)
            tips.append(base + k - j)
            j = k
    branching = [tips[i] for i in rng.choice(len(tips), 3, replace=False)]
    for tip in branching:  # a background segment going on from a tip
        eps.append(eps[tip] + rng.normal(0, 3e-3, 3))
        pairs.append([tip, len(eps) - 1])
        fg.append(False)
    for _ in range(6):  # loose background segments
        p = rng.uniform(-0.1, 0.1, 3)
        eps += [p, p + rng.normal(0, 3e-3, 3)]
        pairs.append([len(eps) - 2, len(eps) - 1])
        fg.append(False)
    ns = len(pairs)
    fg = np.asarray(fg)
    seg = dict(
        features_dc=rng.normal(0, 0.5, (ns, 1, 3)).astype(np.float32),
        features_rest=np.zeros((ns, 0, 3), np.float32),
        opacity=_logit(rng.uniform(0.3, 0.9, (ns, 1))),
        mask=np.where(fg[:, None], _logit(np.float64(0.9)), _logit(np.float64(0.1))),
        width=np.log(rng.uniform(1e-4, 3e-4, (ns, 1))).astype(np.float32),
    )
    return (np.asarray(eps, np.float32), np.asarray(pairs, np.int64), seg,
            len(branching))


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """(scene dir, model dir, branching tips) of the fixture checkpoint."""
    from hairgs_tpu_torch.data.synthetic import generate_dataset, synthetic_test_hair
    from hairgs_tpu_torch.io.npz import load_head_reconstruction_data_npz
    from hairgs_tpu_torch.models.hair import HairModel
    from hairgs_tpu_torch.render.renderer import RasterConfig
    from hairgs_tpu_torch.topo.strands import update_strand_root

    root = tmp_path_factory.mktemp("grow")
    hair = synthetic_test_hair(20, 8, seed=0)
    scene = generate_dataset(
        str(root / "data"), hair, num_cameras=6, width=64, height=64, cam_z=0.35,
        init_subsample=3, device="cpu",
        raster_cfg=RasterConfig(max_tiles_per_gaussian=8, max_pairs_per_tile=128, chunk=16))
    eps, pairs, seg, n_branching = _post_merge_graph(hair, np.random.default_rng(0))
    m = HairModel(sh_degree=0, capacity_round=256, device="cpu")
    m.install(eps, pairs, seg)
    m.ref_strand_root = load_head_reconstruction_data_npz(
        os.path.join(scene, "head_reconstruction_data.npz")).scalp_verts
    update_strand_root(m)
    m.save_ply(str(root / "model" / "point_cloud" / f"iteration_{BASE}" / "point_cloud.ply"))
    return scene, str(root / "model"), n_branching


def _jax_grow(argv, monkeypatch, capsys):
    """scripts/grow_and_save.py as __main__, each growth event with the
    strands whose tip goes on into another segment left out of JAX's
    strands info. Returns (new segments per event, how many of them the
    strands info walked after the event holds, strands left out at the first
    event, the script's output)."""
    import hairgs_tpu.topo.graph_ops as jops

    original = jops.hair_growing
    grown, joined, left_out = [], [], []

    def grow_without_branching(model, **kw):
        pairs = np.asarray(model.host_arrays()["endpoint_pairs"], np.int64)
        degree = np.bincount(pairs.ravel(), minlength=model.num_endpoints)
        info = model.strands_info
        keep = [degree[s[-1, 1]] == 1 for s in info.list_strands]
        left_out.append(keep.count(False))
        model.strands_info = info._replace(
            list_strands=[s for s, k in zip(info.list_strands, keep) if k],
            list_strands_segments_id=[r for r, k in zip(
                info.list_strands_segments_id, keep) if k])
        first_new = model.num_endpoints
        grown.append(original(model, **kw))
        ids = np.unique(np.concatenate(model.strands_info.list_strands).ravel())
        joined.append(int((ids >= first_new).sum()))
        return grown[-1]

    monkeypatch.setattr(jops, "hair_growing", grow_without_branching)
    monkeypatch.setattr(sys, "argv", ["grow_and_save.py", *argv])
    stdout = sys.stdout
    capsys.readouterr()
    try:
        runpy.run_path(str(ROOT / "scripts" / "grow_and_save.py"), run_name="__main__")
    finally:
        sys.stdout = stdout
    return grown, joined, left_out[0], capsys.readouterr().out


def _eval(package, scene, ply, monkeypatch):
    if package == "torch":
        from hairgs_tpu_torch.drivers import eval as teval

        return teval.main(["-s", scene, "-p", ply, "-pt", "gs", "--data_device", "cpu"])
    import eval as jeval

    monkeypatch.setattr(sys, "argv", ["eval.py", "-s", scene, "-p", ply, "-pt", "gs"])
    return jeval.main()


@pytest.mark.parametrize("smooth_lam", ["0", "0.25"])
@pytest.mark.parametrize("merge_iters", ["0", "30"])
@pytest.mark.parametrize("events", ["1", "2"])
def test_grow_driver_matches_jax(checkpoint, tmp_path, monkeypatch, capsys, events,
                                 merge_iters, smooth_lam):
    from hairgs_tpu_torch.drivers import grow_and_save
    from hairgs_tpu_torch.io.ply import load_hair_ply

    scene, model, n_branching = checkpoint
    flags = ["--events", events, "--merge_iters", merge_iters, "--smooth_lam", smooth_lam]
    argv = lambda out: ["-s", scene, "-m", model, "--out", str(tmp_path / out), *flags]
    got = grow_and_save.main([*argv("torch"), "--data_device", "cpu"])
    j_grown, j_joined, j_left_out, j_out = _jax_grow(argv("jax"), monkeypatch, capsys)

    assert got["grown"] == j_grown and got["grown"][0] > 0
    assert got["joined"] == j_joined and got["joined"][0] > 0
    assert got["branching_tips"] == j_left_out == n_branching
    want = f"iteration_{BASE + int(events)}"
    j_ply = str(tmp_path / "jax" / "point_cloud" / want / "point_cloud.ply")
    assert got["path"] == str(tmp_path / "torch" / "point_cloud" / want / "point_cloud.ply")
    if merge_iters == "0":
        assert got["strands"] is None and "merge pass" not in j_out
    else:
        m = re.search(r"merge pass: (\d+) -> (\d+) strands", j_out)
        assert got["strands"] == (int(m.group(1)), int(m.group(2)))
        if events == "2":
            assert got["strands"][1] < got["strands"][0]  # the pass welds grown tips
    (at, rt, ft), (aj, rj, fj) = (load_hair_ply(p, 0) for p in (got["path"], j_ply))
    np.testing.assert_array_equal(at["endpoint_pairs"], aj["endpoint_pairs"])
    np.testing.assert_array_equal(rt, rj)
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_allclose(at["endpoints"], aj["endpoints"], rtol=0, atol=1e-6)
    for k in SEG_KEYS:
        np.testing.assert_array_equal(at[k], aj[k], err_msg=k)
    mt, mj = (_eval(p, scene, ply, monkeypatch) for p, ply in
              (("torch", got["path"]), ("jax", j_ply)))
    assert mt.keys() == mj.keys() == got["metrics"].keys()
    for k in mj:
        np.testing.assert_allclose(mt[k], mj[k], rtol=0, atol=1e-6, err_msg=k)
        np.testing.assert_array_equal(got["metrics"][k], mt[k], err_msg=k)


def test_grow_driver_refuses_a_later_checkpoint(checkpoint, tmp_path):
    """The driver grows the base iteration only: an output directory that
    already holds a later checkpoint raises, as JAX's assert does."""
    from hairgs_tpu_torch.drivers import grow_and_save

    scene, model, _ = checkpoint
    later = tmp_path / "out" / "point_cloud" / f"iteration_{BASE + 2}"
    later.mkdir(parents=True)
    shutil.copy(Path(model) / "point_cloud" / f"iteration_{BASE}" / "point_cloud.ply", later)
    with pytest.raises(ValueError, match="past the base iteration"):
        grow_and_save.main(["-s", scene, "-m", model, "--out", str(tmp_path / "out"),
                            "--base_iter", str(BASE), "--data_device", "cpu"])


# --- the 1k recipe against run_reference_schedule_1k.sh ---------------------

def _script_lines():
    """The shell script's logical lines (continuations joined)."""
    return SCRIPT_1K.read_text().replace("\\\n", " ").splitlines()


def _script_common():
    text = SCRIPT_1K.read_text().replace("\\\n", " ")
    return shlex.split(re.search(r'^COMMON="([^"]*)"', text, re.M).group(1))


def _script_commands(program, env, raw=False):
    """Every command line of the script that runs `program`, its
    variables substituted from `env`, as argv lists after the program (as
    the substituted text with `raw`)."""
    out = []
    for line in _script_lines():
        i = line.find(f"python {program}")
        if i < 0:
            continue
        line = line[i:].split(">")[0].split("||")[0].split("&&")[0]
        for k, v in env.items():
            line = line.replace("${%s}" % k, v).replace("$" + k, v)
        out.append(line if raw else shlex.split(line)[2:])
    return out


def _fake_run(tmp_path, iterations=(), files=()):
    run = tmp_path / "run"
    for it in iterations:
        (run / "model" / "point_cloud" / f"iteration_{it}").mkdir(parents=True, exist_ok=True)
    for name, text in dict(files).items():
        (run / name).parent.mkdir(parents=True, exist_ok=True)
        (run / name).write_text(text)
    run.mkdir(exist_ok=True)
    return run


def _steps(run, stage, extra=()):
    from hairgs_tpu_torch.drivers import pipeline

    args, _, common = pipeline.parse(["-s", str(run / "data"), "-m", str(run / "model"),
                                      "--recipe", "1k", "--data_device", "cpu", *extra])
    steps = pipeline.stage_steps(stage, args, common)
    if isinstance(steps, str):
        return steps
    out = []
    for name, make, tee, _ in steps:
        argv = make()
        i = argv.index("--data_device")
        assert argv[i + 1] == "cpu"
        out.append((name, argv[:i] + argv[i + 2:], tee and os.path.basename(tee)))
    return out


def test_recipe_1k_argv_matches_the_script(tmp_path):
    """Every stage's argv equals the script's command line, variables as
    the script sets them on a run at each step."""
    from hairgs_tpu_torch.drivers import pipeline

    assert pipeline.RECIPE_1K_COMMON == _script_common()
    lines = _script_lines()
    s3 = next(line for line in lines if "train_to $((POST_MERGE + 30000))" in line)
    assert pipeline.RECIPE_1K_STAGE3 == shlex.split(s3.split("))", 1)[1])
    assert any(line.strip() == "train_to 30000" for line in lines)
    run = str(tmp_path / "run")
    env = dict(RUN=run, DATA=f"{run}/data", OUT=f"{run}/model", COMMON=" ".join(
        _script_common()))
    train = _script_commands("train.py", env, raw=True)
    assert len(train) == 1  # train_to's command; "$@" the stage's extras

    def shell_train(extra, n):
        return shlex.split(train[0].replace('"$@"', " ".join(extra)).replace(
            "$((target - cur))", str(n)))[2:]

    # Stage I from nothing, then resumed at 5000
    assert _steps(_fake_run(tmp_path), "stage1") == [("stage1", shell_train([], 30000), None)]
    run_p = _fake_run(tmp_path, [5000])
    assert _steps(run_p, "stage1") == [("stage1", shell_train([], 25000), None)]
    merge = _steps(_fake_run(tmp_path, [30000]), "merge")
    assert merge == [("merge", ["-s", f"{run}/data", "-m", f"{run}/model"], None)]
    # Stage II.5 and Stage III after a merge to 30017
    run_p = _fake_run(tmp_path, [30017], {"post_merge_iter.txt": "30017\n"})
    (run_p / "grown_postmerge" / "point_cloud" / "iteration_30019").mkdir(parents=True)
    env.update(POST_MERGE="30017", GLAST="30019")
    grow_cmds = _script_commands("scripts/grow_and_save.py", env)
    eval_cmds = _script_commands("eval.py", env)
    assert _steps(run_p, "grow") == [("grow", grow_cmds[0], None),
                                     ("grow_eval", eval_cmds[0], "growth_eval.txt")]
    assert _steps(run_p, "stage3") == [
        ("stage3", shell_train(pipeline.RECIPE_1K_STAGE3, 30000), None)]
    # the end, after Stage III reached 60017 and the final growth to 60019
    run_p = _fake_run(tmp_path, [60017])
    (run_p / "grown_final" / "point_cloud" / "iteration_60019").mkdir(parents=True)
    env.update(LAST="60017", GLAST="60019")
    eval_cmds = _script_commands("eval.py", env)
    assert _steps(run_p, "eval") == [
        ("eval", eval_cmds[1], "final_eval.txt"),
        ("grow_final", _script_commands("scripts/grow_and_save.py", env)[1], None),
        ("grow_final_eval", eval_cmds[2], "grown_final_eval.txt")]


def test_recipe_1k_skips_and_resumes(tmp_path):
    """train_to's resume, and each step skipped when its output is there:
    a latest iteration_N gives --iterations target - N; the merge only at
    the Stage-I target and without post_merge_iter.txt; Stage II.5 without
    growth_eval.txt; Stage III from the post-merge iteration, not the grown
    directory's; --iterations sets both stages' lengths."""
    run = _fake_run(tmp_path, [5000, 30000], {"post_merge_iter.txt": "30017\n"})
    assert "reached 30000" in _steps(run, "stage1")
    assert "post_merge_iter.txt holds 30017" in _steps(run, "merge")
    assert _steps(run, "stage1", ["--iterations", "40000"])[0][1][-2:] == [
        "--iterations", "10000"]
    (run / "model" / "point_cloud" / "iteration_30017").mkdir()
    (run / "grown_postmerge" / "point_cloud" / "iteration_30019").mkdir(parents=True)
    s3 = _steps(run, "stage3")
    assert s3[0][1][-2:] == ["--iterations", "30000"]  # 60017 - 30017
    assert _steps(run, "grow")[0][1][4:6] == ["--base_iter", "30017"]
    (run / "growth_eval.txt").write_text("")
    assert _steps(run, "grow") == "growth_eval.txt exists"
    (run / "model" / "point_cloud" / "iteration_45000").mkdir()
    assert _steps(run, "stage3")[0][1][-2:] == ["--iterations", "15017"]
    assert "reached 30517" in _steps(run, "stage3", ["--iterations", "500"])
    (run / "post_merge_iter.txt").unlink()
    assert "merge has not run" in _steps(run, "stage3")
    assert "latest checkpoint is 45000, not 30000" in _steps(run, "merge")
    cut = _fake_run(tmp_path / "cut", [2000])
    assert _steps(cut, "merge", ["--iterations", "2000"])[0][0] == "merge"


def test_recipe_1k_scene_inputs_match_jax(tmp_path, monkeypatch):
    """run_reference_schedule_1k.sh's scene without its renders: the COLMAP
    cameras, images, points and npz data that each package's
    generate_dataset writes for 16 views at 1000x1000 equal byte for byte
    (the renders stubbed with zeros in both)."""
    import hairgs_tpu.data.synthetic as jsyn
    import hairgs_tpu_torch.data.synthetic as tsyn
    from hairgs_tpu_torch.drivers.pipeline import RECIPE_1K_SIZE, SYNTHETIC as S

    text = SCRIPT_1K.read_text()
    assert "synthetic_test_hair(num_strands=150, points_per_strand=24, seed=0)" in text
    assert "num_cameras=16, width=1000, height=1000" in text
    hw = (RECIPE_1K_SIZE, RECIPE_1K_SIZE)
    monkeypatch.setattr(jsyn, "render_strand_view",
                        lambda *a, **k: (np.zeros(hw + (3,)), *(np.zeros(hw),) * 3))
    monkeypatch.setattr(tsyn, "_render_strand_channels",
                        lambda *a, **k: (None, None, None))
    monkeypatch.setattr(tsyn, "_view_maps",
                        lambda *a: (np.zeros(hw + (3,)), *(np.zeros(hw),) * 3))
    kw = dict(num_cameras=S["num_cameras"], width=RECIPE_1K_SIZE, height=RECIPE_1K_SIZE)
    args = (S["num_strands"], S["points_per_strand"])
    jsyn.generate_dataset(str(tmp_path / "j"), jsyn.synthetic_test_hair(*args, seed=S["seed"]),
                          **kw)
    tsyn.generate_dataset(str(tmp_path / "t"), tsyn.synthetic_test_hair(*args, seed=S["seed"]),
                          device="cpu", **kw)
    for f in ("cameras.bin", "images.bin", "points3D.bin"):
        f = f"sparse/0/{f}"
        assert (tmp_path / "t" / f).read_bytes() == (tmp_path / "j" / f).read_bytes(), f
    for f in ("hair_eval_data.npz", "head_reconstruction_data.npz"):
        (a, b) = (np.load(tmp_path / p / f) for p in ("t", "j"))
        assert sorted(a) == sorted(b), f
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (f, k)
    assert len(os.listdir(tmp_path / "t" / "images")) == 16


def test_grow_stage_of_the_512_chain(tmp_path):
    """The optional grow stage of the default recipe: the grow driver on
    the latest checkpoint into grown_postmerge beside the model directory,
    then the eval driver on its output into growth_eval.txt; the default
    stages leave it out, as run_reference_schedule.sh has no growth step."""
    from hairgs_tpu_torch.drivers import pipeline

    run = _fake_run(tmp_path, [30000, 30017])
    (run / "grown_postmerge" / "point_cloud" / "iteration_30019").mkdir(parents=True)
    args, stages, common = pipeline.parse(["-s", "S", "-m", str(run / "model"),
                                           "--iterations", "7"])
    assert "grow" not in stages
    args, stages, common = pipeline.parse(["-s", "S", "-m", str(run / "model"),
                                           "--stages", "merge,grow,stage3"])
    assert stages == ["merge", "grow", "stage3"]
    steps = pipeline.stage_steps("grow", args, common)
    assert [(n, make(), tee) for n, make, tee, _ in steps] == [
        ("grow", ["-s", "S", "-m", str(run / "model"), "--base_iter", "30017", "--out",
                  str(run / "grown_postmerge"), "--data_device", "cuda"], None),
        ("grow_eval", ["-s", "S", "-p", str(run / "grown_postmerge" / "point_cloud" /
                                          "iteration_30019" / "point_cloud.ply"),
                       "-pt", "gs", "-m", str(run / "grown_postmerge"),
                       "--data_device", "cuda"], str(run / "growth_eval.txt"))]
    assert [pipeline.stage_module(n) for n, *_ in steps] == [
        "hairgs_tpu_torch.drivers.grow_and_save", "hairgs_tpu_torch.drivers.eval"]
