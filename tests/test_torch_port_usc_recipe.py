"""Port parity, the USC dress rehearsal: hairgs_tpu_torch's sample
synthesizer (`drivers/synthesize_usc_sample.py`) against
scripts/synthesize_usc_sample.py (run with runpy and the same argv), and
`drivers/pipeline.py --recipe usc` against scripts/usc_dress_rehearsal.sh,
with no training.

Tolerances: the sample's .data and head OBJ equal byte for byte. The
recipe: every step's argv equal to the shell script's command line (the
variables substituted as the script sets them; the parse's `--platform cpu`
is the JAX script's, `--device` the port's), each step's log file the
script's, and its skip decisions on fake run directories those of the
script's tests.
"""

import os
import runpy
import shlex
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
SCRIPT = ROOT / "scripts" / "usc_dress_rehearsal.sh"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers, and the
    idle OpenMP threads of a torch pool spin on cores the others need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("flags", [
    ["--num_strands", "200", "--points_per_strand", "20", "--stub_fraction", "0.3"],
    ["--num_strands", "50", "--points_per_strand", "7", "--stub_fraction", "0.5",
     "--sample", "3", "--step", "0.002", "--seed", "11"],
])
def test_synthesizer_writes_the_scripts_bytes(tmp_path, monkeypatch, capsys, flags):
    from hairgs_tpu_torch.drivers import synthesize_usc_sample

    monkeypatch.setattr(sys, "argv", ["synthesize_usc_sample.py", "--out",
                                      str(tmp_path / "jax"), *flags])
    runpy.run_path(str(ROOT / "scripts" / "synthesize_usc_sample.py"), run_name="__main__")
    j_out = capsys.readouterr().out
    path = synthesize_usc_sample.main(["--out", str(tmp_path / "torch"), *flags])
    t_out = capsys.readouterr().out
    assert t_out.replace("torch", "jax") == j_out
    name = os.path.relpath(path, tmp_path / "torch")
    assert name == os.path.join("hairstyles", "strands%05d.data" % (
        int(flags[flags.index("--sample") + 1]) if "--sample" in flags else 1))
    for f in (name, "head_model.obj"):
        a, b = ((tmp_path / p / f).read_bytes() for p in ("jax", "torch"))
        assert a == b and len(a) > 0, f


def _script_commands(env):
    """{program: (argv after it, the file its output goes to)} for each
    `python <program>` line of the script, its variables substituted."""
    out = {}
    for line in SCRIPT.read_text().replace("\\\n", " ").splitlines():
        i = line.find("python ")
        if i < 0 or line.lstrip().startswith("#"):
            continue
        for k, v in env.items():
            line = line.replace("${%s}" % k, v).replace("$" + k, v)
        cmd, _, rest = line[i:].partition(">")
        argv = shlex.split(cmd.split("||")[0])
        out[os.path.basename(argv[1])] = (argv[2:], shlex.split(rest)[0] if rest else None)
    return out


def _fake_run(tmp_path, files=(), dirs=()):
    run = tmp_path / "run"
    for d in ("raw", *dirs):
        (run / d).mkdir(parents=True, exist_ok=True)
    for f in files:
        (run / f).parent.mkdir(parents=True, exist_ok=True)
        (run / f).write_text("")
    return run


def _steps(run, stage=None, extra=()):
    """The port's steps with their argv (the device flag taken out) and
    log files, for the scene (stage None) or one stage."""
    from hairgs_tpu_torch.drivers import pipeline

    args, _, common = pipeline.parse(["-s", str(run / "dataset" / "00001"), "-m",
                                      str(run / "model"), "--recipe", "usc",
                                      "--data_device", "cpu", *extra])
    steps = (pipeline.usc_scene_steps(args) if stage is None
             else pipeline.stage_steps(stage, args, common))
    if isinstance(steps, str):
        return steps
    out = []
    for name, make, tee, _ in steps:
        argv = make()
        if name != "sample":  # the numpy synthesizer takes no device
            i = argv.index("--device" if name == "parse" else "--data_device")
            assert argv[i + 1] == "cpu"
            argv = argv[:i] + argv[i + 2:]
        out.append((name, pipeline.stage_module(name), argv, tee))
    return out


def test_recipe_usc_argv_matches_the_script(tmp_path):
    """Each step's argv and log file equal the script's line, on a run
    directory as the script finds it before each step."""
    run = _fake_run(tmp_path)
    base, data = str(run), str(run / "dataset" / "00001")
    script = _script_commands(dict(BASE=base, DATA=data, LAST="500"))
    sample, parse = script["synthesize_usc_sample.py"], script["parse_usc_hairsalon.py"]
    i = parse[0].index("--platform")
    assert parse[0][i:i + 2] == ["--platform", "cpu"]
    assert _steps(run) == [
        ("sample", "hairgs_tpu_torch.drivers.synthesize_usc_sample", sample[0], sample[1]),
        ("parse", "hairgs_tpu_torch.drivers.parse_usc_hairsalon",
         parse[0][:i] + parse[0][i + 2:], parse[1])]
    train = script["train.py"]
    assert _steps(run, "stage1") == [
        ("stage1", "hairgs_tpu_torch.drivers.train", train[0], train[1])]
    (run / "model" / "point_cloud" / "iteration_500").mkdir(parents=True)
    ev = script["eval.py"]
    assert _steps(run, "eval") == [("eval", "hairgs_tpu_torch.drivers.eval", ev[0], ev[1])]
    assert [os.path.basename(f) for f in (sample[1], parse[1], train[1], ev[1])] == [
        "synth.log", "parse.log", "fit.log", "eval.txt"]


def test_recipe_usc_skips_and_guards(tmp_path):
    """Each step skipped when its output is there (the script's tests);
    train flags go to Stage I after the recipe's; -s must be the parsed
    sample's directory; the recipe runs Stage I and the eval only."""
    from hairgs_tpu_torch.drivers import pipeline

    run = _fake_run(tmp_path, files=["raw/hairstyles/strands00001.data"])
    assert [s[0] for s in _steps(run)] == ["parse"]
    run = _fake_run(tmp_path, files=["dataset/00001/sparse/0/points3D.bin"])
    assert _steps(run) == []
    assert _steps(run, "stage1", ["--iterations", "50"])[0][2][-2:] == ["--iterations", "50"]
    assert _steps(run, "eval") == "no checkpoint to evaluate"
    (run / "model" / "point_cloud" / "iteration_500").mkdir(parents=True)
    assert "point_cloud exists" in _steps(run, "stage1")
    (run / "eval.txt").write_text("")
    assert _steps(run, "eval") == "eval.txt exists"
    args, stages, _ = pipeline.parse(["-s", "d/00001", "-m", "m", "--recipe", "usc"])
    assert stages == ["stage1", "eval"]
    args, _, _ = pipeline.parse(["-s", "d/00002", "-m", "r/m", "--recipe", "usc"])
    with pytest.raises(ValueError, match="00001"):
        pipeline.usc_scene_steps(args)
    with pytest.raises(ValueError, match="usc"):
        pipeline.parse(["-s", "d/00001", "-m", "m", "--recipe", "usc", "--stages", "merge"])
