"""Port parity, the NeRSemble capture path: hairgs_tpu_torch's parser
(`drivers/parse_nersemble.py`, `--device cpu`) against
scripts/parse_nersemble.py (run with runpy and the same argv) on the
synthetic capture of tests/test_nersemble.py (3 cameras at 64x48, fake
FLAME pickles, the static landmark embedding, 12 angles), and on the same
capture with its alpha and segmentation maps at twice the image resolution
(the resize then does work); the parser's OpenCV replacements in
`data/vision.py` against cv2; the skip-and-continue cases; and Stage I on
the parsed scene, the port's train driver against the root train.py.

Tolerances: masks and images decoded pixel for pixel equal; the
orientation maps equal on >= 99% of the pixels and the confidence maps
within 1 of 255 where the orientation is equal (a confidence within 1e-4,
the Gabor bank's tolerance in tests/test_torch_port_data.py, moves the
truncated value by at most 1); the three COLMAP files and head_mesh.ply
byte for byte; head_reconstruction_data.npz within 1e-6 (the FLAME
forward's bound); the printed lines equal (output directories named alike);
the helpers bit-equal to cv2; Stage I's loss within 1e-4 relative up to
its first densify event, its topology info and sizes equal.
"""

import os
import random
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

cv2 = pytest.importorskip("cv2")

ROOT = Path(__file__).resolve().parent.parent
SCRIPT = ROOT / "scripts" / "parse_nersemble.py"
CAMS = (222200042, 222200044, 222200046)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers, and the
    idle OpenMP threads of a torch pool spin on cores the others need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_double_maps(raw):
    """Alpha and segmentation maps at twice the 64x48 image resolution: an
    alpha with 6-pixel ramps at its edges, a hair region with a slanted
    edge and stray hair pixels, a face region (the parser resizes them to
    the images')."""
    from test_nersemble import CAM_NAMES, H, W

    h, w = 2 * H, 2 * W
    y, x = np.mgrid[0:h, 0:w]
    ramp = np.minimum.reduce([x - 8, 119 - x, y - 4, 87 - y]) / 6.0
    alpha = (np.clip(ramp, 0, 1) * 255).astype(np.uint8)
    seg = np.zeros((h, w), np.uint8)
    seg[(y >= 10) & (y < 40 + x // 8) & (x >= 20) & (x < 80)] = 14
    seg[np.random.default_rng(2).random((h, w)) > 0.995] = 14
    seg[50:80, 20:80] = 6
    frame = os.path.join(raw, "017", "sequences", "EXP-1-head", "timesteps", "frame_00000")
    for name in CAM_NAMES:
        cv2.imwrite(os.path.join(frame, "alpha_map", f"cam_{name}.png"), alpha)
        cv2.imwrite(os.path.join(frame, "facer_segmentation_masks",
                                 f"segmentation_cam_{name}.png"), seg)


def _capture(root, double=False):
    from test_nersemble import _write_capture, _write_flame_assets

    raw = str(root / "raw")
    os.makedirs(raw)
    model, masks, lmk = _write_flame_assets(raw)
    _write_capture(raw)
    if double:
        _write_double_maps(raw)
    return raw, ["-r", raw, "-i", "17", "--flame_model_path", model,
                 "--flame_mask_path", masks, "--num_angles", "12",
                 "--static_landmark_embedding_path", lmk]


def _run_parsers(root, flags):
    """Both parsers into root/jax and root/torch; returns each one's
    printed lines, its output directory written as OUT."""
    import contextlib
    import io

    from hairgs_tpu_torch.drivers import parse_nersemble

    lines = {}
    argv = sys.argv
    for package in ("jax", "torch"):
        dst = str(root / package)
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                if package == "jax":
                    sys.argv = ["parse_nersemble.py", *flags, "-o", dst]
                    runpy.run_path(str(SCRIPT), run_name="__main__")
                else:
                    parse_nersemble.main([*flags, "-o", dst, "--device", "cpu"])
        finally:
            sys.argv = argv
        lines[package] = buf.getvalue().replace(dst, "OUT").splitlines()
    return lines


@pytest.fixture(scope="module", params=["same", "double"])
def parsed(request, tmp_path_factory):
    """Both parsers on the capture: its maps at the images' resolution, or
    at twice it."""
    root = tmp_path_factory.mktemp(f"nersemble_{request.param}")
    _, flags = _capture(root, double=request.param == "double")
    lines = _run_parsers(root, flags)
    return root / "jax" / "017", root / "torch" / "017", lines


def _pixels(path):
    return np.asarray(Image.open(path))


def test_parser_matches_jax(parsed):
    jdir, tdir, lines = parsed
    assert lines["torch"] == lines["jax"]
    assert lines["jax"][-1] == "parsed 1/1 participants"
    for cam in CAMS:
        for sub in ("images", "masks"):
            a, b = (_pixels(d / sub / f"image_{cam}.png") for d in (jdir, tdir))
            np.testing.assert_array_equal(b, a, err_msg=f"{sub} {cam}")
        oa, ob = (_pixels(d / "orientations" / f"image_{cam}_orientation.png")
                  for d in (jdir, tdir))
        ca, cb = (_pixels(d / "orientations" / f"image_{cam}_confidence.png").astype(int)
                  for d in (jdir, tdir))
        same = oa == ob
        assert same.mean() >= 0.99, (cam, same.mean())
        assert np.abs(ca - cb)[same].max() <= 1, cam
    mask = _pixels(tdir / "masks" / f"image_{CAMS[0]}.png")
    assert mask.any() and not mask.all()
    for f in ("cameras.bin", "images.bin", "points3D.bin"):
        assert (tdir / "sparse" / "0" / f).read_bytes() == \
            (jdir / "sparse" / "0" / f).read_bytes(), f
    assert (tdir / "head_mesh.ply").read_bytes() == (jdir / "head_mesh.ply").read_bytes()
    a, b = (np.load(d / "head_reconstruction_data.npz") for d in (jdir, tdir))
    assert sorted(a.files) == sorted(b.files) == ["head_verts", "scalp_verts"]
    for k in a.files:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_allclose(b[k], a[k], rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("missing", ["first_image", "image", "alpha", "segmentation"])
def test_skip_and_continue_matches_jax(tmp_path, missing):
    """A missing file skips the participant in both, with the same lines,
    and leaves the same output behind (the output directory is removed
    after a failed mask or image step, kept after a missing first image)."""
    from test_nersemble import CAM_NAMES

    raw, flags = _capture(tmp_path)
    frame = Path(raw) / "017" / "sequences" / "EXP-1-head" / "timesteps" / "frame_00000"
    name = CAM_NAMES[0 if missing == "first_image" else 1]
    path = {"first_image": frame / "images-2x" / f"cam_{name}.jpg",
            "image": frame / "images-2x" / f"cam_{name}.jpg",
            "alpha": frame / "alpha_map" / f"cam_{name}.png",
            "segmentation": frame / "facer_segmentation_masks" /
            f"segmentation_cam_{name}.png"}[missing]
    path.unlink()
    lines = _run_parsers(tmp_path, flags)
    assert lines["torch"] == lines["jax"]
    assert lines["jax"][-1] == "parsed 0/1 participants"
    assert any("skipping" in line for line in lines["jax"])
    for package in ("jax", "torch"):
        assert (tmp_path / package / "017").exists() == (missing == "first_image")


def test_opencv_helpers_match_cv2(tmp_path):
    """resize_uint8 against cv2.resize (INTER_LINEAR) on random images
    and sizes, up and down, 2x and equal; dilate_uint8 against cv2.dilate;
    read_rgb and read_gray against cv2.imread of a JPEG, a grey PNG and a
    colour PNG; None for a missing file."""
    from hairgs_tpu_torch.data.vision import dilate_uint8, read_gray, read_rgb, resize_uint8

    rng = np.random.default_rng(7)
    sizes = [tuple(int(v) for v in rng.integers(1, 120, 4)) for _ in range(60)]
    sizes += [(96, 128, 48, 64), (48, 64, 48, 64), (90, 120, 30, 40), (5, 7, 10, 14),
              (1, 9, 3, 4), (200, 160, 100, 80)]
    for h, w, hh, ww in sizes:
        img = rng.integers(0, 256, (h, w), dtype=np.uint8)
        np.testing.assert_array_equal(resize_uint8(torch.from_numpy(img), hh, ww).numpy(),
                                      cv2.resize(img, (ww, hh)), err_msg=str((h, w, hh, ww)))
    hair = (rng.random((48, 64)) > 0.97).astype(np.uint8)
    hair[0, :5] = hair[-1, -3:] = 1  # at the border
    np.testing.assert_array_equal(dilate_uint8(torch.from_numpy(hair), 13).numpy(),
                                  cv2.dilate(hair, np.ones((13, 13))))
    rgb = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    cv2.imwrite(str(tmp_path / "a.jpg"), rgb)
    cv2.imwrite(str(tmp_path / "g.png"), rgb[..., 0])
    cv2.imwrite(str(tmp_path / "c.png"), rgb)
    np.testing.assert_array_equal(read_rgb(str(tmp_path / "a.jpg")), cv2.cvtColor(
        cv2.imread(str(tmp_path / "a.jpg")), cv2.COLOR_BGR2RGB))
    for f in ("g.png", "c.png"):
        np.testing.assert_array_equal(read_gray(str(tmp_path / f)), cv2.imread(
            str(tmp_path / f), cv2.IMREAD_GRAYSCALE), err_msg=f)
    assert read_rgb(str(tmp_path / "none.jpg")) is None
    assert read_gray(str(tmp_path / "none.png")) is None


def test_stage1_on_the_parsed_scene_matches_jax(tmp_path, monkeypatch):
    """Stage I on the parsed capture (the FLAME vertices as its initial
    points): the port's train driver on the port's parse against the root
    train.py on the JAX script's, 10 iterations with densify events at 5
    and 10. The port's init takes JAX's 3-NN distances, as in
    test_torch_port_model.py's run under the 1k flags: with its own, the
    loss at iteration 5 parts by 3.7e-3 (with them, by 2.7e-6)."""
    from hairgs_tpu_torch.io.dataset import read_colmap_scene_info
    from test_torch_port_pipeline import (
        STAGE1,
        _Recorder,
        _run_stage,
        _same_run,
        feed_jax_init_distances,
    )

    import hairgs_tpu.logging_utils as jlog
    import hairgs_tpu_torch.logging_utils as tlog

    _, flags = _capture(tmp_path)
    _run_parsers(tmp_path, flags)
    feed_jax_init_distances(monkeypatch)
    recs = {}
    for package in ("jax", "torch"):
        scene = str(tmp_path / package / "017")
        assert read_colmap_scene_info(scene).points.shape == (30, 3)
        recs[package] = rec = _Recorder()
        monkeypatch.setattr(jlog if package == "jax" else tlog, "get_logger",
                            lambda args, rec=rec: rec)
        random.seed(0)
        np.random.seed(0)
        _run_stage(package, "stage1", ["-s", scene, "-m", str(tmp_path / f"model_{package}"),
                                       *STAGE1, "--data_device", "cpu"], monkeypatch, rec)
    assert _same_run(recs["jax"], recs["torch"]) == [5, 10]
