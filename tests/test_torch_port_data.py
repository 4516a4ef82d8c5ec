"""Port parity, data preparation: the USC-HairSalon, CY, head-mesh and FLAME
parsers of hairgs_tpu_torch.data against hairgs_tpu's on synthetic files
and arrays (the fixtures of tests/test_aux.py), the Gabor orientation bank
of data/vision.py against OpenCV and against hairgs_tpu's (which calls
OpenCV), `generate_dataset(orientation_source="gabor")` and the USC parse
driver against JAX's on a tiny scene.

Tolerances: parsers and FLAME bit-equal (host numpy copies; 1e-6 allowed
for the FLAME forward); the grey conversion bit-equal to cv2.cvtColor over
all 2^24 colours; the Gabor kernels within 1e-6 of cv2.getGaborKernel; the
rounded responses equal to cv2.filter2D's on >= 99.9% of (pixel, angle)
entries and never more than 1 apart (OpenCV correlates through a float32
DFT, the port sums directly); the orientation index equal to JAX's on >= 99%
of pixels and the confidence within 1e-4 where it is; the datasets' images
and masks within 1 of 255 per pixel and their Gabor orientation maps equal
on >= 99% of pixels.
"""

import os
import pickle
import struct
import sys

import numpy as np
import pytest
import torch
from PIL import Image


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers, and the
    idle OpenMP threads of a torch pool spin on cores the others need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(a, b):
    """Equal nested results: arrays bit-equal, tuples elementwise."""
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif a is None:
        assert b is None
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def write_usc_sample(root, n_full=30, seed=0):
    """A USC-HairSalon .data file (10000 strands, the parser asserts it):
    `n_full` strands of 100 vertices spread over the index range, the rest
    1-vertex stubs, which the parser skips; and a quad head OBJ."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "hairstyles"), exist_ok=True)
    full = set(np.linspace(0, 9999, n_full).astype(int).tolist())
    with open(os.path.join(root, "hairstyles", "strands00001.data"), "wb") as f:
        f.write(struct.pack("<i", 10000))
        for i in range(10000):
            if i not in full:
                f.write(struct.pack("<i", 1) + np.zeros(3, "<f4").tobytes())
                continue
            th, ph = rng.uniform(0, 2 * np.pi), rng.uniform(0, 0.45 * np.pi)
            root_pt = 0.085 * np.array([np.sin(ph) * np.cos(th), np.cos(ph),
                                        np.sin(ph) * np.sin(th)])
            steps = rng.normal(0, 0.002, (99, 3)) + [0, -0.0035, 0]
            pts = np.concatenate([root_pt[None], root_pt + np.cumsum(steps, 0)])
            f.write(struct.pack("<i", 100) + pts.astype("<f4").tobytes())
    with open(os.path.join(root, "head_model.obj"), "w") as f:
        f.write("v 0 0 0\nv 0.1 0 0\nv 0.1 0.1 0\nv 0 0.1 0\nv 0 0 0.1\n"
                "f 1 2 3 4\nf 1 2 5\n")
    return os.path.join(root, "hairstyles", "strands00001.data")


@pytest.mark.parametrize("kwargs", [{}, {"hsv_spectre_color": False},
                                    {"pct_strands": 50, "normal_required": True}])
def test_usc_parser_matches_jax(tmp_path, kwargs):
    from hairgs_tpu.data.usc import load_hair_from_usc_dataset as jload
    from hairgs_tpu_torch.data.usc import load_hair_from_usc_dataset

    path = write_usc_sample(str(tmp_path))
    a, b = load_hair_from_usc_dataset(path, **kwargs), jload(path, **kwargs)
    # every second strand with 50%: 13 of the 30 full ones
    assert a.verts.shape[0] == 100 * (30 if "pct_strands" not in kwargs else 13)
    for name in b._fields:
        _same(getattr(a, name), getattr(b, name))


def test_cy_roundtrip_and_loader_match_jax(tmp_path):
    from hairgs_tpu.data import cy as jcy
    from hairgs_tpu_torch.data import cy

    rng = np.random.default_rng(1)
    counts = np.array([5, 7, 4, 6], np.uint16)
    pts = rng.normal(0, 10, (int(counts.sum()), 3)).astype(np.float32)
    for name, segments in (("seg.hair", counts), ("flat.hair", None)):
        p = str(tmp_path / name)
        cy.save_cy_hair_file(p, pts if segments is not None else pts[:18],
                             segments, info="port test")
        jp = str(tmp_path / ("j" + name))
        jcy.save_cy_hair_file(jp, pts if segments is not None else pts[:18],
                              segments, info="port test")
        assert open(p, "rb").read() == open(jp, "rb").read()
        f, jf = cy.load_cy_hair_file(p), jcy.load_cy_hair_file(p)
        assert tuple(f.header) == tuple(jf.header) and f.header.info == "port test"
        _same(tuple(f)[1:], tuple(jf)[1:])
        for kw in ({}, {"hsv_spectre_color": False}):
            a, b = cy.load_hair_from_cy_dataset(p, **kw), jcy.load_hair_from_cy_dataset(p, **kw)
            for field in b._fields:
                _same(getattr(a, field), getattr(b, field))


def test_head_obj_matches_jax(tmp_path):
    from hairgs_tpu.data import head as jhead
    from hairgs_tpu_torch.data import head

    p = tmp_path / "head.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 0 0 1\nv 1 1 0\n"
                 "f 1 2 3\nf 1/1 2/2 4/3\nf 2 5 3 1\n")
    pn = tmp_path / "normals.obj"
    pn.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nvn 0 0 1\nvn 0 0 1\nvn 0 0 1\n"
                  "f 1 2 3\n")
    for path in (p, pn):
        _same(head.load_obj(str(path)), jhead.load_obj(str(path)))
        for fn in ("load_head_from_usc_dataset", "load_head_from_cy_dataset"):
            _same(tuple(getattr(head, fn)(str(path))), tuple(getattr(jhead, fn)(str(path))))
    verts, _, faces = head.load_obj(str(p))
    assert faces.shape == (4, 3)  # the quad fans into two triangles
    n = head.estimate_vertex_normals(verts, faces)
    _same(n, jhead.estimate_vertex_normals(verts, faces))
    np.testing.assert_allclose(np.linalg.norm(n, axis=1), 1.0, rtol=1e-5)


def _tiny_flame(mod, v=20, j=5, n_shape=10):
    """tests/test_aux.py::tiny_flame_faces in either package."""
    rng = np.random.default_rng(0)
    jr = np.abs(rng.normal(size=(j, v)))
    jr /= jr.sum(axis=1, keepdims=True)
    w = np.abs(rng.normal(size=(v, j)))
    w /= w.sum(axis=1, keepdims=True)
    m = mod.FlameModel(
        v_template=rng.normal(size=(v, 3)),
        shapedirs=rng.normal(size=(v, 3, n_shape)) * 0.01,
        posedirs=rng.normal(size=(9 * (j - 1), v * 3)) * 0.01,
        j_regressor=jr, lbs_weights=w, parents=np.array([0, 0, 1, 1, 3]),
        faces=np.array([[0, 1, 2]]))
    faces = np.random.default_rng(3).integers(0, v, size=(8, 3))
    return m._replace(faces=faces.astype(np.int64))


def test_flame_matches_jax(tmp_path):
    from hairgs_tpu.data import flame as jfl
    from hairgs_tpu_torch.data import flame as fl

    rng = np.random.default_rng(7)
    m, jm = _tiny_flame(fl), _tiny_flame(jfl)
    _same(fl._rodrigues(rng.normal(size=(6, 3))),
          jfl._rodrigues(np.random.default_rng(7).normal(size=(6, 3))))
    static = {"lmk_face_idx": rng.integers(0, 8, size=5),
              "lmk_b_coords": rng.dirichlet(np.ones(3), size=5)}
    sp = tmp_path / "static.pkl"
    with open(sp, "wb") as f:
        pickle.dump(static, f)
    dyn = {"lmk_face_idx": [rng.integers(0, 8, size=4) for _ in range(79)],
           "lmk_b_coords": [rng.dirichlet(np.ones(3), size=4) for _ in range(79)]}
    dp = tmp_path / "dynamic.npy"
    np.save(dp, np.array(dyn, dtype=object), allow_pickle=True)
    emb = fl.load_dynamic_landmark_embedding(
        str(dp), fl.load_static_landmark_embedding(str(sp)))
    jemb = jfl.load_dynamic_landmark_embedding(
        str(dp), jfl.load_static_landmark_embedding(str(sp)))
    _same(tuple(emb), tuple(jemb))
    masks = {"scalp": np.arange(6), "face": np.arange(3, 9)}
    mp = tmp_path / "masks.pkl"
    with open(mp, "wb") as f:
        pickle.dump(masks, f)
    assert {k: v.tolist() for k, v in fl.load_flame_masks(str(mp)).items()} == \
        {k: v.tolist() for k, v in jfl.load_flame_masks(str(mp)).items()}
    for kw in ({},
               {"shape_params": rng.normal(size=6), "expression_params": rng.normal(size=3),
                "pose_params": rng.normal(0, 0.3, 6), "neck_pose": rng.normal(0, 0.2, 3),
                "eye_pose": rng.normal(0, 0.1, 6), "transl": rng.normal(size=3)},
               {"pose_params": np.array([0, 0.4, 0, 0.1, 0, 0])}):
        for lm in ({}, {"landmark_embedding": emb, "use_face_contour": True}):
            jlm = {"landmark_embedding": jemb, "use_face_contour": True} if lm else {}
            a = fl.flame_forward(m, **kw, **lm)
            b = jfl.flame_forward(jm, **kw, **jlm)
            for x, y in zip(a if lm else (a,), b if jlm else (b,)):
                np.testing.assert_allclose(x, y, rtol=0, atol=1e-6)
    for deg in (0, 10, -10, 80, -80):
        full = np.zeros((5, 3))
        full[0, 1] = np.deg2rad(deg)
        assert fl._dynamic_lmk_index(full, m.parents) == \
            jfl._dynamic_lmk_index(full, jm.parents)


def test_grey_conversion_bit_equal_to_cv2():
    cv2 = pytest.importorskip("cv2")
    from hairgs_tpu_torch.data.vision import rgb_to_gray_uint8

    v = np.arange(256, dtype=np.uint8)
    img = np.stack(np.meshgrid(v, v, v, indexing="ij"), -1).reshape(4096, 4096, 3)
    np.testing.assert_array_equal(rgb_to_gray_uint8(torch.from_numpy(img)).numpy(),
                                  cv2.cvtColor(img, cv2.COLOR_RGB2GRAY))


def test_gabor_kernels_and_responses_match_cv2():
    cv2 = pytest.importorskip("cv2")
    from hairgs_tpu_torch.data.vision import gabor_kernel, gabor_responses

    thetas = np.linspace(0, np.pi, 180)
    ks = np.stack([gabor_kernel(31, 2, t, 3, 0.5) for t in thetas])
    ref_k = np.stack([cv2.getGaborKernel((31, 31), 2, t, 3, 0.5, 0, ktype=cv2.CV_32F)
                      for t in thetas])
    assert ks.dtype == np.float32
    np.testing.assert_allclose(ks, ref_k, rtol=0, atol=1e-6)
    rng = np.random.default_rng(5)
    gray = rng.integers(0, 256, (48, 40), dtype=np.uint8)
    gray[10:30, 5:25] = 77  # a flat block: zero responses and ties
    r = gabor_responses(torch.from_numpy(gray), torch.from_numpy(ref_k)).numpy()
    ref = np.stack([cv2.filter2D(gray, -1, k) for k in ref_k]).astype(np.float32)
    diff = np.abs(r - ref)
    print(f"responses equal to cv2.filter2D's on {np.mean(diff == 0):.6f} of "
          f"{diff.size} entries, max difference {diff.max()}")
    assert np.mean(diff == 0) >= 0.999 and diff.max() <= 1


def _images():
    rng = np.random.default_rng(9)
    flat = rng.integers(0, 256, (56, 56, 3), dtype=np.uint8)
    flat[:20] = 128  # flat regions: all responses 0, confidence 1
    flat[30:, 30:] = (200, 10, 40)
    return [rng.integers(0, 256, (64, 64, 3), dtype=np.uint8),
            rng.integers(0, 256, (48, 40, 3), dtype=np.uint8), flat]


@pytest.mark.parametrize("which", [0, 1, 2])
def test_orientation_field_matches_jax(which):
    pytest.importorskip("cv2")
    from hairgs_tpu.data.vision import estimate_orientation_field as jest
    from hairgs_tpu_torch.data.vision import estimate_orientation_field

    img = _images()[which]
    jo, jc = jest(img)
    to, tc = (t.numpy() for t in estimate_orientation_field(torch.from_numpy(img)))
    assert to.dtype == jo.dtype == np.float64 and tc.dtype == jc.dtype == np.float32
    same = to == jo
    err = np.abs(tc - jc)[same].max()
    print(f"orientation index equal on {same.mean():.6f} of the pixels; "
          f"confidence max abs error {err:.3e} where it is")
    assert same.mean() >= 0.99 and err <= 1e-4


def test_generate_dataset_gabor_matches_jax(tmp_path):
    pytest.importorskip("cv2")
    from hairgs_tpu.data.synthetic import generate_dataset as jgen
    from hairgs_tpu.data.synthetic import synthetic_test_hair
    from hairgs_tpu.render.renderer import RasterConfig as JCfg
    from hairgs_tpu_torch.data.synthetic import generate_dataset
    from hairgs_tpu_torch.render.renderer import RasterConfig

    hair = synthetic_test_hair(num_strands=20, points_per_strand=8, seed=1)
    kw = dict(num_cameras=2, width=64, height=64, cam_z=0.35,
              orientation_source="gabor")
    jgen(str(tmp_path / "j"), hair, raster_cfg=JCfg(max_tiles_per_gaussian=8,
                                                     max_pairs_per_tile=128, chunk=16), **kw)
    generate_dataset(str(tmp_path / "t"), hair, raster_cfg=RasterConfig(
        max_tiles_per_gaussian=8, max_pairs_per_tile=128, chunk=16), device="cpu", **kw)
    _compare_datasets(str(tmp_path / "j"), str(tmp_path / "t"), n_views=2)


def _compare_datasets(jdir, tdir, n_views):
    for cam_id in range(1, n_views + 1):
        for sub, name in (("images", f"image_{cam_id}.png"),
                          ("masks", f"image_{cam_id}.png"),
                          ("orientations", f"image_{cam_id}_orientation.png"),
                          ("orientations", f"image_{cam_id}_confidence.png")):
            a = np.asarray(Image.open(os.path.join(jdir, sub, name)), np.int16)
            b = np.asarray(Image.open(os.path.join(tdir, sub, name)), np.int16)
            assert a.shape == b.shape, name
            if "orientation" in name:
                share = np.mean(a == b)
                print(f"{name}: equal on {share:.4f} of the pixels")
                assert share >= 0.99, name
            else:
                assert np.abs(a - b).max() <= 1, name
    for f in ("hair_eval_data.npz", "head_reconstruction_data.npz"):
        a, b = np.load(os.path.join(jdir, f)), np.load(os.path.join(tdir, f))
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_parse_usc_driver_matches_jax(tmp_path, monkeypatch):
    """The USC parse driver (`--orientation gabor`) against
    scripts/parse_usc_hairsalon.py on the synthetic sample; the port's
    scene loads with its COLMAP reader."""
    pytest.importorskip("cv2")
    import runpy

    from hairgs_tpu_torch.drivers import parse_usc_hairsalon
    from hairgs_tpu_torch.io.dataset import read_colmap_scene_info

    write_usc_sample(str(tmp_path / "usc"))
    flags = ["-d", str(tmp_path / "usc"), "--cameras", "2", "--width", "64",
             "--height", "64", "--orientation", "gabor", "--pct_strands", "50"]
    monkeypatch.setattr(sys, "argv", ["parse_usc_hairsalon.py", *flags,
                                      "-o", str(tmp_path / "j")])
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    runpy.run_path(os.path.join(root, "scripts", "parse_usc_hairsalon.py"),
                   run_name="__main__")
    out = parse_usc_hairsalon.main([*flags, "-o", str(tmp_path / "t"), "--device", "cpu"])
    assert out == [str(tmp_path / "t" / "00001")]
    _compare_datasets(str(tmp_path / "j" / "00001"), out[0], n_views=2)
    info = read_colmap_scene_info(out[0])
    assert len(info.cameras) == 2 and info.points.shape[0] > 0
