"""Port parity, I/O and data: COLMAP / PLY / npz files, scene reading,
camera loading and dataset generation of hairgs_tpu_torch against
hairgs_tpu on the CPU, on the 64 px scene of tests/test_pipeline.py.

Tolerances: arrays read from the same files bit-equal; camera matrices
within 1e-6; a dataset generated by the port (XLA path) against JAX's:
COLMAP files byte-equal, npz arrays bit-equal, RGB PNGs within one level on
>= 99.9% of pixels and masks equal on >= 99.9%.
"""

import os

import numpy as np
import pytest
import torch

SMALL = dict(max_tiles_per_gaussian=8, max_pairs_per_tile=128, chunk=16)
SCENE = dict(num_cameras=6, width=64, height=64, cam_z=0.35,
             init_points="gt_hair_verts", init_subsample=3)


def _hair():
    from hairgs_tpu.data.synthetic import synthetic_test_hair

    return synthetic_test_hair(num_strands=20, points_per_strand=8, seed=1)


@pytest.fixture(scope="module")
def jax_scene(tmp_path_factory):
    """The fixture scene of tests/test_pipeline.py, written by JAX."""
    from hairgs_tpu.data.synthetic import generate_dataset
    from hairgs_tpu.render.renderer import RasterConfig

    root = tmp_path_factory.mktemp("jax_scene")
    return generate_dataset(str(root / "data"), _hair(), **SCENE,
                            raster_cfg=RasterConfig(**SMALL))


@pytest.fixture(scope="module")
def port_scene(tmp_path_factory):
    from hairgs_tpu_torch.data.synthetic import generate_dataset, synthetic_test_hair
    from hairgs_tpu_torch.render.renderer import RasterConfig

    root = tmp_path_factory.mktemp("port_scene")
    overflow = []
    hair = synthetic_test_hair(num_strands=20, points_per_strand=8, seed=1)
    for a, b in zip(hair, _hair()):
        np.testing.assert_array_equal(a, b)
    out = generate_dataset(str(root / "data"), hair, **SCENE,
                           raster_cfg=RasterConfig(**SMALL), device="cpu",
                           overflow=overflow)
    return out, overflow


def test_colmap_and_npz_read_bit_equal_by_both(jax_scene):
    from hairgs_tpu.io import colmap as jc, npz as jn
    from hairgs_tpu_torch.io import colmap as tc, npz as tn

    sparse = os.path.join(jax_scene, "sparse", "0")
    for reader, f in (("read_intrinsics_binary", "cameras.bin"),
                      ("read_extrinsics_binary", "images.bin")):
        a = getattr(jc, reader)(os.path.join(sparse, f))
        b = getattr(tc, reader)(os.path.join(sparse, f))
        assert a.keys() == b.keys()
        for k in a:
            for x, y in zip(a[k], b[k]):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    for x, y in zip(jc.read_points3D_binary(os.path.join(sparse, "points3D.bin")),
                    tc.read_points3D_binary(os.path.join(sparse, "points3D.bin"))):
        np.testing.assert_array_equal(x, y)
    for name, jl, tl in (("hair_eval_data.npz", jn.load_hair_eval_data_npz,
                          tn.load_hair_eval_data_npz),
                         ("head_reconstruction_data.npz",
                          jn.load_head_reconstruction_data_npz,
                          tn.load_head_reconstruction_data_npz)):
        for x, y in zip(jl(os.path.join(jax_scene, name)),
                        tl(os.path.join(jax_scene, name))):
            np.testing.assert_array_equal(x, y)


def test_gaussian_ply_crosses_both_ways(tmp_path):
    from hairgs_tpu.io.ply import load_gaussian_ply as jload, save_gaussian_ply as jsave
    from hairgs_tpu_torch.io.ply import count_ply_elements
    from hairgs_tpu_torch.models.gaussian import GaussianModel

    rng = np.random.default_rng(0)
    model = GaussianModel(sh_degree=1, capacity_round=64, device="cpu")
    model.create_from_pcd(rng.normal(0, 0.1, (50, 3)).astype(np.float32),
                          rng.uniform(0, 1, (50, 3)).astype(np.float32))
    host = model.host_arrays()
    host["features_rest"] = rng.normal(size=host["features_rest"].shape).astype(np.float32)
    host["rotation"] = rng.normal(size=(50, 4)).astype(np.float32)
    model._install(host, 50)
    port_path = str(tmp_path / "port.ply")
    model.save_ply(port_path)
    assert count_ply_elements(port_path) == 1
    back = jload(port_path, 1)
    for k, v in host.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    jax_path = str(tmp_path / "jax.ply")
    jsave(jax_path, host)
    other = GaussianModel(sh_degree=1, capacity_round=64, device="cpu")
    other.load_ply(jax_path)
    assert other.active_sh_degree == 1 and other.count == 50
    for k, v in other.host_arrays().items():
        np.testing.assert_array_equal(v, host[k], err_msg=k)


def test_scene_info_and_cameras_agree(jax_scene):
    from hairgs_tpu.io.dataset import load_camera as jload, read_colmap_scene_info as jread
    from hairgs_tpu_torch.io.dataset import load_camera, read_colmap_scene_info

    ji = jread(jax_scene)
    ti = read_colmap_scene_info(jax_scene)
    np.testing.assert_array_equal(ti.points, ji.points)
    np.testing.assert_array_equal(ti.colors, ji.colors)
    assert ti.ply_path == ji.ply_path
    assert ti.nerf_normalization["radius"] == ji.nerf_normalization["radius"]
    assert [c.image_name for c in ti.cameras] == [c.image_name for c in ji.cameras]
    for tc, jc in zip(ti.cameras, ji.cameras):
        assert tc._replace(R=None, T=None) == jc._replace(R=None, T=None)
        np.testing.assert_array_equal(tc.R, jc.R)
        cam_t, cam_j = load_camera(tc, device="cpu"), jload(jc)
        for name in ("image", "mask", "orientation", "confidence"):
            np.testing.assert_array_equal(getattr(cam_t, name).numpy(),
                                          np.asarray(getattr(cam_j, name)), err_msg=name)
        for name in ("world_view", "full_proj", "cam_center", "tanfovx", "tanfovy"):
            np.testing.assert_allclose(getattr(cam_t, name).numpy(),
                                       np.asarray(getattr(cam_j, name)),
                                       rtol=0, atol=1e-6, err_msg=name)
        assert cam_t.image.dtype == torch.float32 and cam_t.height == 64


def test_generate_dataset_matches_jax(jax_scene, port_scene):
    from PIL import Image

    port, overflow = port_scene
    assert len(overflow) == 6
    assert all(v["overflow_capacity"] == 0 for v in overflow)
    for f in ("cameras.bin", "images.bin", "points3D.bin"):
        with open(os.path.join(jax_scene, "sparse", "0", f), "rb") as a, \
                open(os.path.join(port, "sparse", "0", f), "rb") as b:
            assert a.read() == b.read(), f
    for f in ("hair_eval_data.npz", "head_reconstruction_data.npz"):
        a, b = np.load(os.path.join(jax_scene, f)), np.load(os.path.join(port, f))
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(b[k], a[k], err_msg=f"{f} {k}")
    for i in range(1, 7):
        def png(root, *parts):
            return np.asarray(Image.open(os.path.join(root, *parts))).astype(np.int16)

        rgb_j, rgb_t = (png(r, "images", f"image_{i}.png") for r in (jax_scene, port))
        assert rgb_j.max() > 30
        assert (np.abs(rgb_j - rgb_t) <= 1).mean() >= 0.999, i
        mask_j, mask_t = (png(r, "masks", f"image_{i}.png") for r in (jax_scene, port))
        assert (mask_j == mask_t).mean() >= 0.999, i
    assert sorted(os.listdir(os.path.join(port, "orientations"))) == \
        sorted(os.listdir(os.path.join(jax_scene, "orientations")))


def test_strand_gaussians_and_lighting_match_jax():
    from hairgs_tpu.data.synthetic import strand_segments_to_gaussians as jconv
    from hairgs_tpu_torch.data.synthetic import strand_segments_to_gaussians

    hair = _hair()
    flat = jconv(hair)
    for lighting in (False, True):
        a = jconv(hair, use_lighting=lighting)
        b = strand_segments_to_gaussians(hair, use_lighting=lighting, device="cpu")
        assert a.keys() == b.keys()
        for k in a:
            if not (lighting and k == "colors"):
                np.testing.assert_allclose(b[k], a[k], rtol=0, atol=2e-6, err_msg=k)
    # lit colours: the normals of points on thin strands are ill-posed and
    # their sign is arbitrary (in the reference too), so only the Lambert
    # range ka..ka+kd of the flat colour is common to both packages
    ratio = b["colors"] / np.maximum(flat["colors"], 1e-6)
    ok = flat["colors"] > 1e-3
    assert (ratio[ok] >= 0.5 - 1e-6).all() and (ratio[ok] <= 1.0 + 1e-6).all()
    assert (ratio[ok] > 0.5 + 1e-3).any()


def test_gabor_orientation_is_not_ported(tmp_path):
    """orientation_source="gabor", which raised before data/vision.py was
    ported, now writes the Gabor bank's maps of each saved RGB view (held
    to JAX's in tests/test_torch_port_data.py)."""
    from PIL import Image

    from hairgs_tpu_torch.data.synthetic import generate_dataset
    from hairgs_tpu_torch.data.vision import estimate_orientation_field

    generate_dataset(str(tmp_path), _hair(), **dict(SCENE, num_cameras=2),
                     orientation_source="gabor", device="cpu")
    for cam_id in (1, 2):
        rgb = np.array(Image.open(tmp_path / "images" / f"image_{cam_id}.png"))
        theta, conf = (t.numpy() for t in estimate_orientation_field(
            torch.from_numpy(rgb)))
        saved = np.asarray(Image.open(
            tmp_path / "orientations" / f"image_{cam_id}_orientation.png"))
        np.testing.assert_array_equal(saved, (theta * 255 / np.pi).astype(np.uint8))
        saved = np.asarray(Image.open(
            tmp_path / "orientations" / f"image_{cam_id}_confidence.png"))
        np.testing.assert_array_equal(saved, (conf * 255).astype(np.uint8))


def test_eval_data_loaders_match_jax(tmp_path):
    """The loaders eval.py uses: a Gaussian checkpoint PLY (foreground
    centres and principal axes), a Strand Integration PLY and a Neural
    Haircut PLY read the same by both packages."""
    from hairgs_tpu.evaluation import eval_data as je
    from hairgs_tpu_torch.evaluation import eval_data as te
    from hairgs_tpu_torch.io.ply import save_gaussian_ply, write_ply

    rng = np.random.default_rng(7)
    n = 40
    arrays = dict(
        xyz=rng.normal(0, 0.1, (n, 3)), features_dc=rng.normal(size=(n, 1, 3)),
        features_rest=np.zeros((n, 0, 3)), scaling=np.log(rng.uniform(1e-3, 1e-2, (n, 3))),
        rotation=rng.normal(size=(n, 4)), opacity=rng.normal(0, 3, (n, 1)),
        mask=rng.normal(0, 2, (n, 1)))
    gs = str(tmp_path / "gs.ply")
    save_gaussian_ply(gs, {k: v.astype(np.float32) for k, v in arrays.items()})
    a, b = je.load_eval_data_from_gaussians(gs), te.load_eval_data_from_gaussians(gs, device="cpu")
    assert 0 < b.points.shape[0] < n
    np.testing.assert_array_equal(b.points, a.points)
    np.testing.assert_allclose(b.directions, a.directions, rtol=0, atol=1e-6)

    v = np.zeros(n, dtype=[(c, "f4") for c in ("x", "y", "z", "nx", "ny", "nz")])
    for c in v.dtype.names:
        v[c] = rng.normal(size=n)
    si = str(tmp_path / "si.ply")
    write_ply(si, [("vertex", v)])
    hc = np.zeros(2 * 5, dtype=[(c, "f4") for c in ("x", "y", "z")])
    for c in hc.dtype.names:
        hc[c] = np.cumsum(rng.normal(size=10))
    nh = str(tmp_path / "nh.ply")
    write_ply(nh, [("vertex", hc)])
    for loader, path, kw in (("load_eval_data_from_strand_integration_output", si, {}),
                             ("load_eval_data_from_neural_haircut_output", nh,
                              {"num_points_per_strand": 5})):
        x, y = getattr(je, loader)(path, **kw), getattr(te, loader)(path, **kw)
        for f, g in zip(x, y):
            if f is None:
                assert g is None
            else:
                np.testing.assert_array_equal(g, f)
    assert set(te.eval_data_loading_callbacks) == set(je.eval_data_loading_callbacks)
