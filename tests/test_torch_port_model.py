"""Port parity, the Gaussian model: kNN, `create_from_pcd`, densification,
opacity reset, cleaning and capture/restore of hairgs_tpu_torch against
hairgs_tpu on the CPU.

Tolerances: kNN squared distances rel 1e-5 plus an absolute term of four
fp32 ulps of |q|^2 + |p|^2, the rounding of the |q|^2 + |p|^2 - 2 q.p form,
whose product torch.matmul and XLA accumulate in other orders (indices
equal where the distances are untied by more than that); normals
|cos| > 1 - 1e-5; parameters after `create_from_pcd` and densification
within 1e-6, the initial log-scales plus what that rounding of the 3-NN
distances moves them by; densify info, counts, the remapped Adam moments
and the step exactly equal. The Stage-I chains under the 1k recipe's flags:
the loss within 1e-4 relative up to the first event (the pipeline test's
gate), with JAX's initial 3-NN distances given to the port.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers, and the
    idle OpenMP threads of a torch pool spin on cores the others need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity", "mask")


def _points_with_duplicates(n=400, n_dup=25, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    pts[rng.choice(n, n_dup, replace=False)] = pts[rng.choice(n, n_dup, replace=False)]
    return pts


def _form_atol(q, p):
    """Four fp32 ulps of the largest |q|^2 + |p|^2."""
    return 4 * np.finfo(np.float32).eps * float(
        np.sum(q * q, axis=1).max() + np.sum(p * p, axis=1).max())


def test_knn_and_mean_sq_dist_3nn_match_jax():
    from hairgs_tpu.ops.knn import knn as jknn, mean_sq_dist_3nn as jmsd
    from hairgs_tpu_torch.ops.knn import knn, mean_sq_dist_3nn

    pts = _points_with_duplicates()
    q = pts[:150]
    k = 6
    atol = _form_atol(q, pts)
    # one neighbour more on the JAX side: the gap to rank k + 1
    dj, ij = (np.asarray(a) for a in jknn(jnp.asarray(q), jnp.asarray(pts),
                                          k=k + 1, chunk=64))
    dt, it = knn(torch.from_numpy(q), torch.from_numpy(pts), k, chunk=64)
    dt, it = dt.numpy(), it.numpy()
    np.testing.assert_allclose(dt, dj[:, :k], rtol=1e-5, atol=atol)
    # a rank's index is determined where its distance stands apart from
    # both neighbours in the sorted row by more than the rounding
    d_pad = np.concatenate([np.full((dj.shape[0], 1), -1.0), dj], axis=1)
    gap = 2 * (atol + 1e-5 * d_pad[:, 1:-1])
    untied = ((d_pad[:, 1:-1] - d_pad[:, :-2] > gap)
              & (d_pad[:, 2:] - d_pad[:, 1:-1] > gap))
    assert untied.mean() > 0.5 and (~untied).any()
    np.testing.assert_array_equal(it[untied], ij[:, :k][untied])
    # the duplicates: both packages find the twin at distance 0 (up to the
    # rounding)
    twin = dj[:, 1] <= atol
    assert twin.any() and np.array_equal(dt[:, 1] <= atol, twin)
    np.testing.assert_allclose(
        mean_sq_dist_3nn(torch.from_numpy(pts), chunk=128).numpy(),
        np.asarray(jmsd(jnp.asarray(pts), chunk=128)), rtol=1e-5, atol=atol)


def test_knn_valid_mask_excludes_points():
    from hairgs_tpu.ops.knn import knn as jknn
    from hairgs_tpu_torch.ops.knn import knn

    pts = _points_with_duplicates(n=200, n_dup=0, seed=1)
    valid = np.arange(200) % 3 != 0
    dj, ij = jknn(jnp.asarray(pts), jnp.asarray(pts), k=3, valid=jnp.asarray(valid))
    dt, it = knn(torch.from_numpy(pts), torch.from_numpy(pts), 3,
                 valid=torch.from_numpy(valid))
    assert valid[it.numpy()].all()
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5,
                               atol=_form_atol(pts, pts))


def test_estimate_pointcloud_normals_match_jax_up_to_sign():
    from hairgs_tpu.ops.knn import estimate_pointcloud_normals as jnormals
    from hairgs_tpu_torch.ops.knn import estimate_pointcloud_normals

    # a noisy sphere: each neighbourhood has one clearly smallest direction
    rng = np.random.default_rng(2)
    d = rng.normal(size=(600, 3))
    pts = (d / np.linalg.norm(d, axis=1, keepdims=True)
           * (1.0 + 0.002 * rng.normal(size=(600, 1)))).astype(np.float32)
    nj = np.asarray(jnormals(pts, k=20, chunk=128))
    nt = estimate_pointcloud_normals(torch.from_numpy(pts), k=20, chunk=128).numpy()
    cos = np.abs(np.sum(nj * nt, axis=1))
    assert cos.min() > 1 - 1e-5, cos.min()
    # and they are the sphere's normals
    assert np.abs(np.sum(nt * pts, axis=1)).min() > 0.95


def _cloud(n=300, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 0.05, (n, 3)).astype(np.float32),
            rng.uniform(0, 1, (n, 3)).astype(np.float32))


def _create_both(n=300, sh_degree=1, seed=3, capacity_round=128):
    from hairgs_tpu.models.gaussian import GaussianModel as JModel
    from hairgs_tpu_torch.models.gaussian import GaussianModel

    pts, cols = _cloud(n, seed)
    jm = JModel(sh_degree=sh_degree, spatial_lr_scale=1.3,
                capacity_round=capacity_round)
    tm = GaussianModel(sh_degree=sh_degree, spatial_lr_scale=1.3,
                       capacity_round=capacity_round, device="cpu")
    jm.create_from_pcd(pts, cols)
    tm.create_from_pcd(pts, cols)
    return jm, tm


def _assert_models_close(jm, tm, atol=1e-6, skip=()):
    assert tm.count == jm.count and tm.capacity == jm.capacity
    np.testing.assert_array_equal(tm.active.numpy(), np.asarray(jm.active))
    for name in FIELDS:
        if name not in skip:
            np.testing.assert_allclose(getattr(tm.params, name).numpy(),
                                       np.asarray(getattr(jm.params, name)),
                                       rtol=0, atol=atol, err_msg=name)


def test_create_from_pcd_matches_jax():
    jm, tm = _create_both()
    _assert_models_close(jm, tm, skip=("scaling",))
    # scaling = log(sqrt(mean 3-NN d^2)): a rounding e of d^2 moves it by
    # e / (2 d^2)
    pts, _ = _cloud()
    sj = np.asarray(jm.params.scaling)[:300]
    bound = 1e-6 + 0.5 * _form_atol(pts, pts) / np.exp(2 * sj)
    assert (np.abs(tm.params.scaling.numpy()[:300] - sj) <= bound).all()
    assert not tm.params.scaling[300:].any()
    assert tm.capacity == 384 and tm.count == 300
    assert int(tm.opt_state.step) == 0
    for name in FIELDS:
        assert not getattr(tm.opt_state.mu, name).any()


def _planted_state(jm, seed=4):
    """A JAX capture() with varied scales, opacities, rotations, Adam
    moments and densification statistics that make every branch fire:
    clones, splits, low-opacity and world-size prunes."""
    from hairgs_tpu.config import OptimizationConfig as JOpt

    jm.training_setup(JOpt())
    state = jm.capture()
    rng = np.random.default_rng(seed)
    n = jm.count
    state["param/scaling"] = np.log(rng.choice(
        [1e-3, 5e-3, 2e-2, 0.2], size=(n, 3)) * rng.uniform(0.8, 1.2, (n, 3))
    ).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    state["param/rotation"] = q
    opa = rng.choice([0.001, 0.3, 0.9], size=(n, 1))
    state["param/opacity"] = np.log(opa / (1 - opa)).astype(np.float32)
    for g in ("mu", "nu"):
        for f in FIELDS:
            shape = state[f"{g}/{f}"].shape
            v = rng.normal(size=shape).astype(np.float32)
            state[f"{g}/{f}"] = np.abs(v) if g == "nu" else v
    state["step"] = np.asarray(37)
    state["stats/xyz_grad_accum"] = (rng.uniform(0, 1e-3, (n, 1))
                                     * rng.integers(0, 2, (n, 1))).astype(np.float32)
    denom = rng.integers(0, 4, (n, 1)).astype(np.float32)
    state["stats/denom"] = denom
    state["stats/max_radii2d"] = rng.uniform(0, 30, n).astype(np.float32)
    return state


@pytest.mark.parametrize("size_th", [None, 1000])
def test_densification_matches_jax(size_th):
    from hairgs_tpu.config import OptimizationConfig as JOpt
    from hairgs_tpu_torch.config import OptimizationConfig

    jm, tm = _create_both(sh_degree=1)
    state = _planted_state(jm)
    jm.restore(state)
    tm.restore(state)
    tm.training_setup(OptimizationConfig())
    jm.training_setup(JOpt())
    _assert_models_close(jm, tm, atol=0)
    extent = 1.5
    info_j = jm.densification(extent, size_th)
    info_t = tm.densification(extent, size_th)
    assert info_t == info_j
    assert info_t["clone"] > 0 and info_t["split"] > 0
    assert info_t["prune_low_opacity"] > 0
    if size_th:
        assert info_t["prune_big_ws"] > 0
    assert tm.count == jm.count != 300
    _assert_models_close(jm, tm)
    assert int(tm.opt_state.step) == int(jm.opt_state.step) == 37
    for g in ("mu", "nu"):
        for name in FIELDS:
            np.testing.assert_array_equal(
                getattr(getattr(tm.opt_state, g), name).numpy(),
                np.asarray(getattr(getattr(jm.opt_state, g), name)),
                err_msg=f"{g} {name}")
    for name in ("max_radii2d", "xyz_grad_accum", "denom"):
        assert not getattr(tm.stats, name).any()
    # the split sampler advanced identically: a second event draws alike
    tm.restore(state)
    jm.restore(state)
    assert tm.densification(extent, size_th) == jm.densification(extent, size_th)
    _assert_models_close(jm, tm)


def test_reset_opacity_and_clean_gaussians_match_jax():
    jm, tm = _create_both(sh_degree=0)
    state = _planted_state(jm, seed=5)
    # masks on both sides of the foreground threshold
    rng = np.random.default_rng(6)
    state["param/mask"] = rng.normal(0, 2, (jm.count, 1)).astype(np.float32)
    for m in (jm, tm):
        m.restore(state)
    jm.reset_opacity()
    tm.reset_opacity()
    _assert_models_close(jm, tm)
    assert not tm.opt_state.mu.opacity.any() and not tm.opt_state.nu.opacity.any()
    np.testing.assert_array_equal(tm.opt_state.mu.xyz.numpy(),
                                  np.asarray(jm.opt_state.mu.xyz))
    for m in (jm, tm):
        m.restore(state)
    np.testing.assert_array_equal(tm.compute_foreground_mask_np(),
                                  jm.compute_foreground_mask_np())
    np.testing.assert_array_equal(tm.compute_foreground_mask_np(lines_only=True),
                                  jm.compute_foreground_mask_np(lines_only=True))
    np.testing.assert_allclose(tm.get_segment_endpoints_np(),
                               jm.get_segment_endpoints_np(), rtol=0, atol=1e-6)
    jm.clean_gaussians()
    tm.clean_gaussians()
    assert 0 < tm.count < 300
    _assert_models_close(jm, tm)
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(tm.opt_state.nu, name).numpy(),
                                      np.asarray(getattr(jm.opt_state.nu, name)))


def test_capture_restore_round_trip_and_checkpoint(tmp_path):
    from hairgs_tpu_torch.models.gaussian import GaussianModel

    jm, tm = _create_both(sh_degree=1)
    state = _planted_state(jm)
    state["active_sh_degree"] = np.asarray(1)
    tm.restore(state)
    again = tm.capture()
    assert set(again) == set(state)
    for k, v in state.items():
        np.testing.assert_array_equal(again[k], v, err_msg=k)
    path = str(tmp_path / "ckpt" / "state.npz")
    tm.save_checkpoint(path)
    other = GaussianModel(sh_degree=1, capacity_round=128, device="cpu")
    other.load_checkpoint(path)
    assert other.count == tm.count and other.active_sh_degree == 1
    for k, v in other.capture().items():
        np.testing.assert_array_equal(v, again[k], err_msg=k)
    # the Stage-II conversion, a stub that raised before the hair model was
    # ported (tests/test_torch_port_topo.py holds it to JAX)
    hair = tm.to_hair_model(np.zeros((4, 3), np.float32))
    assert (hair.num_segments, hair.num_endpoints) == (tm.count, 2 * tm.count)
    assert hair.device == tm.device


def test_model_is_a_dataclass_with_jax_fields():
    from hairgs_tpu.models.gaussian import GaussianModel as JModel
    from hairgs_tpu_torch.models.gaussian import GaussianModel

    jf = {f.name for f in dataclasses.fields(JModel)}
    tf = {f.name for f in dataclasses.fields(GaussianModel)}
    assert jf <= tf and tf - jf == {"device"}
    assert GaussianModel(device="cpu").dist_to_scale_factor == JModel().dist_to_scale_factor


def test_stage1_chains_agree_under_the_1k_flags_from_one_init(tmp_path, monkeypatch):
    """The principal axis is discontinuous where scales tie: `argmax` over
    the three scales picks the first of equal values, and the kNN init
    makes all three equal. The port's 3-NN distances differ from JAX's in
    the last bits (the |q|^2 + |p|^2 - 2 q.p products round in another
    order, the bound of test_create_from_pcd_matches_jax), and on the
    reference scene at 128 px under --antialiasing --alpha_min 1e-5 one
    Gaussian's scales then tie the other way by iteration 3: the orientation
    loss parts by 2e-3. So the port's init takes JAX's distances here, and
    the two drivers' chains must then agree within the unchanged 1e-4 loss
    gate to the first densify event under the 1k recipe's COMMON flags. The
    image metrics at the end are stubbed in both (16 renders each; they
    decide nothing here)."""
    import random

    import hairgs_tpu.evaluation.image_metrics as jim
    import hairgs_tpu.logging_utils as jlog
    import hairgs_tpu_torch.evaluation.image_metrics as tim
    import hairgs_tpu_torch.logging_utils as tlog
    import hairgs_tpu_torch.ops.knn as tknn
    from hairgs_tpu.ops.knn import mean_sq_dist_3nn as jmsd
    from hairgs_tpu_torch.drivers import pipeline
    from hairgs_tpu_torch.io.dataset import read_colmap_scene_info
    from test_torch_port_pipeline import (
        _Recorder,
        _run_stage,
        _same_run,
        feed_jax_init_distances,
    )

    scene = str(tmp_path / "data")
    pipeline.write_reference_scene(scene, "cpu", 128)
    pts = read_colmap_scene_info(scene).points.astype(np.float32)
    d_jax = np.asarray(jmsd(jnp.asarray(pts)))
    d_port = tknn.mean_sq_dist_3nn(torch.from_numpy(pts)).numpy()
    assert not np.array_equal(d_port, d_jax)  # the rounding the feed removes
    feed_jax_init_distances(monkeypatch)
    for m in (jim, tim):
        monkeypatch.setattr(m, "evaluate_image_metrics", lambda *a, **k: {})
    # without the feed these flags part the chains at iteration 3
    # (11.8159 against 11.8403)
    flags = [*pipeline.RECIPE_1K_COMMON, "--iterations", "3", "--position_lr_max_steps",
             "10", "--log_interval", "1", "--densify_from_iter", "2",
             "--densification_interval", "3", "--ip", "", "--data_device", "cpu"]
    recs = {}
    for package in ("jax", "torch"):
        recs[package] = rec = _Recorder()
        monkeypatch.setattr(jlog if package == "jax" else tlog, "get_logger",
                            lambda args, rec=rec: rec)
        random.seed(0)
        np.random.seed(0)
        _run_stage(package, "stage1", ["-s", scene, "-m", str(tmp_path / package), *flags],
                   monkeypatch, recs[package])
    assert _same_run(recs["jax"], recs["torch"]) == [3]
