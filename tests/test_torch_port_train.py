"""Port parity, Stage-I training: `render_loss_and_grads`, one whole train
step and the bench scene of hairgs_tpu_torch against hairgs_tpu on the CPU.

The JAX side runs its plain XLA compositor (`use_pallas=False`), which
tests/test_pallas.py holds to the Pallas kernels; the port runs either the
paged path (`use_pallas=True`, the plain versions of its CUDA kernels) or
its own XLA path. Tolerances are those of
tests/test_pallas.py::TestDualCotangent: loss rtol 1e-4, gradients atol
3e-3 x max |g|.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_render import HEIGHT, WIDTH, make_scene

CPU = torch.device("cpu")
N = 30
RASTER = dict(max_tiles_per_gaussian=16, max_pairs_per_tile=64, chunk=16)
PARAM_FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
                "opacity", "mask")


def _grad_close(gt, gj, err_msg=""):
    gj = np.asarray(gj)
    scale = max(np.abs(gj).max(), 1e-4)
    np.testing.assert_allclose(np.asarray(gt), gj, atol=3e-3 * scale, rtol=0,
                               err_msg=err_msg)


def _scene():
    """The scene of tests/test_pallas.py::TestDualCotangent: the JAX camera
    and the Stage-I parameters as numpy arrays keyed like GaussianParams."""
    cam, (means, scales, q, opacity, features) = make_scene(n=N, opacity_max=0.8)
    rng = np.random.default_rng(3)
    cam = cam._replace(
        image=jnp.asarray(rng.uniform(0, 1, (HEIGHT, WIDTH, 3)).astype(np.float32)),
        mask=jnp.asarray((rng.uniform(0, 1, (HEIGHT, WIDTH)) > 0.5).astype(np.float32)),
        orientation=jnp.asarray(rng.uniform(0, np.pi, (HEIGHT, WIDTH)).astype(np.float32)),
        confidence=jnp.asarray(rng.uniform(0, 1, (HEIGHT, WIDTH)).astype(np.float32)))
    opacity = np.asarray(opacity)
    arrays = dict(
        xyz=np.asarray(means),
        features_dc=((np.asarray(features) - 0.5) / 0.28209479177387814)[:, None, :],
        features_rest=np.zeros((N, 0, 3), np.float32),
        scaling=np.log(np.asarray(scales)),
        rotation=np.asarray(q),
        opacity=np.log(opacity / (1 - opacity))[:, None],
        mask=np.zeros((N, 1), np.float32),
    )
    return cam, {k: v.astype(np.float32) for k, v in arrays.items()}


def _both_sides(cam, arrays, use_pallas=True):
    from hairgs_tpu.config import OptimizationConfig as JOpt
    from hairgs_tpu.models.gaussian import GaussianParams as JParams
    from hairgs_tpu.render import RasterConfig as JRaster
    from hairgs_tpu_torch.config import OptimizationConfig
    from hairgs_tpu_torch.models.gaussian import camera_from_numpy, params_from_numpy
    from hairgs_tpu_torch.render.renderer import RasterConfig

    jax_side = (JParams(**{k: jnp.asarray(v) for k, v in arrays.items()}),
                jnp.ones(N, dtype=bool), JOpt(), JRaster(use_pallas=False, **RASTER))
    tcam = camera_from_numpy({k: None if v is None else np.asarray(v)
                              for k, v in cam._asdict().items()}, CPU)
    torch_side = (params_from_numpy(arrays, CPU), torch.ones(N, dtype=torch.bool),
                  OptimizationConfig(), RasterConfig(use_pallas=use_pallas, **RASTER),
                  tcam)
    return jax_side, torch_side


def test_optimization_config_matches_jax():
    from hairgs_tpu.config import OptimizationConfig as JOpt
    from hairgs_tpu_torch.config import OptimizationConfig

    assert dataclasses.asdict(OptimizationConfig()) == dataclasses.asdict(JOpt())


def _check_render_loss_and_grads(use_pallas):
    """Loss, the total-loss parameter gradients and the photometric-only
    viewspace gradient against the JAX XLA path."""
    from hairgs_tpu.models.gaussian import gaussian_render_inputs as jinputs
    from hairgs_tpu.train.trainer import render_loss_and_grads as jrlg
    from hairgs_tpu_torch.models.gaussian import gaussian_render_inputs
    from hairgs_tpu_torch.train.trainer import render_loss_and_grads

    cam, arrays = _scene()
    (jp, jactive, jopt, jraster), (tp, tactive, topt, traster, tcam) = \
        _both_sides(cam, arrays, use_pallas)
    # one compiled program: far quicker on the CPU than op-by-op dispatch
    loss_j, grads_j, offset_j, aux_j = jax.jit(lambda p: jrlg(
        lambda q: jinputs(q, cam.cam_center, 0), p, cam, jactive, jopt,
        jraster, WIDTH, HEIGHT))(jp)
    loss_t, grads_t, offset_t, aux_t = render_loss_and_grads(
        lambda p: gaussian_render_inputs(p, tcam.cam_center, 0), tp, tcam,
        tactive, topt, traster, WIDTH, HEIGHT)

    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-4)
    for name in PARAM_FIELDS:
        gj = np.asarray(getattr(grads_j, name))
        if gj.size:
            _grad_close(getattr(grads_t, name).numpy(), gj, name)
    assert np.abs(np.asarray(offset_j)).max() > 0
    _grad_close(offset_t.numpy(), offset_j, "offset_grad")
    for name, v in aux_t["loss_dict"].items():
        np.testing.assert_allclose(float(v), float(aux_j["loss_dict"][name]),
                                   rtol=1e-4, err_msg=name)
    np.testing.assert_allclose(aux_t["image"].numpy(), np.asarray(aux_j["image"]),
                               atol=3e-5)
    for name in ("overflow_pairs", "overflow_tiles", "overflow_capacity",
                 "pairs_demand"):
        assert int(aux_t[name]) == int(aux_j[name]), name


def test_render_loss_and_grads_matches_jax_plain_path():
    """The port's paged path: the offset gradient comes from the aux rows of
    the dual-cotangent backward."""
    _check_render_loss_and_grads(use_pallas=True)


def test_render_loss_and_grads_xla_path_matches_jax():
    """Both sides on the XLA path: the offset gradient is the photometric
    loss's alone, from a second pull."""
    _check_render_loss_and_grads(use_pallas=False)


def _second_camera(cam):
    """A second view of _scene(): the camera turned 0.15 rad about y, with
    its own targets."""
    from hairgs_tpu.core.camera import make_camera as jmake_camera

    a = 0.15
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    rng = np.random.default_rng(11)
    return jmake_camera(
        R, np.array([0.1, 0.0, 0.3]), fovx=1.2, fovy=1.0,
        image=rng.uniform(0, 1, (HEIGHT, WIDTH, 3)).astype(np.float32),
        mask=(rng.uniform(0, 1, (HEIGHT, WIDTH)) > 0.5).astype(np.float32),
        orientation=rng.uniform(0, np.pi, (HEIGHT, WIDTH)).astype(np.float32),
        confidence=rng.uniform(0, 1, (HEIGHT, WIDTH)).astype(np.float32))


def test_one_train_step_matches_jax():
    """One whole step: statistics (denom and max_radii2d exactly equal),
    Adam moments, and the updated parameters wherever the gradient is large
    enough for its sign to be certain (Adam's first step moves every
    parameter by lr * sign(g))."""
    _check_one_step(batched=False, use_pallas=True)


def test_one_train_step_xla_path_matches_jax():
    """The same with the port on its XLA path: the statistics then come
    from the second, photometric-only pull."""
    _check_one_step(batched=False, use_pallas=False)


def test_batched_train_step_matches_jax():
    """A 2-view stacked step on the port's paged path against JAX's
    make_gaussian_train_step on stack_cameras (XLA path): losses and
    gradients averaged over the views, statistics counted per view."""
    _check_one_step(batched=True, use_pallas=True)


def _check_one_step(batched, use_pallas):
    from hairgs_tpu.core.camera import stack_cameras as jstack
    from hairgs_tpu.optim import adam_init as jadam_init
    from hairgs_tpu.train.trainer import make_gaussian_train_step as jmake
    from hairgs_tpu.models.gaussian import GaussianStats as JStats
    from hairgs_tpu_torch.core.camera import stack_cameras
    from hairgs_tpu_torch.models.gaussian import camera_from_numpy, stats_from_numpy
    from hairgs_tpu_torch.optim import adam_init
    from hairgs_tpu_torch.train.trainer import make_gaussian_train_step

    cam, arrays = _scene()
    (jp, jactive, jopt, jraster), (tp, tactive, topt, traster, tcam) = \
        _both_sides(cam, arrays, use_pallas)
    if batched:
        cam2 = _second_camera(cam)
        tcam = stack_cameras([tcam, camera_from_numpy(
            {k: None if v is None else np.asarray(v)
             for k, v in cam2._asdict().items()}, CPU)])
        cam = jstack([cam, cam2])
    stats = dict(max_radii2d=np.zeros(N, np.float32),
                 xyz_grad_accum=np.zeros((N, 1), np.float32),
                 denom=np.zeros((N, 1), np.float32))
    jstats = JStats(**{k: jnp.asarray(v) for k, v in stats.items()})
    tstats = stats_from_numpy(stats, CPU)
    jstep = jmake(jopt, jraster, width=WIDTH, height=HEIGHT, active_sh_degree=0)
    tstep = make_gaussian_train_step(topt, traster, width=WIDTH, height=HEIGHT,
                                     active_sh_degree=0, device="cpu")
    jp2, jstats2, jopt2, jmetrics, jimg = jstep(jp, jstats, jadam_init(jp),
                                                jactive, cam, jnp.asarray(1))
    tp2, tstats2, topt2, tmetrics, timg = tstep(tp, tstats, adam_init(tp),
                                                tactive, tcam, 1)

    np.testing.assert_array_equal(tstats2.denom.numpy(), np.asarray(jstats2.denom))
    np.testing.assert_array_equal(tstats2.max_radii2d.numpy(),
                                  np.asarray(jstats2.max_radii2d))
    assert float(tstats2.denom.sum()) > 0
    # in a batch, a Gaussian seen by both views is counted twice
    assert float(tstats2.denom.max()) == (2.0 if batched else 1.0)
    _grad_close(tstats2.xyz_grad_accum.numpy(), jstats2.xyz_grad_accum,
                "xyz_grad_accum")
    np.testing.assert_allclose(float(tmetrics["loss"]), float(jmetrics["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(float(tmetrics["psnr"]), float(jmetrics["psnr"]),
                               rtol=1e-4)
    assert int(tmetrics["pairs_demand"]) == int(jmetrics["pairs_demand"])
    np.testing.assert_allclose(timg.numpy(), np.asarray(jimg), atol=3e-5)
    assert int(topt2.step) == int(jopt2.step) == 1
    for name in PARAM_FIELDS:
        mu_j = np.asarray(getattr(jopt2.mu, name))
        if not mu_j.size:
            continue
        _grad_close(getattr(topt2.mu, name).numpy(), mu_j, f"mu {name}")
        sure = np.abs(mu_j) > 3e-3 * np.abs(mu_j).max()
        assert sure.any(), name
        np.testing.assert_allclose(getattr(tp2, name).numpy()[sure],
                                   np.asarray(getattr(jp2, name))[sure],
                                   rtol=1e-6, atol=1e-6, err_msg=name)
        assert torch.isfinite(getattr(tp2, name)).all(), name


@pytest.mark.parametrize("use_pallas", [True, False])
def test_one_train_step_makes_no_constant_from_a_host_number(use_pallas, monkeypatch):
    """A whole Stage-I step makes no tensor from a host number: on the card
    such a copy waits for the device, and a CUDA graph could not capture
    it. `torch.tensor` and `Tensor.new_tensor` raise while the step runs."""
    from hairgs_tpu_torch.models.gaussian import stats_from_numpy
    from hairgs_tpu_torch.optim import adam_init
    from hairgs_tpu_torch.train.trainer import make_gaussian_train_step

    cam, arrays = _scene()
    _, (tp, tactive, topt, traster, tcam) = _both_sides(cam, arrays, use_pallas)
    tstats = stats_from_numpy(dict(max_radii2d=np.zeros(N, np.float32),
                                   xyz_grad_accum=np.zeros((N, 1), np.float32),
                                   denom=np.zeros((N, 1), np.float32)), CPU)
    opt = adam_init(tp)
    step = make_gaussian_train_step(topt, traster, width=WIDTH, height=HEIGHT,
                                    active_sh_degree=0, device="cpu")

    def refuse(*args, **kwargs):
        raise AssertionError("a tensor made from a host number inside the step")

    monkeypatch.setattr(torch, "tensor", refuse)
    monkeypatch.setattr(torch.Tensor, "new_tensor", refuse)
    _, _, opt2, metrics, _ = step(tp, tstats, opt, tactive, tcam, 1)
    assert int(opt2.step) == 1 and np.isfinite(float(metrics["loss"]))


@pytest.mark.parametrize("n,width,height", [(500, 64, 48)])
def test_build_bench_scene_matches_build_bench(n, width, height):
    """The same seed draws the same scene in both frameworks: parameters
    (padded to the capacity bucket), the active mask, the Adam state and the
    four cameras with their targets."""
    from bench import build_bench
    from hairgs_tpu_torch.bench_scene import build_bench_scene
    from hairgs_tpu_torch.models.gaussian import adam_state_from_numpy, params_from_numpy

    model, opt, cams, w, h = build_bench(n_gaussians=n, width=width, height=height)
    scene = build_bench_scene(n_gaussians=n, width=width, height=height,
                              device="cpu")
    assert (scene.width, scene.height, scene.count) == (w, h, model.count)
    assert dataclasses.asdict(scene.opt_cfg) == dataclasses.asdict(opt)
    for name in PARAM_FIELDS:
        np.testing.assert_array_equal(getattr(scene.params, name).numpy(),
                                      np.asarray(getattr(model.params, name)),
                                      err_msg=name)
        for moment in ("mu", "nu"):
            np.testing.assert_array_equal(
                getattr(getattr(scene.opt_state, moment), name).numpy(),
                np.asarray(getattr(getattr(model.opt_state, moment), name)))
    np.testing.assert_array_equal(scene.active.numpy(), np.asarray(model.active))
    # the JAX model's host views (active rows only) carry across unchanged
    host = params_from_numpy(model.host_arrays(), CPU)
    moments = adam_state_from_numpy(model.host_moments(), 0, CPU)
    for name in PARAM_FIELDS:
        np.testing.assert_array_equal(getattr(host, name).numpy(),
                                      getattr(scene.params, name)[:n].numpy())
        np.testing.assert_array_equal(getattr(moments.nu, name).numpy(),
                                      getattr(scene.opt_state.nu, name)[:n].numpy())
    assert int(moments.step) == int(scene.opt_state.step) == 0
    for name in ("max_radii2d", "xyz_grad_accum", "denom"):
        np.testing.assert_array_equal(getattr(scene.stats, name).numpy(),
                                      np.asarray(getattr(model.stats, name)))
    assert len(scene.cams) == len(cams) == 4
    for ct, cj in zip(scene.cams, cams):
        for name in cj._fields:
            np.testing.assert_array_equal(getattr(ct, name).numpy(),
                                          np.asarray(getattr(cj, name)),
                                          err_msg=name)
