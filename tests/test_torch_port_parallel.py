"""Port parity, view-parallel training: `parallel/mesh.py` of
hairgs_tpu_torch against hairgs_tpu/parallel/mesh.py on the CPU.

The JAX side runs on the 8 virtual CPU devices of tests/conftest.py; the
port side in 2 gloo ranks (tests/torch_port_ranks.py), spawned once for
the module. Inputs are the fixtures of tests/test_parallel.py (Stage I,
4 views) and `__graft_entry__._tiny_hair_setup` (Stage III, 4 views).

Tolerances: the mesh-size rule and the view slices equal; one step against
JAX's make_sharded_*_step and make_shardmap_*_step on make_mesh(2): loss
within 1e-4 relative, parameters, Adam moments and statistics within rtol
1e-3 / atol 1e-5 (tests/test_slab.py's step tolerances; the sums run in
another order), counters equal, and the two ranks' results bit-equal.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_ranks import Ranks

N_VIEWS = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers, and the
    idle OpenMP threads of a torch pool spin on cores the others need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cam_arrays(cam):
    return {k: None if v is None else np.asarray(v) for k, v in cam._asdict().items()}


def _gaussian_case():
    from tests.test_parallel import CFG, H, W, build_setup

    model, cams, opt = build_setup(N_VIEWS)
    inputs = dict(
        params={k: np.asarray(v) for k, v in model.params._asdict().items()},
        stats={k: np.asarray(v) for k, v in model.stats._asdict().items()},
        moments={g: {k: np.asarray(v) for k, v in getattr(model.opt_state, g)
                     ._asdict().items()} for g in ("mu", "nu")},
        active=np.asarray(model.active), cams=[_cam_arrays(c) for c in cams],
        opt=dataclasses.asdict(opt), raster=dataclasses.asdict(CFG), width=W, height=H)
    return model, cams, opt, inputs


def _hair_case(tmp):
    import __graft_entry__ as ge
    from hairgs_tpu.render import RasterConfig

    model, opt, camera_at, (sp, sv), (w, h) = ge._tiny_hair_setup()
    cams = [camera_at(0.8 * i) for i in range(N_VIEWS)]
    cfg = RasterConfig(max_tiles_per_gaussian=8, max_pairs_per_tile=128, chunk=16)
    path = os.path.join(tmp, "hair_state.npz")
    model.save_checkpoint(path)
    inputs = dict(checkpoint=path, capacity_round=256, cams=[_cam_arrays(c) for c in cams],
                  smooth_pairs=np.asarray(sp), smooth_valid=np.asarray(sv),
                  opt=dataclasses.asdict(opt), raster=dataclasses.asdict(cfg),
                  width=w, height=h)
    return (model, cams, opt, cfg, sp, sv, (w, h)), inputs


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The port's steps in 2 gloo ranks, and JAX's in this process while
    they run."""
    tmp = str(tmp_path_factory.mktemp("parallel"))
    g_model, g_cams, g_opt, g_inputs = _gaussian_case()
    hair, h_inputs = _hair_case(tmp)
    ranks = Ranks(2, ["view_gaussian", "view_hair"],
                  {"gaussian": g_inputs, "hair": h_inputs}, tmp)
    jax_steps = dict(gaussian=_jax_gaussian_steps(g_model, g_cams, g_opt),
                     hair=_jax_hair_steps(*hair))
    return dict(ranks=ranks.wait(), jax=jax_steps)


def _jax_hair_steps(model, cams, opt, cfg, sp, sv, size):
    from hairgs_tpu.core.camera import stack_cameras
    from hairgs_tpu.parallel.mesh import (
        make_mesh,
        make_sharded_hair_step,
        make_shardmap_hair_step,
    )
    from hairgs_tpu.train import make_hair_train_step

    batch = stack_cameras(cams)
    mesh = make_mesh(2)
    kw = dict(width=size[0], height=size[1], active_sh_degree=0,
              spatial_lr_scale=model.spatial_lr_scale,
              dist_to_scale_factor=model.dist_to_scale_factor)
    copy = lambda t: jax.tree.map(jnp.array, t)  # noqa: E731 (steps donate)
    steps = {"sharded": make_sharded_hair_step(make_hair_train_step(opt, cfg, **kw), mesh),
             "shardmap": make_shardmap_hair_step(opt, cfg, mesh=mesh, **kw)}
    return {name: step(copy(model.params), model.graph, copy(model.stats),
                       copy(model.opt_state), batch, jnp.asarray(1), sp, sv)
            for name, step in steps.items()}


def _jax_gaussian_steps(model, cams, opt):
    from hairgs_tpu.core.camera import stack_cameras
    from hairgs_tpu.parallel.mesh import (
        make_mesh,
        make_sharded_gaussian_step,
        make_shardmap_gaussian_step,
    )
    from hairgs_tpu.train import make_gaussian_train_step
    from tests.test_parallel import CFG, H, W

    batch = stack_cameras(cams)
    mesh = make_mesh(2)
    copy = lambda t: jax.tree.map(jnp.array, t)  # noqa: E731 (steps donate)
    step_fn = make_gaussian_train_step(opt, CFG, width=W, height=H, active_sh_degree=0)
    out = {"sharded": make_sharded_gaussian_step(step_fn, mesh)(
        copy(model.params), copy(model.stats), copy(model.opt_state), model.active,
        batch, jnp.asarray(1))}
    out["shardmap"] = make_shardmap_gaussian_step(
        opt, CFG, width=W, height=H, active_sh_degree=0, mesh=mesh)(
        copy(model.params), copy(model.stats), copy(model.opt_state), model.active,
        batch, jnp.asarray(1))
    return out


def _check_step(port, ref, what):
    p, s, o, m, _ = ref
    np.testing.assert_allclose(port["metrics"]["loss"], float(m["loss"]), rtol=1e-4,
                               err_msg=what)
    for key in ("overflow_pairs", "overflow_tiles"):
        assert port["metrics"][key] == int(m[key]), (what, key)
    for group, tree in (("params", p), ("stats", s), ("opt", o.mu)):
        for name, value in tree._asdict().items():
            np.testing.assert_allclose(port[group][name], np.asarray(value),
                                       rtol=1e-3, atol=1e-5,
                                       err_msg=f"{what} {group}/{name}")


def _ranks_equal(a, b, path=""):
    """Every value bit-equal between two ranks' results, but the image of
    each rank's own first view."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            if k != "image":
                _ranks_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, float):
        assert a == b or (np.isnan(a) and np.isnan(b)), path


@pytest.mark.parametrize(("view_batch", "world", "max_devices"), [
    (1, 8, 0), (2, 8, 0), (4, 8, 0), (6, 8, 0), (8, 8, 0), (12, 8, 0),
    (6, 4, 0), (5, 8, 0), (8, 8, 3), (8, 3, 0), (9, 8, 0), (4, 1, 0)])
def test_view_mesh_rule_matches_jax(monkeypatch, view_batch, world, max_devices):
    from hairgs_tpu.parallel import mesh as jmesh
    from hairgs_tpu_torch.parallel import mesh as tmesh

    devices = jax.devices()[:world]
    monkeypatch.setattr(jmesh.jax, "devices", lambda: devices)
    ref = jmesh.make_view_mesh(view_batch, max_devices)
    monkeypatch.setattr(tmesh, "_world", lambda: (0, world))
    monkeypatch.setattr(tmesh, "make_mesh", lambda n, device=None: n)
    got = tmesh.make_view_mesh(view_batch, max_devices, device="cpu")
    assert got == (None if ref is None else ref.devices.size)


def test_shard_view_batch_gives_contiguous_slices():
    from hairgs_tpu_torch.core.camera import make_camera, stack_cameras
    from hairgs_tpu_torch.parallel.mesh import Mesh, shard_view_batch

    cams = stack_cameras([make_camera(np.eye(3), np.array([0.0, 0.0, i]), 1.0, 1.0,
                                      device="cpu") for i in range(6)])
    for i in range(3):
        mesh = Mesh(np.arange(3).reshape(3, 1), torch.device("cpu"), "gloo", (i, 0), {})
        local = shard_view_batch(cams, mesh)
        np.testing.assert_array_equal(local.world_view.numpy(),
                                      cams.world_view[2 * i:2 * i + 2].numpy())
        assert local.image is None
    with pytest.raises(ValueError, match="does not split"):
        shard_view_batch(stack_cameras([make_camera(np.eye(3), np.zeros(3), 1.0, 1.0,
                                                    device="cpu")] * 4), mesh)


@pytest.mark.parametrize("name", ["sharded", "shardmap"])
def test_view_parallel_gaussian_step_matches_jax(both, name):
    ref = both["jax"]["gaussian"]
    for rank, res in both["ranks"].items():
        for port_name in ("sharded", "shardmap", "driver"):
            _check_step(res["view_gaussian"][port_name], ref[name],
                        f"rank {rank} port {port_name} vs jax {name}")
    _ranks_equal(both["ranks"][0]["view_gaussian"], both["ranks"][1]["view_gaussian"])
    calls, nbytes = both["ranks"][0]["view_gaussian"]["sharded"]["collectives"]
    n_params = sum(v.size for v in both["ranks"][0]["view_gaussian"]["sharded"]
                   ["params"].values())
    # one SUM (gradients, statistics, losses), one SUM of the counters, one
    # MAX (max_radii2d, pairs_demand)
    assert calls == 3
    assert nbytes > 4 * n_params


@pytest.mark.parametrize("name", ["sharded", "shardmap"])
def test_view_parallel_hair_step_matches_jax(both, name):
    for rank, res in both["ranks"].items():
        for port_name in ("sharded", "shardmap", "driver"):
            assert "loss/smooth" in res["view_hair"][port_name]["metrics"]
            _check_step(res["view_hair"][port_name], both["jax"]["hair"][name],
                        f"rank {rank} port {port_name} vs jax {name}")
    _ranks_equal(both["ranks"][0]["view_hair"], both["ranks"][1]["view_hair"])


def test_backend_rule():
    from hairgs_tpu_torch.parallel.mesh import choose_backend

    assert choose_backend(torch.device("cpu"), 1) == "gloo"
    assert choose_backend(torch.device("cpu"), 8) == "gloo"
