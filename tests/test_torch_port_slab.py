"""Port parity, depth-slab sharding: `parallel/slab.py` and
`render/binning.py::permute_rows` of hairgs_tpu_torch against
hairgs_tpu/parallel/slab.py on the CPU.

The JAX side runs on the 8 virtual CPU devices of tests/conftest.py; the
port's slab train steps run in 4 gloo ranks as a (2 x 2) mesh
(tests/torch_port_ranks.py), spawned once for the module under a faked
layout of two nodes of two ranks. Inputs are the fixtures of
tests/test_slab.py and `__graft_entry__._tiny_hair_setup`.

Tolerances: compose_segments within 1e-6 (one segment) and 1e-5
(associativity), as tests/test_slab.py; render_gauss_sharded on the XLA
path against JAX's at k = 2, 4, 8: render and T within rtol 1e-4 / atol
1e-5, radii equal, overflow 0, gradients within rtol 5e-3 / atol 1e-6; on
the paged path (the kernels' plain versions) against one render of the
depth-permuted rows with the card's gates (1e-3; gradients 5e-3 x max
|g|); permute_rows bit-equal to autograd's index_add; the slab steps
against JAX's make_slab_train_step on make_2d_mesh(2, 2): loss within
1e-4 relative, parameters, moments and statistics within rtol 1e-3 / atol
1e-5 (test_slab.py's), and the ranks bit-equal.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_ranks import Ranks

CPU = torch.device("cpu")
SLABS = (2, 4, 8)
BG = (0.1, 0.2, 0.3, 0.0, 0.0, 0.0, 0.0)


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


def _port_camera(cam):
    from hairgs_tpu_torch.models.gaussian import camera_from_numpy

    return camera_from_numpy(_cam_arrays(cam), CPU)


def _port_params(jparams, requires_grad=False):
    from hairgs_tpu_torch.models.gaussian import params_from_numpy

    p = params_from_numpy({k: np.asarray(v) for k, v in jparams._asdict().items()}, CPU)
    return type(p)(*[t.requires_grad_(requires_grad) for t in p])


def _raster(cfg, **kw):
    from hairgs_tpu_torch.render.renderer import RasterConfig

    return RasterConfig(**{**dataclasses.asdict(cfg), **kw})


# --- the slab train steps in 4 ranks, JAX's while they run ---------------


def _step_inputs(tmp):
    import __graft_entry__ as ge
    from hairgs_tpu.render import RasterConfig
    from tests.test_slab import CFG, H, W, TestSlabTrainStep

    model, cams, opt = TestSlabTrainStep()._gaussian_setup(2)
    gaussian = dict(
        params={k: np.asarray(v) for k, v in model.params._asdict().items()},
        stats={k: np.asarray(v) for k, v in model.stats._asdict().items()},
        moments={g: {k: np.asarray(v) for k, v in getattr(model.opt_state, g)
                     ._asdict().items()} for g in ("mu", "nu")},
        active=np.asarray(model.active), cams=[_cam_arrays(c) for c in cams],
        opt=dataclasses.asdict(opt), raster=dataclasses.asdict(CFG), width=W, height=H)
    hmodel, hopt, camera_at, (sp, sv), (w, h) = ge._tiny_hair_setup()
    hcams = [camera_at(0.8 * i) for i in range(2)]
    hcfg = RasterConfig(max_tiles_per_gaussian=8, max_pairs_per_tile=128, chunk=16)
    path = os.path.join(tmp, "hair_state.npz")
    hmodel.save_checkpoint(path)
    hair = dict(checkpoint=path, capacity_round=256, cams=[_cam_arrays(c) for c in hcams],
                smooth_pairs=np.asarray(sp), smooth_valid=np.asarray(sv),
                opt=dataclasses.asdict(hopt), raster=dataclasses.asdict(hcfg),
                width=w, height=h)
    return ((model, cams, opt), (hmodel, hcams, hopt, hcfg, sp, sv, (w, h)),
            {"gaussian": gaussian, "hair": hair})


def _jax_slab_steps(gaussian, hair):
    from hairgs_tpu.core.camera import stack_cameras
    from hairgs_tpu.parallel.slab import make_2d_mesh, make_slab_train_step
    from tests.test_slab import CFG, H, W

    mesh = make_2d_mesh(2, 2)
    copy = lambda t: jax.tree.map(jnp.array, t)  # noqa: E731
    model, cams, opt = gaussian
    out = {"gaussian": make_slab_train_step(
        "gaussian", opt, CFG, width=W, height=H, active_sh_degree=0, mesh=mesh)(
        copy(model.params), copy(model.stats), copy(model.opt_state), model.active,
        stack_cameras(cams), jnp.asarray(1))}
    model, cams, opt, cfg, sp, sv, (w, h) = hair
    out["hair"] = make_slab_train_step(
        "hair", opt, cfg, width=w, height=h, active_sh_degree=0,
        spatial_lr_scale=model.spatial_lr_scale,
        dist_to_scale_factor=model.dist_to_scale_factor, mesh=mesh)(
        copy(model.params), model.graph, copy(model.stats), copy(model.opt_state),
        stack_cameras(cams), jnp.asarray(1), sp, sv)
    return out


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("slab"))
    gaussian, hair, inputs = _step_inputs(tmp)
    ranks = Ranks(4, ["slab_steps", "node_layout"], inputs, tmp, local_world=2)
    # JAX's side of every test of the module while the ranks run
    ref = _jax_slab_steps(gaussian, hair)
    renders = {k: _jax_sharded(k) for k in SLABS}
    grads = {k: _jax_sharded_grads(k) for k in SLABS}
    return dict(ranks=ranks.wait(), jax=ref, inputs=inputs, renders=renders,
                grads=grads)


def _check_step(port, ref, what, loss_rtol=1e-4):
    p, s, o, m, _ = ref
    np.testing.assert_allclose(port["metrics"]["loss"], float(m["loss"]),
                               rtol=loss_rtol, err_msg=what)
    for key in ("overflow_pairs", "overflow_tiles"):
        assert port["metrics"][key] == int(m[key]) == 0, (what, key)
    for group, tree in (("params", p), ("stats", s), ("opt", o.mu)):
        for name, value in tree._asdict().items():
            np.testing.assert_allclose(port[group][name], np.asarray(value),
                                       rtol=1e-3, atol=1e-5,
                                       err_msg=f"{what} {group}/{name}")


@pytest.mark.parametrize("kind", ["gaussian", "hair"])
def test_slab_step_matches_jax(steps, kind):
    for rank, res in steps["ranks"].items():
        _check_step(res["slab_steps"][kind], steps["jax"][kind], f"rank {rank} {kind}")
    first = steps["ranks"][0]["slab_steps"][kind]
    for rank in (1, 2, 3):
        other = steps["ranks"][rank]["slab_steps"][kind]
        for group in ("params", "stats", "opt"):
            for name, value in first[group].items():
                np.testing.assert_array_equal(other[group][name], value,
                                              err_msg=f"rank {rank} {group}/{name}")
        assert other["metrics"] == first["metrics"]
    if kind == "gaussian":
        # viewspace gradients over gauss, gradients over the mesh, the
        # view-level values over data, the counters, the maxima; and one
        # segment gather per view
        calls, nbytes = first["collectives"]
        assert calls == 5 + 1
        assert [r["slab_steps"]["coords"] for r in steps["ranks"].values()] == \
            [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_one_process_slab_step_matches_jax(steps):
    """The 1 x 1 slab step (no process group): the one-process oracle of
    the card's slab checks, the same update over both views."""
    from hairgs_tpu_torch.core.camera import stack_cameras
    from hairgs_tpu_torch.models.gaussian import (
        adam_state_from_numpy,
        camera_from_numpy,
        params_from_numpy,
        stats_from_numpy,
    )
    from hairgs_tpu_torch.config import OptimizationConfig
    from hairgs_tpu_torch.parallel.mesh import build_mesh
    from hairgs_tpu_torch.parallel.slab import make_slab_train_step
    from hairgs_tpu_torch.render.renderer import RasterConfig

    g = steps["inputs"]["gaussian"]
    step = make_slab_train_step(
        "gaussian", OptimizationConfig(**g["opt"]), RasterConfig(**g["raster"]),
        width=g["width"], height=g["height"], active_sh_degree=0,
        mesh=build_mesh([[0]], device="cpu"))
    cams = stack_cameras([camera_from_numpy(c, CPU) for c in g["cams"]])
    p, s, o, m, _ = step(params_from_numpy(g["params"], CPU),
                         stats_from_numpy(g["stats"], CPU),
                         adam_state_from_numpy(g["moments"], 0, CPU),
                         torch.tensor(g["active"]), cams, 1)
    port = dict(params={k: v.numpy() for k, v in p._asdict().items()},
                stats={k: v.numpy() for k, v in s._asdict().items()},
                opt={k: v.numpy() for k, v in o.mu._asdict().items()},
                metrics={k: float(v) for k, v in m.items()})
    _check_step(port, steps["jax"]["gaussian"], "1x1 slab step")


def test_2d_mesh_layout_over_fake_nodes(steps):
    """LOCAL_WORLD_SIZE=2 (two nodes of two ranks): rows stay inside a
    node; an interleaved node list puts each gauss group on one node and
    the data axis across both, as JAX's multi-slice layout does."""
    from hairgs_tpu_torch.parallel.slab import grid_ranks

    for rank, res in steps["ranks"].items():
        env, inter = res["node_layout"]["env"], res["node_layout"]["interleaved"]
        np.testing.assert_array_equal(env["grid"], [[0, 1], [2, 3]])
        np.testing.assert_array_equal(inter["grid"], [[0, 2], [1, 3]])
        np.testing.assert_array_equal(env["gauss"], env["grid"][rank // 2])
        np.testing.assert_array_equal(env["data"], env["grid"][:, rank % 2])
        row = rank % 2  # interleaved: node = rank % 2
        np.testing.assert_array_equal(inter["gauss"], inter["grid"][row])
        assert inter["coords"] == (row, rank // 2)
    np.testing.assert_array_equal(grid_ranks(2, 4, [i // 4 for i in range(8)]),
                                  [[0, 1, 2, 3], [4, 5, 6, 7]])
    np.testing.assert_array_equal(grid_ranks(2, 4, [i % 2 for i in range(8)]),
                                  [[0, 2, 4, 6], [1, 3, 5, 7]])
    np.testing.assert_array_equal(grid_ranks(2, 2, [0] * 4), [[0, 1], [2, 3]])
    with pytest.raises(ValueError, match="inside one node"):
        grid_ranks(2, 4, [0, 0, 0, 1, 1, 1, 1, 1])


# --- single-process pieces -------------------------------------------------


def test_compose_segments_matches_jax():
    from hairgs_tpu.parallel.slab import compose_segments as jcompose
    from hairgs_tpu_torch.parallel.slab import compose_segments

    rng = np.random.default_rng(0)
    c = rng.uniform(0, 1, (2, 4, 4, 3)).astype(np.float32)
    t = rng.uniform(0.2, 1, (2, 4, 4)).astype(np.float32)
    color, trans = compose_segments(torch.tensor(c), torch.tensor(t))
    np.testing.assert_allclose(color.numpy(), c[0] + t[0][..., None] * c[1], rtol=1e-6)
    np.testing.assert_allclose(trans.numpy(), t[0] * t[1], rtol=1e-6)
    rng = np.random.default_rng(1)
    c = rng.uniform(0, 1, (8, 4, 4, 3)).astype(np.float32)
    t = rng.uniform(0.2, 1, (8, 4, 4)).astype(np.float32)
    color_a, t_a = compose_segments(torch.tensor(c), torch.tensor(t))
    ch1, th1 = compose_segments(torch.tensor(c[:4]), torch.tensor(t[:4]))
    ch2, th2 = compose_segments(torch.tensor(c[4:]), torch.tensor(t[4:]))
    np.testing.assert_allclose(color_a.numpy(), (ch1 + th1[..., None] * ch2).numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t_a.numpy(), (th1 * th2).numpy(), rtol=1e-5, atol=1e-6)
    jc, jt = jcompose(jnp.asarray(c), jnp.asarray(t))
    np.testing.assert_allclose(color_a.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(t_a.numpy(), np.asarray(jt), rtol=1e-6, atol=1e-7)


def test_permute_rows_matches_index_add():
    from hairgs_tpu_torch.render.binning import permute_rows

    rng = np.random.default_rng(4)
    rows = torch.tensor(rng.normal(size=(37, 5)).astype(np.float32), requires_grad=True)
    perm = torch.tensor(rng.permutation(37))
    inv = torch.argsort(perm)
    g = torch.tensor(rng.normal(size=(37, 5)).astype(np.float32))
    out = permute_rows(rows, perm, inv)
    np.testing.assert_array_equal(out.detach().numpy(), rows.detach().numpy()[perm.numpy()])
    (ours,) = torch.autograd.grad(out, rows, g)
    (ref,) = torch.autograd.grad(rows[perm], rows, g)  # autograd's index_add
    np.testing.assert_array_equal(ours.numpy(), ref.numpy())
    np.testing.assert_array_equal(
        ref.numpy(), torch.zeros(37, 5).index_add_(0, perm, g).numpy())
    # padding: a shorter permutation whose cotangent gets zero rows appended
    rows2 = torch.tensor(rng.normal(size=(5, 2)).astype(np.float32), requires_grad=True)
    fwd, bwd = torch.tensor([2, 0, 1]), torch.tensor([1, 2, 0])
    (g2,) = torch.autograd.grad(permute_rows(rows2, fwd, bwd), rows2, torch.ones(3, 2))
    np.testing.assert_array_equal(g2.numpy(), [[1, 1]] * 3 + [[0, 0]] * 2)


def _jax_sharded(k, n=96):
    """JAX's slab render of tests/test_slab.py's scene with a scattered
    fifth of the rows inactive and a background."""
    from hairgs_tpu.models.gaussian import gaussian_render_inputs
    from hairgs_tpu.parallel.slab import gauss_mesh, render_gauss_sharded
    from tests.test_slab import CFG, H, W, build_scene

    model, cam = build_scene(n=n)
    active = np.asarray(model.active).copy()
    active[::5] = False
    bg = jnp.asarray(BG)
    mesh = gauss_mesh(k)

    @jax.jit  # one program: eager shard_map takes minutes on the CPU
    def run(params, active):
        return render_gauss_sharded(
            cam, **gaussian_render_inputs(params, cam.cam_center, 0), active=active,
            bg=bg, width=W, height=H, config=CFG, mesh=mesh)

    return model, cam, active, run(model.params, jnp.asarray(active))


def _port_sharded(model, cam, active, k, bg=None, **raster):
    """The port's slab render of the same scene."""
    from hairgs_tpu_torch.models.gaussian import gaussian_render_inputs
    from hairgs_tpu_torch.parallel.slab import render_gauss_sharded
    from tests.test_slab import CFG, H, W

    tcam = _port_camera(cam)
    inputs = gaussian_render_inputs(_port_params(model.params), tcam.cam_center, 0)
    return render_gauss_sharded(tcam, **inputs, active=torch.tensor(active),
                                bg=None if bg is None else torch.tensor(np.asarray(bg)),
                                width=W, height=H, config=_raster(CFG, **raster),
                                num_slabs=k)


@pytest.mark.parametrize("k", SLABS)
def test_render_gauss_sharded_matches_jax(steps, k):
    model, cam, active, ref = steps["renders"][k]
    assert not active.all()
    out = _port_sharded(model, cam, active, k, bg=BG)
    for key in ("render", "render_photo", "final_T"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-4, atol=1e-5, err_msg=key)
    np.testing.assert_array_equal(out["radii"].numpy(), np.asarray(ref["radii"]))
    np.testing.assert_array_equal(out["visibility_filter"].numpy(),
                                  np.asarray(ref["visibility_filter"]))
    for key in ("overflow_pairs", "overflow_tiles", "overflow_capacity"):
        assert int(out[key]) == int(ref[key]) == 0, key
    assert int(out["pairs_demand"]) == int(ref["pairs_demand"])


def _jax_sharded_grads(k):
    from hairgs_tpu.models.gaussian import gaussian_render_inputs as jinputs
    from hairgs_tpu.parallel.slab import gauss_mesh, render_gauss_sharded as jsharded
    from tests.test_slab import CFG, H, W, build_scene

    model, cam = build_scene(n=64)
    target = np.random.default_rng(7).uniform(0, 1, (H, W, 7)).astype(np.float32)
    mesh = gauss_mesh(k)

    def loss_j(params):
        img = jsharded(cam, **jinputs(params, cam.cam_center, 0), active=model.active,
                       width=W, height=H, config=CFG, mesh=mesh)["render"]
        return jnp.mean((img - target) ** 2)

    return model, cam, target, jax.jit(jax.grad(loss_j))(model.params)


@pytest.mark.parametrize("k", SLABS)
def test_render_gauss_sharded_gradients_match_jax(steps, k):
    from hairgs_tpu_torch.models.gaussian import gaussian_render_inputs
    from hairgs_tpu_torch.parallel.slab import render_gauss_sharded
    from tests.test_slab import CFG, H, W

    model, cam, target, g_jax = steps["grads"][k]
    tcam = _port_camera(cam)
    params = _port_params(model.params, requires_grad=True)
    img = render_gauss_sharded(tcam, **gaussian_render_inputs(params, tcam.cam_center, 0),
                               active=torch.tensor(np.asarray(model.active)), width=W,
                               height=H, config=_raster(CFG), num_slabs=k)["render"]
    torch.mean((img - torch.tensor(target)) ** 2).backward()
    for name, gj in g_jax._asdict().items():
        np.testing.assert_allclose(getattr(params, name).grad.numpy(), np.asarray(gj),
                                   rtol=5e-3, atol=1e-6, err_msg=name)


def _permuted_oracle(model, cam, active, raster, params=None):
    """One render of the depth-permuted rows (the card's oracle)."""
    from hairgs_tpu_torch.models.gaussian import gaussian_render_inputs
    from hairgs_tpu_torch.parallel.slab import _depth_slab_permutation
    from hairgs_tpu_torch.render.renderer import render
    from tests.test_slab import H, W

    tcam = _port_camera(cam)
    params = _port_params(model.params) if params is None else params
    inputs = gaussian_render_inputs(params, tcam.cam_center, 0)
    act = torch.tensor(active)
    perm, _ = _depth_slab_permutation(inputs["means3d"], act, tcam.world_view)
    out = render(tcam, **{k: v[perm] for k, v in inputs.items()}, active=act[perm],
                 width=W, height=H, config=raster)
    return out, perm


@pytest.mark.parametrize("k", [2, 4])
def test_paged_slab_render_matches_permuted_oracle(k):
    """The paged path (the kernels' plain versions) with the gates of the
    card's phase 14: image and T within 1e-3 of one render of the
    depth-permuted rows, radii equal, overflow 0, gradients within 5e-3 x
    max |g| and 1e-5 in relative L2."""
    from hairgs_tpu_torch.models.gaussian import gaussian_render_inputs
    from hairgs_tpu_torch.parallel.slab import render_gauss_sharded
    from tests.test_slab import CFG, H, W, build_scene

    model, cam = build_scene(n=96)
    active = np.asarray(model.active)
    raster = _raster(CFG, use_pallas=True, chunk=16)
    target = torch.tensor(np.random.default_rng(7).uniform(0, 1, (H, W, 7))
                          .astype(np.float32))
    p_ref = _port_params(model.params, requires_grad=True)
    ref, perm = _permuted_oracle(model, cam, active, raster, p_ref)
    torch.mean((ref["render"] - target) ** 2).backward()
    tcam = _port_camera(cam)
    p_out = _port_params(model.params, requires_grad=True)
    out = render_gauss_sharded(tcam, **gaussian_render_inputs(p_out, tcam.cam_center, 0),
                               active=torch.tensor(active), width=W, height=H,
                               config=raster, num_slabs=k)
    torch.mean((out["render"] - target) ** 2).backward()
    for key in ("overflow_pairs", "overflow_tiles", "overflow_capacity"):
        assert int(out[key]) == int(ref[key]) == 0, key
    for key in ("render", "final_T"):
        assert (out[key] - ref[key]).abs().max() <= 1e-3, key
    np.testing.assert_array_equal(out["radii"].numpy(), ref["radii"][torch.argsort(perm)]
                                  .detach().numpy())
    for name in p_out._fields:
        a, b = getattr(p_out, name).grad, getattr(p_ref, name).grad
        if b.numel() == 0:
            continue
        scale = max(b.abs().max().item(), 1e-12)
        assert (a - b).abs().max() <= 5e-3 * scale, name
        assert (a - b).norm() <= 1e-5 * max(b.norm().item(), 1e-12) + 1e-12, name


def test_slab_boundary_latch_bound():
    """A slab starts from T = 1, so its stop test (T below T_EPS = 1e-4)
    sees T / T_prefix where one table sees T. A Gaussian can pass that
    test in one render and not in the other only while T (1 - alpha) <
    T_EPS, i.e. T < T_EPS / (1 - ALPHA_MAX) = 0.01. So: pixels whose
    one-table transmittance stays >= 0.01 agree to rounding, and the
    others differ by at most the transmittance left at that point (< 0.01)
    times the largest feature. A dense, opaque scene makes pixels latch."""
    from hairgs_tpu_torch.models.gaussian import GaussianParams, gaussian_render_inputs
    from hairgs_tpu_torch.parallel.slab import render_gauss_sharded
    from hairgs_tpu_torch.render.composite_pairs import ALPHA_MAX, T_EPS
    from hairgs_tpu_torch.render.renderer import RasterConfig, render

    from hairgs_tpu_torch.core.camera import make_camera

    rng = np.random.default_rng(11)
    n, w, h = 256, 32, 32
    xyz = np.stack([rng.uniform(-0.15, 0.15, n), rng.uniform(-0.15, 0.15, n),
                    rng.uniform(2.5, 3.5, n)], 1)
    params = GaussianParams(
        xyz=torch.tensor(xyz, dtype=torch.float32),
        features_dc=torch.tensor(rng.normal(0, 1, (n, 1, 3)), dtype=torch.float32),
        features_rest=torch.zeros(n, 0, 3),
        scaling=torch.full((n, 3), float(np.log(0.05))),
        rotation=torch.tensor([[1.0, 0, 0, 0]]).repeat(n, 1),
        opacity=torch.full((n, 1), 6.0),  # sigmoid: 0.9975, clamped to 0.99
        mask=torch.zeros(n, 1))
    cam = make_camera(np.eye(3), np.zeros(3), 0.6, 0.6, device="cpu")
    raster = RasterConfig(max_tiles_per_gaussian=16, max_pairs_per_tile=256, chunk=16,
                          use_pallas=True)
    inputs = gaussian_render_inputs(params, cam.cam_center, 0)
    active = torch.ones(n, dtype=torch.bool)
    from hairgs_tpu_torch.parallel.slab import _depth_slab_permutation

    perm, _ = _depth_slab_permutation(inputs["means3d"], active, cam.world_view)
    ref = render(cam, **{k: v[perm] for k, v in inputs.items()}, active=active,
                 width=w, height=h, config=raster)
    fmax = inputs["features"].abs().max()
    edge = T_EPS / (1.0 - ALPHA_MAX)
    deep = ref["final_T"] < edge
    assert deep.sum() > 40  # pixels latch: the bound is not vacuous
    assert int(ref["overflow_tiles"]) == 0
    for k in (2, 4, 8):
        out = render_gauss_sharded(cam, **inputs, active=active, width=w, height=h,
                                   config=raster, num_slabs=k)
        d_img = (out["render"] - ref["render"]).abs().amax(dim=-1)
        d_t = (out["final_T"] - ref["final_T"]).abs()
        assert d_img[~deep].max() <= 1e-5 * fmax, k
        assert d_t[~deep].max() <= 1e-6, k
        assert d_img.max() <= edge * fmax, k
        assert d_t.max() <= edge, k
        print(f"k={k}: pixels below T {edge}: {int(deep.sum())}, largest image "
              f"difference there {float(d_img[deep].max()):.3e} (bound "
              f"{float(edge * fmax):.3e}), elsewhere {float(d_img[~deep].max()):.3e}")
