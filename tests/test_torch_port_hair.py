"""Port parity, the hair model: `hair_derived`, `hair_render_inputs`, both
strand losses, the hair state crossing between the packages (PLY and npz),
and one Stage-III train step of hairgs_tpu_torch against hairgs_tpu on the
CPU.

Tolerances: derived parameters and render inputs within 1e-6, their
gradients within 1e-5 x max |g| (JAX's), with collapsed segments and pad
rows present and no NaN anywhere; both strand losses' values within 1e-6
relative and their endpoint gradients within 1e-5 x max |g|; PLY and npz
planes bit-equal in both directions (the port's PLY rewrite byte-identical);
one train step on the XLA path: loss within 1e-5 relative, updated
parameters within 1e-4 relative L2; the port's paged path (plain versions
of its kernels) against JAX's XLA path with the gates of
scripts/tpu_parity_check.py:50-58 (image 1e-3, loss 1e-2 relative,
gradients 5e-3 x max |g|).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_render import HEIGHT, WIDTH

CPU = torch.device("cpu")
FIELDS = ("endpoints", "features_dc", "features_rest", "opacity", "mask", "width")
SEG_KEYS = ("features_dc", "features_rest", "opacity", "mask", "width")
RASTER = dict(max_tiles_per_gaussian=16, max_pairs_per_tile=64, chunk=16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers, and the
    idle OpenMP threads of a torch pool spin on cores the others need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def hair_arrays(seed=0, n_strands=6, per_strand=4, n_collapsed=2, sh_rest=0):
    """Chains of segments in front of the camera of tests/test_render.py,
    plus collapsed segments (two endpoints at one position); numpy
    (endpoints, pairs, seg) as HairModel.install takes them."""
    rng = np.random.default_rng(seed)
    eps, pairs = [], []
    for _ in range(n_strands):
        start = np.array([rng.uniform(-0.6, 0.6), rng.uniform(-0.5, 0.5),
                          rng.uniform(2.5, 4.0)])
        base = len(eps)
        eps.append(start)
        for k in range(per_strand):
            step = rng.normal(0, 1, 3) * np.array([1.0, 1.0, 0.3])
            eps.append(eps[-1] + 0.12 * step / np.linalg.norm(step))
            pairs.append([base + k, base + k + 1])
    for _ in range(n_collapsed):
        p = np.array([rng.uniform(-0.5, 0.5), rng.uniform(-0.4, 0.4), 3.0])
        pairs.append([len(eps), len(eps) + 1])
        eps += [p, p.copy()]
    ns = len(pairs)
    opacity = rng.uniform(0.3, 0.9, (ns, 1))
    mask = rng.uniform(0.3, 0.9, (ns, 1))
    seg = dict(
        features_dc=rng.normal(0, 0.5, (ns, 1, 3)),
        features_rest=rng.normal(0, 0.1, (ns, sh_rest, 3)),
        opacity=np.log(opacity / (1 - opacity)),
        mask=np.log(mask / (1 - mask)),
        width=np.log(rng.uniform(0.01, 0.03, (ns, 1))),
    )
    return (np.asarray(eps, np.float32), np.asarray(pairs, np.int64),
            {k: v.astype(np.float32) for k, v in seg.items()})


def both_models(arrays, capacity_round=64, sh_degree=0):
    """The same arena installed in a JAX and a port HairModel."""
    from hairgs_tpu.models.hair import HairModel as JHair
    from hairgs_tpu_torch.models.hair import HairModel

    eps, pairs, seg = arrays
    jm = JHair(sh_degree=sh_degree, capacity_round=capacity_round)
    jm.install(eps, pairs, {k: v.copy() for k, v in seg.items()})
    tm = HairModel(sh_degree=sh_degree, capacity_round=capacity_round, device="cpu")
    tm.install(eps, pairs, {k: v.copy() for k, v in seg.items()})
    return jm, tm


def _close_grad(gt, gj, rel, name):
    gj = np.asarray(gj)
    gt = np.asarray(gt)
    assert np.isfinite(gt).all() and np.isfinite(gj).all(), name
    np.testing.assert_allclose(gt, gj, rtol=0, atol=rel * max(np.abs(gj).max(), 1e-12),
                               err_msg=name)


def _weights(shapes, seed=7):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(0, 1, s).astype(np.float32) for k, s in shapes.items()}


def test_hair_derived_and_render_inputs_match_jax():
    from hairgs_tpu.models.hair import hair_derived as jderived
    from hairgs_tpu.models.hair import hair_render_inputs as jinputs
    from hairgs_tpu_torch.models.hair import hair_derived, hair_render_inputs

    jm, tm = both_models(hair_arrays(seed=1, sh_rest=3), sh_degree=1)
    factor = jm.dist_to_scale_factor
    cam = np.array([0.1, -0.2, 0.0], np.float32)
    for name, jfn, tfn in (
            ("derived", lambda p: jderived(p, jm.graph, factor),
             lambda p: hair_derived(p, tm.graph, factor)),
            ("render_inputs",
             lambda p: jinputs(p, jm.graph, jnp.asarray(cam), 1, factor),
             lambda p: hair_render_inputs(p, tm.graph, torch.from_numpy(cam), 1,
                                          factor))):
        # compiled: far quicker on the CPU than op-by-op dispatch
        out_j = jax.jit(jfn)(jm.params)
        w = _weights({k: v.shape for k, v in out_j.items()})
        leaves = [t.detach().requires_grad_(True) for t in tm.params]
        out_t = tfn(type(tm.params)(*leaves))
        for k in out_j:
            np.testing.assert_allclose(out_t[k].detach().numpy(), np.asarray(out_j[k]),
                                       rtol=0, atol=1e-6, err_msg=f"{name} {k}")
            assert np.isfinite(out_t[k].detach().numpy()).all()

        def jloss(p):
            out = jfn(p)
            return sum(jnp.sum(out[k] * w[k]) for k in out)

        gj = jax.jit(jax.grad(jloss))(jm.params)
        tloss = sum(torch.sum(out_t[k] * torch.from_numpy(w[k])) for k in out_t)
        gt = torch.autograd.grad(tloss, leaves, allow_unused=True)
        for field, a, b in zip(FIELDS, gt, gj):
            if np.asarray(b).size and a is not None:
                _close_grad(a.numpy(), b, 1e-5, f"{name} d{field}")
        # the collapsed segments (the last two live rows) and the pad rows
        # point the rotation at identity and get finite gradients
        rot = out_t.get("rotation", out_t.get("rotations"))
        ns = tm.num_segments
        np.testing.assert_array_equal(rot[ns - 2:].detach().numpy(),
                                      np.tile([1.0, 0, 0, 0], (rot.shape[0] - ns + 2, 1)))


def test_sub_10um_segments_of_the_fitted_graph_match_jax():
    """On a crop of the fitted USC-HairSalon start with its 531 segments
    under 10 um: the render inputs' endpoint gradient (a fixed random
    cotangent) grows as one over the segment's length, so those segments'
    endpoints carry nearly all of it, in JAX as in the port; each endpoint's
    gradient equals JAX's within 1e-5 of its largest component, on those
    segments as on the rest."""
    from hairgs_tpu.models.hair import hair_render_inputs as jinputs
    from hairgs_tpu_torch.models.hair import hair_render_inputs
    from tests.test_torch_port_topo import _fitted_crop

    eps, pairs, seg, _, _, length = _fitted_crop()
    jm, tm = both_models((eps, pairs, seg))
    factor, cam = jm.dist_to_scale_factor, np.array([0.0, 0.0, 0.5], np.float32)

    def jfn(p):
        return jinputs(p, jm.graph, jnp.asarray(cam), 0, factor)

    w = _weights({k: v.shape for k, v in jax.jit(jfn)(jm.params).items()})
    gj = jax.jit(jax.grad(lambda p: sum(jnp.sum(jfn(p)[k] * w[k]) for k in w)))(jm.params)
    leaves = [t.detach().requires_grad_(True) for t in tm.params]
    out = hair_render_inputs(type(tm.params)(*leaves), tm.graph, torch.from_numpy(cam), 0,
                             factor)
    (gt,) = torch.autograd.grad(sum(torch.sum(out[k] * torch.from_numpy(w[k])) for k in out),
                                leaves[:1])
    n = tm.num_endpoints
    gj, gt = np.asarray(gj.endpoints)[:n], gt.numpy()[:n]
    tiny = np.unique(pairs[length < 1e-5])
    for g in (gj, gt):
        assert (g[tiny] ** 2).sum() > 0.99 * (g ** 2).sum()
    rel = np.abs(gt - gj).max(axis=1) / np.maximum(np.abs(gj).max(axis=1), 1e-30)
    assert rel.max() < 1e-5


def test_clip_gradient_at_the_bound_matches_jnp_clip():
    """jnp.clip passes half the gradient at a bound (max/min split a tie);
    the port's smoothness loss clips with torch.maximum/minimum, which do
    the same, where torch.clamp would pass all of it."""
    lo, hi = -1 + 1e-6, 1 - 1e-6
    xs = np.array([hi, lo, 0.3, 1.0, -1.0], np.float32)
    gj = [float(jax.grad(lambda x: jnp.clip(x, lo, hi))(jnp.float32(x))) for x in xs]
    x = torch.tensor(xs, requires_grad=True)
    torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi)).sum().backward()
    assert x.grad.tolist() == gj == [0.5, 0.5, 1.0, 0.0, 0.0]


def _strand_tables(seed=2):
    from hairgs_tpu_torch.topo.strands import smooth_pair_indices

    eps, pairs, _ = hair_arrays(seed=seed)
    # a fold-back (antiparallel) pair: dot = -1, clipped
    eps[2] = eps[0]
    strands = [pairs[i:i + 4] for i in range(0, 24, 4)]
    info = type("Info", (), {"list_strands": strands})
    sp, valid = smooth_pair_indices(info, max_pairs=32)
    return eps, sp, valid


def test_angle_smoothness_loss_matches_jax():
    from hairgs_tpu.losses.strand import angle_smoothness_loss as jloss
    from hairgs_tpu_torch.losses.strand import angle_smoothness_loss

    eps, sp, valid = _strand_tables()
    vj, gj = jax.jit(jax.value_and_grad(
        lambda e: jloss(e, jnp.asarray(sp), jnp.asarray(valid))))(jnp.asarray(eps))
    e = torch.from_numpy(eps).requires_grad_(True)
    vt = angle_smoothness_loss(e, torch.from_numpy(sp).long(), torch.from_numpy(valid))
    (gt,) = torch.autograd.grad(vt, e)
    assert float(vj) > 0
    np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=1e-6)
    _close_grad(gt.numpy(), gj, 1e-5, "smooth")
    # no valid pair: 0 and a zero gradient
    none = np.zeros_like(valid)
    e = torch.from_numpy(eps).requires_grad_(True)
    v0 = angle_smoothness_loss(e, torch.from_numpy(sp).long(), torch.from_numpy(none))
    (g0,) = torch.autograd.grad(v0, e)
    assert float(v0.detach()) == 0.0 and float(g0.abs().max()) == 0.0


def test_smoothness_table_padded_to_the_arena_changes_nothing():
    """The train driver pads the smoothness table to the segment arena's
    capacity, so its shape changes only with the arena's. On a graph of
    several-segment strands (as merges leave them) the loss and its endpoint
    gradient equal those of the table in its 1024-row bucket, and match
    JAX's loss on JAX's table within the tolerances above. Its padding rows
    point at endpoints spread over the graph, not all at endpoint 0."""
    from hairgs_tpu.losses.strand import angle_smoothness_loss as jloss
    from hairgs_tpu.topo.strands import compute_strands_info as jinfo
    from hairgs_tpu.topo.strands import smooth_pair_indices as jsmooth
    from hairgs_tpu_torch.losses.strand import angle_smoothness_loss
    from hairgs_tpu_torch.topo.strands import compute_strands_info, smooth_pair_indices

    jm, tm = both_models(hair_arrays(seed=6, n_strands=10))
    for m in (jm, tm):
        m.ref_strand_root = np.array([[0.0, 0.0, 2.0]], np.float32)
    info = compute_strands_info(tm)
    arena = smooth_pair_indices(info, max_pairs=tm.capacity)
    bucket = smooth_pair_indices(info)
    assert arena[0].shape[0] == tm.capacity != bucket[0].shape[0] == 1024
    assert arena[1].sum() == bucket[1].sum() > 0
    # each padding row on one endpoint, the rows spread over the endpoints
    pad = arena[0][~arena[1]]
    assert (pad == pad[:, :1, :1]).all()
    assert np.bincount(pad[:, 0, 0]).max() <= -(-pad.shape[0] // info.list_strands.flat.max())
    eps = tm.params.endpoints.detach()

    def value_and_grad(sp, valid):
        e = eps.clone().requires_grad_(True)
        v = angle_smoothness_loss(e, torch.from_numpy(sp).long(), torch.from_numpy(valid))
        (g,) = torch.autograd.grad(v, e)
        return v.detach(), g

    (va, ga), (vb, gb) = value_and_grad(*arena), value_and_grad(*bucket)
    assert float(va) > 0
    assert torch.equal(va, vb) and torch.equal(ga, gb)
    sp, valid = jsmooth(jinfo(jm))
    vj, gj = jax.jit(jax.value_and_grad(
        lambda e: jloss(e, jnp.asarray(sp), jnp.asarray(valid))))(jnp.asarray(eps.numpy()))
    np.testing.assert_allclose(float(va), float(vj), rtol=1e-6)
    _close_grad(ga.numpy(), gj, 1e-5, "smooth")


def test_magnet_loss_matches_jax_with_ties():
    """Tips on a grid (equidistant neighbours, so the top 3 tie), pad rows,
    a tip whose segment is collapsed (invalid), against lax.top_k."""
    from hairgs_tpu.losses.strand import strand_joints_magnet_loss as jloss
    from hairgs_tpu_torch.losses.strand import strand_joints_magnet_loss

    g = np.stack(np.meshgrid(np.arange(4), np.arange(3), indexing="ij"), -1)
    tips = np.zeros((12, 3), np.float32)
    tips[:, :2] = 0.01 * g.reshape(-1, 2)
    other = tips + np.array([0, 0, 0.02], np.float32)
    other[5] = tips[5]  # collapsed tip segment
    eps = np.concatenate([tips, other], 0)
    m = 16
    ids = np.zeros(m, np.int32)
    comp = np.zeros(m, np.int32)
    valid = np.zeros(m, bool)
    ids[:12] = np.arange(12)
    comp[:12] = np.arange(12) + 12
    valid[:12] = True
    # strand complementaries among the listed tips for some rows
    comp[0], comp[1] = 1, 0
    vj, gj = jax.jit(jax.value_and_grad(lambda e: jloss(
        e, jnp.asarray(ids), jnp.asarray(comp), jnp.asarray(valid))))(jnp.asarray(eps))
    e = torch.from_numpy(eps).requires_grad_(True)
    vt = strand_joints_magnet_loss(e, torch.from_numpy(ids).long(),
                                   torch.from_numpy(comp).long(),
                                   torch.from_numpy(valid))
    (gt,) = torch.autograd.grad(vt, e)
    assert float(vj) > 0
    np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=1e-6)
    _close_grad(gt.numpy(), gj, 1e-5, "magnet")


def _assert_planes_equal(ta, ja, keys):
    for k in keys:
        np.testing.assert_array_equal(np.asarray(ta[k]), np.asarray(ja[k]), err_msg=k)


def test_hair_ply_crosses_both_ways(tmp_path):
    from hairgs_tpu.models.hair import HairModel as JHair
    from hairgs_tpu_torch.models.hair import HairModel

    jm, _ = both_models(hair_arrays(seed=3, sh_rest=3), sh_degree=1)
    jm.ref_strand_root = np.array([[0.0, 0.0, 3.0], [0.1, 0.1, 3.0]], np.float32)
    jm.strand_root_endpoint_idx = np.array([0, 5, 10], np.int64)
    jpath, tpath = str(tmp_path / "j.ply"), str(tmp_path / "t.ply")
    jm.save_ply(jpath)
    tm = HairModel(sh_degree=1, capacity_round=64, device="cpu")
    tm.load_ply(jpath)
    keys = ("endpoints", "endpoint_pairs") + SEG_KEYS
    _assert_planes_equal(tm.host_arrays(), jm.host_arrays(), keys)
    np.testing.assert_array_equal(tm.strand_root_endpoint_idx, jm.strand_root_endpoint_idx)
    np.testing.assert_array_equal(tm.ref_strand_root, jm.ref_strand_root)
    tm.save_ply(tpath)
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read()
    back = JHair(sh_degree=1, capacity_round=64)
    back.load_ply(tpath)
    _assert_planes_equal(back.host_arrays(), jm.host_arrays(), keys)
    assert [s.tolist() for s in back.strands_info.list_strands] == \
        [s.tolist() for s in tm.strands_info.list_strands]


def test_hair_checkpoint_crosses_both_ways(tmp_path):
    """JAX's npz state dict restores into the port in memory (restore), the
    port's save_checkpoint loads into JAX; parameters, moments, step and
    roots bit-equal."""
    from hairgs_tpu.models.hair import HairModel as JHair
    from hairgs_tpu_torch.models.hair import HairModel

    jm, _ = both_models(hair_arrays(seed=4))
    jm.ref_strand_root = np.array([[0.0, 0.0, 3.0]], np.float32)
    jm.strand_root_endpoint_idx = np.array([2, 3], np.int64)
    rng = np.random.default_rng(5)

    def stamp(tree):
        return type(tree)(*[jnp.asarray(rng.normal(size=v.shape).astype(np.float32))
                            for v in tree])

    jm.opt_state = jm.opt_state._replace(mu=stamp(jm.opt_state.mu),
                                         nu=stamp(jm.opt_state.nu),
                                         step=jnp.asarray(17, jnp.int32))
    jm.active_sh_degree = 0
    jpath = str(tmp_path / "j.npz")
    jm.save_checkpoint(jpath)
    state = dict(np.load(jpath))
    tm = HairModel(sh_degree=0, capacity_round=64, device="cpu")
    tm.restore(state)
    assert tm.capture().keys() == state.keys()
    for k, v in tm.capture().items():
        np.testing.assert_array_equal(v, state[k], err_msg=k)
        assert v.dtype == state[k].dtype, k
    tpath = str(tmp_path / "t.npz")
    tm.save_checkpoint(tpath)
    back = JHair(sh_degree=0, capacity_round=64)
    back.load_checkpoint(tpath)
    _assert_planes_equal(back.host_arrays(), jm.host_arrays(),
                         ("endpoints", "endpoint_pairs") + SEG_KEYS)
    bm, jmm = back.host_moments(), jm.host_moments()
    for g in ("mu", "nu"):
        _assert_planes_equal(bm[g], jmm[g], FIELDS)
    assert int(back.opt_state.step) == 17
    assert len(back.strands_info.list_strands) == len(tm.strands_info.list_strands) > 0


def _step_inputs(use_pallas, lambda_magnet=0.0):
    """A hair scene, camera and tables for one Stage-III step on both
    sides."""
    from hairgs_tpu.config import OptimizationConfig as JOpt
    from hairgs_tpu.core.camera import make_camera as jmake_camera
    from hairgs_tpu.render import RasterConfig as JRaster
    from hairgs_tpu.topo.strands import magnet_indices as jmagnet
    from hairgs_tpu.topo.strands import smooth_pair_indices as jsmooth
    from hairgs_tpu.topo.strands import compute_strands_info as jinfo
    from hairgs_tpu_torch.config import OptimizationConfig
    from hairgs_tpu_torch.models.gaussian import camera_from_numpy
    from hairgs_tpu_torch.render.renderer import RasterConfig

    jm, tm = both_models(hair_arrays(seed=6, n_strands=10))
    for m in (jm, tm):
        m.ref_strand_root = np.array([[0.0, 0.0, 2.0]], np.float32)
    rng = np.random.default_rng(8)
    cam = jmake_camera(np.eye(3), np.zeros(3), fovx=1.2, fovy=1.0,
                       image=rng.uniform(0, 1, (HEIGHT, WIDTH, 3)).astype(np.float32),
                       mask=(rng.uniform(0, 1, (HEIGHT, WIDTH)) > 0.5).astype(np.float32),
                       orientation=rng.uniform(0, np.pi, (HEIGHT, WIDTH)).astype(np.float32),
                       confidence=rng.uniform(0, 1, (HEIGHT, WIDTH)).astype(np.float32))
    tcam = camera_from_numpy({k: None if v is None else np.asarray(v)
                              for k, v in cam._asdict().items()}, CPU)
    jopt = dataclasses.replace(JOpt(), lambda_magnet=lambda_magnet, lambda_smooth=0.05)
    topt = OptimizationConfig(**dataclasses.asdict(jopt))
    info = jinfo(jm)
    sp, sv = jsmooth(info)
    mag = jmagnet(jm)
    return (jm, tm, cam, tcam, jopt, topt, sp, sv, mag,
            JRaster(use_pallas=False, **RASTER), RasterConfig(use_pallas=use_pallas, **RASTER))


def test_hair_train_step_matches_jax():
    """One make_hair_train_step with the smoothness and the magnet terms on,
    both packages on their XLA path."""
    from hairgs_tpu.train.trainer import make_hair_train_step as jmake
    from hairgs_tpu_torch.train.trainer import make_hair_train_step

    jm, tm, cam, tcam, jopt, topt, sp, sv, mag, jraster, traster = \
        _step_inputs(False, lambda_magnet=50.0)
    kw = dict(width=WIDTH, height=HEIGHT, active_sh_degree=0,
              dist_to_scale_factor=jm.dist_to_scale_factor, use_magnet=True)
    jstep = jmake(jopt, jraster, **kw)
    tstep = make_hair_train_step(topt, traster, device="cpu", **kw)
    jp, _, _, jmet, _ = jstep(jm.params, jm.graph, jm.stats, jm.opt_state, cam,
                              jnp.asarray(1), jnp.asarray(sp), jnp.asarray(sv),
                              magnet_idx=tuple(jnp.asarray(x) for x in mag))
    tp, tstats, _, tmet, _ = tstep(
        tm.params, tm.graph, tm.stats, tm.opt_state, tcam, 1,
        torch.from_numpy(sp).long(), torch.from_numpy(sv),
        magnet_idx=(torch.from_numpy(mag[0]).long(), torch.from_numpy(mag[1]).long(),
                    torch.from_numpy(mag[2])))
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-5)
    for k in ("loss/smooth", "loss/magnet", "loss/l1", "loss/mask"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-5, err_msg=k)
    assert float(tmet["loss/smooth"]) > 0 and float(tmet["loss/magnet"]) > 0
    for name in FIELDS:
        a, b = getattr(tp, name).numpy(), np.asarray(getattr(jp, name))
        if b.size:
            assert np.linalg.norm(a - b) <= 1e-4 * np.linalg.norm(b), name
    assert float(tstats.denom.sum()) > 0


def test_hair_paged_path_matches_jax_xla_path():
    """render_loss_and_grads of the hair model: the port's paged path (the
    plain versions of its kernels) against JAX's XLA path, with the gates of
    scripts/tpu_parity_check.py."""
    from hairgs_tpu.models.hair import hair_render_inputs as jinputs
    from hairgs_tpu.train.trainer import render_loss_and_grads as jrlg
    from hairgs_tpu_torch.models.hair import hair_render_inputs
    from hairgs_tpu_torch.train.trainer import render_loss_and_grads

    jm, tm, cam, tcam, jopt, topt, *_, jraster, traster = _step_inputs(True)
    f = jm.dist_to_scale_factor
    loss_j, grads_j, _, aux_j = jax.jit(lambda p: jrlg(
        lambda q: jinputs(q, jm.graph, cam.cam_center, 0, f), p, cam,
        jm.graph.seg_active, jopt, jraster, WIDTH, HEIGHT))(jm.params)
    loss_t, grads_t, _, aux_t = render_loss_and_grads(
        lambda q: hair_render_inputs(q, tm.graph, tcam.cam_center, 0, f), tm.params,
        tcam, tm.graph.seg_active, topt, traster, WIDTH, HEIGHT)
    assert np.abs(aux_t["image"].numpy() - np.asarray(aux_j["image"])).max() < 1e-3
    assert abs(float(loss_t) - float(loss_j)) < 1e-2 * max(1.0, abs(float(loss_j)))
    for name in FIELDS:
        b = np.asarray(getattr(grads_j, name))
        if b.size:
            _close_grad(getattr(grads_t, name).numpy(), b, 5e-3, name)
