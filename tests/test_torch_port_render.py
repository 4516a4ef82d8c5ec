"""Port parity, render: binning, the paged compositor and `render` of
hairgs_tpu_torch against hairgs_tpu on the CPU.

The same numpy inputs go to both frameworks. The binning tables are integer
results and must be exactly equal. The compositor's plain version is held to
the JAX Pallas kernels run in interpret mode (called only a few times: the
interpreter is slow on the CPU); `render` is held to the JAX package's plain
XLA path, which tests/test_pallas.py holds to the Pallas path.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tests.test_binning_order import CHUNK as TIE_CHUNK
from tests.test_binning_order import GRID_H as TIE_GRID_H
from tests.test_binning_order import GRID_W as TIE_GRID_W
from tests.test_binning_order import K as TIE_K
from tests.test_binning_order import R_MAX as TIE_R_MAX
from tests.test_binning_order import _scene as tie_scene
from tests.test_render import HEIGHT, WIDTH, make_scene

CPU = torch.device("cpu")
TS = 16
GRID_W = (WIDTH + TS - 1) // TS
GRID_H = (HEIGHT + TS - 1) // TS
R_MAX, MAX_PAIRS, CHUNK = 16, 64, 16
MAX_CHUNKS = MAX_PAIRS // CHUNK
ALPHA_MIN = 1.0 / 255.0
FWD_ATOL = 3e-5


def _t(x):
    return torch.tensor(np.asarray(x))


def _grad_close(gt, gj, err_msg=""):
    gj = np.asarray(gj)
    scale = max(np.abs(gj).max(), 1e-12)
    np.testing.assert_allclose(np.asarray(gt), gj, atol=3e-3 * scale, rtol=0,
                               err_msg=err_msg)


def _port_camera(cam):
    from hairgs_tpu_torch.models.gaussian import camera_from_numpy

    return camera_from_numpy({k: None if v is None else np.asarray(v)
                              for k, v in cam._asdict().items()}, CPU)


def _preprocessed(n=60, seed=0, **scene_kw):
    """make_scene(n) through the port's preprocess (held to the JAX one by
    tests/test_torch_port_core.py): (prep, effective opacity, features)."""
    from hairgs_tpu_torch.render.preprocess import preprocess

    cam, args = make_scene(n=n, seed=seed, **scene_kw)
    means, scales, q, opacity, features = (_t(a) for a in args)
    prep = preprocess(means, scales, q, _port_camera(cam), WIDTH, HEIGHT, TS,
                      opacity=opacity)
    opa_eff = torch.where(prep.valid, opacity, torch.zeros_like(opacity))
    return prep, opa_eff, features


def _binning_inputs(n=60, seed=0):
    """rect, depth, valid, xy, conic and q_cut of make_scene, as numpy."""
    prep, opa_eff, _ = _preprocessed(n, seed)
    q_cut = torch.log(torch.clamp(opa_eff, min=1e-12) / ALPHA_MIN)
    return {k: v.numpy() for k, v in dict(
        rect=prep.rect, depth=prep.depth, valid=prep.valid, xy=prep.xy,
        conic=prep.conic, q_cut=q_cut).items()}


def _both_binnings(inp, grid_w, grid_h, r_max, max_pairs, chunk, **kw):
    from hairgs_tpu.render.binning import bin_gaussians_sorted as jbin
    from hairgs_tpu_torch.render.binning import bin_gaussians_sorted

    geo = {k: inp[k] for k in ("xy", "conic", "q_cut") if k in inp}
    bj = jax.jit(lambda r, d, v, g: jbin(r, d, v, grid_w, grid_h, r_max,
                                         max_pairs, chunk, **g, **kw))(
        *(jnp.asarray(inp[k]) for k in ("rect", "depth", "valid")),
        {k: jnp.asarray(v) for k, v in geo.items()})
    bt = bin_gaussians_sorted(*(_t(inp[k]) for k in ("rect", "depth", "valid")),
                              grid_w, grid_h, r_max, max_pairs, chunk,
                              **{k: _t(v) for k, v in geo.items()}, **kw)
    return bj, bt


def _assert_binning_equal(bj, bt):
    for name in bj._fields:
        np.testing.assert_array_equal(getattr(bt, name).numpy(),
                                      np.asarray(getattr(bj, name)), err_msg=name)


@pytest.mark.parametrize("pair_capacity", [0, 3 * CHUNK])
def test_bin_gaussians_sorted_exact(pair_capacity):
    """Default capacity, and a compact capacity that truncates tiles."""
    bj, bt = _both_binnings(_binning_inputs(), GRID_W, GRID_H, R_MAX,
                            MAX_PAIRS, CHUNK, tile_size=TS,
                            pair_capacity=pair_capacity)
    _assert_binning_equal(bj, bt)
    assert int(bt.counts.sum()) > 0
    if pair_capacity:
        assert int(bt.overflow_capacity) > 0


@pytest.mark.parametrize("seed,tie_fraction", [(1, 0.5), (2, 0.9)])
def test_bin_gaussians_sorted_exact_on_depth_ties(seed, tie_fraction):
    """The depth-tie scene of tests/test_binning_order.py: the fused
    [tile | quantized depth] key must order the ties as the JAX sort does."""
    rect, depth, valid = tie_scene(300, seed, tie_fraction)
    inp = dict(rect=np.asarray(rect), depth=np.asarray(depth),
               valid=np.asarray(valid))
    bj, bt = _both_binnings(inp, TIE_GRID_W, TIE_GRID_H, TIE_R_MAX, TIE_K,
                            TIE_CHUNK)
    _assert_binning_equal(bj, bt)


@pytest.mark.parametrize("bf16", [False, True])
def test_gather_pairs_forward_and_backward(bf16):
    """Both planes' gather; on a bf16 plane the backward sums each
    Gaussian's slots in f32 and rounds once to bf16, in both frameworks."""
    from hairgs_tpu.render.binning import gather_pairs as jgather
    from hairgs_tpu_torch.render.binning import gather_pairs

    _, bt = _both_binnings(_binning_inputs(), GRID_W, GRID_H, R_MAX, MAX_PAIRS,
                           CHUNK, tile_size=TS)
    src, inv = bt.paged_src.numpy(), bt.inv_paged.numpy()
    rng = np.random.default_rng(4)
    packed = rng.normal(size=(61, 8)).astype(np.float32)
    packed[-1] = 0.0
    g = rng.normal(size=(src.shape[0], 8)).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    out_j, vjp = jax.vjp(lambda p: jgather(p, jnp.asarray(src), jnp.asarray(inv),
                                           R_MAX), jnp.asarray(packed).astype(jdt))
    tp = _t(packed).to(tdt).requires_grad_(True)
    out_t = gather_pairs(tp, bt.paged_src, bt.inv_paged, R_MAX)
    assert out_t.dtype == tdt
    np.testing.assert_array_equal(out_t.detach().float().numpy(),
                                  np.asarray(out_j.astype(jnp.float32)))
    out_t.backward(_t(g).to(tdt))
    assert tp.grad.dtype == tdt
    d_j = np.asarray(vjp(jnp.asarray(g).astype(jdt))[0].astype(jnp.float32))
    if bf16:
        _assert_within_bf16_ulp(tp.grad.float().numpy(), d_j, "d_packed")
    else:
        np.testing.assert_allclose(tp.grad.numpy(), d_j, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def pair_table():
    """geo_rows, feat_rows, starts, counts of make_scene(n=40) at 48x40,
    built by the port's paged path (whose binning is held exactly to the
    JAX package's above), as numpy: both compositors get these arrays."""
    from hairgs_tpu_torch.render.binning import bin_gaussians_sorted, gather_pairs
    from hairgs_tpu_torch.render.composite_pairs import pack_geo_rows, pad_feat_rows

    prep, opa_eff, features = _preprocessed(n=40, opacity_max=0.8)
    q_cut = torch.log(torch.clamp(opa_eff, min=1e-12) / ALPHA_MIN)
    b = bin_gaussians_sorted(prep.rect, prep.depth, prep.valid, GRID_W, GRID_H,
                             R_MAX, MAX_PAIRS, CHUNK, xy=prep.xy,
                             conic=prep.conic, q_cut=q_cut, tile_size=TS)
    aux = np.random.default_rng(8).normal(size=(40, 2)).astype(np.float32)
    geo = pack_geo_rows(prep.xy, prep.conic, opa_eff, aux=_t(aux))
    feat = pad_feat_rows(torch.where(prep.valid[:, None], features,
                                     torch.zeros_like(features)), False)
    zero = lambda t: torch.cat([t, torch.zeros((1, t.shape[1]))])
    geo_rows = gather_pairs(zero(geo), b.paged_src, b.inv_paged, R_MAX).T
    feat_rows = gather_pairs(zero(feat), b.paged_src, b.inv_paged, R_MAX).T
    return tuple(np.ascontiguousarray(x.numpy())
                 for x in (geo_rows, feat_rows, b.starts, b.counts))


@pytest.mark.parametrize("with_stats", [True, False])
def test_composite_pairs_plain_matches_pallas_interpret(pair_table, with_stats):
    """Forward (out, trans, tstarts over live chunks) and the dual-cotangent
    VJP of the port's plain version against the JAX Pallas kernels."""
    from hairgs_tpu.render.pallas_composite import _forward_pallas
    from hairgs_tpu.render.pallas_composite import composite_pairs as jcomp
    from hairgs_tpu_torch.render import composite_pairs as cp

    geo, feat, starts, counts = pair_table
    nt, c = GRID_W * GRID_H, 3
    assert counts.max() > CHUNK  # several chunks per tile are exercised
    rng = np.random.default_rng(5)
    g_aux = rng.normal(size=(nt, 256, c)).astype(np.float32)
    g_photo = rng.normal(size=(nt, 256, c)).astype(np.float32)
    g_trans = rng.normal(size=(nt, 256)).astype(np.float32)

    static = (GRID_W, GRID_H, TS, CHUNK, MAX_CHUNKS, c, True, 1, with_stats,
              False, ALPHA_MIN)
    (out_j, _, trans_j), vjp = jax.vjp(
        lambda g, f: jcomp(g, f, jnp.asarray(starts), jnp.asarray(counts), *static),
        jnp.asarray(geo), jnp.asarray(feat))
    d_geo_j, d_feat_j = vjp((jnp.asarray(g_aux), jnp.asarray(g_photo),
                             jnp.asarray(g_trans)))

    tg, tf = _t(geo).requires_grad_(True), _t(feat).requires_grad_(True)
    out_t, photo_t, trans_t = cp.composite_pairs(
        tg, tf, _t(starts), _t(counts), GRID_W, GRID_H, TS, CHUNK, MAX_CHUNKS, c,
        with_stats=with_stats, alpha_min=ALPHA_MIN)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), atol=FWD_ATOL)
    np.testing.assert_allclose(trans_t.detach().numpy(), np.asarray(trans_j),
                               atol=FWD_ATOL)
    torch.autograd.backward([out_t, photo_t, trans_t],
                            [_t(g_aux), _t(g_photo), _t(g_trans)])
    _grad_close(tg.grad.numpy(), d_geo_j, "d_geo")
    _grad_close(tf.grad.numpy(), d_feat_j, "d_feat")
    if with_stats:
        assert np.abs(np.asarray(d_geo_j)[6:]).max() > 0
    else:
        assert tg.grad[6:].abs().max().item() == 0.0

    if with_stats:  # the start transmittances, once
        _, _, (ts_j, _) = _forward_pallas(
            jnp.asarray(geo), jnp.asarray(feat), jnp.asarray(starts),
            jnp.asarray(counts), GRID_W, GRID_H, TS, CHUNK, MAX_CHUNKS, c, True, 1)
        _, _, ts_t, _ = cp.composite_pairs_fwd_plain(
            _t(geo), _t(feat), _t(starts), _t(counts), GRID_W, TS, CHUNK,
            MAX_CHUNKS, c)
        live = np.arange(MAX_CHUNKS)[None, :] < ((counts + CHUNK - 1) // CHUNK)[:, None]
        live = np.repeat(live.reshape(-1), 256).reshape(-1, 256)
        # the Pallas kernel leaves the rows of chunks past a tile's count
        # unwritten (NaN in interpret mode): compare the live rows only
        ts_j = np.asarray(ts_j)[: nt * MAX_CHUNKS]
        np.testing.assert_allclose(ts_t.numpy()[live], ts_j[live], atol=FWD_ATOL)
        assert np.all(ts_t.numpy()[~live] == 0.0)


def _latch_fixture():
    """One tile, 8 slots centred on pixel (0,0) with conic a = c = 50:
    opacities [.99, .99, .99, 0, .5, 0, 0, 0]; the .99 splats carry colour
    (1,0,0) and the .5 splat (0,1,0)."""
    k = 8
    geo = np.zeros((8, k), np.float32)
    geo[2] = geo[4] = 50.0
    geo[5] = [0.99, 0.99, 0.99, 0, 0.5, 0, 0, 0]
    feat = np.zeros((8, k), np.float32)
    feat[0, :3] = 1.0
    feat[1, 4] = 1.0
    return geo, feat


@pytest.mark.parametrize("chunk,green,trans", [(4, 0.005, 0.005), (8, 0.0, 0.01)])
def test_chunk_boundary_latch(chunk, green, trans):
    """The transmittance latch starts again at every chunk boundary: with
    chunk 4 the third .99 splat trips it and the .5 splat in the next chunk
    adds 0.005 of green; with chunk 8 both fall in the latched chunk. The
    JAX package's plain compositor gives the same numbers."""
    from hairgs_tpu.render.composite import composite as jcomposite
    from hairgs_tpu_torch.render.composite_pairs import composite_pairs_fwd_plain

    geo, feat = _latch_fixture()
    out, t, _, _ = composite_pairs_fwd_plain(
        _t(geo), _t(feat), torch.zeros(1, dtype=torch.int32),
        torch.full((1,), 8, dtype=torch.int32), 1, TS, chunk, 8 // chunk, 3)
    np.testing.assert_allclose(out[0, 0].numpy(), [0.99, green, 0.0], atol=1e-6)
    np.testing.assert_allclose(float(t[0, 0]), trans, atol=1e-6)

    out_j, t_j = jcomposite(jnp.asarray(geo[:2].T[None]),
                            jnp.asarray(geo[2:5].T[None]), jnp.asarray(geo[5][None]),
                            jnp.asarray(feat[:3].T[None]), 1, 1, TS, chunk)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(out_j)[0], atol=1e-6)
    np.testing.assert_allclose(t[0].numpy(), np.asarray(t_j)[0], atol=1e-6)


def test_composite_pairs_cuda_tensor_never_falls_back():
    """The dispatcher sends a CUDA tensor to the kernel's wrapper and only a
    CPU tensor to the plain version; the wrapper refuses anything but CUDA
    tensors and counts no launch when it raises."""
    from hairgs_tpu_torch.render import composite_pairs as cp

    geo, feat = _latch_fixture()
    assert cp._dispatch(_t(geo), "plain", "cuda") == "plain"
    on_card = SimpleNamespace(device=torch.device("cuda", 0))
    assert cp._dispatch(on_card, "plain", "cuda") == "cuda"
    with pytest.raises(ValueError):
        cp._dispatch(torch.empty(0, device="meta"), "plain", "cuda")
    before = dict(cp.launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cp.composite_pairs_fwd_cuda(
            _t(geo), _t(feat), torch.zeros(1, dtype=torch.int32),
            torch.full((1,), 8, dtype=torch.int32), 1, TS, 4, 2, 3)
    assert cp.launches == before


def _dual_cotangent_scene():
    """The scene of tests/test_pallas.py::TestDualCotangent, as numpy."""
    cam, (means, scales, q, opacity, features) = make_scene(n=30, opacity_max=0.8)
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 1, (HEIGHT, WIDTH, 3)).astype(np.float32)
    mask = (rng.uniform(0, 1, (HEIGHT, WIDTH)) > 0.5).astype(np.float32)
    orient = rng.uniform(0, np.pi, (HEIGHT, WIDTH)).astype(np.float32)
    conf = rng.uniform(0, 1, (HEIGHT, WIDTH)).astype(np.float32)
    cam = cam._replace(image=jnp.asarray(img), mask=jnp.asarray(mask),
                       orientation=jnp.asarray(orient), confidence=jnp.asarray(conf))
    return cam, [np.asarray(a) for a in (means, scales, q, opacity, features)]




@pytest.mark.parametrize("antialiasing,use_pallas,pair_capacity", [
    pytest.param(False, True, 0, id="False"),
    pytest.param(True, True, 0, id="True"),
    pytest.param(False, False, 0, id="xla-False"),
    pytest.param(True, False, 0, id="xla-True"),
    pytest.param(False, False, 3 * CHUNK, id="xla-capacity")])
def test_render_matches_jax_plain_path(antialiasing, use_pallas, pair_capacity):
    """The port's render on either path against the JAX package's XLA path.
    With use_pallas=False every key of the dict matches, pairs_demand and
    the untruncated tile_counts exactly, and pair_capacity (a setting of the
    paged table) truncates nothing, as in JAX: a port that took the paged
    path here lost 0.69 of the image to it. The paged path
    (use_pallas=True) reports its counts capped at max_pairs_per_tile."""
    from hairgs_tpu.render import RasterConfig as JConfig
    from hairgs_tpu.render import render as jrender
    from hairgs_tpu_torch.render.renderer import RasterConfig, render

    cam, (means, scales, q, opacity, features) = _dual_cotangent_scene()
    kw = dict(max_tiles_per_gaussian=R_MAX, max_pairs_per_tile=MAX_PAIRS,
              chunk=CHUNK, antialiasing=antialiasing, pair_capacity=pair_capacity)
    bg = np.asarray([0.2, 0.4, 0.6], np.float32)
    # one compiled program: far quicker on the CPU than op-by-op dispatch
    oj = jax.jit(lambda m, s, r, o, f, b: jrender(
        cam, means3d=m, scales=s, rotations=r, opacity=o, features=f, bg=b,
        width=WIDTH, height=HEIGHT, config=JConfig(use_pallas=False, **kw)))(
        *map(jnp.asarray, (means, scales, q, opacity, features, bg)))
    ot = render(_port_camera(cam), means3d=_t(means), scales=_t(scales),
                rotations=_t(q), opacity=_t(opacity), features=_t(features),
                bg=_t(bg), width=WIDTH, height=HEIGHT,
                config=RasterConfig(use_pallas=use_pallas, **kw))
    assert set(ot) == set(oj)
    for name in ("render", "render_photo", "final_T"):
        np.testing.assert_allclose(ot[name].detach().numpy(), np.asarray(oj[name]),
                                   atol=FWD_ATOL, err_msg=name)
    np.testing.assert_allclose(ot["radii"].numpy(), np.asarray(oj["radii"]),
                               rtol=1e-5)
    np.testing.assert_array_equal(ot["visibility_filter"].numpy(),
                                  np.asarray(oj["visibility_filter"]))
    for name in ("overflow_pairs", "overflow_tiles", "overflow_capacity",
                 "pairs_demand"):
        assert int(ot[name]) == int(oj[name]), name
    counts_j = np.asarray(oj["tile_counts"])
    np.testing.assert_array_equal(
        ot["tile_counts"].numpy(),
        np.minimum(counts_j, MAX_PAIRS) if use_pallas else counts_j)
    assert float(ot["final_T"].min()) < 0.5  # the scene covers pixels


def _both_dense_binnings(inp, grid_w, grid_h, r_max, max_pairs, **kw):
    from hairgs_tpu.render.binning import bin_gaussians as jbin
    from hairgs_tpu_torch.render.binning import bin_gaussians

    geo = {k: inp[k] for k in ("xy", "conic", "q_cut") if k in inp}
    bj = jax.jit(lambda r, d, v, g: jbin(r, d, v, grid_w, grid_h, r_max,
                                         max_pairs, **g, **kw))(
        *(jnp.asarray(inp[k]) for k in ("rect", "depth", "valid")),
        {k: jnp.asarray(v) for k, v in geo.items()})
    bt = bin_gaussians(*(_t(inp[k]) for k in ("rect", "depth", "valid")),
                       grid_w, grid_h, r_max, max_pairs,
                       **{k: _t(v) for k, v in geo.items()}, **kw)
    return bj, bt


@pytest.mark.parametrize("seed,tie_fraction", [(None, None), (1, 0.5), (2, 0.9)])
def test_bin_gaussians_exact(seed, tie_fraction):
    """The dense XLA-path tables equal JAX's: on make_scene (with the exact
    tile cull), and on the depth-tie scene of tests/test_binning_order.py,
    whose quantized-depth ties must keep the stable Gaussian order."""
    if seed is None:
        bj, bt = _both_dense_binnings(_binning_inputs(), GRID_W, GRID_H, R_MAX,
                                      MAX_PAIRS, tile_size=TS)
    else:
        rect, depth, valid = tie_scene(300, seed, tie_fraction)
        inp = dict(rect=np.asarray(rect), depth=np.asarray(depth),
                   valid=np.asarray(valid))
        bj, bt = _both_dense_binnings(inp, TIE_GRID_W, TIE_GRID_H, TIE_R_MAX,
                                      TIE_K)
    _assert_binning_equal(bj, bt)
    assert int(bt.pair_valid.sum()) > 0


@pytest.fixture(scope="module")
def dense_table():
    """xy_g, con_g, opa_g, feat_g of make_scene(n=40) at 48x40 in the dense
    layout of the port's bin_gaussians (held exactly to JAX's above), the
    invalid slots zeroed, as numpy: both compositors get these arrays."""
    from hairgs_tpu_torch.render.binning import bin_gaussians

    prep, opa_eff, features = _preprocessed(n=40, opacity_max=0.8)
    q_cut = torch.log(torch.clamp(opa_eff, min=1e-12) / ALPHA_MIN)
    b = bin_gaussians(prep.rect, prep.depth, prep.valid, GRID_W, GRID_H, R_MAX,
                      MAX_PAIRS, xy=prep.xy, conic=prep.conic, q_cut=q_cut,
                      tile_size=TS)
    gid, pv = b.gather_idx.long(), b.pair_valid
    gathered = (torch.where(pv[..., None], prep.xy[gid], 0.0),
                torch.where(pv[..., None], prep.conic[gid], 0.0),
                torch.where(pv, opa_eff[gid], 0.0),
                torch.where(pv[..., None], features[gid], 0.0))
    assert int(b.tile_counts.max()) > CHUNK  # several chunks per tile
    return tuple(x.numpy() for x in gathered)


def test_composite_matches_jax(dense_table):
    """The XLA-path compositor: forward within 3e-5 of JAX's `composite`,
    and its VJP (the reverse chunk scan) within 3e-3 x scale."""
    from hairgs_tpu.render.composite import composite as jcomposite
    from hairgs_tpu_torch.render.composite import composite

    rng = np.random.default_rng(6)
    g_out = rng.normal(size=(GRID_W * GRID_H, 256, 3)).astype(np.float32)
    g_trans = rng.normal(size=(GRID_W * GRID_H, 256)).astype(np.float32)
    (out_j, trans_j), vjp = jax.vjp(
        lambda *a: jcomposite(*a, GRID_W, GRID_H, TS, CHUNK, ALPHA_MIN),
        *map(jnp.asarray, dense_table))
    grads_j = vjp((jnp.asarray(g_out), jnp.asarray(g_trans)))

    leaves = [_t(a).requires_grad_(True) for a in dense_table]
    out_t, trans_t = composite(*leaves, GRID_W, GRID_H, TS, CHUNK, ALPHA_MIN)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               atol=FWD_ATOL)
    np.testing.assert_allclose(trans_t.detach().numpy(), np.asarray(trans_j),
                               atol=FWD_ATOL)
    torch.autograd.backward([out_t, trans_t], [_t(g_out), _t(g_trans)])
    for name, leaf, gj in zip(("xy", "conic", "opacity", "feat"), leaves, grads_j):
        assert np.abs(np.asarray(gj)).max() > 0, name
        _grad_close(leaf.grad.numpy(), gj, name)


def test_composite_naive_matches_jax():
    """The sequential oracle with its permanent done latch, rects applied,
    on a background."""
    from hairgs_tpu.render.composite import composite_naive as jnaive
    from hairgs_tpu_torch.render.composite import composite_naive

    prep, opa_eff, features = _preprocessed(n=60)
    bg = np.asarray([0.2, 0.4, 0.6], np.float32)
    args = (prep.xy, prep.conic, opa_eff, features, prep.depth, prep.valid)
    img_t, trans_t = composite_naive(*args, WIDTH, HEIGHT, bg=_t(bg),
                                     rect=prep.rect)
    img_j, trans_j = jnaive(*(jnp.asarray(a.numpy()) for a in args), WIDTH,
                            HEIGHT, bg=jnp.asarray(bg),
                            rect=jnp.asarray(prep.rect.numpy()))
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), atol=FWD_ATOL)
    np.testing.assert_allclose(trans_t.numpy(), np.asarray(trans_j), atol=FWD_ATOL)
    assert float(trans_t.min()) < 0.5


def _bf16_round(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _assert_within_bf16_ulp(k, p, err_msg=""):
    """|k - p| <= 2^-7 |p| (one bf16 ulp of p) everywhere, or both 0."""
    k, p = np.asarray(k), np.asarray(p)
    bad = np.abs(k - p) > 2.0**-7 * np.abs(p)
    assert not bad.any(), (f"{err_msg}: {bad.sum()} entries beyond one bf16 "
                           f"ulp, e.g. {k[bad][:4]} vs {p[bad][:4]}")


ARG_NAMES = ("means", "scales", "q", "opacity", "features")


def _bf16_loss_inputs():
    """make_scene(n=40) and fixed cotangents of the loss
    sum(render * gw) + sum(final_T * gt)."""
    cam, args = make_scene(n=40, opacity_max=0.8)
    rng = np.random.default_rng(9)
    gw = rng.normal(size=(HEIGHT, WIDTH, 3)).astype(np.float32)
    gt = rng.normal(size=(HEIGHT, WIDTH)).astype(np.float32)
    return cam, [np.asarray(a) for a in args], gw, gt


def _jax_render_grads(cam, args, gw, gt, cfg):
    from hairgs_tpu.render import render as jrender

    def loss(*a):
        out = jrender(cam, means3d=a[0], scales=a[1], rotations=a[2],
                      opacity=a[3], features=a[4], width=WIDTH, height=HEIGHT,
                      config=cfg)
        return (jnp.sum(out["render"] * gw) + jnp.sum(out["final_T"] * gt),
                out["render"])

    (_, img), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3, 4), has_aux=True))(*map(jnp.asarray, args))
    return np.asarray(img), [np.asarray(g) for g in grads]


def _port_render_grads(cam, args, gw, gt, cfg):
    from hairgs_tpu_torch.render.renderer import render

    leaves = [_t(a).requires_grad_(True) for a in args]
    out = render(_port_camera(cam), means3d=leaves[0], scales=leaves[1],
                 rotations=leaves[2], opacity=leaves[3], features=leaves[4],
                 width=WIDTH, height=HEIGHT, config=cfg)
    loss = torch.sum(out["render"] * _t(gw)) + torch.sum(out["final_T"] * _t(gt))
    loss.backward()
    return out["render"].detach().numpy(), [x.grad.numpy() for x in leaves]


def test_render_feat_bf16_matches_xla_on_bf16_features():
    """The paged path with a bf16 feature plane against the JAX XLA path fed
    the same features rounded to bf16: the forward within 3e-5 (only the
    features round; every sum is f32), the geometry gradients within 3e-3
    x scale, and d_features within one bf16 ulp of its scale, 2^-7 max|p|.
    d_features rounds twice on the bf16 plane, per pair and per Gaussian,
    so where a Gaussian's pairs cancel, its sum moves by the rounding of
    the pairs, not of itself. The elementwise one-ulp gates are the
    plane-level test below and the Pallas-interpret test, which round at
    the same points."""
    from hairgs_tpu.render import RasterConfig as JConfig
    from hairgs_tpu_torch.render.renderer import RasterConfig

    cam, args, gw, gt = _bf16_loss_inputs()
    kw = dict(max_tiles_per_gaussian=R_MAX, max_pairs_per_tile=MAX_PAIRS,
              chunk=CHUNK)
    img_t, g_t = _port_render_grads(
        cam, args, gw, gt, RasterConfig(use_pallas=True, feat_bf16=True, **kw))
    args_b = args[:4] + [_bf16_round(args[4])]
    img_j, g_j = _jax_render_grads(cam, args_b, gw, gt,
                                   JConfig(use_pallas=False, **kw))
    np.testing.assert_allclose(img_t, img_j, atol=FWD_ATOL)
    for name, gt_, gj in zip(ARG_NAMES[:4], g_t, g_j):
        assert np.abs(gj).max() > 0, name
        _grad_close(gt_, gj, name)
    np.testing.assert_allclose(g_t[4], g_j[4], rtol=0,
                               atol=2.0**-7 * np.abs(g_j[4]).max())


def test_bf16_d_feat_rounds_each_pair_once(pair_table, dense_table):
    """The bf16 plane's d_feat slot by slot: the port's compositor backward
    against JAX's XLA `composite` VJP on the same pairs (the two binnings
    order every tile alike), rounded to bf16 once, within one bf16 ulp."""
    from hairgs_tpu.render.composite import composite as jcomposite
    from hairgs_tpu_torch.render.composite_pairs import composite_pairs

    geo, feat, starts, counts = pair_table
    nt, c = GRID_W * GRID_H, 3
    rng = np.random.default_rng(7)
    g_out = rng.normal(size=(nt, 256, c)).astype(np.float32)
    g_trans = rng.normal(size=(nt, 256)).astype(np.float32)
    xy_g, con_g, opa_g, feat_g = dense_table
    _, vjp = jax.vjp(lambda f: jcomposite(
        jnp.asarray(xy_g), jnp.asarray(con_g), jnp.asarray(opa_g), f, GRID_W,
        GRID_H, TS, CHUNK, ALPHA_MIN), jnp.asarray(_bf16_round(feat_g)))
    (d_feat_j,) = vjp((jnp.asarray(g_out), jnp.asarray(g_trans)))
    expect = _bf16_round(np.asarray(d_feat_j))  # (NT, K, C)

    tf = _t(feat).to(torch.bfloat16).requires_grad_(True)
    out, photo, trans = composite_pairs(
        _t(geo), tf, _t(starts), _t(counts), GRID_W, GRID_H, TS, CHUNK,
        MAX_CHUNKS, c)
    torch.autograd.backward([out, trans], [_t(g_out), _t(g_trans)])
    assert tf.grad.dtype == torch.bfloat16
    d_feat = tf.grad.float().numpy()
    got = np.zeros_like(expect)
    for t in range(nt):
        k = int(counts[t])
        got[t, :k] = d_feat[:c, starts[t]:starts[t] + k].T
    assert np.abs(expect).max() > 0
    _assert_within_bf16_ulp(got, expect, "d_feat")


def test_render_feat_bf16_matches_jax_pallas_interpret():
    """Once, against JAX's own bf16 plane: render(use_pallas=True,
    feat_bf16=True) with the Pallas kernels in interpret mode."""
    from hairgs_tpu.render import RasterConfig as JConfig
    from hairgs_tpu_torch.render.renderer import RasterConfig

    cam, args, gw, gt = _bf16_loss_inputs()
    kw = dict(max_tiles_per_gaussian=R_MAX, max_pairs_per_tile=MAX_PAIRS,
              chunk=CHUNK, use_pallas=True, feat_bf16=True)
    img_t, g_t = _port_render_grads(cam, args, gw, gt, RasterConfig(**kw))
    img_j, g_j = _jax_render_grads(cam, args, gw, gt,
                                   JConfig(tiles_per_step=1, **kw))
    np.testing.assert_allclose(img_t, img_j, atol=FWD_ATOL)
    for name, gt_, gj in zip(ARG_NAMES[:4], g_t, g_j):
        _grad_close(gt_, gj, name)
    _assert_within_bf16_ulp(g_t[4], g_j[4], "features")


def test_bf16_plane_keeps_transmittance_bit_equal(pair_table):
    """T, tstarts and the latch plane touch no feature: the plain forward on
    the bf16 plane gives the f32 plane's bit for bit, and its image differs only by the
    rounding of the features."""
    from hairgs_tpu_torch.render import composite_pairs as cp

    geo, feat, starts, counts = (_t(a) for a in pair_table)
    args = (starts, counts, GRID_W, TS, CHUNK, MAX_CHUNKS, 3)
    out_f, t_f, ts_f, lat_f = cp.composite_pairs_fwd_plain(geo, feat, *args)
    out_b, t_b, ts_b, lat_b = cp.composite_pairs_fwd_plain(
        geo, feat.to(torch.bfloat16), *args)
    assert torch.equal(t_f, t_b) and torch.equal(ts_f, ts_b)
    assert torch.equal(lat_f, lat_b)
    out_r, _, _, _ = cp.composite_pairs_fwd_plain(
        geo, feat.to(torch.bfloat16).to(torch.float32), *args)
    assert torch.equal(out_b, out_r)
    assert 0 < float((out_b - out_f).abs().max()) < 1e-2


def _warp_of_pixel_rows(ok):
    """(n, 256) bool -> (n, 8) bool: any pixel of rows 2w, 2w+1 passes."""
    return ok.reshape(ok.shape[0], 8, 32).any(dim=2)


def _random_pairs(rng, n, kind):
    """n pairs around tile (2, 1) of a 16-px grid: geometry rows (8, n) f32
    of the given kind of conic and opacity."""
    tx0, ty0 = 32.0, 16.0
    x = tx0 + rng.uniform(-60, 76, n)
    y = ty0 + rng.uniform(-60, 76, n)
    if kind == "near_degenerate":
        a = 10 ** rng.uniform(-4, 1, n)
        c = 10 ** rng.uniform(-4, 1, n)
        b = rng.choice([-1, 1], n) * np.sqrt(a * c) * (1 - 10 ** rng.uniform(-8, -1, n))
    elif kind == "garbage":
        a, b, c = rng.normal(0, 1, (3, n))
        bad = rng.uniform(size=(3, n)) < 0.1
        a, b, c = (np.where(m, rng.choice([np.inf, -np.inf, np.nan], n), v)
                   for m, v in zip(bad, (a, b, c)))
    else:  # elongated: a covariance with eigenvalues 0.3 .. 1e4 px^2
        lam = 10 ** rng.uniform(np.log10(0.3), 4, (2, n))
        th = rng.uniform(0, np.pi, n)
        cs, sn = np.cos(th), np.sin(th)
        cxx = lam[0] * cs**2 + lam[1] * sn**2
        cyy = lam[0] * sn**2 + lam[1] * cs**2
        cxy = (lam[0] - lam[1]) * cs * sn
        det = cxx * cyy - cxy**2
        a, b, c = cyy / det, -cxy / det, cxx / det
    if kind == "near_threshold":
        opa = ALPHA_MIN * (1 + rng.choice([-1, 1], n) * 10 ** rng.uniform(-7, -1, n))
    else:
        opa = rng.choice([rng.uniform(0, 1, n), np.full(n, 0.999),
                          rng.uniform(0, 2 * ALPHA_MIN, n)])
    geo = np.zeros((8, n), np.float32)
    geo[:6] = np.stack([x, y, a, b, c, opa]).astype(np.float32)
    return geo, tx0, ty0


@settings(max_examples=40, deadline=None, database=None)
@given(seed=st.integers(0, 2**32 - 1),
       kind=st.sampled_from(["elongated", "near_degenerate", "near_threshold",
                             "garbage"]))
def test_warp_cull_is_conservative(seed, kind):
    """No pixel that passes `_slot_quantities`' fp32 gate lies in a warp
    strip (rows 2w, 2w+1) that the kernels' cull predicate clears: random,
    elongated, near-degenerate and near-threshold conics and opacities."""
    from hairgs_tpu_torch.render import composite_pairs as cp

    n = 256
    geo, tx0, ty0 = _random_pairs(np.random.default_rng(seed), n, kind)
    g = _t(geo)
    p = torch.arange(256)
    px = (tx0 + p % 16).float().expand(n, 256)
    py = (ty0 + p // 16).float().expand(n, 256)
    _, _, ok, *_ = cp._slot_quantities(g, torch.arange(n), torch.ones(n, dtype=torch.bool),
                                       px, py, ALPHA_MIN)
    mask = cp.warp_reach_plain(g, torch.full((n,), tx0), torch.full((n,), ty0))
    kept = (mask[:, None] >> torch.arange(8)) & 1 == 1
    missed = _warp_of_pixel_rows(ok) & ~kept
    assert not missed.any(), f"{int(missed.sum())} culled (pair, warp) pass the gate"
    if kind == "elongated":  # the cull is not vacuous
        assert (~kept).any()


def test_warp_cull_edges():
    """Opacity below alpha_min (or NaN) reaches no warp; a conic that is not
    finite or not positive definite reaches every warp; a small round
    splat on pixel (5, 5) of its tile reaches rows 4-6 (warps 2 and 3), and
    one below the tile reaches none."""
    from hairgs_tpu_torch.render import composite_pairs as cp

    cols = np.array([
        [5, 5, 1, 0, 1, ALPHA_MIN / 2],
        [5, 5, 1, 0, 1, np.nan],
        [5, 5, np.inf, 0, 1, 0.5],
        [5, 5, 1, 2, 1, 0.5],
        [5, 5, -1, 0, 1, 0.5],
        [5, 5, 4, 0, 4, 0.5],
        [5, 100, 4, 0, 4, 0.5],
    ], np.float32).T
    mask = cp.warp_reach_plain(_t(cols), torch.zeros(7), torch.zeros(7))
    assert mask.tolist() == [0, 0, 0xFF, 0xFF, 0xFF, 0b1100, 0]


def _kernel_warp_sum16(v):
    """numpy float32 emulation of composite_bwd.cu::warp_sum16 on one warp:
    v (32 lanes, 16 values); returns the value each even lane 2j writes
    (value j)."""
    lanes = np.arange(32)
    x = v.astype(np.float32)
    for off, half in ((16, 8), (8, 4), (4, 2), (2, 1)):
        up = (lanes & off) != 0
        keep = np.where(up[:, None], x[:, half:], x[:, :half])
        send = np.where(up[:, None], x[:, :half], x[:, half:])
        x = keep + send[lanes ^ off]
    x = x[:, 0] + x[lanes ^ 1, 0]
    return x[0::2]


def test_transposed_butterfly_sums_as_block_sum():
    """The backward's 16-value butterfly gives each value the bits of the
    per-value xor tree that `_block_sum` repeats: sums of values of both
    signs and wide magnitudes agree exactly."""
    from hairgs_tpu_torch.render import composite_pairs as cp

    rng = np.random.default_rng(11)
    for _ in range(20):
        v = (rng.normal(size=(32, 16)) * 10 ** rng.uniform(-6, 6, (32, 16))
             ).astype(np.float32)
        got = _kernel_warp_sum16(v)
        block = np.zeros((1, 256, 16), np.float32)
        block[0, :32] = v
        want = cp._block_sum(_t(block))[0].numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["pair_table", "latch4", "latch8"])
def test_forward_latch_plane_is_the_rerun_drop_slot(pair_table, case):
    """The plain forward's latch plane is the slot at which the plain
    backward's rerun drops each pixel, and the transmittance after each
    chunk that the rerun finds is the forward's tstarts[j + 1] (the final T
    after the last chunk), bit for bit: the kernel backward starts each
    chunk from these instead of running it forward again."""
    from hairgs_tpu_torch.render import composite_pairs as cp

    if case == "pair_table":
        geo, feat, starts, counts = (_t(a) for a in pair_table)
        grid_w, chunk, max_chunks = GRID_W, CHUNK, MAX_CHUNKS
    else:
        geo, feat = (_t(a) for a in _latch_fixture())
        starts = torch.zeros(1, dtype=torch.int32)
        counts = torch.full((1,), 8, dtype=torch.int32)
        grid_w, chunk = 1, int(case[5:])
        max_chunks = 8 // chunk
    out, trans, tstarts, latch = cp.composite_pairs_fwd_plain(
        geo, feat, starts, counts, grid_w, TS, chunk, max_chunks, 3)
    drop, t_after = cp.rerun_latch_plain(geo, starts, counts, tstarts, trans,
                                         grid_w, TS, chunk, max_chunks)
    assert torch.equal(latch, drop)
    if case != "pair_table":  # (make_scene's opacities latch no pixel)
        assert (latch >= 0).any()
    nt = starts.shape[0]
    cnt = cp.clamp_counts_to_live_chunks(counts, tstarts, chunk, max_chunks)
    nch = ((cnt + chunk - 1) // chunk).tolist()
    ts = tstarts.reshape(nt, max_chunks, -1)
    ta = t_after.reshape(nt, max_chunks, -1)
    for t in range(nt):
        for j in range(nch[t]):
            want = ts[t, j + 1] if j + 1 < nch[t] else trans[t]
            assert torch.equal(ta[t, j], want), (t, j)
