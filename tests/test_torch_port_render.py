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


def _preprocessed(n=60, seed=0, **scene_kw):
    """make_scene(n) through the port's preprocess (held to the JAX one by
    tests/test_torch_port_core.py): (prep, effective opacity, features)."""
    from hairgs_tpu_torch.models.gaussian import camera_from_numpy
    from hairgs_tpu_torch.render.preprocess import preprocess

    cam, args = make_scene(n=n, seed=seed, **scene_kw)
    means, scales, q, opacity, features = (_t(a) for a in args)
    tcam = camera_from_numpy({k: None if v is None else np.asarray(v)
                              for k, v in cam._asdict().items()}, CPU)
    prep = preprocess(means, scales, q, tcam, WIDTH, HEIGHT, TS, opacity=opacity)
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


def test_gather_pairs_forward_and_backward():
    from hairgs_tpu.render.binning import gather_pairs as jgather
    from hairgs_tpu_torch.render.binning import gather_pairs

    _, bt = _both_binnings(_binning_inputs(), GRID_W, GRID_H, R_MAX, MAX_PAIRS,
                           CHUNK, tile_size=TS)
    src, inv = bt.paged_src.numpy(), bt.inv_paged.numpy()
    rng = np.random.default_rng(4)
    packed = rng.normal(size=(61, 8)).astype(np.float32)
    packed[-1] = 0.0
    g = rng.normal(size=(src.shape[0], 8)).astype(np.float32)
    out_j, vjp = jax.vjp(lambda p: jgather(p, jnp.asarray(src), jnp.asarray(inv),
                                           R_MAX), jnp.asarray(packed))
    tp = _t(packed).requires_grad_(True)
    out_t = gather_pairs(tp, bt.paged_src, bt.inv_paged, R_MAX)
    np.testing.assert_array_equal(out_t.detach().numpy(), np.asarray(out_j))
    out_t.backward(_t(g))
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=1e-6, atol=1e-6)


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
        _, _, ts_t = cp.composite_pairs_fwd_plain(
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
    out, t, _ = composite_pairs_fwd_plain(
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


@pytest.mark.parametrize("antialiasing", [False, True])
def test_render_matches_jax_plain_path(antialiasing):
    from hairgs_tpu.render import RasterConfig as JConfig
    from hairgs_tpu.render import render as jrender
    from hairgs_tpu_torch.models.gaussian import camera_from_numpy
    from hairgs_tpu_torch.render.renderer import RasterConfig, render

    cam, (means, scales, q, opacity, features) = _dual_cotangent_scene()
    kw = dict(max_tiles_per_gaussian=R_MAX, max_pairs_per_tile=MAX_PAIRS,
              chunk=CHUNK, antialiasing=antialiasing)
    bg = np.asarray([0.2, 0.4, 0.6], np.float32)
    # one compiled program: far quicker on the CPU than op-by-op dispatch
    oj = jax.jit(lambda m, s, r, o, f, b: jrender(
        cam, means3d=m, scales=s, rotations=r, opacity=o, features=f, bg=b,
        width=WIDTH, height=HEIGHT, config=JConfig(use_pallas=False, **kw)))(
        *map(jnp.asarray, (means, scales, q, opacity, features, bg)))
    tcam = camera_from_numpy({k: None if v is None else np.asarray(v)
                              for k, v in cam._asdict().items()}, CPU)
    ot = render(tcam, means3d=_t(means), scales=_t(scales), rotations=_t(q),
                opacity=_t(opacity), features=_t(features), bg=_t(bg),
                width=WIDTH, height=HEIGHT, config=RasterConfig(**kw))
    for name in ("render", "render_photo", "final_T"):
        np.testing.assert_allclose(ot[name].detach().numpy(), np.asarray(oj[name]),
                                   atol=FWD_ATOL, err_msg=name)
    np.testing.assert_allclose(ot["radii"].numpy(), np.asarray(oj["radii"]),
                               rtol=1e-5)
    for name in ("overflow_pairs", "overflow_tiles", "pairs_demand"):
        assert int(ot[name]) == int(oj[name]), name
    np.testing.assert_array_equal(ot["tile_counts"].numpy(),
                                  np.minimum(np.asarray(oj["tile_counts"]), MAX_PAIRS))
    assert float(ot["final_T"].min()) < 0.5  # the scene covers pixels


def test_render_feat_bf16_not_ported_yet():
    from hairgs_tpu_torch.core.camera import make_camera
    from hairgs_tpu_torch.render.renderer import RasterConfig, render

    cam = make_camera(np.eye(3), np.zeros(3), fovx=1.2, fovy=1.0, device="cpu")
    z = torch.zeros((1, 3))
    with pytest.raises(NotImplementedError):
        render(cam, means3d=z, scales=z + 0.1, rotations=torch.tensor([[1.0, 0, 0, 0]]),
               opacity=torch.ones(1), features=z, width=WIDTH, height=HEIGHT,
               config=RasterConfig(feat_bf16=True))
