"""Port parity, the strand topology: the walk, root flips, smoothness and
magnet tables, `update_strand_root`, merge candidates, merging, the Stage-II
loop, densification (split, prune, weld), the opacity reset, growth, the
Gaussian-to-hair conversion and the moment and statistics carry maps of
hairgs_tpu_torch against hairgs_tpu on the CPU, on the fixtures of
tests/test_topo.py and on random strand scenes; and the port's native
library (built here by g++) against its numpy oracles and JAX's numpy path.

The JAX side runs its numpy path (its native library is not built here);
the port runs its native library unless a test asks for the oracle.
Tolerances: integer graphs, strand lists, counts, event info and moment
carries equal; float planes equal, but the endpoints made by
`to_hair_model` within 1e-6 (torch and JAX round the rotations
differently); merge candidate distances bit-equal to numpy's norm.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

SEG_KEYS = ("features_dc", "features_rest", "opacity", "mask", "width")
FIELDS = ("endpoints",) + SEG_KEYS


def inv_sig(x):
    return float(np.log(x / (1 - x)))


def _cfgs(**changes):
    from hairgs_tpu.config import OptimizationConfig as JOpt
    from hairgs_tpu_torch.config import OptimizationConfig

    j = dataclasses.replace(JOpt(), **changes)
    return j, OptimizationConfig(**dataclasses.asdict(j))


def make_pair(endpoints, pairs, opacity=0.5, mask=0.9, width=1e-4, ref_root=None,
              seg=None, **cfg_changes):
    """tests/test_topo.py::make_hair_model in both packages, from the same
    arrays: install, root ids, training_setup, strands info."""
    from hairgs_tpu.models.hair import HairModel as JHair
    from hairgs_tpu.topo.strands import compute_strands_info as jinfo
    from hairgs_tpu.topo.strands import update_strand_root as jroot
    from hairgs_tpu_torch.models.hair import HairModel
    from hairgs_tpu_torch.topo.strands import compute_strands_info, update_strand_root

    ns = pairs.shape[0]
    if seg is None:
        seg = dict(
            features_dc=np.zeros((ns, 1, 3), np.float32),
            features_rest=np.zeros((ns, 0, 3), np.float32),
            opacity=np.full((ns, 1), inv_sig(opacity), np.float32),
            mask=np.full((ns, 1), inv_sig(mask), np.float32),
            width=np.full((ns, 1), np.log(width), np.float32),
        )
    root = np.asarray(ref_root if ref_root is not None else [[0.0, 0.0, 0.0]],
                      np.float32)
    jcfg, tcfg = _cfgs(**cfg_changes)
    models = []
    for cls, kw, root_fn, info_fn, cfg in (
            (JHair, {}, jroot, jinfo, jcfg),
            (HairModel, {"device": "cpu"}, update_strand_root, compute_strands_info,
             tcfg)):
        m = cls(sh_degree=0, capacity_round=64, **kw)
        m.install(np.asarray(endpoints, np.float32), np.asarray(pairs, np.int64),
                  {k: v.copy() for k, v in seg.items()})
        m.ref_strand_root = root
        root_fn(m)
        m.training_setup(cfg)
        info_fn(m)
        models.append(m)
    return models


def two_strands():
    eps = np.asarray([[0, 0, 0], [0.01, 0, 0], [0.02, 0, 0],
                      [0.021, 0, 0], [0.031, 0, 0], [0.041, 0, 0]], np.float32)
    return eps, np.asarray([[0, 1], [1, 2], [3, 4], [4, 5]], np.int64)


def random_scene(seed, n_lines=10, per_line=12, spacing=0.004, drop=0.3):
    """Points every 4 mm (jittered) along random lines, joined into
    segments, a share of which is dropped: the pieces are strands whose
    tips face each other across a gap (merge candidates, near-ties
    included); random per-segment opacity and mask (some background)."""
    rng = np.random.default_rng(seed)
    eps, pairs = [], []
    for _ in range(n_lines):
        d = rng.normal(0, 1, 3)
        d /= np.linalg.norm(d)
        p = rng.uniform(-0.02, 0.02, 3)
        base = len(eps)
        eps += [p + d * spacing * j + rng.normal(0, 2e-4, 3)
                for j in range(per_line + 1)]
        pairs += [[base + j, base + j + 1] for j in range(per_line)
                  if rng.uniform() > drop]
    pairs = np.asarray(pairs, np.int64)
    used = np.unique(pairs)
    remap = np.zeros(len(eps), np.int64)
    remap[used] = np.arange(used.size)
    ns = pairs.shape[0]

    def logit(u):
        return np.log(u / (1 - u)).astype(np.float32)

    seg = dict(
        features_dc=rng.normal(0, 0.5, (ns, 1, 3)).astype(np.float32),
        features_rest=np.zeros((ns, 0, 3), np.float32),
        opacity=logit(rng.uniform(0.002, 0.9, (ns, 1))),
        mask=logit(rng.uniform(0.1, 0.95, (ns, 1))),
        width=np.log(rng.uniform(1e-4, 3e-4, (ns, 1))).astype(np.float32),
    )
    return np.asarray(eps, np.float32)[used], remap[pairs], seg


def assert_same(jm, tm, atol=0.0):
    """Arenas (live rows), graph, counts, roots, strands info and the
    statistics equal."""
    assert (tm.num_segments, tm.num_endpoints) == (jm.num_segments, jm.num_endpoints)
    assert tm.capacity == jm.graph.endpoint_pairs.shape[0]
    ja, ta = jm.host_arrays(), tm.host_arrays()
    np.testing.assert_array_equal(ta["endpoint_pairs"], ja["endpoint_pairs"])
    for k in FIELDS:
        np.testing.assert_allclose(ta[k], ja[k], rtol=0, atol=atol, err_msg=k)
    np.testing.assert_array_equal(tm.strand_root_endpoint_idx, jm.strand_root_endpoint_idx)
    assert_same_info(tm.strands_info, jm.strands_info)
    for k in ("max_radii2d", "xyz_grad_accum", "denom"):
        np.testing.assert_array_equal(getattr(tm.stats, k).numpy(),
                                      np.asarray(getattr(jm.stats, k)), err_msg=k)


def assert_same_info(ti, ji):
    assert len(ti.list_strands) == len(ji.list_strands)
    for a, b in zip(ti.list_strands, ji.list_strands):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ti.list_strands_segments_id, ji.list_strands_segments_id):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ti.id_to_strand_id, ji.id_to_strand_id)
    np.testing.assert_array_equal(ti.strand_endpoint_id_to_complementary,
                                  ji.strand_endpoint_id_to_complementary)


# --------------------------------------------------------------------------
# the fixtures of tests/test_topo.py, one case each
# --------------------------------------------------------------------------

def _case_walk():
    return make_pair(*two_strands()), None


def _case_flip():
    return make_pair(*two_strands(), ref_root=[[0.1, 0, 0]]), None


def _case_background():
    from hairgs_tpu.topo.strands import compute_strands_info as jinfo
    from hairgs_tpu_torch.topo.strands import compute_strands_info

    jm, tm = make_pair(*two_strands(), mask=0.1)
    assert len(compute_strands_info(tm).list_strands) == 0
    jinfo(jm)
    return (jm, tm), None


def _case_update_strand_root():
    jm, tm = make_pair(*two_strands(), ref_root=[[0, 0, 0], [0.0405, 0, 0]])
    assert set(tm.strand_root_endpoint_idx.tolist()) == {0, 5}
    return (jm, tm), None


def _case_merge():
    from hairgs_tpu.topo.graph_ops import hair_merging as jmerge
    from hairgs_tpu_torch.topo.graph_ops import hair_merging

    jm, tm = make_pair(*two_strands())
    return (jm, tm), (jmerge(jm), hair_merging(tm))


def _case_stage2_loop():
    from hairgs_tpu.topo.merge import stage2_merge_loop as jloop
    from hairgs_tpu_torch.topo.merge import stage2_merge_loop

    jm, tm = make_pair(*two_strands())
    return (jm, tm), (jloop(jm, max_iterations=100), stage2_merge_loop(tm, 100))


def _densify(jm, tm, **kw):
    from hairgs_tpu.topo.graph_ops import hair_densification as jdens
    from hairgs_tpu_torch.topo.graph_ops import hair_densification

    ji = jdens(jm, extent=1.0, max_screen_size=kw.get("size"))
    ti = hair_densification(tm, extent=1.0, max_screen_size=kw.get("size"))
    strip = lambda d: {k: v for k, v in d.items() if not k.startswith("t_")}
    return strip(ji), strip(ti)


def _case_split():
    eps = np.asarray([[0, 0, 0], [1.0, 0, 0]], np.float32)
    jm, tm = make_pair(eps, np.asarray([[0, 1]], np.int64))
    return (jm, tm), _densify(jm, tm)


def _case_prune():
    jm, tm = make_pair(*two_strands(), opacity=0.001)
    return (jm, tm), _densify(jm, tm)


def _case_weld():
    eps = np.asarray([[0, 0, 0], [0.01, 0, 0], [0.01, 0, 0], [0.02, 0, 0]], np.float32)
    jm, tm = make_pair(eps, np.asarray([[0, 1], [1, 2], [2, 3]], np.int64),
                       num_points_strand=1)
    return (jm, tm), _densify(jm, tm)


def _case_reset():
    from hairgs_tpu.topo.graph_ops import hair_reset_opacity as jreset
    from hairgs_tpu_torch.topo.graph_ops import hair_reset_opacity

    jm, tm = make_pair(*two_strands(), opacity=0.7)
    jreset(jm)
    hair_reset_opacity(tm)
    for g in ("mu", "nu"):
        assert float(getattr(tm.opt_state, g).opacity.abs().max()) == 0.0
    return (jm, tm), None


def _case_growth():
    from hairgs_tpu.topo.graph_ops import hair_growing as jgrow
    from hairgs_tpu_torch.topo.graph_ops import hair_growing

    jm, tm = make_pair(*two_strands())
    return (jm, tm), (jgrow(jm, growth_length=0.002), hair_growing(tm, growth_length=0.002))


def _case_clean():
    from hairgs_tpu.topo.graph_ops import clean_hair_gaussians as jclean
    from hairgs_tpu.topo.strands import compute_strands_info as jinfo
    from hairgs_tpu_torch.topo.graph_ops import clean_hair_gaussians
    from hairgs_tpu_torch.topo.strands import compute_strands_info

    eps, pairs, seg = random_scene(3)
    jm, tm = make_pair(eps, pairs, seg=seg)
    n = tm.num_segments
    jclean(jm)
    clean_hair_gaussians(tm)
    assert tm.num_segments < n
    jinfo(jm)
    compute_strands_info(tm)
    return (jm, tm), None


CASES = dict(walk=_case_walk, flip=_case_flip, background=_case_background,
             update_strand_root=_case_update_strand_root, merge=_case_merge,
             stage2_loop=_case_stage2_loop, split=_case_split, prune=_case_prune,
             weld=_case_weld, reset=_case_reset, growth=_case_growth,
             clean=_case_clean)


@pytest.mark.parametrize("case", sorted(CASES))
def test_topology_fixture_matches_jax(case):
    (jm, tm), results = CASES[case]()
    if results is not None:
        assert results[1] == results[0]
    assert_same(jm, tm)


def test_smooth_and_magnet_tables_match_jax():
    from hairgs_tpu.topo.strands import magnet_indices as jmag
    from hairgs_tpu.topo.strands import smooth_pair_indices as jsmooth
    from hairgs_tpu_torch.topo.strands import magnet_indices, smooth_pair_indices

    eps, pairs, seg = random_scene(4)
    jm, tm = make_pair(eps, pairs, seg=seg)
    for a, b in zip(smooth_pair_indices(tm.strands_info), jsmooth(jm.strands_info)):
        np.testing.assert_array_equal(a, b)
    sp, valid = smooth_pair_indices(tm.strands_info)
    assert valid.sum() > 10
    for a, b in zip(magnet_indices(tm), jmag(jm)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_scene_events_match_jax(seed):
    """On a random scene: the candidates (native) against JAX's numpy path,
    a densification with statistics stamped in both, a merge in the same
    event (chained mirror), growth, then the Stage-II loop to convergence:
    graphs, info, iterations and the surviving statistics equal."""
    from hairgs_tpu.topo.graph_ops import hair_densification as jdens
    from hairgs_tpu.topo.graph_ops import hair_growing as jgrow
    from hairgs_tpu.topo.graph_ops import hair_merging as jmerge
    from hairgs_tpu.topo.merge import compute_endpoint_pair_to_merge as jcand
    from hairgs_tpu.topo.merge import stage2_merge_loop as jloop
    from hairgs_tpu_torch.topo.graph_ops import (
        hair_densification,
        hair_growing,
        hair_merging,
    )
    from hairgs_tpu_torch.topo.merge import (
        compute_endpoint_pair_to_merge,
        stage2_merge_loop,
    )

    eps, pairs, seg = random_scene(seed)
    jm, tm = make_pair(eps, pairs, seg=seg, ref_root=[[0.0, 0.0, 0.05]],
                       densify_grad_threshold=2e-4, merge_dist_th_init=5e-3,
                       merge_angle_th_init=35.0)
    cand = compute_endpoint_pair_to_merge(tm)
    np.testing.assert_array_equal(cand, jcand(jm))
    np.testing.assert_array_equal(compute_endpoint_pair_to_merge(tm, native=False), cand)
    assert cand.shape[0] >= 3

    rng = np.random.default_rng(seed + 10)
    cap = tm.capacity
    stats = dict(max_radii2d=rng.uniform(0, 5, cap).astype(np.float32),
                 xyz_grad_accum=rng.uniform(0, 2e-3, (cap, 1)).astype(np.float32),
                 denom=rng.integers(0, 4, (cap, 1)).astype(np.float32))
    jm.stats = type(jm.stats)(**{k: jnp.asarray(v) for k, v in stats.items()})
    tm.stats = type(tm.stats)(**{k: torch.from_numpy(v) for k, v in stats.items()})
    ji, ja = jdens(jm, 0.5, 20, return_arrays=True)
    ti, ta = hair_densification(tm, 0.5, 20, return_arrays=True)
    strip = lambda d: {k: v for k, v in d.items() if not k.startswith("t_")}
    assert strip(ti) == strip(ji)
    assert_same(jm, tm)
    assert hair_merging(tm, arrays=ta) == jmerge(jm, arrays=ja)
    assert_same(jm, tm)
    # the port grows only from endpoints of one segment; JAX's growth also
    # branches from foreground tips that go on into a background segment.
    # Held to JAX with those strands left out of JAX's strands info
    jm.strands_info, branching = _without_branching_tips(jm)
    assert branching == (5, 0, 1)[seed]
    assert hair_growing(tm) == jgrow(jm) > 0
    assert _max_degree(tm) <= 2
    assert_same(jm, tm)
    n_strands = len(tm.strands_info.list_strands)
    iters = stage2_merge_loop(tm, 50)
    assert iters == jloop(jm, max_iterations=50)
    assert len(tm.strands_info.list_strands) <= n_strands
    assert_same(jm, tm)


FITTED = "benchmark/starts/usc_hairsalon_1k_fitted.npz"


def _fitted_crop():
    """About 2000 segments of the fitted USC-HairSalon start (the graph the
    port's Stage I and merge left): its 300 longest, every one under
    10 um, a run of 300 background ones and a run of 900 rows of ordinary
    ones, on their endpoints renumbered; with its reference roots and the
    split length of the whole graph (its foreground's diagonal over
    `num_points_strand`)."""
    import os

    from hairgs_tpu_torch.config import OptimizationConfig
    from hairgs_tpu_torch.models.gaussian import FG_BIN_TH, OPACITY_TH

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with np.load(os.path.join(root, FITTED)) as z:
        g = {k: z[k] for k in z.files}
    eps, pairs = g["endpoints"], g["endpoint_pairs"]
    length = np.linalg.norm(eps[pairs[:, 1]] - eps[pairs[:, 0]], axis=1)
    sig = lambda x: 1.0 / (1.0 + np.exp(-x[:, 0]))
    fg = (sig(g["opacity"]) >= OPACITY_TH) & (sig(g["mask"]) >= FG_BIN_TH)
    diag = np.linalg.norm(np.ptp(eps[pairs[fg].ravel()], axis=0))
    rows = np.unique(np.concatenate([
        np.argsort(-length)[:300], np.flatnonzero(length < 1e-5),
        np.flatnonzero(~fg)[5000:5300], np.arange(100_000, 100_900)]))
    used, remap = np.unique(pairs[rows], return_inverse=True)
    seg = dict(features_dc=g["features_dc"][rows],
               features_rest=np.zeros((rows.size, 0, 3), np.float32),
               opacity=g["opacity"][rows], mask=g["mask"][rows], width=g["width"][rows])
    return (eps[used], remap.reshape(-1, 2), seg, g["ref_strand_root"],
            float(diag) / OptimizationConfig().num_points_strand, length[rows])


def test_fitted_graph_densification_matches_jax():
    """Two densify events on a crop of the fitted USC-HairSalon start, with
    the same seeded statistics in both packages and the whole graph's
    split length: Stage III's first (no screen-size prune before the
    opacity reset at 3000) and a later one (screen size 20, so the long
    segments are pruned as too wide). The counts of each strategy, the
    graphs, the strands info and the surviving statistics equal JAX's."""
    from hairgs_tpu.topo.graph_ops import hair_densification as jdens
    from hairgs_tpu_torch.topo.graph_ops import hair_densification

    eps, pairs, seg, ref_root, split_length, length = _fitted_crop()
    assert 1800 <= pairs.shape[0] <= 2200 and length.max() > 0.2
    assert (length < 1e-5).sum() == 531
    jm, tm = make_pair(eps, pairs, seg=seg, ref_root=ref_root)
    assert_same(jm, tm)
    rng = np.random.default_rng(1600000001)
    strip = lambda d: {k: v for k, v in d.items() if not k.startswith("t_")}
    for size in (None, 20):
        jm.max_segment_length = tm.max_segment_length = split_length
        cap = tm.capacity
        stats = dict(max_radii2d=rng.uniform(0, 5, cap).astype(np.float32),
                     xyz_grad_accum=rng.uniform(0, 2e-3, (cap, 1)).astype(np.float32),
                     denom=rng.integers(0, 4, (cap, 1)).astype(np.float32))
        jm.stats = type(jm.stats)(**{k: jnp.asarray(v) for k, v in stats.items()})
        tm.stats = type(tm.stats)(**{k: torch.from_numpy(v) for k, v in stats.items()})
        ti, ji = hair_densification(tm, 0.55, size), jdens(jm, 0.55, size)
        assert strip(ti) == strip(ji)
        assert ti["split"] > 0 and ti["clone"] > 0 and ti["prune_total"] > 0
        assert_same(jm, tm)
    assert ti["prune_big_ws"] > 0


def _max_degree(m):
    pairs = m.host_arrays(keys=("endpoint_pairs",))["endpoint_pairs"]
    return int(np.bincount(pairs.astype(np.int64).ravel()).max())


def _without_branching_tips(jm):
    """JAX's strands info without the strands whose tip is an endpoint of
    more than one segment of the whole graph, and how many were left out."""
    pairs = np.asarray(jm.host_arrays()["endpoint_pairs"], np.int64)
    degree = np.bincount(pairs.ravel(), minlength=jm.num_endpoints)
    info = jm.strands_info
    keep = [degree[s[-1, 1]] == 1 for s in info.list_strands]
    return info._replace(
        list_strands=[s for s, k in zip(info.list_strands, keep) if k],
        list_strands_segments_id=[r for r, k in zip(
            info.list_strands_segments_id, keep) if k]), keep.count(False)


def test_growth_never_branches_a_strand():
    """A foreground strand 0-1-2, rooted at 0, goes on into a background
    segment 2-3. Its tip 2 does not grow (JAX's growth gives endpoint 2 a
    third segment), and the walk still succeeds once 2-3 turns foreground,
    where it raised before; then the true tip 3 grows."""
    from hairgs_tpu.topo.graph_ops import hair_growing as jgrow
    from hairgs_tpu_torch.topo.graph_ops import hair_growing
    from hairgs_tpu_torch.topo.strands import compute_strands_info

    eps = np.asarray([[0, 0, 0.01], [0.004, 0, 0.01], [0.008, 0, 0.01],
                      [0.012, 0, 0.01]], np.float32)
    pairs = np.asarray([[0, 1], [1, 2], [2, 3]], np.int64)
    seg = dict(
        features_dc=np.zeros((3, 1, 3), np.float32),
        features_rest=np.zeros((3, 0, 3), np.float32),
        opacity=np.full((3, 1), inv_sig(0.5), np.float32),
        mask=np.asarray([[inv_sig(0.9)], [inv_sig(0.9)], [inv_sig(0.1)]],
                        np.float32),
        width=np.full((3, 1), np.log(1e-4), np.float32),
    )
    jm, tm = make_pair(eps, pairs, seg=seg, ref_root=[[0.0, 0.0, 0.0]])
    assert [s.tolist() for s in tm.strands_info.list_strands] == [[[0, 1], [1, 2]]]
    assert jgrow(jm) == 1 and _max_degree(jm) == 3
    assert hair_growing(tm) == 0 and _max_degree(tm) == 2
    # the background segment turns foreground: the walk finds one strand
    tm.params = tm.params._replace(mask=torch.full_like(tm.params.mask, inv_sig(0.9)))
    info = compute_strands_info(tm)
    assert [s.shape[0] for s in info.list_strands] == [3]
    assert hair_growing(tm) == 1 and _max_degree(tm) == 2


def test_conversion_matches_jax():
    """GaussianModel.to_hair_model from the same Stage-I arena in both
    packages."""
    from hairgs_tpu.config import OptimizationConfig as JOpt
    from hairgs_tpu.models.gaussian import GaussianModel as JGauss
    from hairgs_tpu_torch.config import OptimizationConfig
    from hairgs_tpu_torch.models.gaussian import GaussianModel

    rng = np.random.default_rng(0)
    n = 40
    q = rng.normal(size=(n, 4)).astype(np.float32)
    arrays = dict(
        xyz=rng.normal(0, 0.05, (n, 3)).astype(np.float32),
        features_dc=rng.normal(0, 0.5, (n, 1, 3)).astype(np.float32),
        features_rest=np.zeros((n, 0, 3), np.float32),
        scaling=np.log(rng.uniform(1e-4, 3e-3, (n, 3))).astype(np.float32),
        rotation=q / np.linalg.norm(q, axis=1, keepdims=True),
        opacity=rng.normal(0, 2, (n, 1)).astype(np.float32),
        mask=rng.normal(0, 2, (n, 1)).astype(np.float32),
    )
    root = np.asarray([[0, 0, 0], [0.02, 0.0, 0.0]], np.float32)
    jg = JGauss(sh_degree=0, capacity_round=64)
    jg._install({k: v.copy() for k, v in arrays.items()}, n)
    jg.training_setup(JOpt())
    tg = GaussianModel(sh_degree=0, capacity_round=64, device="cpu")
    tg._install({k: v.copy() for k, v in arrays.items()}, n)
    tg.training_setup(OptimizationConfig())
    jh, th = jg.to_hair_model(root), tg.to_hair_model(root)
    assert th.device == tg.device and th.max_segment_length == pytest.approx(
        jh.max_segment_length, rel=1e-5)
    ja, ta = jh.host_arrays(), th.host_arrays()
    np.testing.assert_array_equal(ta["endpoint_pairs"], ja["endpoint_pairs"])
    np.testing.assert_allclose(ta["endpoints"], ja["endpoints"], rtol=0, atol=1e-6)
    for k in SEG_KEYS:
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
    np.testing.assert_array_equal(th.strand_root_endpoint_idx, jh.strand_root_endpoint_idx)
    assert_same_info(th.strands_info, jh.strands_info)


def test_moment_and_stat_carry_maps_match_jax():
    """Stamped Adam moments through a merge and a prune-only densification:
    surviving rows keep theirs, new rows start at zero, the surviving
    statistics are restored, as in JAX."""
    from hairgs_tpu.topo.graph_ops import hair_merging as jmerge
    from hairgs_tpu_torch.topo.graph_ops import hair_merging

    def stamp(m, lib, base):
        def tree(t, b):
            return type(t)(*[lib.broadcast_to(
                (lib.arange(v.shape[0]) + b).reshape((-1,) + (1,) * (v.ndim - 1)),
                v.shape).astype(v.dtype) if lib is jnp else
                (torch.arange(v.shape[0], dtype=v.dtype) + b).reshape(
                    (-1,) + (1,) * (v.ndim - 1)).expand(v.shape).clone()
                for v in t])
        m.opt_state = m.opt_state._replace(mu=tree(m.opt_state.mu, base),
                                           nu=tree(m.opt_state.nu, base + 1000))

    jm, tm = make_pair(*two_strands())
    stamp(jm, jnp, 1.0)
    stamp(tm, torch, 1.0)
    assert hair_merging(tm) == jmerge(jm) == 1
    for g in ("mu", "nu"):
        for k in FIELDS:
            np.testing.assert_array_equal(
                getattr(getattr(tm.opt_state, g), k).numpy(),
                np.asarray(getattr(getattr(jm.opt_state, g), k)), err_msg=f"{g}/{k}")
    mu_w = tm.opt_state.mu.width[: tm.num_segments, 0].tolist()
    assert mu_w[:2] == [1.0, 4.0] and mu_w[2:] == [0.0, 0.0]

    eps, pairs = two_strands()
    seg_opacity = np.full((4, 1), inv_sig(0.5), np.float32)
    seg_opacity[3] = inv_sig(0.001)  # the tip segment of strand B is pruned
    seg = dict(features_dc=np.zeros((4, 1, 3), np.float32),
               features_rest=np.zeros((4, 0, 3), np.float32), opacity=seg_opacity,
               mask=np.full((4, 1), inv_sig(0.9), np.float32),
               width=np.full((4, 1), np.log(1e-4), np.float32))
    jm, tm = make_pair(eps, pairs, seg=seg, num_points_strand=1)
    stats = dict(max_radii2d=np.arange(64, dtype=np.float32),
                 xyz_grad_accum=np.full((64, 1), 1e-9, np.float32),
                 denom=np.ones((64, 1), np.float32))
    jm.stats = type(jm.stats)(**{k: jnp.asarray(v) for k, v in stats.items()})
    tm.stats = type(tm.stats)(**{k: torch.from_numpy(v) for k, v in stats.items()})
    stamp(jm, jnp, 1.0)
    stamp(tm, torch, 1.0)
    ji, ti = _densify(jm, tm)
    assert ti == ji and ti["prune_total"] == 1
    assert_same(jm, tm)
    assert tm.stats.max_radii2d[:3].tolist() == [0.0, 1.0, 2.0]
    for g in ("mu", "nu"):
        for k in FIELDS:
            np.testing.assert_array_equal(
                getattr(getattr(tm.opt_state, g), k).numpy(),
                np.asarray(getattr(getattr(jm.opt_state, g), k)), err_msg=f"{g}/{k}")


# --------------------------------------------------------------------------
# the native library against its oracles (the cases of tests/test_topo.py::
# TestNativeMerge, which skip here: JAX's library is not built)
# --------------------------------------------------------------------------

def _candidate_trial(rng):
    m = int(rng.integers(5, 300))
    pts = rng.uniform(-0.1, 0.1, (m, 3)).astype(np.float32)
    d = rng.normal(size=(m, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tips = rng.permutation(m * 3)[:m].astype(np.int64)
    comp_full = np.full(3 * m, -1, np.int64)
    perm = rng.permutation(m)
    for i in range(0, m - 1, 2):
        a, b = tips[perm[i]], tips[perm[i + 1]]
        comp_full[a] = b
        comp_full[b] = a
    return pts, d, tips, comp_full


@pytest.mark.parametrize("bidirectional", [False, True])
def test_native_candidates_match_ckdtree_loop(bidirectional):
    from scipy.spatial import cKDTree

    from hairgs_tpu_torch.native import merge_candidates

    rng = np.random.default_rng(0)
    dist_th, dir_th = 0.02, float(np.cos(np.deg2rad(30)))
    for trial in range(8):
        pts, d, tips, comp_full = _candidate_trial(rng)
        p1, p2, dist = merge_candidates(pts, d, dist_th, dir_th, bidirectional,
                                        tips, comp_full[tips])
        nls = cKDTree(pts).query_ball_point(pts, r=dist_th, return_sorted=True)
        rp1, rp2, rd = [], [], []
        for i in range(pts.shape[0]):
            nn = np.asarray(nls[i])
            gid = tips[i]
            nn = nn[(tips[nn] != comp_full[gid]) & (tips[nn] != gid)]
            if nn.size == 0:
                continue
            dots = d[nn] @ (-d[i])
            if bidirectional:
                dots = np.abs(dots)
            nn = nn[dots >= dir_th]
            rd += list(np.linalg.norm(pts[i] - pts[nn], axis=1))
            rp1 += [gid] * nn.size
            rp2 += list(tips[nn])
        np.testing.assert_array_equal(p1, np.asarray(rp1, np.int64), err_msg=str(trial))
        np.testing.assert_array_equal(p2, np.asarray(rp2, np.int64), err_msg=str(trial))
        # bit-equal distances: the stable sort orders near-ties alike
        np.testing.assert_array_equal(dist, np.asarray(rd, np.float32), err_msg=str(trial))


def test_native_greedy_filter_matches_both_oracles():
    from hairgs_tpu.topo.merge import _remove_complementary_rows as jfilter
    from hairgs_tpu_torch.native import greedy_complementary_filter
    from hairgs_tpu_torch.topo.merge import _remove_complementary_rows

    rng = np.random.default_rng(1)
    for trial in range(6):
        k, e = int(rng.integers(1, 150)), 400
        pairs = rng.integers(0, e, (k, 2)).astype(np.int64)
        # a strand complementary map covers every tip (the oracles size
        # their tables by its largest entry)
        comp = rng.permutation(e).astype(np.int64)
        got = pairs[greedy_complementary_filter(pairs, comp)]
        np.testing.assert_array_equal(got, _remove_complementary_rows(pairs, comp))
        np.testing.assert_array_equal(got, jfilter(pairs, comp))


def test_native_walk_matches_both_oracles():
    """Random path graphs (shuffled rows, flipped pairs) with a cycle that
    no degree-1 start reaches."""
    from hairgs_tpu.topo.strands import _walk_strands_np as jwalk
    from hairgs_tpu_torch.native import walk_strands
    from hairgs_tpu_torch.topo.strands import Strands, _walk_strands_np

    rng = np.random.default_rng(2)
    for trial in range(5):
        perm = rng.permutation(300)
        pairs, at = [], 0
        while at < 280:
            k = int(rng.integers(1, 8))
            ids = perm[at:at + k + 1]
            pairs += [[ids[j], ids[j + 1]] for j in range(len(ids) - 1)]
            at += k + 1
        cyc = perm[290:294]
        pairs += [[cyc[j], cyc[(j + 1) % 4]] for j in range(4)]
        pairs = np.asarray(pairs, np.int64)[rng.permutation(len(pairs))]
        flip = rng.uniform(size=len(pairs)) < 0.5
        pairs[flip] = pairs[flip][:, ::-1]
        seq, rows, offsets, *got = walk_strands(pairs, 300)
        got = [list(Strands(seq, offsets)), list(Strands(rows, offsets))] + got
        for want in (_walk_strands_np(pairs, 300), jwalk(pairs, 300)):
            assert len(got[0]) == len(want[0])
            for a, b in zip(got[0] + got[1], want[0] + want[1]):
                np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(got[2], want[2])
            np.testing.assert_array_equal(got[3], want[3])
    with pytest.raises(RuntimeError, match="malformed"):
        walk_strands(np.asarray([[0, 1], [0, 2], [0, 3]]), 4)


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """No numpy fallback: a library that cannot be built raises."""
    from hairgs_tpu_torch import native

    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "LIB_PATH", tmp_path / "libhairgs_native.so")
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ["-DNO_SUCH", "-Werror=x"])
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.walk_strands(np.asarray([[0, 1]]), 2)
