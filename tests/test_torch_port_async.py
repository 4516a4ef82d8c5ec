"""Port parity, the background topology events (`--async_topology`): the
cases of tests/test_topo.py::TestAsyncTopology run on
hairgs_tpu_torch.topo.async_events, and `compute_topology_update` +
`apply_topology_update` of hairgs_tpu_torch.topo.graph_ops against
hairgs_tpu's on the same host snapshot.

Tolerances: an idle flight (no training between launch and poll) equals
the synchronous events exactly; the live and snapshot values of the
survivor case within 1e-7 (the nudge) and 1e-6 (the merged joint, a
midpoint in fp32), as in JAX's test; the port's update against JAX's:
every array, the event info and the strands info equal, and after the
install the arenas, graph, statistics and moments equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_topo import (
    FIELDS,
    assert_same,
    assert_same_info,
    make_pair,
    random_scene,
    two_strands,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers, and the
    idle OpenMP threads of a torch pool spin on cores the others need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(eps, pairs, **kw):
    return make_pair(eps, pairs, **kw)[1]


def _worker(m):
    from hairgs_tpu_torch.topo.async_events import TopologyWorker

    return TopologyWorker(m)


def _state(m):
    return m.host_arrays(), [s.copy() for s in m.strands_info.list_strands]


def _stamp_moments(m, base=1.0):
    def tree(t, b):
        return type(t)(*[(torch.arange(v.shape[0], dtype=v.dtype) + b).reshape(
            (-1,) + (1,) * (v.ndim - 1)).expand(v.shape).clone() for v in t])

    m.opt_state = m.opt_state._replace(mu=tree(m.opt_state.mu, base),
                                       nu=tree(m.opt_state.nu, base + 1000))


def test_idle_matches_sync_merge():
    from hairgs_tpu_torch.topo.graph_ops import hair_densification, hair_merging

    eps, pairs = two_strands()
    m_sync, m_async = _port(eps, pairs), _port(eps, pairs)
    _, arrays = hair_densification(m_sync, extent=1.0, max_screen_size=None,
                                   return_arrays=True)
    hair_merging(m_sync, arrays=arrays)

    w = _worker(m_async)
    w.launch(densify=True, merge=True, extent=1.0, size_th=None)
    assert w.in_flight
    assert w.poll(force=True)
    assert not w.in_flight and not w.poll(force=True)

    a_s, strands_s = _state(m_sync)
    a_a, strands_a = _state(m_async)
    assert len(strands_s) == len(strands_a) == 1
    np.testing.assert_array_equal(strands_s[0], strands_a[0])
    for k in a_s:
        np.testing.assert_array_equal(a_a[k], a_s[k], err_msg=k)


def test_idle_matches_sync_split():
    from hairgs_tpu_torch.topo.graph_ops import hair_densification

    eps = np.asarray([[0, 0, 0], [1.0, 0, 0]], np.float32)
    pairs = np.asarray([[0, 1]], np.int64)
    m_sync, m_async = _port(eps, pairs), _port(eps, pairs)
    hair_densification(m_sync, extent=1.0, max_screen_size=None)
    assert m_sync.num_segments == 2

    w = _worker(m_async)
    w.launch(densify=True, merge=False, extent=1.0, size_th=None)
    assert w.poll(force=True)
    a_s, _ = _state(m_sync)
    a_a, _ = _state(m_async)
    for k in a_s:
        np.testing.assert_array_equal(a_a[k], a_s[k], err_msg=k)


def test_survivors_keep_live_values():
    eps, pairs = two_strands()
    m = _port(eps, pairs)
    w = _worker(m)
    w.launch(densify=False, merge=True, extent=1.0, size_th=None)
    # "train" while the flight is out: a feature plane and an endpoint move
    # on the device; the snapshot must not see it
    endpoints = m.params.endpoints.clone()
    endpoints[0, 0] += 5e-4
    m.params = m.params._replace(features_dc=m.params.features_dc + 1.0,
                                 endpoints=endpoints)
    assert w.poll(force=True)

    arr = m.host_arrays()
    # the merge prunes segment rows 1 and 2 and appends re-linked copies:
    # rows 0 and 3 survive at 0 and 1 with the live (moved) features; the
    # appended copies keep the snapshot's values
    np.testing.assert_allclose(arr["features_dc"][:2], 1.0)
    np.testing.assert_allclose(arr["features_dc"][2:], 0.0)
    # endpoint 0 survives the merge with its live nudge
    d = np.linalg.norm(arr["endpoints"] - np.asarray([5e-4, 0, 0]), axis=1)
    assert d.min() < 1e-7
    # the merged joint is a new row: the midpoint of snapshot ids 2 and 3
    d = np.linalg.norm(arr["endpoints"] - np.asarray([0.0205, 0, 0]), axis=1)
    assert d.min() < 1e-6


def test_moments_carry_through_async():
    eps, pairs = two_strands()
    m = _port(eps, pairs)
    _stamp_moments(m)
    mu_w_before = m.opt_state.mu.width[: m.num_segments].clone()
    w = _worker(m)
    w.launch(densify=False, merge=True, extent=1.0, size_th=None)
    assert w.poll(force=True)
    mu_w = m.opt_state.mu.width[: m.num_segments]
    assert torch.equal(mu_w[0], mu_w_before[0])
    assert torch.equal(mu_w[1], mu_w_before[3])
    assert bool(torch.all(mu_w[2:] == 0.0))


def test_worker_error_surfaces_in_poll():
    eps, pairs = two_strands()
    m = _port(eps, pairs)
    m.ref_strand_root = None  # poisons compute_strands_info in the flight
    w = _worker(m)
    w.launch(densify=True, merge=False, extent=1.0, size_th=None)
    with pytest.raises(RuntimeError, match="async topology event failed"):
        w.poll(force=True)
    assert not w.in_flight


@pytest.mark.parametrize("seed", [1, 4])
def test_compute_and_apply_update_match_jax(seed):
    """A densify + merge update computed on the same host snapshot by both
    packages, with launch-time thresholds other than the live ones, then
    installed after the live parameters moved."""
    from hairgs_tpu.core.hostsync import sliced_pull as jpull
    from hairgs_tpu.topo.graph_ops import apply_topology_update as japply
    from hairgs_tpu.topo.graph_ops import compute_topology_update as jcompute
    from hairgs_tpu_torch.core.hostsync import sliced_pull
    from hairgs_tpu_torch.topo.graph_ops import (
        apply_topology_update,
        compute_topology_update,
    )

    eps, pairs, seg = random_scene(seed)
    jm, tm = make_pair(eps, pairs, seg=seg, ref_root=[[0.0, 0.0, 0.05]],
                       densify_grad_threshold=2e-4)
    rng = np.random.default_rng(seed + 20)
    cap = tm.capacity
    stats = dict(max_radii2d=rng.uniform(0, 5, cap).astype(np.float32),
                 xyz_grad_accum=rng.uniform(0, 2e-3, (cap, 1)).astype(np.float32),
                 denom=rng.integers(0, 4, (cap, 1)).astype(np.float32))
    jm.stats = type(jm.stats)(**{k: jnp.asarray(v) for k, v in stats.items()})
    tm.stats = type(tm.stats)(**{k: torch.from_numpy(v) for k, v in stats.items()})
    _stamp_moments(tm)
    jm.opt_state = jm.opt_state._replace(**{
        g: type(getattr(jm.opt_state, g))(*[jnp.asarray(t.numpy()) for t in
                                            getattr(tm.opt_state, g)])
        for g in ("mu", "nu")})

    def snapshot(m, pull):
        e, s = m.num_endpoints, m.num_segments
        arrays = pull({"endpoints": (m.params.endpoints, e),
                       "endpoint_pairs": (m.graph.endpoint_pairs, s),
                       **{k: (getattr(m.params, k), s) for k in FIELDS[1:]}})
        st = pull({k: (getattr(m.stats, k), s) for k in stats})
        return arrays, st

    kw = dict(densify=True, merge=True, extent=0.5, max_screen_size=20,
              merge_dist_th=5e-3, merge_angle_th=35.0)
    uj = jcompute(jm, **dict(zip(("arrays", "stats"), snapshot(jm, jpull))), **kw)
    ut = compute_topology_update(tm, **dict(zip(("arrays", "stats"),
                                                snapshot(tm, sliced_pull))), **kw)
    assert ut.info == uj.info and ut.info["merge"] > 0
    assert_same_info(ut.strands_info, uj.strands_info)
    for name in ("endpoints", "pairs", "ep_src", "seg_src", "strand_root_idx"):
        np.testing.assert_array_equal(getattr(ut.st, name), getattr(uj.st, name),
                                      err_msg=name)
    for group in ("seg", "stats"):
        for k, v in getattr(uj.st, group).items():
            np.testing.assert_array_equal(getattr(ut.st, group)[k], v, err_msg=k)

    # training moved the live values while the update was computed
    bump = rng.normal(0, 1e-3, tuple(tm.params.features_dc.shape)).astype(np.float32)
    jm.params = jm.params._replace(features_dc=jm.params.features_dc + bump)
    tm.params = tm.params._replace(features_dc=tm.params.features_dc
                                   + torch.from_numpy(bump))
    japply(jm, uj)
    apply_topology_update(tm, ut)
    assert "t_apply" in ut.info
    assert_same(jm, tm)
    for g in ("mu", "nu"):
        for k in FIELDS:
            np.testing.assert_array_equal(
                getattr(getattr(tm.opt_state, g), k).numpy(),
                np.asarray(getattr(getattr(jm.opt_state, g), k)), err_msg=f"{g}/{k}")
