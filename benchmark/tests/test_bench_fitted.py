"""The starts a traffic names (harness.start): a fitted strand graph read
from an archive on the capture of the configuration's own seed, the two
generated starts as they were before it, and the reader of densification's
strategies spans."""

import json
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import capture, check, harness, spans
from benchmark.reference import stage3
from hairgs_tpu_torch import telemetry

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CPU = torch.device("cpu")
CAPTURE_SEED = 2**31 + 21
# a strand graph laid along the tiny capture's strands, as the tiny
# Stage-III cell lays it (conftest.make_tiny_spec)
TINY_GRAPH = dict(pieces=200, segments_per_piece=2, segment_points=2, gap_points=0,
                  jitter_m=0.002, width_m=[0.0003, 0.0008], opacity=[0.5, 0.95],
                  mask=[0.7, 0.95], iteration=30000)


def parent_start(config, traffic, seed, dev):
    """The capture and start graph as the harness made them before the
    fitted start: `capture.make` of the run's seed, then `start_graph`."""
    cap = capture.make(config, seed, dev)
    if traffic["start"] == "initial_points":
        return cap, None
    return cap, capture.merged_graph(config["merged_graph"], cap, seed, dev)


def fitted_spec(tiny_spec, tmp_path, background_every=0):
    """The fitted configuration and its traffic at the tiny size of the
    Stage-III cell (its capture, flags and limits), the archive written from
    the tiny capture of CAPTURE_SEED by capture.merged_graph; with
    `background_every`, every such segment's mask is set under the
    foreground threshold."""
    spec = tiny_spec("usc1k_stage3_merges")
    with open(os.path.join(ROOT, "benchmark", "configs", "usc_hairsalon_1k_fitted.json")) as fh:
        fitted = json.load(fh)["fitted_start"]
    with open(os.path.join(ROOT, "benchmark", "traffic", "stage3_full_from_fitted.json")) as fh:
        traffic = dict(json.load(fh), warmup_iterations=5, profile_max_iterations=3)
    cfg = {k: v for k, v in spec.config.items() if k != "merged_graph"}
    cap = capture.make(cfg, CAPTURE_SEED, CPU)
    graph = capture.merged_graph(TINY_GRAPH, cap, CAPTURE_SEED, CPU)
    if background_every:
        graph["mask"][::background_every] = -3.0  # sigmoid 0.047 < 0.25
    path = tmp_path / "start.npz"
    np.savez_compressed(path, **{k: graph[k] for k in harness.GRAPH_KEYS})
    cfg["fitted_start"] = dict(fitted, file=str(path), capture_seed=CAPTURE_SEED)
    return spec._replace(config=cfg, traffic=traffic), cap, graph


def test_fitted_start_round_trips(tmp_path, tiny_spec):
    """The archive's graph comes back whole, writes as the hair checkpoint
    the program loads, and is the reference's initial state."""
    from hairgs_tpu_torch.io.ply import load_hair_ply

    spec, cap, graph = fitted_spec(tiny_spec, tmp_path)
    got_cap, got = harness.start(spec.config, spec.traffic, 2**31 + 5, CPU)
    assert set(got) == set(harness.GRAPH_KEYS)
    for k in harness.GRAPH_KEYS:
        assert got[k].dtype == graph[k].dtype and np.array_equal(got[k], graph[k]), k
    ply = str(tmp_path / "point_cloud.ply")
    capture.write_hair_ply(ply, got)
    arrays, root_idx, ref_root = load_hair_ply(ply, 0)
    for k in ("endpoints", "endpoint_pairs", "features_dc", "opacity", "mask", "width"):
        assert np.array_equal(arrays[k], graph[k]), k
    assert np.array_equal(root_idx, graph["strand_root_idx"])
    assert np.array_equal(ref_root, graph["ref_strand_root"])
    args, _ = harness.port_args(["-s", "", *spec.config["flags"], *spec.traffic["flags"]])
    _, leaves, model = check.reference_inputs(got_cap, harness.opt_values(args), CPU, got)
    for k in stage3.LEAVES:
        assert torch.equal(leaves[k], torch.tensor(graph[k])), k
    assert model.leaves == stage3.LEAVES


def test_fitted_capture_is_the_capture_seeds(tmp_path, tiny_spec):
    spec, cap, _ = fitted_spec(tiny_spec, tmp_path)
    a, ga = harness.start(spec.config, spec.traffic, 2**31 + 5, CPU)
    b, gb = harness.start(spec.config, spec.traffic, 7, CPU)
    for c in (a, b):
        assert np.array_equal(c["points"], cap["points"])
        assert all(np.array_equal(x, y) for v, w in zip(c["views"], cap["views"])
                   for x, y in zip(v, w))
    assert all(np.array_equal(ga[k], gb[k]) for k in harness.GRAPH_KEYS)
    other, _ = parent_start(spec.config, {"start": "initial_points"}, 7, CPU)
    assert not np.array_equal(other["points"], cap["points"])


def test_unknown_start_raises(tiny_spec):
    spec = tiny_spec("usc1k_stage3_merges")
    with pytest.raises(ValueError, match="unknown start"):
        harness.start(spec.config, dict(spec.traffic, start="grown_graph"), 3, CPU)


@pytest.mark.parametrize("workload", ["usc1k_stage1", "nersemble2x_stage1",
                                      "usc1k_stage3_merges"])
def test_generated_starts_are_the_parents(workload, tiny_spec):
    spec = tiny_spec(workload)
    seed = 2**31 + 11
    cap, graph = harness.start(spec.config, spec.traffic, seed, CPU)
    want_cap, want_graph = parent_start(spec.config, spec.traffic, seed, CPU)
    assert np.array_equal(cap["points"], want_cap["points"])
    assert np.array_equal(cap["colours"], want_cap["colours"])
    assert all(np.array_equal(x, y) for v, w in zip(cap["views"], want_cap["views"])
               for x, y in zip(v, w))
    assert torch.equal(cap["visible"], want_cap["visible"])
    assert (graph is None) == (want_graph is None)
    if graph is not None:
        assert set(graph) == set(want_graph)
        assert all(np.array_equal(graph[k], want_graph[k]) for k in graph)


def test_reference_strands_are_the_programs(tmp_path, tiny_spec):
    """The reference's consecutive segments are the program's smoothness
    pairs (the strand walk over the foreground segments), also where some
    segments are background; on a graph of foreground segments alone the
    foreground rule changes nothing."""
    from hairgs_tpu_torch.models.hair import HairModel
    from hairgs_tpu_torch.topo.strands import smooth_pair_indices

    _, _, graph = fitted_spec(tiny_spec, tmp_path, background_every=7)
    fg = stage3.foreground(graph)
    assert 0 < (~fg).sum() < fg.sum()
    ply = str(tmp_path / "point_cloud.ply")
    capture.write_hair_ply(ply, graph)
    model = HairModel(device="cpu")
    model.load_ply(ply)
    pairs, valid = smooth_pair_indices(model.strands_info)

    def key(p):  # a pair of segments [[a, b], [b, c]] read either way
        return sorted(min((int(r[0, 0]), int(r[0, 1]), int(r[1, 1])),
                          (int(r[1, 1]), int(r[0, 1]), int(r[0, 0])))
                      for r in np.asarray(p))

    assert key(stage3.consecutive_pairs(graph["endpoint_pairs"], fg)) == key(pairs[valid])
    everything = np.ones(graph["endpoint_pairs"].shape[0], bool)
    assert np.array_equal(stage3.consecutive_pairs(graph["endpoint_pairs"], everything),
                          stage3.consecutive_pairs(graph["endpoint_pairs"]))


def test_sound_run_from_a_fitted_start_is_correct(tmp_path, tiny_spec):
    """A run of the tiny fitted cell, with background segments in its
    start, passes the cell's limits."""
    spec, _, _ = fitted_spec(tiny_spec, tmp_path, background_every=7)
    result, rows, correct = harness.run(spec, 2**31 + 5, 0.5, False, time.perf_counter(),
                                        device="cpu")
    assert correct, rows


def test_faults_from_a_fitted_start_fail(tmp_path, monkeypatch, tiny_spec):
    """With the timed path broken underneath, the fitted cell's runs are not
    correct: the optimiser step returning its state unchanged; half of the
    image left out of the losses, the mean taken over the rest."""
    from hairgs_tpu_torch.train import trainer

    spec, _, _ = fitted_spec(tiny_spec, tmp_path, background_every=7)

    def run():
        _, rows, correct = harness.run(spec, 2**31 + 5, 0.5, False, time.perf_counter(),
                                       device="cpu")
        return correct, {n: v for n, v, _ in rows}

    with monkeypatch.context() as m:
        m.setattr(trainer, "adam_step",
                  lambda params, grads, state, lr, out=None: (params, state))
        correct, numbers = run()
        assert not correct and numbers["change"] == pytest.approx(1.0)

    def top_half(fn):
        def loss(channels, camera, opt_cfg):
            h = channels.shape[0] // 2
            cut = camera._replace(**{k: getattr(camera, k)[:h] for k in
                                     ("image", "mask", "orientation", "confidence")})
            return fn(channels[:h], cut, opt_cfg)
        return loss

    monkeypatch.setattr(trainer, "_photometric_loss", top_half(trainer._photometric_loss))
    monkeypatch.setattr(trainer, "_auxiliary_loss", top_half(trainer._auxiliary_loss))
    correct, numbers = run()
    assert not correct, numbers


def test_tf32_control_from_a_fitted_start_fails(tmp_path, tiny_spec):
    spec, _, _ = fitted_spec(tiny_spec, tmp_path, background_every=7)
    result, rows, _ = harness.run(spec, 2**31 + 5, 0.5, False, time.perf_counter(),
                                  device="cpu")
    fol = result["check"]["followed"]
    cap, graph = harness.start(spec.config, spec.traffic, 2**31 + 5, CPU)
    args, _ = harness.port_args(["-s", "", *spec.config["flags"], *spec.traffic["flags"]])
    opt, rt = harness.opt_values(args), harness.rt_values(args)
    inputs = check.reference_inputs(cap, opt, CPU, graph)
    base = check.follow(cap, opt, rt, CPU, order=fol.order, inputs=inputs).readout
    low = check.follow(cap, opt, rt, CPU, order=fol.order, inputs=inputs,
                       precision="tf32").readout
    kept = ~(fol.truncated | fol.capped)
    ok, judged = check.judge(check.compare(low, base, kept=kept)[0], spec.limits)
    assert not ok, judged


MS = 1_000_000  # ns


def _ring(rows):
    r = telemetry.Ring(64)
    for name, i, parent, t0, t1 in rows:
        r.write(telemetry.NAMES.index(name), i, parent, 1, t0 * MS, t1 * MS)
    return r


def test_densify_strategies_share(monkeypatch):
    """In a window of 1000 ms: a densify event whose strategies take 40 ms,
    a second whose strategies have 10 ms inside the window, and a
    strategies span outside any event, which does not count; None in a
    window of merges alone."""
    ctx = SimpleNamespace(logger=SimpleNamespace(t_open=1.0, t_close=2.0, rows=[]))
    densify = [
        ("topo/pull", 11, 10, 1100, 1120), ("topo/strategies", 12, 10, 1120, 1160),
        ("topo/install", 13, 10, 1160, 1170), ("topo/walk", 14, 10, 1170, 1200),
        ("topo/event", 10, -1, 1100, 1200),
        ("topo/strategies", 20, -1, 1300, 1400),  # outside any event
        ("topo/strategies", 32, 30, 1990, 2050), ("topo/event", 30, -1, 1980, 2100),
    ]
    monkeypatch.setattr(telemetry, "RING", _ring(densify))
    read = harness.reader("densify_strategies_share.stage3")
    assert read(ctx) == pytest.approx(4.0 + 1.0)
    topology = sum(spans.__dict__[f"{m}_share"](ctx) for m in spans.TOPOLOGY_PHASES)
    assert read(ctx) + topology <= 100 * (100 + 20) / 1000
    merges = [("topo/pull", 11, 10, 1100, 1120), ("topo/merge_search", 12, 10, 1120, 1160),
              ("topo/event", 10, -1, 1100, 1200), ("topo/strategies", 20, -1, 1300, 1400)]
    monkeypatch.setattr(telemetry, "RING", _ring(merges))
    assert read(ctx) is None
