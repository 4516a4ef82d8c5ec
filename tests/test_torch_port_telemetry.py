"""The port's spans (hairgs_tpu_torch/telemetry.py): nesting and parents on
each thread, the ring's bound and its dropped count, the profiler ranges
(only while a profiler records), and the spans the training loop and the
topology events record: one `train/step` per step, `info.topology_ms` as
its `topo/event` span, the `t_*` phase keys as their spans."""

import collections
import random
import sys
import threading
from argparse import ArgumentParser

import numpy as np
import pytest
import torch

from hairgs_tpu_torch import telemetry


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers, and the
    idle OpenMP threads of a torch pool spin on cores the others need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def ring(monkeypatch):
    """A fresh ring for the spans the test records."""
    r = telemetry.Ring(1 << 12)
    monkeypatch.setattr(telemetry, "RING", r)
    return r


def _by_id(spans):
    return {int(i): (spans.names[c], int(p), int(t)) for i, c, p, t in
            zip(spans.id, spans.code, spans.parent, spans.tid)}


def test_nesting_and_parents_on_each_thread(ring):
    def nest(out):
        with telemetry.span(telemetry.TOPO_EVENT) as outer:
            with telemetry.span(telemetry.TOPO_PULL) as inner:
                pass
            with telemetry.span(telemetry.TOPO_WALK) as second:
                pass
        out.extend([outer, inner, second, threading.get_native_id()])

    main, worker = [], []
    nest(main)
    t = threading.Thread(target=nest, args=(worker,))
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    spans = ring.snapshot()
    assert spans.dropped == 0 and len(spans.id) == 6
    by_id = _by_id(spans)
    for outer, inner, second, tid in (main, worker):
        assert by_id[outer.id] == ("topo/event", -1, tid)
        assert by_id[inner.id] == ("topo/pull", outer.id, tid)
        assert by_id[second.id] == ("topo/walk", outer.id, tid)
        assert outer.t0 <= inner.t0 <= inner.t1 <= second.t0 <= second.t1 <= outer.t1
        assert outer.ms == pytest.approx((outer.t1 - outer.t0) * 1e-6)
    assert main[3] != worker[3]
    with pytest.raises(KeyError):
        telemetry.span("not/a/span")


def test_a_span_ends_when_its_body_raises(ring):
    with pytest.raises(RuntimeError):
        with telemetry.span(telemetry.TRAIN_STEP):
            raise RuntimeError("the window closed")
    with telemetry.span(telemetry.LOSS) as after:
        pass
    assert after.parent == -1
    assert list(ring.snapshot().code) == [telemetry.NAMES.index(n)
                                          for n in ("train/step", "loss")]


def test_the_ring_keeps_the_newest_and_counts_the_dropped():
    r = telemetry.Ring(8)
    assert r.snapshot().dropped == 0 and len(r.snapshot().id) == 0
    for i in range(20):
        r.write(i % len(telemetry.NAMES), i, i - 1, 7, 10 * i, 10 * i + 5)
    spans = r.snapshot()
    assert spans.dropped == 12
    assert spans.id.tolist() == list(range(12, 20))
    assert spans.t0.tolist() == [10 * i for i in range(12, 20)]
    assert spans.parent.tolist() == list(range(11, 19))
    assert telemetry.CAPACITY * telemetry._RECORD.size <= 16 * 2**20


def test_spans_from_many_threads_are_all_kept(ring):
    """Threads that end spans at once lose none and share no id (a short
    switch interval makes them interleave)."""
    per, workers = 300, 12

    def record():
        for _ in range(per):
            with telemetry.span(telemetry.TOPO_WALK):
                pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=record) for _ in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    spans = ring.snapshot()
    assert spans.dropped == 0 and len(spans.id) == per * workers
    assert len(set(spans.id.tolist())) == per * workers
    assert len(set(spans.tid.tolist())) == workers


def _ranges(prof):
    return [e.name() for e in prof.profiler.kineto_results.events()
            if e.name().startswith(telemetry.PREFIX)]


def test_profiler_ranges_only_while_profiling(ring):
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(4, requires_grad=True)
    with telemetry.span(telemetry.LOSS):
        (x * 2).sum()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with telemetry.span(telemetry.TRAIN_STEP):
            with telemetry.span(telemetry.LOSS):
                (x * 2).sum()
    with profile(activities=[ProfilerActivity.CPU]) as quiet:
        (x * 3).sum()
    assert sorted(_ranges(prof)) == ["hairgs::loss", "hairgs::train/step"]
    assert _ranges(quiet) == []
    # a host range, not a user annotation the profiler mirrors on the device
    assert not any(e.is_user_annotation() for e in prof.profiler.kineto_results.events()
                   if e.name().startswith(telemetry.PREFIX))
    assert len(ring.snapshot().id) == 3


def _hair_model():
    """Two strands of 2 segments whose facing tips lie 1 mm apart."""
    from hairgs_tpu_torch.config import OptimizationConfig
    from hairgs_tpu_torch.models.hair import HairModel
    from hairgs_tpu_torch.topo.strands import compute_strands_info, update_strand_root

    eps = np.asarray([[0, 0, 0], [0.01, 0, 0], [0.02, 0, 0],
                      [0.021, 0, 0], [0.031, 0, 0], [0.041, 0, 0]], np.float32)
    pairs = np.asarray([[0, 1], [1, 2], [3, 4], [4, 5]], np.int64)
    ns = pairs.shape[0]
    m = HairModel(sh_degree=0, capacity_round=64, device="cpu")
    m.install(eps, pairs, dict(
        features_dc=np.zeros((ns, 1, 3), np.float32),
        features_rest=np.zeros((ns, 0, 3), np.float32),
        opacity=np.zeros((ns, 1), np.float32), mask=np.full((ns, 1), 2.0, np.float32),
        width=np.full((ns, 1), np.log(1e-4), np.float32)))
    m.ref_strand_root = np.zeros((1, 3), np.float32)
    update_strand_root(m)
    m.training_setup(OptimizationConfig())
    compute_strands_info(m)
    return m


def _seconds(spans, name, tid=None):
    """Σ seconds of the named spans (on one thread)."""
    keep = [(t1 - t0) * 1e-9 for c, t, t0, t1 in
            zip(spans.code, spans.tid, spans.t0.tolist(), spans.t1.tolist())
            if spans.names[c] == name and (tid is None or t == tid)]
    return sum(keep)


def test_phase_keys_are_their_spans(ring):
    from hairgs_tpu_torch.logging_utils import TrainingInfo
    from hairgs_tpu_torch.topo.async_events import TopologyWorker
    from hairgs_tpu_torch.topo.graph_ops import hair_densification, hair_merging

    m = _hair_model()
    info = TrainingInfo()
    _, arrays = hair_densification(m, 1.0, None, info, return_arrays=True)
    d = dict(info.densification_info)
    spans = ring.snapshot()
    for key, name in (("t_pull", "topo/pull"), ("t_strategies", "topo/strategies"),
                      ("t_install", "topo/install"), ("t_walk", "topo/walk")):
        assert d[key] == round(_seconds(spans, name), 3), key

    ring_merge = telemetry.Ring(1 << 10)
    telemetry.RING = ring_merge
    try:
        info = TrainingInfo()
        assert hair_merging(m, info) == 1
        spans = ring_merge.snapshot()
        d = info.densification_info
        by_id = _by_id(spans)
        walks = [i for i, v in by_id.items() if v[0] == "topo/walk"]
        first_walk = min(walks)
        apply_id = next(i for i, v in by_id.items() if v[0] == "topo/merge_apply")
        walk_s = [(int(t1) - int(t0)) * 1e-9 for i, t0, t1 in
                  zip(spans.id, spans.t0, spans.t1) if int(i) == first_walk][0]
        assert d["t_merge_prep"] == round(_seconds(spans, "topo/pull") + walk_s, 3)
        assert d["t_merge_candidates"] == round(_seconds(spans, "topo/merge_search"), 3)
        assert d["t_merge_apply"] == round(_seconds(spans, "topo/merge_apply"), 3)
        # the install and the second walk lie inside the apply
        assert {by_id[i][1] for i in walks if i != first_walk} == {apply_id}
        assert [v[1] for v in by_id.values() if v[0] == "topo/install"] == [apply_id]
    finally:
        telemetry.RING = ring

    m = _hair_model()
    w = TopologyWorker(m)
    w.launch(densify=True, merge=True, extent=1.0, size_th=None)
    w._thread.join(timeout=60)
    assert w.done
    info = TrainingInfo()
    assert w.poll(training_info=info) and not w.in_flight and not w.done
    d = info.densification_info
    spans = ring.snapshot()
    worker = {int(t) for c, t in zip(spans.code, spans.tid)
              if spans.names[c] == "topo/async_pull"}
    assert len(worker) == 1 and threading.get_native_id() not in worker
    # the worker times its pull and its computation as a whole
    assert {spans.names[c] for c, t in zip(spans.code, spans.tid)
            if int(t) in worker} == {"topo/async_pull", "topo/async_compute"}
    assert d["t_async_pull"] == round(_seconds(spans, "topo/async_pull"), 3)
    assert d["t_async_compute"] == round(_seconds(spans, "topo/async_compute"), 3)
    assert d["t_apply"] == round(_seconds(spans, "topo/async_apply"), 3)


CONFIGS = ("ModelConfig", "OptimizationConfig", "GeneralConfig", "RuntimeConfig")


@pytest.fixture(scope="module")
def tiny_scene(tmp_path_factory):
    from hairgs_tpu_torch.data.synthetic import generate_dataset, synthetic_test_hair
    from hairgs_tpu_torch.render.renderer import RasterConfig

    hair = synthetic_test_hair(num_strands=20, points_per_strand=8, seed=1)
    return generate_dataset(
        str(tmp_path_factory.mktemp("scene") / "data"), hair, num_cameras=4, width=32,
        height=32, cam_z=0.35, init_points="gt_hair_verts", init_subsample=3,
        raster_cfg=RasterConfig(max_tiles_per_gaussian=8, max_pairs_per_tile=128,
                                chunk=16), device="cpu")


def test_training_records_a_step_span_per_step_and_its_events(ring, tiny_scene,
                                                              tmp_path):
    """8 Stage-I steps with densify events at 3 and 6: one `train/step` per
    step, nested in `train/loop`; `info.elapsed_time` is its step's span and
    `info.topology_ms` its event's; the step's phases nest in the step."""
    from hairgs_tpu_torch import config
    from hairgs_tpu_torch.drivers import train as driver

    parser = ArgumentParser()
    for c in CONFIGS:
        config.add_config_args(parser, getattr(config, c))
    n = 8
    args = parser.parse_args([
        "-s", tiny_scene, "-m", str(tmp_path / "out"), "--data_device", "cpu",
        "--iterations", str(n), "--position_lr_max_steps", str(n),
        "--densify_from_iter", "2", "--densification_interval", "3",
        "--save_frequency", "100", "--eval_frequency", "100", "--logger", "none",
        "--max_tiles_per_gaussian", "8", "--max_pairs_per_tile", "128",
        "--composite_chunk", "16", "--capacity_round", "256", "--ip", ""])

    class Rows:
        def __init__(self):
            self.rows = []

        def log(self, info, model):
            self.rows.append((info.iter, info.elapsed_time, info.topology_ms))

        def close(self):
            pass

    random.seed(0)
    np.random.seed(0)
    rows = Rows()
    driver.training(*(config.extract_config(args, getattr(config, c)) for c in CONFIGS),
                    args, logger=rows)
    spans = ring.snapshot()
    by_id = _by_id(spans)
    ms = {int(i): (int(t1) - int(t0)) * 1e-6
          for i, t0, t1 in zip(spans.id, spans.t0, spans.t1)}
    names = collections.Counter(v[0] for v in by_id.values())
    assert names["train/step"] == n and names["train/loop"] == 1
    assert names["topo/event"] == 2
    loop = next(i for i, v in by_id.items() if v[0] == "train/loop")
    steps = sorted(i for i, v in by_id.items() if v[0] == "train/step")
    events = sorted(i for i, v in by_id.items() if v[0] == "topo/event")
    assert all(by_id[i][1] == loop for i in steps + events)
    assert [r[1] for r in rows.rows[1:]] == [ms[i] for i in steps]
    assert [r[2] for r in rows.rows if r[2] is not None] == [ms[i] for i in events]
    assert [r[0] for r in rows.rows if r[2] is not None] == [3, 6]
    for name in ("render/inputs", "loss", "backward"):
        assert {by_id[i][1] for i, v in by_id.items() if v[0] == name} <= set(steps)
    assert {by_id[by_id[i][1]][0] for i, v in by_id.items()
            if v[0] in ("render/preprocess", "render/binning", "render/composite")
            and by_id[i][1] in steps} == {"train/step"}
