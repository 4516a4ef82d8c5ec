"""The readers of the program's spans (benchmark/spans.py): the window
readers on a hand-made ring, the trace readers on a CPU profiler trace of
spans, a forward and its backward, with kernels laid beside its operations
(the backward's through the nodes' sequence numbers), and None wherever
there is nothing to read."""

import sys
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness, spans
from hairgs_tpu_torch import telemetry

STAGE1 = ("host_step_share.stage1", "idle_outside_step.stage1", "syncs_per_it.stage1",
          "binning_device_share.stage1", "loss_device_share.stage1")
STAGE3 = ("host_step_share.stage3", "merge_search_share.stage3",
          "strand_walk_share.stage3", "topology_transfer_share.stage3",
          "idle_outside_step.stage3", "syncs_per_it.stage3",
          "binning_device_share.stage3", "loss_device_share.stage3")
TRACE = ("idle_outside_step", "syncs_per_it", "binning_device_share", "loss_device_share")
WINDOW = ("host_step_share", "merge_search_share", "strand_walk_share",
          "topology_transfer_share")
MS = 1_000_000  # ns


def _ring(rows, capacity=64):
    """A ring of (name, id, parent, t0 ms, t1 ms) rows, in that order of ends."""
    r = telemetry.Ring(capacity)
    for name, i, parent, t0, t1 in rows:
        r.write(telemetry.NAMES.index(name), i, parent, 1, t0 * MS, t1 * MS)
    return r


# a window of 1000 ms from 1000 to 2000: steps of 100 (clipped), 300 and
# 100 (clipped) ms in it; one merge event with its phases; a walk outside it
WINDOW_ROWS = [
    ("train/step", 1, -1, 900, 1100), ("train/step", 2, -1, 1200, 1500),
    ("topo/pull", 11, 10, 1500, 1520), ("topo/merge_search", 12, 10, 1520, 1600),
    ("topo/install", 14, 13, 1600, 1620), ("topo/walk", 15, 13, 1620, 1700),
    ("train/sync", 16, 13, 1700, 1750), ("topo/merge_apply", 13, 10, 1600, 1750),
    ("topo/strand_tables", 17, 10, 1750, 1780), ("topo/event", 10, -1, 1500, 1800),
    ("topo/walk", 18, -1, 1800, 1850), ("train/step", 3, -1, 1900, 2200),
]


def _window_ctx():
    return SimpleNamespace(logger=SimpleNamespace(t_open=1.0, t_close=2.0, rows=[],
                                                  prof=None), traced_its=2)


def test_window_readers_on_a_ring(monkeypatch):
    monkeypatch.setattr(telemetry, "RING", _ring(WINDOW_ROWS))
    ctx = _window_ctx()
    read = {m: harness.reader(m)(ctx) for m in STAGE3 if not m.startswith(TRACE)}
    assert read == {
        "host_step_share.stage3": pytest.approx(50.0),
        "merge_search_share.stage3": pytest.approx(8.0),
        "strand_walk_share.stage3": pytest.approx(8.0 + 3.0),
        "topology_transfer_share.stage3": pytest.approx(2.0 + 2.0),
    }
    assert harness.reader("host_step_share.stage1")(ctx) == pytest.approx(50.0)
    # Σ phases within the event's 300 ms
    assert sum(list(read.values())[1:]) <= 30.0


def test_window_readers_on_a_wrapped_ring(monkeypatch):
    """A ring that wrapped reads while what it kept reaches back past the
    window's start, and not once spans that ended in the window are gone."""
    early = [("train/step", 100 + k, -1, 10 * k, 10 * k + 5) for k in range(60)]
    monkeypatch.setattr(telemetry, "RING", _ring(early + WINDOW_ROWS, capacity=16))
    ctx = _window_ctx()
    assert telemetry.RING.snapshot().dropped == 60 + len(WINDOW_ROWS) - 16
    assert harness.reader("host_step_share.stage3")(ctx) == pytest.approx(50.0)
    monkeypatch.setattr(telemetry, "RING", _ring(early + WINDOW_ROWS, capacity=8))
    for m in WINDOW:
        assert spans.__dict__[m](ctx) is None, m


def test_window_readers_without_spans(monkeypatch):
    """A program without the span module reads nothing, nor one that
    recorded no step in the window; a window without a topology event
    holds none of their phases."""
    import hairgs_tpu_torch

    ctx = _window_ctx()
    monkeypatch.setattr(telemetry, "RING", _ring([("train/loop", 1, -1, 0, 10)]))
    assert spans.host_step_share(ctx) is None
    assert spans.merge_search_share(ctx) == 0.0
    monkeypatch.setitem(sys.modules, "hairgs_tpu_torch.telemetry", None)
    monkeypatch.delattr(hairgs_tpu_torch, "telemetry")
    for m in WINDOW:
        assert spans.__dict__[m](ctx) is None, m


class Event:
    """A trace event: a recorded one with its fields overridden, or a
    made-up runtime call or device operation."""

    def __init__(self, base=None, **fields):
        self._base, self._f = base, fields

    def __getattr__(self, name):
        if name in self._f:
            return lambda: self._f[name]
        return getattr(self._base, name)


def _kernel(corr, start, end):
    return Event(name=f"kernel{corr}", start_ns=start, duration_ns=end - start,
                 device_type="DeviceType.CUDA", is_user_annotation=False,
                 correlation_id=corr)


def _runtime(name, corr, host_event):
    """A runtime call made inside a recorded host operation."""
    return Event(name=name, start_ns=host_event.start_ns() + 1, duration_ns=1,
                 device_type="DeviceType.CPU", is_user_annotation=False,
                 correlation_id=corr, start_thread_id=host_event.start_thread_id(),
                 fwd_thread_id=0, sequence_nr=-1)


def _cpu_trace():
    """A CPU trace of one step: binning's exp, the loss's mul and sum, their
    backward in `backward`, and a sync."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(8, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with telemetry.span(telemetry.TRAIN_STEP):
            with telemetry.span(telemetry.RENDER_BINNING):
                y = x.exp()
            with telemetry.span(telemetry.LOSS):
                loss = (y * 3.0).sum()
            with telemetry.span(telemetry.BACKWARD):
                torch.autograd.grad(loss, x)
        with telemetry.span(telemetry.TRAIN_SYNC):
            loss.item()
        y.neg()  # launched outside every span
    return list(prof.profiler.kineto_results.events())


def _one(events, name, **fields):
    found = [e for e in events if e.name() == name
             and all(getattr(e, k)() == v for k, v in fields.items())]
    assert len(found) == 1, (name, fields, len(found))
    return found[0]


def _ctx(events):
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    return SimpleNamespace(logger=SimpleNamespace(prof=prof), traced_its=2)


def _laid(events, outside_ns=0):
    """The trace with a kernel beside each operation that launches one:
    binning's exp [0, 10], the loss's mul [10, 30], the mul's backward
    [40, 50], the exp's backward [50, 60] (ns after the step's start), two
    synchronisations, and `outside_ns` of kernel launched outside every
    span."""
    step = _one(events, "hairgs::train/step")
    s0 = step.start_ns()
    exp = _one(events, "aten::exp")
    mul = _one(events, "aten::mul", sequence_nr=exp.sequence_nr() + 1)
    mul_bwd = [e for e in events if e.name() == "aten::mul"
               and e.start_ns() > _one(events, "MulBackward0").start_ns()
               and e.start_ns() < _one(events, "ExpBackward0").start_ns()][0]
    exp_bwd = [e for e in events if e.name() == "aten::mul"
               and e.start_ns() > _one(events, "ExpBackward0").start_ns()][0]
    item = _one(events, "aten::item")
    neg = _one(events, "aten::neg")
    laid = []
    for corr, op, (a, b) in ((1, exp, (0, 10)), (2, mul, (10, 30)), (3, mul_bwd, (40, 50)),
                             (4, exp_bwd, (50, 60)), (5, neg, (60, 60 + outside_ns))):
        laid += [_runtime("cudaLaunchKernel", corr, op), _kernel(corr, s0 + a, s0 + b)]
    laid += [_runtime("cudaMemcpyAsync", 6, item), _runtime("cudaStreamSynchronize", 7, item),
             _runtime("cudaDeviceSynchronize", 8, item)]
    return events + laid, step


def test_trace_readers_attribute_forward_and_backward():
    events, _ = _laid(_cpu_trace())
    ctx = _ctx(events)
    # busy 50 ns of the 60: idle from 30 to 40
    assert spans.binning_device_share(ctx) == pytest.approx(100 * 20 / 50)
    assert spans.loss_device_share(ctx) == pytest.approx(100 * 30 / 50)
    assert spans.syncs_per_it(ctx) == pytest.approx(2 / 2)
    for m in STAGE1[1:] + STAGE3[4:]:
        assert 0 <= harness.reader(m)(ctx) <= 100, m


def test_step_wait_is_the_syncs_inside_the_steps():
    """The copy and synchronisations of `aten::item` lie outside the step;
    a copy and a synchronisation made in the loss's mul and in binning's
    exp lie inside it: their 1 ns each is the steps' wait."""
    events, _ = _laid(_cpu_trace())
    assert spans.trace(_ctx(events)).step_wait == 0
    mul = [e for e in events if e.name() == "aten::mul"][0]
    exp = _one(events, "aten::exp")
    ctx = _ctx(events + [_runtime("cudaMemcpyAsync", 9, mul),
                         _runtime("cudaStreamSynchronize", 10, exp)])
    assert spans.trace(ctx).step_wait == 2
    assert spans.syncs_per_it(ctx) == pytest.approx(3 / 2)


def test_idle_outside_step():
    """Gaps of d inside the step and of 2d astride its end: a third of the
    idle time lies outside it."""
    events, step = _laid(_cpu_trace())
    s0, s1 = step.start_ns(), step.start_ns() + step.duration_ns()
    d = (s1 - s0) // 4
    kept = [e for e in events if not str(e.device_type()).endswith("CUDA")]
    kernels = [_kernel(1, s0, s0 + d), _kernel(2, s0 + 2 * d, s0 + 3 * d),
               _kernel(3, s1 + d, s1 + 2 * d)]
    idle = d + (s1 + d) - (s0 + 3 * d)  # d rounds (s1 - s0) / 4 down
    assert spans.idle_outside_step(_ctx(kept + kernels)) == pytest.approx(100 * d / idle)
    assert 100 * d / idle == pytest.approx(100 / 3, rel=1e-3)


def test_trace_readers_read_nothing_without_spans_or_with_unattributed_time():
    events, _ = _laid(_cpu_trace(), outside_ns=2)  # 2 of 52 busy ns: read
    assert spans.loss_device_share(_ctx(events)) == pytest.approx(100 * 30 / 52)
    events, _ = _laid(_cpu_trace(), outside_ns=3)  # 3 of 53: not
    assert spans.loss_device_share(_ctx(events)) is None
    assert spans.binning_device_share(_ctx(events)) is None
    bare = [e for e in _laid(_cpu_trace())[0] if not e.name().startswith("hairgs::")]
    for m in TRACE:
        assert spans.__dict__[m](_ctx(bare)) is None, m
    cpu_only = _cpu_trace()  # spans, but no device operation and no runtime call
    for m in TRACE:
        assert spans.__dict__[m](_ctx(cpu_only)) is None, m
    assert spans.idle_outside_step(SimpleNamespace(logger=SimpleNamespace(prof=None))) is None


def test_timeline_innermost_and_pieces():
    tl = spans.Timeline([(0, 100, "a"), (10, 20, "b"), (30, 60, "c"), (40, 50, "d")])
    assert [tl.at(t) for t in (-1, 0, 15, 20, 25, 45, 55, 99, 100)] == \
        [None, "a", "b", "a", "a", "d", "c", "a", None]
    assert list(tl.pieces(15, 45)) == [("b", 5), ("a", 10), ("c", 10), ("d", 5)]
    assert list(tl.pieces(90, 120)) == [("a", 10), (None, 20)]
