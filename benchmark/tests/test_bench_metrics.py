"""Each per-layer reader on a recorded window and profiler fixture, and the
trace reading itself."""

import os
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness, trace
from benchmark.window import Row, tail_s_per_it

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class Event:
    def __init__(self, name, start, end, device):
        self._n, self._s, self._e, self._d = name, start, end, device

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def device_type(self):
        return f"DeviceType.{self._d}"


def fake_prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


def test_trace_union_gaps_and_labels():
    prof = fake_prof([Event("k1", 0, 10, "CUDA"), Event("k2", 5, 20, "CUDA"),
                      Event("k1", 30, 40, "CUDA"),
                      Event("aten::item", 15, 36, "CPU"),
                      Event("cudaStreamSynchronize", 18, 35, "CPU")])
    t = trace.read(prof)
    assert t.launches == 3
    assert t.busy_s == pytest.approx(30e-9)
    assert t.device_ops == [["k1", pytest.approx(20e-9)], ["k2", pytest.approx(15e-9)]]
    assert t.idle_gaps == [["cudaStreamSynchronize", pytest.approx(10e-9)]]
    assert trace.read(fake_prof([Event("x", 0, 5, "CPU")])) == trace.Trace(0.0, 0, [], [])


def window_fixture():
    """A 10-s window of 400 iterations whose last 8 (synchronised at 410)
    took 0.5 s, then 4 profiled iterations."""
    rows = [Row(21, 100.0, None, 10, False), Row(22, 100.1, 50.0, 10, False),
            Row(23, 100.2, 25.0, 12, False), Row(410, 109.5, None, 12, True),
            Row(418, 109.9, None, 12, False)]
    logger = SimpleNamespace(
        rows=rows, t_open=100.0, t_close=110.0, it_open=20, it_close=420,
        prof_rows=[Row(421, 0, None, 12, False), Row(422, 0, 30.0, 12, False),
                   Row(423, 0, None, 13, False), Row(424, 0, None, 13, False)])
    tr = trace.Trace(busy_s=0.02, launches=1200, device_ops=[], idle_gaps=[])
    return harness.Context(logger, tr, None, None, [], torch.device("cpu"), 5)


STAGES = pytest.mark.parametrize("stage", ["stage1", "stage3"])


@STAGES
def test_window_readers(stage):
    ctx = window_fixture()
    assert harness.reader(f"topology_share.{stage}")(ctx) == pytest.approx(0.75)
    assert harness.reader(f"launches_per_it.{stage}")(ctx) == pytest.approx(300.0)
    # 5 ms busy per iteration against the 50 ms per iteration of 410-420
    assert harness.reader(f"device_idle.{stage}")(ctx) == pytest.approx(90.0)


def test_tail_stretch():
    """The stretch starts at the latest synchronised row at least n
    iterations before the close; with none, the whole window."""
    log = window_fixture().logger
    assert tail_s_per_it(log, 4) == pytest.approx(0.05)
    assert tail_s_per_it(log, 10) == pytest.approx(0.05)
    assert tail_s_per_it(log, 11) == pytest.approx(10.0 / 400)


@STAGES
def test_readers_find_nothing(stage):
    ctx = window_fixture()
    ctx.trace = trace.Trace(0.0, 0, [], [])
    assert harness.reader(f"launches_per_it.{stage}")(ctx) is None
    assert harness.reader(f"device_idle.{stage}")(ctx) is None
    assert harness.reader(f"composite_roofline.{stage}")(ctx) is None  # no card


def test_every_metric_has_a_reader():
    import json

    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        manifest = json.load(fh)
    for m in manifest["per_layer"]:
        assert callable(harness.reader(m["name"])), m["name"]


class OneTile(harness.Context):
    """A context whose every view holds one tile with one Gaussian."""

    def raster(self):
        return SimpleNamespace(alpha_min=1 / 255, viewspace_stats=True)

    def table(self, v):
        geo = torch.zeros((8, 2))
        geo[:, 0] = torch.tensor([8.0, 8.0, 0.25, 0.0, 0.25, 0.5, 0.0, 0.0])
        return geo, None, torch.tensor([0]), torch.tensor([1]), 1, 7


def test_step_mfu_reader():
    from benchmark import counts
    from hairgs_tpu_torch.models.gaussian import GaussianParams

    base = window_fixture()
    n, arena = 10, 16  # Gaussians in an arena of 16 rows
    params = GaussianParams(
        xyz=torch.zeros(arena, 3), features_dc=torch.zeros(arena, 1, 3),
        features_rest=torch.zeros(arena, 0, 3), scaling=torch.zeros(arena, 3),
        rotation=torch.zeros(arena, 4), opacity=torch.zeros(arena, 1),
        mask=torch.zeros(arena, 1))
    ctx = OneTile(base.logger, base.trace, SimpleNamespace(count=n, params=params), None,
                  [{"width": 16, "height": 16}] * 2, torch.device("cpu"), 5)
    assert ctx.parameters == 15 * n
    gates = counts.gate_counts(*ctx.table(0)[:1], torch.tensor([0]), torch.tensor([1]), 1)
    ops = counts.step_ops(counts.fwd_ops(7, gates) + counts.bwd_ops(gates), 256, n, 15 * n)
    want = 100 * ops / 0.05 / counts.PEAK_FP32_FLOP_PER_S
    assert harness.reader("step_mfu.stage1")(ctx) == pytest.approx(want)


def test_hair_rows_and_parameters():
    """A strand graph's leaves: endpoints by the endpoint count, the rest by
    the segment count."""
    from benchmark.window import live_rows, splats
    from hairgs_tpu_torch.models.hair import HairParams

    e, s, arena = 9, 6, 16
    params = HairParams(
        endpoints=torch.zeros(arena, 3), features_dc=torch.zeros(arena, 1, 3),
        features_rest=torch.zeros(arena, 0, 3), opacity=torch.zeros(arena, 1),
        mask=torch.zeros(arena, 1), width=torch.zeros(arena, 1))
    model = SimpleNamespace(num_endpoints=e, num_segments=s, params=params)
    assert splats(model) == s
    assert live_rows(model)["endpoints"] == e and live_rows(model)["width"] == s
    ctx = harness.Context(None, None, model, None, [], torch.device("cpu"), 0)
    assert ctx.parameters == 3 * e + (3 + 1 + 1 + 1) * s


def test_composite_roofline_on_card(card):
    """The reader's kernels run and read a share in (0, 100] on a dense
    one-tile table."""
    from hairgs_tpu_torch.render.renderer import RasterConfig

    g = torch.Generator().manual_seed(0)
    n = 128
    geo = torch.zeros((8, n + 128))
    geo[0, :n] = torch.rand(n, generator=g) * 16
    geo[1, :n] = torch.rand(n, generator=g) * 16
    geo[2, :n] = geo[4, :n] = 0.2
    geo[5, :n] = 0.6
    feat = torch.rand((8, n + 128), generator=g)

    class Dense(harness.Context):
        def raster(self):
            return RasterConfig(max_pairs_per_tile=128, chunk=128, use_pallas=True)

        def table(self, v):
            return (geo.to(card), feat.to(card), torch.tensor([0], dtype=torch.int32, device=card),
                    torch.tensor([n], dtype=torch.int32, device=card), 1, 7)

    ctx = Dense(None, None, None, None, [], card, 3)
    share = harness.reader("composite_roofline.stage1")(ctx)
    assert 0 < share <= 100
