"""The Stage-I step replayed as a CUDA graph (hairgs_tpu_torch/train/graphed.py).

On the CPU the capture backend is a fake that runs what it records: at
capture the step once, at each replay the step again, its outputs written
into those of the capture (what a replay leaves in a graph's output
tensors). The wrapper's logic around it is the card's: when it captures,
what it copies in, what it returns, when it leaves the step eager.

`test_graphed_steps_equal_eager_steps_on_the_card` is the same comparison
on the card with real graphs; it skips without one. On the card, from the
root of a checkout (the tests' conftest.py imports JAX, which the card's
machine does not have):

    python3 -m pytest --noconftest -p no:cacheprovider -q -m card \
        -W ignore::pytest.PytestUnknownMarkWarning tests/test_torch_port_graphed.py
"""

import pytest
import torch

from hairgs_tpu_torch.bench_scene import build_bench_scene
from hairgs_tpu_torch.core.camera import stack_cameras
from hairgs_tpu_torch.optim import AdamState
from hairgs_tpu_torch.render.renderer import RasterConfig, render
from hairgs_tpu_torch.train import graphed
from hairgs_tpu_torch.train.graphed import GraphedStep
from hairgs_tpu_torch.train.trainer import make_gaussian_train_step

W, H = 48, 32
RASTER = RasterConfig(max_tiles_per_gaussian=8, max_pairs_per_tile=64, chunk=16,
                      use_pallas=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


class FakeGraphs:
    """A capture backend that takes CPU tensors: it records the callable
    and runs it at each replay, its outputs in the capture's output list."""

    def __init__(self):
        self.captures = self.replays = 0
        self.replaying = False

    @staticmethod
    def supports(t):
        return True

    @staticmethod
    def warm_up(fn):
        return fn()

    def capture(self, fn):
        self.captures += 1
        out = [None, None]
        return (fn, out), out

    def replay(self, graph):
        fn, out = graph
        self.replays += 1
        self.replaying = True
        try:
            out[:] = fn()
        finally:
            self.replaying = False


def _scene(device="cpu"):
    return build_bench_scene(n_gaussians=300, width=W, height=H, seed=2,
                             capacity_round=256, device=device)


def _step(scene, raster=RASTER, backend=None, device="cpu"):
    step = make_gaussian_train_step(scene.opt_cfg, raster, width=W, height=H,
                                    active_sh_degree=0, device=device)
    if backend is not None:
        step.backend = backend
    return step


def _run(step, scene, state, views, first=1):
    """len(views) steps from `state`; each step's (state, metrics, image),
    cloned."""
    out, active = [], state[3]
    for i, v in enumerate(views):
        *state, metrics, image = step(*state[:3], active, scene.cams[v], first + i)
        state = (*state, active)
        out.append((graphed._map(torch.clone, tuple(state)),
                    {k: m.clone() for k, m in metrics.items()}, image.clone()))
    return out


def _assert_equal(a, b):
    (sa, ma, ia), (sb, mb, ib) = a, b
    for x, y in zip(graphed._leaves(sa), graphed._leaves(sb)):
        assert torch.equal(x, y)
    assert ma.keys() == mb.keys()
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    assert torch.equal(ia, ib)


def _start(scene):
    return (scene.params, scene.stats, scene.opt_state, scene.active)


def test_graphed_steps_equal_eager_steps_and_capture_once_per_key():
    """Three steps through the fake: one capture, two replays, and every
    output equal to the eager step's bit for bit. The caller's starting
    state is left as it was; the returned state is the static buffers,
    the same tensors after every step."""
    scene = _scene()
    before = graphed._map(torch.clone, _start(scene))
    fake = FakeGraphs()
    step = _step(scene, backend=fake)
    assert isinstance(step, GraphedStep)
    ran = _run(step, scene, _start(scene), [0, 1, 2])
    assert (fake.captures, fake.replays) == (1, 2)
    eager = _run(step.eager, scene, _start(scene), [0, 1, 2])
    for a, b in zip(ran, eager):
        _assert_equal(a, b)
    assert int(ran[-1][0][2].step) == 3
    for x, y in zip(graphed._leaves(before), graphed._leaves(_start(scene))):
        assert torch.equal(x, y)
    # the returned state is the graph's buffers
    p1 = step(*_start(scene)[:3], scene.active, scene.cams[0], 1)[0]
    p2 = step(p1, *step._state[1:3], scene.active, scene.cams[1], 2)[0]
    assert all(a is b for a, b in zip(p1, p2))
    assert all(a is b for a, b in zip(p2, step._state[0]))


def _grown(state, rows):
    """The state in arenas `rows` rows longer: zero rows, inactive."""
    def pad(t):
        return torch.cat([t, torch.zeros((rows,) + t.shape[1:], dtype=t.dtype)])

    params, stats, opt, active = state
    return (graphed._map(pad, params), graphed._map(pad, stats),
            AdamState(graphed._map(pad, opt.mu), graphed._map(pad, opt.nu), opt.step),
            pad(active))


def test_recapture_on_a_new_capacity_and_a_new_raster_config():
    """A grown arena is a new key: a second capture, whose steps equal the
    eager ones. A new RasterConfig is a new step, as the driver builds it
    after a controller changed one, and records its own graph."""
    scene = _scene()
    fake = FakeGraphs()
    step = _step(scene, backend=fake)
    state = _run(step, scene, _start(scene), [0, 1])[-1][0]
    grown = _grown(state, 256)
    ran = _run(step, scene, grown, [2, 3], first=3)
    assert (fake.captures, fake.replays) == (2, 2)
    for a, b in zip(ran, _run(step.eager, scene, grown, [2, 3], first=3)):
        _assert_equal(a, b)
    other = _step(scene, RasterConfig(**{**RASTER.__dict__, "pair_capacity": 4096}),
                  backend=fake)
    _run(other, scene, ran[-1][0], [0, 1], first=5)
    assert (fake.captures, fake.replays) == (3, 3)


def test_a_state_tensor_is_copied_in_only_where_its_storage_changed(monkeypatch):
    """Before a replay the wrapper copies in the tensors that are not its
    buffers (a topology event's new arenas) and nothing else of the state;
    the step then reads them."""
    scene = _scene()
    fake = FakeGraphs()
    step = _step(scene, backend=fake)
    params, stats, opt = step(*_start(scene), scene.cams[0], 1)[:3]
    new_opacity = params.opacity - 0.5
    into = []
    copy = torch.Tensor.copy_

    def counted(dst, src, *a, **k):
        if not fake.replaying:
            into.append(dst.data_ptr())
        return copy(dst, src, *a, **k)

    monkeypatch.setattr(torch.Tensor, "copy_", counted)
    state = (params._replace(opacity=new_opacity.clone()), stats, opt, step._state[3])
    expect = step.eager(*state, scene.cams[1], 2)
    got = step(*state, scene.cams[1], 2)
    buffers = {t.data_ptr(): name for name, t in
               zip(["p"] * 7 + ["s"] * 3 + ["o"] * 15 + ["active"],
                   graphed._leaves(step._state))}
    assert [buffers[p] for p in into if p in buffers] == ["p"]
    assert step._state[0].opacity.data_ptr() in into
    _assert_equal((got[:3], got[3], got[4]), (expect[:3], expect[3], expect[4]))


def test_the_eager_step_runs_where_no_graph_can():
    """A batch of views, a reducer, another render function and the CPU
    without the fake take the eager step and capture nothing."""
    scene = _scene()
    fake = FakeGraphs()
    step = _step(scene, backend=fake)
    batch = stack_cameras(scene.cams[:2])
    got = step(*_start(scene)[:3], scene.active, batch, 1)
    expect = step.eager(*_start(scene)[:3], scene.active, batch, 1)
    assert fake.captures == 0 and step._graph is None
    _assert_equal((got[:3], got[3], got[4]), (expect[:3], expect[3], expect[4]))
    for kwargs in (dict(reducer=object()),
                   dict(render_fn=lambda *a, **k: render(*a, **k))):
        plain = make_gaussian_train_step(scene.opt_cfg, RASTER, width=W, height=H,
                                         active_sh_degree=0, device="cpu", **kwargs)
        assert not isinstance(plain, GraphedStep)
    cpu = _step(scene)
    assert isinstance(cpu.backend, graphed.CudaGraphs)
    cpu(*_start(scene)[:3], scene.active, scene.cams[0], 1)
    assert cpu._graph is None and cpu._key is None


@pytest.mark.card
def test_graphed_steps_equal_eager_steps_on_the_card(card):
    """Five graphed steps on the bench scene equal five eager steps bit for
    bit (parameters, moments, statistics, metrics, image), a re-capture on
    a changed pair capacity after the second, and no graphed step makes a
    call that waits for the card (torch's sync debug mode raises on one)."""
    scene = build_bench_scene(n_gaussians=20_000, width=512, height=512, seed=1,
                              device=card)
    w, h = scene.width, scene.height
    raster = RasterConfig(max_tiles_per_gaussian=16, max_pairs_per_tile=1024, chunk=32,
                          use_pallas=True, pair_capacity=200_000)
    grown = RasterConfig(**{**raster.__dict__, "pair_capacity": 300_000})

    def steps(make):
        out, state = [], _start(scene)
        for i, cfg in enumerate([raster, raster, grown, grown, grown]):
            if i in (0, 2):
                step = make(cfg)
            *state, metrics, image = step(*state[:3], scene.active, scene.cams[i % 4],
                                          100 + i)
            state = (*state, scene.active)
            out.append((graphed._map(torch.clone, tuple(state)),
                        {k: m.clone() for k, m in metrics.items()}, image.clone()))
        return out

    def build(cfg):
        return make_gaussian_train_step(scene.opt_cfg, cfg, width=w, height=h,
                                        active_sh_degree=0, device=card)

    eager = steps(lambda cfg: build(cfg).eager)
    torch.cuda.synchronize()
    captured = []

    def graphed_step(cfg):
        step = build(cfg)
        captured.append(step)
        return step

    torch.cuda.set_sync_debug_mode("error")
    try:
        ran = steps(graphed_step)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert all(s._graph is not None for s in captured)
    for a, b in zip(ran, eager):
        _assert_equal(a, b)
