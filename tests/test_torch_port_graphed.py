"""The Stage-I and Stage-III steps replayed as a CUDA graph
(hairgs_tpu_torch/train/graphed.py).

On the CPU the capture backend is a fake that runs what it records: at
capture the step once, at each replay the step again, its outputs written
into those of the capture (what a replay leaves in a graph's output
tensors). The wrapper's logic around it is the card's: when it captures,
what it copies in, what it returns, when it leaves the step eager, which
graphs it frees and when it hands their memory back. The fake keeps the
books of the graphs and pools alive, so a test bounds them.

`test_graphed_steps_equal_eager_steps_on_the_card` and
`test_graphed_hair_steps_equal_eager_steps_on_the_card` are the same
comparisons on the card with real graphs; they skip without one. On the card, from the
root of a checkout (the tests' conftest.py imports JAX, which the card's
machine does not have):

    python3 -m pytest --noconftest -p no:cacheprovider -q -m card \
        -W ignore::pytest.PytestUnknownMarkWarning tests/test_torch_port_graphed.py
"""

import contextlib
import weakref

import numpy as np
import pytest
import torch

from hairgs_tpu_torch import telemetry
from hairgs_tpu_torch.bench_scene import build_bench_scene
from hairgs_tpu_torch.core.camera import stack_cameras
from hairgs_tpu_torch.optim import AdamState
from hairgs_tpu_torch.render.renderer import RasterConfig, render
from hairgs_tpu_torch.train import graphed
from hairgs_tpu_torch.train.graphed import GraphedStep
from hairgs_tpu_torch.train.trainer import make_gaussian_train_step, make_hair_train_step

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


class _Graph:
    """A fake graph: the callable it recorded, the outputs its replays
    write, whether it was freed."""

    def __init__(self, fn, out):
        self.fn, self.out = fn, out
        self.freed = False


class FakeGraphs:
    """A capture backend that takes CPU tensors: it records the callable
    and runs it at each replay, its outputs in the capture's output list.

    It keeps the books of the card's allocator for graphs, across all its
    instances: each capture records into a pool of its own, of one unit of
    memory; a pool stays reserved while a graph in it lives (neither freed
    nor collected), and after that until a `release`."""

    pools = {}  # pool id: its graphs, as weak references

    def __init__(self):
        self.captures = self.replays = 0
        self.replaying = False
        self.held = None
        self.most_live = 0  # the most graphs alive at the end of a capture

    @staticmethod
    def supports(t):
        return True

    @staticmethod
    def warm_up(fn):
        return fn()

    def capture(self, fn):
        self.captures += 1
        out = [None, None]
        graph = _Graph(fn, out)
        FakeGraphs.pools[len(FakeGraphs.pools)] = [weakref.ref(graph)]
        self.most_live = max(self.most_live, live_graphs())
        return graph, out

    def replay(self, graph):
        assert not graph.freed
        self.replays += 1
        self.replaying = True
        try:
            graph.out[:] = graph.fn()
        finally:
            self.replaying = False

    @staticmethod
    def free(graph):
        graph.freed = True

    @staticmethod
    def release():
        for pool, refs in list(FakeGraphs.pools.items()):
            if not any(_alive(r) for r in refs):
                del FakeGraphs.pools[pool]

    @staticmethod
    def reserved():
        return len(FakeGraphs.pools)

    @staticmethod
    def live():
        return live_graphs()


def _alive(ref):
    graph = ref()
    return graph is not None and not graph.freed


def live_graphs():
    return sum(_alive(r) for refs in FakeGraphs.pools.values() for r in refs)


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


@pytest.fixture
def books(monkeypatch):
    """The fake in place of the card's backend, from empty books; the
    capture counter, fresh."""
    monkeypatch.setattr(FakeGraphs, "pools", {})
    monkeypatch.setattr(graphed, "SHARED", FakeGraphs())
    counter = []
    monkeypatch.setattr(telemetry, "CAPTURES", counter)
    return counter


def test_one_graph_and_one_pool_live_through_new_keys_and_rebuilt_steps(books):
    """The arenas grow under one step (a new key each), and the driver
    builds a new step for each new tile cap (2048 -> 4096 -> 2048) and drops
    the old one. After every step one graph and one pool are alive; after
    every capture the counter reads one pool reserved and one live graph; each key captures once; every step
    equals the eager step bit for bit."""
    scene = _scene()

    def build(max_pairs):  # as training()'s build_step, on the shared backend
        return _step(scene, RasterConfig(**{**RASTER.__dict__,
                                            "max_pairs_per_tile": max_pairs}))

    state, it = _start(scene), 1
    backends = set()
    for max_pairs, grows in ((2048, 2), (4096, 1), (2048, 0)):
        step = build(max_pairs)  # the old step is dropped here
        backends.add(id(step.backend))
        for g in range(grows + 1):
            if g:
                state = _grown(state, 256)
            expect = _run(step.eager, scene, state, [0, 1], first=it)
            ran = _run(step, scene, state, [0, 1], first=it)
            for a, b in zip(ran, expect):
                _assert_equal(a, b)
            assert live_graphs() == 1 and len(FakeGraphs.pools) == 1
            state, it = ran[-1][0], it + 2
    fake = step.backend
    assert len(backends) == 1 and fake.most_live == 1
    assert (fake.captures, fake.replays) == (6, 6)
    assert books == [(1, 1)] * 6


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
    a changed pair capacity after the second, which frees the first graph,
    and no graphed step makes a call that waits for the card (torch's sync
    debug mode raises on one)."""
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
    # the second step's capture freed the first step's graph
    assert captured[-1]._graph is graphed.SHARED.held is not None
    assert captured[0]._graph is not graphed.SHARED.held
    assert graphed.SHARED.live() == 1
    for a, b in zip(ran, eager):
        _assert_equal(a, b)


class _HairScene:
    """Strands of several segments of 4 mm from points of the bench scene's
    cloud, in sharp bends (so the smoothness term acts), in a hair model;
    the bench scene's cameras and optimisation settings."""

    def __init__(self, n_strands=12, per_strand=4, width=W, height=H,
                 capacity_round=64, device="cpu", seed=3):
        from hairgs_tpu_torch.models.hair import HairModel

        bench = build_bench_scene(n_gaussians=n_strands, width=width, height=height,
                                  seed=seed, capacity_round=capacity_round,
                                  device=device)
        rng = np.random.default_rng(seed)
        roots = bench.params.xyz[:n_strands].cpu().numpy()
        steps = rng.normal(0, 1, (n_strands, per_strand, 3))
        steps *= 4e-3 / np.linalg.norm(steps, axis=-1, keepdims=True)
        points = roots[:, None] + np.concatenate(
            [np.zeros((n_strands, 1, 3)), np.cumsum(steps, axis=1)], axis=1)
        ids = np.arange(n_strands * (per_strand + 1)).reshape(n_strands, -1)
        self.strands = [np.stack([i[:-1], i[1:]], axis=1) for i in ids]
        ns = n_strands * per_strand
        prob = lambda lo, hi, n: np.log(1 / rng.uniform(lo, hi, (n, 1)) - 1) * -1
        seg = dict(features_dc=rng.normal(0, 0.5, (ns, 1, 3)),
                   features_rest=np.zeros((ns, 0, 3)),
                   opacity=prob(0.3, 0.9, ns), mask=prob(0.3, 0.9, ns),
                   width=np.log(rng.uniform(5e-4, 2e-3, (ns, 1))))
        self.model = HairModel(sh_degree=0, capacity_round=capacity_round, device=device)
        self.model.install(points.reshape(-1, 3).astype(np.float32),
                           np.concatenate(self.strands),
                           {k: v.astype(np.float32) for k, v in seg.items()})
        self.cams, self.opt_cfg = bench.cams, bench.opt_cfg
        self.width, self.height, self.device = width, height, device

    def tables(self, strands, capacity):
        """The smoothness table of `strands`, padded to `capacity` rows as the
        train driver pads it, on the device."""
        from hairgs_tpu_torch.topo.strands import smooth_pair_indices

        info = type("Info", (), {"list_strands": strands})
        pairs, valid = smooth_pair_indices(info, max_pairs=capacity)
        return (torch.from_numpy(pairs.astype(np.int64)).to(self.device),
                torch.from_numpy(valid).to(self.device))

    def start(self):
        m = self.model
        return (m.params, m.graph, m.stats, m.opt_state,
                *self.tables(self.strands, m.capacity))

    def step(self, raster=RASTER):
        return make_hair_train_step(
            self.opt_cfg, raster, width=self.width, height=self.height,
            active_sh_degree=0, dist_to_scale_factor=self.model.dist_to_scale_factor,
            device=self.device)

    def merge(self):
        """A merge's install at the same capacities, as a function of the
        state: strand 1's root joined to strand 0's tip, so new
        `endpoint_pairs` and a new smoothness table of the same shapes. Its
        tensors are made here, before any step."""
        row = len(self.strands[0])  # strand 1's first segment
        joined = np.concatenate([self.strands[0], self.strands[1]])
        joined[row, 0] = self.strands[0][-1, 1]
        pairs = self.model.graph.endpoint_pairs.clone()
        pairs[row] = torch.from_numpy(joined[row]).to(self.device)
        tables = self.tables([joined] + self.strands[2:], self.model.capacity)

        def install(state):
            params, graph, stats, opt, _, _ = state
            return (params, graph._replace(endpoint_pairs=pairs), stats, opt, *tables)

        return install

    def grown(self, state, rows=64):
        """A densify's install: every arena `rows` rows longer (zero rows,
        inactive), the smoothness table padded to the new capacity; nothing
        comes from the host."""
        params, graph, stats, opt, pairs, valid = state

        def pad(t):
            return torch.cat([t, torch.zeros((rows,) + t.shape[1:], dtype=t.dtype,
                                             device=t.device)])

        return (graphed._map(pad, params), graphed._map(pad, graph),
                graphed._map(pad, stats),
                AdamState(graphed._map(pad, opt.mu), graphed._map(pad, opt.nu), opt.step),
                pad(pairs), pad(valid))


def _run_hair(step, hair, state, installs, n=6, first=1, watch=None):
    """n steps from `state`, `installs[i]` replacing the state before step i;
    each step's (params, stats, opt_state), metrics and image, cloned.
    `watch(i)` is a context around step i's call."""
    out = []
    for i in range(n):
        if i in installs:
            state = installs[i](state)
        params, graph, stats, opt, pairs, valid = state
        with watch(i) if watch else contextlib.nullcontext():
            params, stats, opt, metrics, image = step(
                params, graph, stats, opt, hair.cams[i % len(hair.cams)], first + i,
                pairs, valid)
        state = (params, graph, stats, opt, pairs, valid)
        out.append((graphed._map(torch.clone, (params, stats, opt)),
                    {k: m.clone() for k, m in metrics.items()}, image.clone()))
    return out


@pytest.mark.card
def test_graphed_hair_steps_equal_eager_steps_on_the_card(card):
    """Five graphed Stage-III steps on 2000 strands of 10 segments at 512²
    equal five eager steps bit for bit (parameters, moments, statistics,
    metrics with the smoothness term, image), through a merge's install
    before the second (copied in) and a densify's before the third (a
    re-capture, which frees the first graph), and no graphed step makes a
    call that waits for the card (torch's sync debug mode raises on one)."""
    hair = _HairScene(n_strands=2000, per_strand=10, width=512, height=512,
                      capacity_round=4096, device=card)
    raster = RasterConfig(max_tiles_per_gaussian=16, max_pairs_per_tile=1024, chunk=32,
                          use_pallas=True, pair_capacity=200_000)
    installs = {1: hair.merge(), 2: lambda state: hair.grown(state, 4096)}
    eager = _run_hair(hair.step(raster).eager, hair, hair.start(), installs, n=5,
                      first=100)
    torch.cuda.synchronize()
    step = hair.step(raster)
    start = hair.start()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ran = _run_hair(step, hair, start, installs, n=5, first=100)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert step._graph is graphed.SHARED.held is not None
    assert graphed.SHARED.live() == 1
    assert float(ran[-1][1]["loss/smooth"]) > 0
    for a, b in zip(ran, eager):
        _assert_equal(a, b)


def test_the_eager_hair_step_runs_where_no_graph_can():
    """A Stage-III step with the magnet term on takes the eager step and
    captures nothing; a reducer or another render function builds no
    graphed step."""
    import dataclasses

    from hairgs_tpu_torch.topo.strands import magnet_indices

    hair = _HairScene()
    opt_cfg = dataclasses.replace(hair.opt_cfg, lambda_magnet=0.5)
    common = dict(width=hair.width, height=hair.height, active_sh_degree=0,
                  dist_to_scale_factor=hair.model.dist_to_scale_factor, device="cpu")
    step = make_hair_train_step(opt_cfg, RASTER, use_magnet=True, **common)
    fake = step.backend = FakeGraphs()
    magnet = tuple(torch.from_numpy(a.astype(np.int64) if a.dtype != bool else a)
                   for a in magnet_indices(hair.model))
    params, graph, stats, opt, pairs, valid = hair.start()
    got = step(params, graph, stats, opt, hair.cams[0], 1, pairs, valid, magnet)
    expect = step.eager(params, graph, stats, opt, hair.cams[0], 1, pairs, valid, magnet)
    assert fake.captures == 0 and step._graph is None
    assert float(got[3]["loss/magnet"]) > 0
    _assert_equal((got[:3], got[3], got[4]), (expect[:3], expect[3], expect[4]))
    for kwargs in (dict(reducer=object()),
                   dict(render_fn=lambda *a, **k: render(*a, **k))):
        assert not isinstance(make_hair_train_step(opt_cfg, RASTER, **common, **kwargs),
                              GraphedStep)


HAIR_STATE = (["params"] * 6 + ["endpoint_pairs", "seg_active", "ep_active"]
              + ["stats"] * 3 + ["opt_state"] * 13 + ["smooth_pairs", "smooth_valid"])


def test_graphed_hair_steps_equal_eager_steps_through_a_merge_and_a_densify(
        books, monkeypatch):
    """Six Stage-III steps through the fake equal six eager steps bit for bit
    (parameters, moments, statistics, metrics with the smoothness term,
    image). A merge's install between steps 2 and 3 (new endpoint pairs and
    a new smoothness table of the same shapes) is copied in with no
    capture, and nothing of the params, statistics and Adam's state is
    copied; a densify's install between steps 4 and 5 (new capacities)
    captures once more, and one graph stays alive."""
    hair = _HairScene()
    installs = {2: hair.merge(), 4: hair.grown}
    expect = _run_hair(hair.step().eager, hair, hair.start(), installs)
    step = hair.step()
    assert isinstance(step, GraphedStep) and isinstance(step.backend, FakeGraphs)
    fake = step.backend
    copy = torch.Tensor.copy_
    copied = set()

    @contextlib.contextmanager
    def watch(i):
        if i != 2:
            yield
            return
        captures, into = fake.captures, []

        def counted(dst, src, *a, **k):
            if not fake.replaying:
                into.append(dst.data_ptr())
            return copy(dst, src, *a, **k)

        monkeypatch.setattr(torch.Tensor, "copy_", counted)
        try:
            yield
        finally:
            monkeypatch.setattr(torch.Tensor, "copy_", copy)
        assert fake.captures == captures
        leaves = graphed._leaves(step._state)
        assert len(leaves) == len(HAIR_STATE)
        buffers = {t.data_ptr(): name for name, t in zip(HAIR_STATE, leaves) if t.numel()}
        copied.update(buffers[p] for p in into if p in buffers)

    ran = _run_hair(step, hair, hair.start(), installs, watch=watch)
    for a, b in zip(ran, expect):
        _assert_equal(a, b)
    assert float(ran[-1][1]["loss/smooth"]) > 0
    assert (fake.captures, fake.replays) == (2, 4)
    assert live_graphs() == 1 and books == [(1, 1), (1, 1)]
    assert int(ran[-1][0][2].step) == 6
    # the caller's graph and table are not the step's buffers: copied at
    # every replay, the merge's new ones among them
    assert copied == {"endpoint_pairs", "seg_active", "ep_active", "smooth_pairs",
                      "smooth_valid"}
