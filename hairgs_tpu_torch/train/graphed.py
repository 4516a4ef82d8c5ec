"""The single-view Stage-I train step replayed as one CUDA graph.

Eagerly, a Stage-I step is ~1340 kernel launches, each a Python call, an
autograd node and a trip through the dispatcher: the host, not the card,
sets the pace. `GraphedStep` records the step once per static shape as a
`torch.cuda.CUDAGraph` and replays it, so the host enqueues one graph
launch and a few copies per step. The same kernels run in the same order
on the same inputs, so the results are those of the eager step bit for bit.

The graph reads fixed buffers: the arenas (parameters, Adam's moments
and step, the densification statistics), the active mask, one camera and
the learning rate of `xyz`. Adam and the statistics write the step's new
state into the arenas they read, by the eager step's operations (their
`out=` forms), and each call returns those buffers, so between steps the
model's state is the graph's. Before a replay the drawn view is copied
into the camera buffers, the learning rate is filled in, and a state
tensor is copied in only where it is not the buffer already (after a
topology event installed new arenas of the same capacity).

A new key (the shapes of the state and the camera) records a new graph in
place of the previous one, inside a `train/capture` span: one eager run of the
step on a side stream, as capture asks of a first run, which is this
step's, then the capture, which runs nothing. The step's `RasterConfig`,
SH degree and image size are fixed for a step; the driver builds a new
step, and so a new graph, when a controller changes one. A batch of views
and tensors that the backend does not take (the CPU) run the eager step.
"""

import torch

from hairgs_tpu_torch import telemetry
from hairgs_tpu_torch.render.composite_pairs import launches


def _leaves(tree):
    """The tensors (and Nones) of nested tuples, in order."""
    if tree is None or isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for t in tree for leaf in _leaves(t)]


def _map(fn, tree):
    """fn on every tensor of nested (named) tuples; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    items = [_map(fn, t) for t in tree]
    return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)


def _signature(tree):
    return tuple(None if t is None else (tuple(t.shape), t.dtype, t.device)
                 for t in _leaves(tree))


class CudaGraphs:
    """The capture backend: `torch.cuda.CUDAGraph` on a side stream. The
    graphs it records in turn share one memory pool: a new one, recorded
    while the one it replaces still holds the pool, reuses its blocks."""

    def __init__(self):
        self._stream = None
        self._pool = None

    @staticmethod
    def supports(t: torch.Tensor) -> bool:
        return t.is_cuda

    def _side(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream()
        self._stream.wait_stream(torch.cuda.current_stream())
        return self._stream

    def warm_up(self, fn):
        """fn() run on the side stream; its result."""
        side = self._side()
        with torch.cuda.stream(side):
            out = fn()
        torch.cuda.current_stream().wait_stream(side)
        return out

    def capture(self, fn):
        """(graph, fn's result): fn() recorded into a new graph, not run.
        Unlike `torch.cuda.graph`, no synchronise, garbage collection or
        cache release before the capture: a step records one afresh
        whenever its shapes change."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        side = self._side()
        with torch.cuda.stream(side):
            graph.capture_begin(pool=self._pool)
            try:
                out = fn()
            finally:
                graph.capture_end()
        torch.cuda.current_stream().wait_stream(side)
        return graph, out

    @staticmethod
    def replay(graph):
        graph.replay()


class GraphedStep:
    """`step_fn(params, stats, opt_state, active, camera, step)` of Stage I
    (`trainer.make_gaussian_train_step`), replayed as a graph where the
    backend takes the tensors and the camera is one view.

    `eager` is the step itself; `body(params, stats, opt_state, active,
    camera, lr_tree, in_place)` the same step with its learning rates given;
    `lr_tree(step)` the learning rates at `step` (xyz's a 0-d float32
    tensor).
    """

    def __init__(self, eager, body, lr_tree, backend=None):
        self.eager = eager
        self.body = body
        self.lr_tree = lr_tree
        self.backend = CudaGraphs() if backend is None else backend
        self._key = None
        self._graph = None
        self._out = None  # the graph's (metrics, image)
        self._state = None  # (params, stats, opt_state, active) it reads
        self._camera = None
        self._lr = None  # xyz's learning rate, 0-d float32
        self._launches = {}  # the compositor launches one replay makes

    def __call__(self, params, stats, opt_state, active, camera, step):
        if camera.world_view.ndim != 2 or not self.backend.supports(active):
            return self.eager(params, stats, opt_state, active, camera, step)
        state = (params, stats, opt_state, active)
        rates = self.lr_tree(step)
        key = (_signature(state), _signature(camera))
        if key != self._key:
            with telemetry.span(telemetry.TRAIN_CAPTURE):
                return self._capture(key, state, camera, rates)
        for dst, src in zip(_leaves(self._state), _leaves(state)):
            if dst.data_ptr() != src.data_ptr():
                dst.copy_(src)
        self._load(camera, rates.xyz)
        self.backend.replay(self._graph)
        for name, n in self._launches.items():
            launches[name] += n
        return (*self._state[:3], *self._out)

    def _load(self, camera, xyz_lr):
        for dst, src in zip(_leaves(self._camera), _leaves(camera)):
            if dst is not None:
                dst.copy_(src)
        if xyz_lr.device == self._lr.device:
            self._lr.copy_(xyz_lr)
        else:  # the host's float32 rate, passed with the fill
            self._lr.fill_(xyz_lr.item())

    def _capture(self, key, state, camera, rates):
        self._key = None
        self._state = _map(torch.clone, state)
        self._camera = _map(torch.clone, camera)
        self._lr = torch.empty((), dtype=torch.float32, device=state[-1].device)
        self._load(camera, rates.xyz)
        rates = rates._replace(xyz=self._lr)

        def step():  # (metrics, image); the new state in the buffers
            return self.body(*self._state, self._camera, rates, in_place=True)[3:]

        result = self.backend.warm_up(step)  # this step's
        before = dict(launches)
        # the previous graph is freed once this one holds the pool
        self._graph, self._out = self.backend.capture(step)
        # the capture ran nothing: its launches are counted at each replay
        self._launches = {k: launches[k] - before[k] for k in launches}
        launches.update(before)
        self._key = key
        return (*self._state[:3], *result)
