"""The single-view train steps of Stage I and Stage III replayed as one
CUDA graph.

Eagerly, a step is ~1340 (Stage I) or ~1540 (Stage III) kernel launches,
each a Python call, an autograd node and a trip through the dispatcher:
the host, not the card, sets the pace. `GraphedStep` records the step once
per static shape as a `torch.cuda.CUDAGraph` and replays it, so the host
enqueues one graph launch and a few copies per step. The same kernels run
in the same order on the same inputs, so the results are those of the
eager step bit for bit.

The graph reads fixed buffers: the step's state (Stage I: the arenas of
parameters, Adam's moments and step, the densification statistics and the
active mask; Stage III: those of the hair model, its segment graph and the
smoothness table), one camera and the one learning rate that follows a
schedule. Adam and the statistics write the step's new state into the
arenas they read, by the eager step's operations (their `out=` forms), and
each call returns those buffers, so between steps the model's state is the
graph's. Before a replay the drawn view is copied into the camera buffers,
the learning rate is filled in, and a state tensor is copied in only where
it is not the buffer already (after a topology event installed new arenas
or tables of the same capacity).

A new key (the shapes of the state and the camera) records a new graph in
place of the previous one, inside a `train/capture` span: one eager run of the
step on a side stream, as capture asks of a first run, which is this
step's, then the capture, which runs nothing. The step's `RasterConfig`,
SH degree and image size are fixed for a step; the driver builds a new
step, and so a new graph, when a controller changes one. A call the graph
does not take (a batch of views, Stage III's magnet term) and tensors that
the backend does not take (the CPU) run the eager step.

Memory. The steps share one backend (`SHARED`), which holds one graph at a
time, each in a memory pool of its own. A capture first frees the graph
the backend holds, whichever step recorded it, and before it records hands
the caching allocator's free blocks back to the card: the allocator
releases no cached memory while a capture is under way, so a capture could
otherwise run out of memory beside gigabytes reserved by earlier graphs'
pools and left free. So the memory held for graphs is one step's, however
many keys the arenas and the controllers produce. After each capture the
reserved bytes and the live graphs go to `telemetry.CAPTURES` and to
standard error.
"""

import sys
import weakref

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
    """The capture backend: `torch.cuda.CUDAGraph` on a side stream, each
    graph recorded into a pool of its own. `free` destroys a graph, so its
    pool holds only blocks that tensors still use; `release` hands the
    allocator's free blocks, those of such pools too, back to the card."""

    _recorded = weakref.WeakSet()  # the graphs recorded and not yet freed

    def __init__(self):
        self._stream = None
        self.held = None  # the one graph kept for replay (`GraphedStep` sets it)

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
        """(graph, fn's result): fn() recorded into a new graph in a new
        pool, not run. Unlike `torch.cuda.graph`, no synchronise or
        garbage collection before the capture."""
        graph = torch.cuda.CUDAGraph()
        side = self._side()
        with torch.cuda.stream(side):
            graph.capture_begin(pool=torch.cuda.graph_pool_handle())
            try:
                out = fn()
            finally:
                graph.capture_end()
        torch.cuda.current_stream().wait_stream(side)
        self._recorded.add(graph)
        return graph, out

    @staticmethod
    def replay(graph):
        graph.replay()

    def free(self, graph):
        """Destroy the graph (a launch of it in flight still completes)."""
        self._recorded.discard(graph)
        graph.reset()

    @staticmethod
    def release():
        torch.cuda.empty_cache()

    @staticmethod
    def reserved() -> int:
        return torch.cuda.memory_reserved()

    def live(self) -> int:
        return len(self._recorded)


SHARED = CudaGraphs()  # the backend the graphed steps share


class GraphedStep:
    """A train step with the JAX step's signature, replayed as a graph where
    the call allows one and the backend takes its tensors.

    `eager(*args)` is the step itself. `split(*args)` names what a replay
    reads: (state, camera, step), the state a tuple of tensors and nested
    tuples of them, or None where the graph cannot take the call.
    `body(*state, camera, lr_tree, in_place)` is the same step with its
    learning rates given, returning (params, stats, opt_state, metrics,
    image); with `in_place` it writes the new params, stats and opt_state
    into those of the state. `lr_tree(step)` the learning rates at `step`,
    whose leaf `rate` (Stage I's xyz, Stage III's endpoints) is a 0-d
    float32 tensor. `backend` defaults to `SHARED`: the graph this step
    replays is the one the backend holds, and once another step captured,
    this one captures again on its next call.
    """

    def __init__(self, eager, body, lr_tree, split, rate, backend=None):
        self.eager = eager
        self.body = body
        self.lr_tree = lr_tree
        self.split = split
        self.rate = rate
        self.backend = SHARED if backend is None else backend
        self._key = None
        self._graph = None
        self._out = None  # the graph's (metrics, image)
        self._state = None  # the state it reads
        self._carried = None  # (params, stats, opt_state): buffers of _state
        self._camera = None
        self._lr = None  # the scheduled learning rate, 0-d float32
        self._launches = {}  # the compositor launches one replay makes

    def __call__(self, *args, **kwargs):
        call = self.split(*args, **kwargs)
        if call is None:
            return self.eager(*args, **kwargs)
        state, camera, step = call
        first = _leaves(state)[0]
        if camera.world_view.ndim != 2 or not self.backend.supports(first):
            return self.eager(*args, **kwargs)
        rates = self.lr_tree(step)
        key = (_signature(state), _signature(camera))
        if key != self._key or self.backend.held is not self._graph:
            with telemetry.span(telemetry.TRAIN_CAPTURE):
                return self._capture(key, state, camera, rates, first.device)
        for dst, src in zip(_leaves(self._state), _leaves(state)):
            if dst.data_ptr() != src.data_ptr():
                dst.copy_(src)
        self._load(camera, getattr(rates, self.rate))
        self.backend.replay(self._graph)
        for name, n in self._launches.items():
            launches[name] += n
        return (*self._carried, *self._out)

    def _load(self, camera, lr):
        for dst, src in zip(_leaves(self._camera), _leaves(camera)):
            if dst is not None:
                dst.copy_(src)
        if lr.device == self._lr.device:
            self._lr.copy_(lr)
        else:  # the host's float32 rate, passed with the fill
            self._lr.fill_(lr.item())

    def _capture(self, key, state, camera, rates, device):
        backend = self.backend
        self._key = self._graph = self._out = self._carried = None
        if backend.held is not None:
            backend.free(backend.held)  # the graph it replaces, whichever step's
            backend.held = None
        self._state = _map(torch.clone, state)
        self._camera = _map(torch.clone, camera)
        self._lr = torch.empty((), dtype=torch.float32, device=device)
        self._load(camera, getattr(rates, self.rate))
        rates = rates._replace(**{self.rate: self._lr})

        def step():  # the new state in the buffers
            return self.body(*self._state, self._camera, rates, in_place=True)

        result = backend.warm_up(step)  # this step's
        self._carried = result[:3]
        before = dict(launches)
        backend.release()  # a capture cannot free cached memory itself
        self._graph, self._out = backend.capture(lambda: step()[3:])
        backend.held = self._graph
        # the capture ran nothing: its launches are counted at each replay
        self._launches = {k: launches[k] - before[k] for k in launches}
        launches.update(before)
        self._key = key
        reserved, live = backend.reserved(), backend.live()
        telemetry.CAPTURES.append((reserved, live))
        print(f"[graphed] capture {len(telemetry.CAPTURES)}: {reserved} bytes reserved, "
              f"{live} live graph(s)", file=sys.stderr)
        return result
