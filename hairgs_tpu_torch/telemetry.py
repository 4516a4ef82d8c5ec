"""The port's spans: one recorder for every timed phase of the training loop.

    with telemetry.span(telemetry.TRAIN_STEP) as step:
        ...
    step.ms  # its wall time on the host

A span stamps its start and end with `time.perf_counter_ns()` (the clock
of `time.perf_counter()`), with the thread it ran on and the span open
around it on that thread (its parent; a stack per thread). Ended spans go
into `RING`, preallocated columns that keep the newest `CAPACITY` spans
(12 MB: a minute of training and more) and count the ones they
dropped. Nothing is written to a file: readers take `RING.snapshot()`.

While a `torch.profiler` session records, each span is also a range named
"hairgs::<name>" in the profiler's trace, so the trace carries the
program's spans on its own clock, beside the kernels they launched. The
range is a `_RecordFunctionFast` (a host-side function range) and not a
`record_function`: the profiler mirrors a `record_function` user
annotation onto the device's timeline as one more event of the device,
which readers of the trace would count as work of the device, and it costs
about 15 us where the fast range costs 2. With no profiler a span costs
two clock reads and a ring write, and enters no range.

Span names are the constants below (`NAMES`); any other name raises.
"""

import itertools
import struct
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

# drivers/train.py (train/capture: train/graphed.py)
TRAIN_LOOP = "train/loop"  # the iterations of training(), for its closing line
TRAIN_STEP = "train/step"  # one step_fn call: its enqueue and in-step waits
TRAIN_SYNC = "train/sync"  # a wait for the device: the metric pull, a synchronise
TRAIN_CAPTURE = "train/capture"  # a step's warm-up and CUDA-graph capture
TOPO_EVENT = "topo/event"  # a topology event between steps (info.topology_ms)
TOPO_STRAND_TABLES = "topo/strand_tables"  # the smoothness tables' rebuild
# train/trainer.py
RENDER_INPUTS = "render/inputs"  # the model's render inputs
LOSS = "loss"  # the photometric and auxiliary losses
BACKWARD = "backward"  # the backward pass of the render and the losses
STRAND_TERMS = "strand_terms"  # a strand regularizer and its gradient
ADAM = "adam"  # the densification statistics and the Adam update
# render/renderer.py
RENDER_PREPROCESS = "render/preprocess"
RENDER_BINNING = "render/binning"  # the binning through the gathered planes
RENDER_COMPOSITE = "render/composite"
# topo/graph_ops.py, topo/merge.py, topo/async_events.py
TOPO_PULL = "topo/pull"  # a HairHostState's pull of the arenas
TOPO_STRATEGIES = "topo/strategies"
TOPO_INSTALL = "topo/install"
TOPO_WALK = "topo/walk"  # a compute_strands_info walk
TOPO_MERGE_SEARCH = "topo/merge_search"
TOPO_MERGE_APPLY = "topo/merge_apply"
TOPO_ASYNC_PULL = "topo/async_pull"
TOPO_ASYNC_COMPUTE = "topo/async_compute"
TOPO_ASYNC_APPLY = "topo/async_apply"

NAMES = (TRAIN_LOOP, TRAIN_STEP, TRAIN_SYNC, TOPO_EVENT, TOPO_STRAND_TABLES,
         RENDER_INPUTS, LOSS, BACKWARD, STRAND_TERMS, ADAM, RENDER_PREPROCESS,
         RENDER_BINNING, RENDER_COMPOSITE, TOPO_PULL, TOPO_STRATEGIES,
         TOPO_INSTALL, TOPO_WALK, TOPO_MERGE_SEARCH, TOPO_MERGE_APPLY,
         TOPO_ASYNC_PULL, TOPO_ASYNC_COMPUTE, TOPO_ASYNC_APPLY, TRAIN_CAPTURE)
PREFIX = "hairgs::"  # of the profiler ranges
CAPACITY = 1 << 18  # spans the ring keeps

_CODE = {name: code for code, name in enumerate(NAMES)}
_LABEL = tuple(PREFIX + name for name in NAMES)
_ids = itertools.count()  # span ids; next() on a count is atomic
_local = threading.local()
_profiling = torch.autograd._profiler_enabled
_range = torch._C._profiler._RecordFunctionFast
_clock = time.perf_counter_ns


class Spans(NamedTuple):
    """The ring's spans, in the order they ended."""
    code: np.ndarray  # index into `names`
    id: np.ndarray
    parent: np.ndarray  # the enclosing span's id on its thread, -1 for none
    tid: np.ndarray  # the thread's native id
    t0: np.ndarray  # perf_counter ns
    t1: np.ndarray
    names: tuple
    dropped: int  # spans that ended before these and are no longer kept


# one ended span: its place in the order of ends (from 1), then the fields
# of Spans
_RECORD = struct.Struct("<qhqqiqq")
_pack, _SIZE = _RECORD.pack_into, _RECORD.size
_DTYPE = np.dtype([("seq", "<i8"), ("code", "<i2"), ("id", "<i8"), ("parent", "<i8"),
                   ("tid", "<i4"), ("t0", "<i8"), ("t1", "<i8")])


class Ring:
    """A preallocated buffer of ended spans; the newest `capacity` stay.
    A write is one `pack_into`, so writers on several threads need no
    lock: each takes its slot from a counter."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        self._buf = bytearray(_RECORD.size * capacity)
        self._ends = itertools.count(1)

    def write(self, code, span_id, parent, tid, t0, t1):
        seq = next(self._ends)
        _pack(self._buf, (seq - 1) % self.capacity * _SIZE,
              seq, code, span_id, parent, tid, t0, t1)

    def snapshot(self) -> Spans:
        rec = np.frombuffer(bytes(self._buf), _DTYPE)
        rec = rec[rec["seq"] > 0]
        rec = rec[np.argsort(rec["seq"])]
        written = int(rec["seq"][-1]) if len(rec) else 0
        return Spans(rec["code"], rec["id"], rec["parent"], rec["tid"], rec["t0"],
                     rec["t1"], NAMES, written - len(rec))


RING = Ring()


class span:
    """A named phase; `ms` and `seconds` hold its wall time once it ended."""

    __slots__ = ("code", "id", "parent", "t0", "t1", "_stack", "_tid", "_range")

    def __init__(self, name: str):
        self.code = _CODE[name]

    def __enter__(self):
        try:
            stack, self._tid = _local.state
        except AttributeError:  # the thread's first span
            stack, self._tid = _local.state = ([], threading.get_native_id())
        self._stack = stack
        self.parent = stack[-1] if stack else -1
        self.id = next(_ids)
        stack.append(self.id)
        self._range = None
        if _profiling():
            self._range = _range(_LABEL[self.code])
            self._range.__enter__()
        self.t0 = _clock()
        return self

    def __exit__(self, *exc):
        self.t1 = _clock()
        if self._range is not None:
            self._range.__exit__(*exc)
        self._stack.pop()
        RING.write(self.code, self.id, self.parent, self._tid, self.t0, self.t1)
        return False

    @property
    def ms(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) * 1e-9
