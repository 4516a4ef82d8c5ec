"""Background topology-event worker, opt-in via the train driver's
`--async_topology` (counterpart of hairgs_tpu/topo/async_events.py).

A synchronous densify or merge event stops training while it pulls the
arenas and runs the graph surgery in numpy on one core. This worker moves
everything but the final install off the training loop:

1. `launch` (main thread, milliseconds): copy the live rows on the device
   (`core/hostsync.py::sliced_cut`, new tensors that later steps cannot
   change) and record a CUDA event after the copies.
2. worker thread: pull the snapshot (on the card, from a side stream that
   waits on that event only, into pinned memory, so the pull overlaps the
   steps queued meanwhile), then run the whole strategy, merge and walk
   pipeline on it (`graph_ops.compute_topology_update`).
3. `poll` (main thread, between steps): once the thread has finished,
   install the update. Surviving rows gather their live device values and
   Adam moments (`HairModel.install(carry_param_values=True)`); only the
   topology and the new rows' values come from the snapshot.

Semantics differ from the reference's synchronous events (hence opt-in):
the strategies see statistics and values as of the snapshot's iteration,
the surgery lands the flight's length later, and new rows are made from
the parents' snapshot values. Events that change surviving rows on the
host (opacity reset, growth) stay synchronous in the driver and settle any
flight first.

The strategies run numpy and Python on the worker while the main thread
queues kernels, and both need the interpreter lock: a flight may slow the
steps it overlaps.
"""

import threading
import time

import torch


class TopologyWorker:
    """One topology event in flight at a time, computed on a daemon
    thread."""

    def __init__(self, model):
        self.model = model
        self._thread = None
        self._result = None
        self._error = None

    @property
    def in_flight(self) -> bool:
        return self._thread is not None

    def launch(self, *, densify: bool, merge: bool, extent: float, size_th):
        """Snapshot the model and start computing an event. A previous
        flight is settled (blocking) first: with the reference cadences
        (events every 100 iterations, flights of seconds) a flight still
        out here means a misconfigured schedule."""
        from hairgs_tpu_torch.core.hostsync import sliced_cut

        self.poll(force=True)
        m = self.model
        e, s = m.num_endpoints, m.num_segments
        p = m.params
        cut = sliced_cut({
            "endpoints": (p.endpoints, e),
            "endpoint_pairs": (m.graph.endpoint_pairs, s),
            "features_dc": (p.features_dc, s),
            "features_rest": (p.features_rest, s),
            "opacity": (p.opacity, s),
            "mask": (p.mask, s),
            "width": (p.width, s),
            "stats/max_radii2d": (m.stats.max_radii2d, s),
            "stats/xyz_grad_accum": (m.stats.xyz_grad_accum, s),
            "stats/denom": (m.stats.denom, s),
        })
        ready = None
        if m.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record()
        # the merge thresholds follow a schedule on the live model: freeze
        # them at launch so the flight computes what a synchronous event
        # at this iteration would
        kwargs = dict(densify=densify, merge=merge, extent=extent,
                      max_screen_size=size_th,
                      merge_dist_th=m.merge_dist_th,
                      merge_angle_th=m.merge_angle_th)
        self._thread = threading.Thread(
            target=self._run, args=(cut, ready, kwargs), daemon=True,
            name="topology-worker")
        self._thread.start()

    def _run(self, cut, ready, kwargs):
        from hairgs_tpu_torch.core.hostsync import finish_pull
        from hairgs_tpu_torch.topo.graph_ops import compute_topology_update

        try:
            t0 = time.perf_counter()
            pulled = finish_pull(cut, ready)
            t_pull = time.perf_counter()
            stats = {k[len("stats/"):]: pulled.pop(k)
                     for k in list(pulled) if k.startswith("stats/")}
            upd = compute_topology_update(
                self.model, arrays=pulled, stats=stats, **kwargs)
            upd.info.update(
                t_async_pull=round(t_pull - t0, 3),
                t_async_compute=round(time.perf_counter() - t_pull, 3),
            )
            self._result = upd
        except Exception as e:  # raised again on the main thread by poll()
            self._error = e

    def poll(self, force: bool = False, training_info=None) -> bool:
        """Install the pending update if the flight has finished (with
        `force`, wait for it). Returns True when a topology change was
        installed."""
        if self._thread is None:
            return False
        if not force and self._thread.is_alive():
            return False
        self._thread.join()
        self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async topology event failed") from err
        upd, self._result = self._result, None
        from hairgs_tpu_torch.topo.graph_ops import apply_topology_update

        apply_topology_update(self.model, upd, training_info)
        return True
