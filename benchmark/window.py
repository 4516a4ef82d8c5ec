"""The measured window inside `training()`: a logger (the program's
`logging_utils.Logger` interface, passed as `training(..., logger=)`) that
stamps every iteration, keeps what the correctness check reads of the
first steps, opens the window after the warm-up iterations and closes it
after the run's seconds by leaving `training()` with `WindowClosed`.

It synchronises the device only where the window opens and closes. In a
traced run the window is followed by a profiled stretch that runs until a
few iterations past the first topology event (densify, merge)."""

import time
from typing import NamedTuple, Optional

import torch

from hairgs_tpu_torch.logging_utils import Logger

FOLLOWED_STEPS = 3  # the steps the reference follows
PROFILE_AFTER_EVENT = 5  # iterations profiled past the first topology event


class Row(NamedTuple):
    """One iteration as the logger saw it."""
    it: int  # iterations since the first the run took
    t: float  # host seconds when the program handed it to the logger
    topology_ms: Optional[float]  # a topology event's time, where one ran
    splats: int  # Gaussians, or a strand graph's segments, after it
    synced: bool  # the program waited for the device in it (its log cadence)


class WindowClosed(Exception):
    """Raised from the logger to leave `training()` when the run is over."""


def live_rows(model) -> dict:
    """The rows of each parameter leaf that hold the model (its arenas are
    padded): a strand graph's endpoints and segments, or the Gaussians."""
    if hasattr(model, "num_segments"):
        return {k: model.num_endpoints if k == "endpoints" else model.num_segments
                for k in model.params._fields}
    return {k: model.count for k in model.params._fields}


def splats(model) -> int:
    return model.num_segments if hasattr(model, "num_segments") else model.count


def _clone(tree, rows):
    return {k: v[:rows[k]].detach().clone() for k, v in tree._asdict().items()}


class WindowLogger(Logger):
    def __init__(self, rt, seconds: float, warmup: int, log_interval: int,
                 trace: bool, sync, profile_max: int = 250):  # iterations
        self.rt = rt
        self.seconds = seconds
        self.warmup = warmup
        self.log_interval = log_interval
        self.trace = trace
        self.sync = sync
        self.profile_max = profile_max
        self.model = None
        self.start_iter = None
        self.first = {"losses": [], "max_radii": []}  # what the check reads
        self.rows = []  # Row of each iteration in the window
        self.t_open = self.t_close = None
        self.it_open = self.it_close = None
        self.prof = None
        self.prof_rows = []
        self.t_prof = None
        self.event_at = None
        # the first steps sync every iteration, so their losses are read
        rt.log_interval = 1

    def _first_steps(self, it, info, model):
        st = self.first
        if it == 0:
            st["rows"] = live_rows(model)
            st["p0"] = _clone(model.params, st["rows"])
            return
        n = splats(model)
        st["losses"].append(info.loss)
        st["max_radii"].append(model.stats.max_radii2d[:n].detach().clone())
        if it == 1:
            st["mu1"] = _clone(model.opt_state.mu, st["rows"])
            st["grad_accum"] = model.stats.xyz_grad_accum[:n, 0].detach().clone()
        if it == FOLLOWED_STEPS:
            st["p3"] = _clone(model.params, st["rows"])
            self.rt.log_interval = self.log_interval

    def log(self, info, model=None):
        now = time.perf_counter()
        if self.start_iter is None:  # the iteration a resumed model starts at
            self.start_iter = info.iter
        it = info.iter - self.start_iter
        self.model = model
        row = Row(it, now, info.topology_ms, splats(model),
                  info.iter % self.log_interval == 0)
        if it <= FOLLOWED_STEPS:
            self._first_steps(it, info, model)
        if it == self.warmup:
            self.sync()
            self.t_open, self.it_open = time.perf_counter(), it
        elif self.t_close is None and self.t_open is not None:
            self.rows.append(row)
            if now - self.t_open >= self.seconds:
                self.sync()
                self.t_close, self.it_close = time.perf_counter(), it
                if not self.trace:
                    raise WindowClosed
                acts = [torch.profiler.ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                self.prof = torch.profiler.profile(activities=acts)
                self.prof.start()
                self.t_prof = time.perf_counter()
        elif self.prof is not None:
            self.prof_rows.append(row)
            if info.topology_ms is not None and self.event_at is None:
                self.event_at = it
            n = len(self.prof_rows)
            if ((self.event_at is not None and it >= self.event_at + PROFILE_AFTER_EVENT)
                    or n >= self.profile_max):
                self.sync()
                self.t_prof_end = time.perf_counter()
                self.prof.stop()
                raise WindowClosed

    @property
    def it_s(self) -> float:
        return (self.it_close - self.it_open) / (self.t_close - self.t_open)


def tail_s_per_it(logger, n: int) -> float:
    """Wall seconds per iteration over the window's last stretch of at least
    `n` iterations: from the latest row, `n` or more before the close, at
    which the program synchronised (so its stamp is the device's), to the
    synchronised close. That is the unprofiled stretch next to the profiled
    one, from nearly the same model state."""
    for r in reversed(logger.rows):
        if r.synced and logger.it_close - r.it >= n:
            return (logger.t_close - r.t) / (logger.it_close - r.it)
    return (logger.t_close - logger.t_open) / (logger.it_close - logger.it_open)
