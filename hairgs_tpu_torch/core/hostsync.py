"""Device->host pulls of the live rows of capacity-padded arenas
(counterpart of hairgs_tpu/core/hostsync.py).

The arenas are padded to a capacity bucket; a topology event needs only
their first `n` rows. `sliced_cut` copies those rows on the device (a new
tensor, so a later step that rebinds or updates the arena cannot change the
snapshot) and `finish_pull` moves them to the host with one copy per
plane. The split lets a worker thread do the transfer half while the
caller keeps training; `sliced_pull` does both.
"""

import torch


def sliced_cut(sources) -> dict:
    """Device half of a pull: {key: (tensor, n_rows)} -> {key: (copy of the
    first n_rows, n_rows)}, queued on the caller's current stream."""
    return {k: (t[:n].detach().clone(), n) for k, (t, n) in sources.items()}


def finish_pull(cut, ready=None) -> dict:
    """Transfer half of a pull. The arrays share no memory with an arena
    (the cut is a copy), so the host mirrors may mutate them in place.

    Without `ready`: one `.cpu()` per plane, ordered on the current stream.
    With `ready` (a CUDA event recorded after the cut, on the stream that
    queued it): the copies wait for that event only, on a side stream, into
    pinned host memory, so a worker thread's pull overlaps the train steps
    queued after the cut instead of waiting behind them. `cut` holds the
    device copies until the side stream has finished with them, so the
    caching allocator cannot hand their memory to a step meanwhile."""
    if ready is None:
        return {k: t.cpu().numpy() for k, (t, _) in cut.items()}
    device = next(iter(cut.values()))[0].device
    stream = torch.cuda.Stream(device=device)
    host = {}
    with torch.cuda.stream(stream):
        stream.wait_event(ready)
        for k, (t, _) in cut.items():
            host[k] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host[k].copy_(t, non_blocking=True)
    stream.synchronize()
    return {k: h.numpy() for k, h in host.items()}


def sliced_pull(sources) -> dict:
    """sources: {key: (tensor, n_rows)} -> {key: np.ndarray[:n_rows]}."""
    return finish_pull(sliced_cut(sources))
