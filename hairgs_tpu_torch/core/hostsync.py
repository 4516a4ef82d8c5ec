"""Device->host pulls of the live rows of capacity-padded arenas
(counterpart of hairgs_tpu/core/hostsync.py).

The arenas are padded to a capacity bucket; a topology event needs only
their first `n` rows. `sliced_cut` copies those rows on the device (a new
tensor, so a later step that rebinds or updates the arena cannot change the
snapshot) and `finish_pull` moves them to the host with one `.cpu()` per
plane. The split lets a worker thread do the transfer half while the
caller keeps training; `sliced_pull` does both.
"""


def sliced_cut(sources) -> dict:
    """Device half of a pull: {key: (tensor, n_rows)} -> {key: (copy of the
    first n_rows, n_rows)}."""
    return {k: (t[:n].detach().clone(), n) for k, (t, n) in sources.items()}


def finish_pull(cut) -> dict:
    """Transfer half of a pull: one `.cpu()` per plane. The arrays share no
    memory with an arena (the cut is a copy), so the host mirrors may
    mutate them in place."""
    return {k: t.cpu().numpy() for k, (t, _) in cut.items()}


def sliced_pull(sources) -> dict:
    """sources: {key: (tensor, n_rows)} -> {key: np.ndarray[:n_rows]}."""
    return finish_pull(sliced_cut(sources))
