"""graph_replay_share.stage3: the share of the window's Stage-III steps that
replayed a recorded CUDA graph, 100 x (1 - captures / steps), from the
program's ring: a `train/capture` span (a warm-up and a capture) inside a
`train/step` span marks a step that recorded its graph. None where the
program has no such span, or recorded none in the run (its steps ran
eagerly), or no step overlaps the window."""

from benchmark.spans import _rows, window

CAPTURE = "train/capture"


def read(ctx):
    w = window(ctx)
    if w is None or CAPTURE not in w.spans.names:
        return None
    if not (w.spans.code == w.spans.names.index(CAPTURE)).any():
        return None
    steps = len(_rows(w, "train/step"))
    if steps == 0:
        return None
    return 100.0 * (1.0 - len(_rows(w, CAPTURE)) / steps)
