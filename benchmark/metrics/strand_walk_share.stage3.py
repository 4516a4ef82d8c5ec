"""strand_walk_share.stage3: spans.strand_walk_share, in the cells that report `stage3_it_s`."""

from benchmark.spans import strand_walk_share as read  # noqa: F401
