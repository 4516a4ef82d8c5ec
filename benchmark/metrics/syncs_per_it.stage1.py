"""syncs_per_it.stage1: spans.syncs_per_it, in the cells that report `stage1_it_s`."""

from benchmark.spans import syncs_per_it as read  # noqa: F401
