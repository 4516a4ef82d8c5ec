"""launches_per_it.stage1: readers.launches_per_it, in the cells that report `stage1_it_s`."""

from benchmark.readers import launches_per_it as read  # noqa: F401
