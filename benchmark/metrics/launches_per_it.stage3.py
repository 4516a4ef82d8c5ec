"""launches_per_it.stage3: readers.launches_per_it, in the cells that report `stage3_it_s`."""

from benchmark.readers import launches_per_it as read  # noqa: F401
