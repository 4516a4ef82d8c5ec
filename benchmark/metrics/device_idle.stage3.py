"""device_idle.stage3: readers.device_idle, in the cells that report `stage3_it_s`."""

from benchmark.readers import device_idle as read  # noqa: F401
