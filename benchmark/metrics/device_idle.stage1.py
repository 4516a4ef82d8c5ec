"""device_idle.stage1: readers.device_idle, in the cells that report `stage1_it_s`."""

from benchmark.readers import device_idle as read  # noqa: F401
