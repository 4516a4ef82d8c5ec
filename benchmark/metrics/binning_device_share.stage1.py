"""binning_device_share.stage1: spans.binning_device_share, in the cells that report `stage1_it_s`."""

from benchmark.spans import binning_device_share as read  # noqa: F401
