"""loss_device_share.stage1: spans.loss_device_share, in the cells that report `stage1_it_s`."""

from benchmark.spans import loss_device_share as read  # noqa: F401
