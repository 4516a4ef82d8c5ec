"""host_step_share.stage1: spans.host_step_share, in the cells that report `stage1_it_s`."""

from benchmark.spans import host_step_share as read  # noqa: F401
