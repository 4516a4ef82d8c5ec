"""idle_outside_step.stage1: spans.idle_outside_step, in the cells that report `stage1_it_s`."""

from benchmark.spans import idle_outside_step as read  # noqa: F401
