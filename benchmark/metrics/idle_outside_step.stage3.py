"""idle_outside_step.stage3: spans.idle_outside_step, in the cells that report `stage3_it_s`."""

from benchmark.spans import idle_outside_step as read  # noqa: F401
