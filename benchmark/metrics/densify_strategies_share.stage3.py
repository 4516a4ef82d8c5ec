"""densify_strategies_share.stage3: spans.densify_strategies_share, in the cells that report `stage3_it_s` and densify in the window."""

from benchmark.spans import densify_strategies_share as read  # noqa: F401
