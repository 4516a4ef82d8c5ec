"""merge_search_share.stage3: spans.merge_search_share, in the cells that report `stage3_it_s`."""

from benchmark.spans import merge_search_share as read  # noqa: F401
