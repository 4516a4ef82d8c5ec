"""topology_transfer_share.stage3: spans.topology_transfer_share, in the cells that report `stage3_it_s`."""

from benchmark.spans import topology_transfer_share as read  # noqa: F401
