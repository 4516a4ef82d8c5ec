"""topology_share.stage3: readers.topology_share, in the cells that report `stage3_it_s`."""

from benchmark.readers import topology_share as read  # noqa: F401
