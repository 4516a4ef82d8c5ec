"""topology_share.stage1: readers.topology_share, in the cells that report `stage1_it_s`."""

from benchmark.readers import topology_share as read  # noqa: F401
