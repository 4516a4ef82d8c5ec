"""step_mfu.stage1: readers.step_mfu, in the cells that report `stage1_it_s`."""

from benchmark.readers import step_mfu as read  # noqa: F401
