"""step_mfu.stage3: readers.step_mfu, in the cells that report `stage3_it_s`."""

from benchmark.readers import step_mfu as read  # noqa: F401
