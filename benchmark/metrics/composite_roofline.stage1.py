"""composite_roofline.stage1: readers.composite_roofline, in the cells that report `stage1_it_s`."""

from benchmark.readers import composite_roofline as read  # noqa: F401
