"""composite_roofline.stage3: readers.composite_roofline, in the cells that report `stage3_it_s`."""

from benchmark.readers import composite_roofline as read  # noqa: F401
