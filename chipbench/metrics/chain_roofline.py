"""`chain_roofline`: Kernel 3 (`bottleneck_wgmma*`, one launch a chained bottleneck): the sum of
the launches' bounds at their flush's padded bucket over the sum of their
device times, over the flushes whose launches all ran in the traced window."""

from chipbench import readers

LAYER = "kernels (ops, ops/csrc)"
UNIT = "%"
MOVES = "images_per_s"


def read(record: dict):
    n, work = readers.chain_work(record["config"])
    return readers.roofline_percent(record, "bottleneck_wgmma", n, work)
