"""`flash_roofline`: Kernel 1 (`flash_wgmma*`, one launch a block) at [bucket, heads, tokens,
head_dim]: the sum of the launches' bounds over the sum of their device
times, over the flushes whose launches all ran in the traced window."""

from chipbench import readers

LAYER = "kernels (ops, ops/csrc)"
UNIT = "%"
MOVES = "images_per_s"


def read(record: dict):
    n, work = readers.flash_work(record["config"])
    return readers.roofline_percent(record, "flash_wgmma", n, work)
