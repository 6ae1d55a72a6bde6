"""`device_idle.backlog`: 1 - the union of the device operations' intervals over the traced window."""

from chipbench import readers

LAYER = "device (H100)"
UNIT = "%"
MOVES = "images_per_s"


def read(record: dict):
    return readers.idle_percent(record)
