"""`device_idle.label`: 1 - the union of the device operations' intervals over the traced window."""

from chipbench import readers

LAYER = "device (H100)"
UNIT = "%"
MOVES = "classify_p95_ms"


def read(record: dict):
    return readers.idle_percent(record)
