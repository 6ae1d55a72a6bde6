"""`device_ms_per_image.backlog`: Device time an answered image: the union of the device operations'
intervals in the traced window over the answers that came in it."""

from chipbench import readers

LAYER = "engine and model step (runtime.engine, runtime.device_decode, models)"
UNIT = "ms"
MOVES = "images_per_s"


def read(record: dict):
    return readers.device_ms_per_image(record)
