"""`images_per_s`: answers that came inside the window, over its seconds."""

from chipbench import load

UNIT = "images/s"


def read(record: dict):
    return load.completed_per_s(record["window"])
