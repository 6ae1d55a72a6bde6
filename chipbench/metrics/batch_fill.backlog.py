"""`batch_fill.backlog`: Images a flush in the traced window: the rise of `queued` over the rise of
`flushes`, summed over the pixel batcher and every decode lane."""

from chipbench import readers

LAYER = "service and batcher (runtime.service, runtime.batcher)"
UNIT = "images"
MOVES = "images_per_s"


def read(record: dict):
    return readers.ratio(record, "queued", "flushes")
