"""`queue_wait_ms.label`: The mean wait of the oldest request of a flush when the flush fires, over
the traced window: the rise of the `batch_queue_ms` histogram's sum over
the rise of its count."""

from chipbench import readers

LAYER = "service and batcher (runtime.service, runtime.batcher)"
UNIT = "ms"
MOVES = "classify_p95_ms"


def read(record: dict):
    return readers.ratio(record, "queue_ms_sum", "queue_ms_count")
