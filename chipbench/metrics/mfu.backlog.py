"""`mfu.backlog`: The whole step's share of the card's peak: model FLOPs (forward, real
images, `chipbench.roofline.model_flops`) of the answers that came in the
traced window, over its seconds, over the bf16 dense peak of one H100 SXM,
989 TFLOP/s at 700 W; the run prints the card's power limit beside it."""

from chipbench import readers

LAYER = "engine and model step (runtime.engine, runtime.device_decode, models)"
UNIT = "%"
MOVES = "images_per_s"


def read(record: dict):
    return readers.mfu_percent(record)
