"""`entropy_decode_ms.backlog`: The mean host entropy decode of a request: the
span `entropy_decode` on the executor thread, around
`imgcodec.jpeg_coefficients`. The sum of the program's `entropy_decode_ms`
histogram over its count, as the program holds them when the run ends (its
served load: the pre-roll, the window and the drain; the set-up's warm-up
records none). None where the program has no such histogram."""

LAYER = "service and batcher (runtime.service, runtime.batcher)"
UNIT = "ms"
MOVES = "images_per_s"


def read(record: dict):
    from ics_tpu_torch.utils.metrics import registry

    get = getattr(registry, "get", None)    # a program without it has none of these names
    hist = get("entropy_decode_ms") if get else None
    return hist.sum / hist.count if hist is not None and hist.count else None
