"""`dispatch_wait_ms.backlog`: The mean wait of a flush's stage-and-dispatch
for an executor thread, from its hand-off on the event loop until a worker
starts it. The sum of the program's `dispatch_wait_ms` histogram over its
count, as the program holds them when the run ends (its served load: the
pre-roll, the window and the drain; the set-up's warm-up records none). None
where the program has no such histogram."""

LAYER = "service and batcher (runtime.service, runtime.batcher)"
UNIT = "ms"
MOVES = "images_per_s"


def read(record: dict):
    from ics_tpu_torch.utils.metrics import registry

    get = getattr(registry, "get", None)    # a program without it has none of these names
    hist = get("dispatch_wait_ms") if get else None
    return hist.sum / hist.count if hist is not None and hist.count else None
