"""`flush_host_ms.backlog`: The mean host time of a flush's stage-and-dispatch
on its worker: the span `dispatch` (staging, padding, the pageable copy and
the step's enqueue). The sum of the program's `dispatch_ms` histogram over
its count, as the program holds them when the run ends (its served load: the
pre-roll, the window and the drain; the set-up's warm-up records none). None
where the program has no such histogram."""

LAYER = "engine and model step (runtime.engine, runtime.device_decode, models)"
UNIT = "ms"
MOVES = "images_per_s"


def read(record: dict):
    from ics_tpu_torch.utils.metrics import registry

    get = getattr(registry, "get", None)    # a program without it has none of these names
    hist = get("dispatch_ms") if get else None
    return hist.sum / hist.count if hist is not None and hist.count else None
