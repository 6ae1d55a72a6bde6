"""`pipelined_share.backlog`: the share of flushes dispatched while an earlier
flush of their lane was still unresolved (the batchers' two-deep pipeline
overlapping two flushes): the program's counter `pipelined_flushes` (the
batchers' `pipelined` count) over the count of its `dispatch_ms` histogram
(one a flush's stage-and-dispatch), in %, as the program holds them when the
run ends (its served load; the set-up's warm-up counts none). None where the
program has no such counter."""

LAYER = "service and batcher (runtime.service, runtime.batcher)"
UNIT = "%"
MOVES = "images_per_s"


def read(record: dict):
    from ics_tpu_torch.utils.metrics import registry

    get = getattr(registry, "get", None)    # a program without it has none of these names
    pipelined, hist = (get(n) if get else None for n in ("pipelined_flushes", "dispatch_ms"))
    if pipelined is None or hist is None or not hist.count:
        return None
    return 100.0 * pipelined.value / hist.count
