"""`pinned_share.backlog`: the share of flushes whose staged arrays crossed to
the card from a page-locked staging slot without blocking: the program's
counter `pinned_flushes` over the count of its `dispatch_ms` histogram (one a
flush's stage-and-dispatch), in %, as the program holds them when the run
ends (its served load: the pre-roll, the window and the drain; the set-up's
warm-up counts none). None where the program has no such counter."""

LAYER = "engine and model step (runtime.engine, runtime.device_decode, models)"
UNIT = "%"
MOVES = "images_per_s"


def read(record: dict):
    from ics_tpu_torch.utils.metrics import registry

    get = getattr(registry, "get", None)    # a program without it has none of these names
    pinned, hist = (get(n) if get else None for n in ("pinned_flushes", "dispatch_ms"))
    if pinned is None or hist is None or not hist.count:
        return None
    return 100.0 * pinned.value / hist.count
