"""`event_ms_per_image.backlog`: stream time inside a step, a resolved image,
by CUDA events: the sum of the program's `step_device_ms` histogram over its
counter `resolved_images` (the steps' real images). Each step runs from an
event before its copy to one after its top-k, and is credited only the part
that no step timed before it covered: both lanes enqueue on one stream, so
the sum is the union of the steps' intervals, each moment once. Read as the
program holds them when the run ends (its served load; warm-ups and each
shape's first step count none). None where the program has no such
histogram."""

LAYER = "engine and model step (runtime.engine, runtime.device_decode, models)"
UNIT = "ms"
MOVES = "images_per_s"


def read(record: dict):
    from ics_tpu_torch.utils.metrics import registry

    get = getattr(registry, "get", None)    # a program without it has none of these names
    hist, images = (get(n) if get else None for n in ("step_device_ms", "resolved_images"))
    if hist is None or images is None or not images.value:
        return None
    return hist.sum / images.value
