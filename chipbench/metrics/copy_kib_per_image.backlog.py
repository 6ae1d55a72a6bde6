"""`copy_kib_per_image.backlog`: KiB copied host to device an image: the
program's counter `copy_bytes` (the padded arrays each flush hands to the
copy) over its counter `dispatched_images` (the flushes' real images), over
1024, as the program holds them when the run ends (its served load; the
set-up's warm-up counts none). None where the program has no such counter."""

LAYER = "engine and model step (runtime.engine, runtime.device_decode, models)"
UNIT = "KiB"
MOVES = "images_per_s"


def read(record: dict):
    from ics_tpu_torch.utils.metrics import registry

    get = getattr(registry, "get", None)    # a program without it has none of these names
    copied, images = (get(n) if get else None for n in ("copy_bytes", "dispatched_images"))
    if copied is None or images is None or not images.value:
        return None
    return copied.value / images.value / 1024
