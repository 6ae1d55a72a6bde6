"""`classify_p95_ms`: the 95th percentile over every request due in the
window, each timed from the moment it was due to its answer; a request
that failed or never came counts as +inf (printed as 1e12)."""

from chipbench import load

UNIT = "ms"


def read(record: dict):
    return load.percentile(load.latencies_ms(record["window"]), 95)
