"""The readers of the staging counters, `pinned_share.backlog` and
`pipelined_share.backlog`: the right share from a hand-made registry, None
from a program that has no such counter (the parent commit's), and a traced
CPU run of the backlog loop that reports both (no slot is page-locked on the
CPU, so the first reads 0)."""

from __future__ import annotations

import math
from types import SimpleNamespace

import pytest

from chipbench import manifest, run

NEW = {
    # metric: (its counter, the reading of 30 such flushes of 40)
    "pinned_share.backlog": ("pinned_flushes", 75.0),
    "pipelined_share.backlog": ("pipelined_flushes", 75.0),
}


def _registry(monkeypatch, counters: dict, dispatches) -> None:
    from ics_tpu_torch.utils import metrics

    fresh = metrics.Registry()
    if dispatches is not None:
        h = fresh.histogram("dispatch_ms")
        h._sum, h._total = 9.0 * dispatches, dispatches
    for name, value in counters.items():
        fresh.counter(name).inc(value)
    monkeypatch.setattr(metrics, "registry", fresh)


@pytest.mark.parametrize("metric", sorted(NEW))
def test_each_reader_reads_its_share_of_the_flushes(monkeypatch, metric):
    counter, want = NEW[metric]
    _registry(monkeypatch, {counter: 30.0}, 40)
    assert manifest.reader(metric).read({}) == pytest.approx(want)
    _registry(monkeypatch, {counter: 0.0}, 40)      # the counter made, nothing counted
    assert manifest.reader(metric).read({}) == 0.0


@pytest.mark.parametrize("metric", sorted(NEW))
def test_each_reader_gives_none_where_the_program_has_no_such_counter(monkeypatch, metric):
    counter, _ = NEW[metric]
    # a program with the tracing names but not these two counters
    _registry(monkeypatch, {"copy_bytes": 10.0, "dispatched_images": 2.0}, 40)
    assert manifest.reader(metric).read({}) is None
    from ics_tpu_torch.utils import metrics

    monkeypatch.setattr(metrics, "registry", SimpleNamespace(_metrics={}))
    assert manifest.reader(metric).read({}) is None
    # a counter but no flush dispatched
    _registry(monkeypatch, {counter: 0.0}, None)
    assert manifest.reader(metric).read({}) is None
    _registry(monkeypatch, {counter: 0.0}, 0)
    assert manifest.reader(metric).read({}) is None


def test_both_are_in_the_manifest_for_the_backlog_cells():
    per_layer = {m["name"]: m for m in manifest.benchmark()["per_layer"]}
    for metric in NEW:
        assert per_layer[metric]["workloads"] == ["vit_l16.backlog", "resnet50.backlog"]
        assert per_layer[metric]["moves"] == "images_per_s"


def test_a_traced_cpu_run_of_the_closed_loop_reports_both():
    from chipbench.tests import test_chipbench_run as cpu_run

    bench = cpu_run._bench()
    bench["per_layer"] += [{"name": n, "unit": "%", "moves": "images_per_s",
                            "workloads": [cpu_run.CELL["name"]]} for n in sorted(NEW)]
    result = run.run_cell(cpu_run.CELL, cpu_run._config(), cpu_run._traffic("closed"),
                          cpu_run.LIMITS, bench, 2**31 + 93, 2.0, True, device="cpu")
    assert result["correct"], result["checks"]
    assert result["metrics"]["pinned_share.backlog"]["value"] == 0.0
    value = result["metrics"]["pipelined_share.backlog"]["value"]
    assert math.isfinite(value) and 0.0 <= value <= 100.0
