"""The readers of the program's spans and counters: the right ratio from a
hand-made registry, None from a program that has none of them (the parent
commit's), the classify entry's counters unchanged, and a traced CPU run
that reports the new metrics of the label cell."""

from __future__ import annotations

import math
from types import SimpleNamespace

import pytest

from chipbench import manifest, run
from chipbench.entries import classify

NEW = {
    # metric: (the registry's histograms' sums and counts, its counters, the reading)
    "entropy_decode_ms.label": ({"entropy_decode_ms": (30.0, 4)}, {}, 7.5),
    "entropy_decode_ms.backlog": ({"entropy_decode_ms": (30.0, 4)}, {}, 7.5),
    "dispatch_wait_ms.label": ({"dispatch_wait_ms": (9.0, 3)}, {}, 3.0),
    "dispatch_wait_ms.backlog": ({"dispatch_wait_ms": (9.0, 3)}, {}, 3.0),
    "flush_host_ms.backlog": ({"dispatch_ms": (50.0, 2)}, {}, 25.0),
    "copy_kib_per_image.backlog": ({}, {"copy_bytes": 8 * 1024 * 100.0,
                                        "dispatched_images": 100.0}, 8.0),
    "event_ms_per_image.backlog": ({"step_device_ms": (60.0, 2)},
                                   {"resolved_images": 40.0}, 1.5),
}


def _registry(monkeypatch, hists: dict, counters: dict) -> None:
    from ics_tpu_torch.utils import metrics

    fresh = metrics.Registry()
    for name, (total, count) in hists.items():
        h = fresh.histogram(name)
        h._sum, h._total = total, count
    for name, value in counters.items():
        fresh.counter(name).inc(value)
    monkeypatch.setattr(metrics, "registry", fresh)


@pytest.mark.parametrize("metric", sorted(NEW))
def test_each_new_reader_reads_its_ratio(monkeypatch, metric):
    hists, counters, want = NEW[metric]
    _registry(monkeypatch, hists, counters)
    assert manifest.reader(metric).read({}) == pytest.approx(want)


@pytest.mark.parametrize("metric", sorted(NEW))
def test_each_new_reader_gives_none_where_the_program_has_no_such_names(monkeypatch, metric):
    # the parent commit's program: the registry holds only the batchers' names
    _registry(monkeypatch, {"batch_queue_ms": (12.0, 3), "batch_occupancy": (9.0, 3)}, {})
    assert manifest.reader(metric).read({}) is None
    # a program whose registry has no `get` (the parent's) has none of them
    from ics_tpu_torch.utils import metrics

    monkeypatch.setattr(metrics, "registry", SimpleNamespace(_metrics={}))
    assert manifest.reader(metric).read({}) is None
    # and a name that exists but counted nothing
    hists, counters, _ = NEW[metric]
    _registry(monkeypatch, {n: (0.0, 0) for n in hists}, {n: 0.0 for n in counters})
    assert manifest.reader(metric).read({}) is None


def test_the_new_metrics_are_in_the_manifest_where_their_readers_find_something():
    per_layer = {m["name"]: m for m in manifest.benchmark()["per_layer"]}
    for metric in NEW:
        cells = per_layer[metric]["workloads"]
        assert cells == (["resnet50.label-open"] if metric.endswith(".label")
                         else ["vit_l16.backlog", "resnet50.backlog"])


def test_the_classify_entry_counters_keep_their_four_keys(monkeypatch):
    _registry(monkeypatch, {"batch_queue_ms": (12.0, 3), "dispatch_ms": (5.0, 1)},
              {"copy_bytes": 10.0})
    stats = lambda q, f: SimpleNamespace(stats={"queued": q, "flushes": f})  # noqa: E731
    service = SimpleNamespace(batcher=stats(2, 1), coeff_batchers={("420", 64): stats(7, 2)})
    got = classify.Session.counters(SimpleNamespace(service=service))
    assert got == {"queued": 9, "flushes": 3, "queue_ms_sum": 12.0, "queue_ms_count": 3}


def test_a_traced_cpu_run_reports_the_new_label_metrics():
    from chipbench.tests import test_chipbench_run as cpu_run

    bench = cpu_run._bench()
    bench["per_layer"] += [{"name": n, "unit": "ms", "moves": "classify_p95_ms",
                            "workloads": [cpu_run.CELL["name"]]}
                           for n in ("entropy_decode_ms.label", "dispatch_wait_ms.label")]
    result = run.run_cell(cpu_run.CELL, cpu_run._config(), cpu_run._traffic("closed"),
                          cpu_run.LIMITS, bench, 2**31 + 91, 2.0, True, device="cpu")
    assert result["correct"], result["checks"]
    for name in ("entropy_decode_ms.label", "dispatch_wait_ms.label"):
        value = result["metrics"][name]["value"]
        assert math.isfinite(value) and value >= 0, (name, value)
    assert result["metrics"]["entropy_decode_ms.label"]["value"] > 0
