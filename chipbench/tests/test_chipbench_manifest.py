"""``BENCHMARK.json`` against the benchmark's contract, and the files it
names: every name and unit in the allowed characters, every per-layer
metric reported only where the end-to-end metric it moves is, and the
configurations, traffic, limits and readers found by name."""

from __future__ import annotations

import json
import re

import pytest

from chipbench import correct, load, manifest
from chipbench.reference import models

BENCH = manifest.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
E2E = {m["name"] for m in BENCH["end_to_end"]}
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["chipbench"]
    assert BENCH["command"][1].startswith("chipbench/")
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_every_name_and_unit_uses_only_the_allowed_characters():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [c["name"] for c in BENCH["configs"]] + CELLS
    names += [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert all(UNIT.match(m["unit"]) for m in BENCH["end_to_end"] + BENCH["per_layer"])
    lines = [c["why"] for c in BENCH["configs"]] + [w["why"] for w in BENCH["workloads"]]
    lines += [c["source"] for c in BENCH["configs"]] + [m["layer"] for m in BENCH["per_layer"]]
    lines += BENCH["command"]
    assert all(LINE.match(s) for s in lines), [s for s in lines if not LINE.match(s)]
    for kind in ("end_to_end", "per_layer", "configs", "workloads"):
        assert len({x["name"] for x in BENCH[kind]}) == len(BENCH[kind])


def test_entries_have_just_the_contract_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert "setup_s" in E2E


def test_every_per_layer_metric_is_reported_where_the_metric_it_moves_is():
    for m in BENCH["per_layer"]:
        assert m["moves"] in E2E
        for cell in m["workloads"]:
            reported = {e["name"] for e in manifest.metrics_for(cell, BENCH, "end_to_end")}
            assert m["moves"] in reported, (m["name"], cell)


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for cell in CELLS:
        e2e = {m["name"] for m in manifest.metrics_for(cell, BENCH, "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert manifest.metrics_for(cell, BENCH, "per_layer")


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_each_metric_has_a_reader_that_declares_its_layer_unit_and_arrow(metric):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    reader = manifest.reader(metric)
    assert (reader.LAYER, reader.UNIT, reader.MOVES) == (entry["layer"], entry["unit"],
                                                        entry["moves"])
    assert callable(reader.read)


def test_metrics_of_one_layer_name_it_letter_for_letter():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert len(layers) == 4


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_configuration_traffic_and_limits_by_name(cell):
    w = manifest.cell(cell, BENCH)
    config = manifest.config(w["config"])
    entry = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert entry["file"] == f"chipbench/configs/{w['config']}.json"
    assert config["name"] == entry["name"] and config["source"] == entry["source"]
    assert config["reduced"] == entry["reduced"] == []
    traffic = manifest.traffic(w["traffic"])
    assert max(traffic["images"]["long_side"]) <= 1024       # every image on a decode lane
    buckets = [int(b) for b in config["settings"]["TPU_BATCH_BUCKETS"].split(",")]
    assert traffic["warm_buckets"] and set(traffic["warm_buckets"]) <= set(buckets)
    limits = manifest.limits(cell)
    assert limits and set(limits) <= set(correct.COMPARED)
    assert all(0 < v < 100 for v in limits.values())


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_entry_loop_architecture_and_metrics_as_files(cell):
    # a cell names everything it runs by data: the entry and the loop in its
    # traffic file, the reference in its configuration, a reader for each
    # metric; adding a cell of another kind adds these files and edits none
    w = manifest.cell(cell, BENCH)
    config, traffic = manifest.config(w["config"]), manifest.traffic(w["traffic"])
    session = manifest.entry(traffic["entry"]).Session
    for method in ("start", "drive", "counters", "probe", "status", "stop", "describe", "close",
                   "check"):
        assert callable(getattr(session, method)), method
    assert callable(load.loop(traffic["loop"]).run)
    arch = models.architecture(config)
    assert callable(arch.param_spec) and callable(arch.features) and arch.macs(config) > 0
    for kind in ("end_to_end", "per_layer"):
        for m in manifest.metrics_for(cell, BENCH, kind):
            reader = manifest.reader(m["name"])
            assert reader.UNIT == m["unit"] and callable(reader.read), m["name"]
