"""``BENCHMARK.json`` and the files it names, found by name: a cell's
configuration under ``configs/``, its traffic under ``traffic/``, its
correctness limits under ``limits/``, each metric's reader under
``metrics/``, the entry a traffic drives under ``entries/``; and by the
data in those files, the kind of loop under ``loops/`` (``load.loop``) and
each architecture's reference under ``reference/``
(``reference.models.architecture``). Adding a cell or a metric adds
files; nothing here changes."""

from __future__ import annotations

import importlib
import importlib.util
from types import ModuleType
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _load(folder: str, name: str) -> dict:
    return json.loads((HERE / folder / f"{name}.json").read_text())


def cell(name: str, bench: dict | None = None) -> dict:
    bench = bench or benchmark()
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return _load("configs", name)


def traffic(name: str) -> dict:
    return _load("traffic", name)


def limits(cell_name: str) -> dict:
    return _load("limits", cell_name)


def metrics_for(cell_name: str, bench: dict, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports: those that
    list it, and those with no list (a per-layer one: where the end-to-end
    metric it moves is reported)."""
    e2e = [m for m in bench["end_to_end"] if cell_name in m.get("workloads", [cell_name])]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if ((cell_name in m["workloads"]) if "workloads" in m else (m["moves"] in names))]


def entry(name: str) -> ModuleType:
    """The module ``entries/<name>.py``."""
    return importlib.import_module(f"chipbench.entries.{name}")


def reader(metric_name: str) -> ModuleType:
    """The module ``metrics/<name>.py``, end-to-end or per-layer, loaded by
    path (names hold dots)."""
    path = HERE / "metrics" / f"{metric_name}.py"
    spec = importlib.util.spec_from_file_location(
        "chipbench_metric_" + metric_name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
