"""A whole run on the CPU at a tiny size: the program's plain paths under
the harness, past the look for a card. A sound run comes out correct, each
planted fault and the float8 control do not, and a traced run gives the
per-layer metrics and the breakdown."""

from __future__ import annotations

import json

import pytest

from chipbench import faults, manifest, run

CELL = {"name": "tiny.label", "config": "resnet_tiny", "traffic": "tiny", "chips": 1}
LIMITS = {"top1_gap": 0.5, "score_gap": 1.0}


def _config():
    cfg = manifest.config("resnet50")
    cfg.update(name="resnet_tiny", registry_name="resnet_tiny", image_size=64, resize_short=64,
               blocks=[1, 1, 1, 1], chains=[])
    cfg["settings"] = dict(cfg["settings"], TPU_DEFAULT_MODEL="resnet_tiny",
                           TPU_BATCH_BUCKETS="1,8", TPU_FUSED_CHAINS="false")
    return cfg


def _traffic(loop):
    images = dict(manifest.traffic("label-open")["images"], count=12, long_side=[64, 200])
    return {"entry": "classify", "loop": loop, "rate_per_s": 20, "clients": 4, "preroll_s": 0.5,
            "warm_buckets": [1, 8], "images": images}


def _bench():
    e2e = [{"name": "classify_p95_ms", "unit": "ms", "workloads": [CELL["name"]]},
           {"name": "images_per_s", "unit": "images/s", "workloads": [CELL["name"]]},
           {"name": "setup_s", "unit": "s"}]
    per_layer = [{"name": n, "unit": "x", "moves": "classify_p95_ms", "workloads": [CELL["name"]]}
                 for n in ("batch_fill.label", "queue_wait_ms.label", "device_idle.label")]
    return {"end_to_end": e2e, "per_layer": per_layer}


def _run(loop="open", traced=False, hook=None, control=False, seed=2**31 + 77):
    return run.run_cell(CELL, _config(), _traffic(loop), LIMITS, _bench(), seed, 2.0, traced,
                        device="cpu", on_service=hook, control=control)


def test_a_sound_run_is_correct_and_reports_its_metrics():
    result = _run(control=True)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 20 and result["failed"] == 0
    assert set(result["metrics"]) == {"classify_p95_ms", "images_per_s", "setup_s"}
    checks = result["checks"]
    assert checks["host_decoded"]["value"] == 0
    # the control (the reference in float8) in the program's place, judged by
    # the same limits: it reads higher than the program and is not correct
    control = result["control"]
    assert control["checks"]["score_gap"]["value"] > 2 * checks["score_gap"]["value"]
    assert not control["correct"]
    # set-up leaves out the reference's part of making the weights
    assert 0 < result["metrics"]["setup_s"]["value"]
    json.dumps(result)


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_planted_fault_makes_the_run_incorrect(fault):
    result = _run(hook=faults.FAULTS[fault])
    assert not result["correct"], result["checks"]


def test_a_traced_run_reads_the_per_layer_metrics_and_the_breakdown():
    result = _run(loop="closed", traced=True)
    assert result["correct"], result["checks"]
    # a benchmark run prints only numbers that are compared, each beside its limit
    assert all(c["limit"] is not None for c in result["checks"].values())
    assert {"batch_fill.label", "queue_wait_ms.label"} <= set(result["metrics"])
    assert result["metrics"]["batch_fill.label"]["value"] >= 1
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert result["device"]["window_s"] > 0


def test_each_run_serves_its_own_configuration(monkeypatch):
    # the program reads its TPU_* settings once a process: a second run of
    # the process (a test file, the readings) must still serve its own model
    from ics_tpu_torch.core.config import reload_settings, settings

    monkeypatch.setenv("TPU_DEFAULT_MODEL", "vit_tiny")
    reload_settings()
    result = _run()
    assert settings.TPU_DEFAULT_MODEL == "resnet_tiny"
    assert result["correct"], result["checks"]
