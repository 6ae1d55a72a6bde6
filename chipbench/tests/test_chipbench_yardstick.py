"""The yardstick's own arithmetic, on the CPU: the traffic from the seed,
the percentiles, the device trace's reductions and the roofline."""

from __future__ import annotations

import json
import math

import numpy as np
import pytest

from chipbench import load, roofline, scenes, trace
from chipbench.reference import models
from chipbench.manifest import HERE

IMAGES = {"count": 12, "long_side": [64, 200], "aspects": [[4, 3], [3, 2], [1, 1]],
          "shapes": [2, 4], "blur_noise": 12, "grain": 6, "quality": 90, "subsampling": "4:2:0"}


def test_same_seed_same_images_and_schedule():
    a, b = scenes.make_images(IMAGES, 2**31 + 5), scenes.make_images(IMAGES, 2**31 + 5)
    assert a == b
    assert scenes.make_images(IMAGES, 7) != a
    assert (load.arrival_offsets(300, 4.0, 11) == load.arrival_offsets(300, 4.0, 11)).all()
    assert (load.image_order(12, 50, 11) == load.image_order(12, 50, 11)).all()


def test_every_seed_gets_the_same_sizes_and_gaps_in_another_order():
    s1, s2 = scenes.image_sizes(IMAGES, 1), scenes.image_sizes(IMAGES, 2)
    assert sorted(s1) == sorted(s2) and s1 != s2
    g1 = sorted(map(float, load.arrival_offsets(200, 3.0, 1)[1:] - load.arrival_offsets(200, 3.0, 1)[:-1]))
    o2 = load.arrival_offsets(200, 3.0, 2)
    g2 = sorted(map(float, o2[1:] - o2[:-1]))
    # the same gaps but the first one taken as the start
    assert len(g1) == len(g2)
    assert abs(sum(g1) - sum(g2)) < 0.05


def test_images_are_baseline_jpegs_within_the_size_limits():
    blobs = scenes.make_images(IMAGES, 3)
    for blob, (h, w) in zip(blobs, scenes.image_sizes(IMAGES, 3)):
        assert blob[:2] == b"\xff\xd8" and b"\xff\xc0" in blob   # SOI, baseline SOF0
        assert max(h, w) <= 200


def _window(latencies_ms, failed=0):
    w = load.Window(start=0.0, end=10.0)
    for i, ms in enumerate(latencies_ms):
        w.requests.append(load.Request(image=0, due=1.0 + i * 1e-3, sent=1.0,
                                       done=1.0 + i * 1e-3 + ms / 1e3, answer={}))
    for _ in range(failed):
        w.requests.append(load.Request(image=0, due=2.0, sent=2.0, error="RuntimeError: x"))
    w.requests.append(load.Request(image=0, due=11.0, sent=11.0, done=11.5))  # after the window
    return w


def test_p95_over_all_requests_from_the_due_time_with_a_stalled_request_counted():
    lat = load.latencies_ms(_window([10.0] * 94 + [20.0] * 6))
    assert len(lat) == 100                                # the request after the window is out
    assert load.percentile(lat, 95) == pytest.approx(float(np.percentile(lat, 95)))
    assert load.percentile(lat, 50) == pytest.approx(10.0)
    # a stalled request counts, as the slowest: one in place of a 20 ms answer
    lat = load.latencies_ms(_window([10.0] * 94 + [20.0] * 5, failed=1))
    assert len(lat) == 100 and math.isinf(max(lat))
    assert load.percentile(lat, 95) == pytest.approx(float(np.percentile(lat[:-1] + [20.0], 95)))
    # more than one in twenty missing: no finite 95th percentile
    assert math.isinf(load.percentile(load.latencies_ms(_window([10.0] * 94, failed=6)), 95))


def test_a_request_is_timed_from_when_it_was_due_not_sent():
    w = load.Window(start=0.0, end=5.0)
    w.requests.append(load.Request(image=0, due=1.0, sent=1.3, done=1.4, answer={}))
    assert load.latencies_ms(w) == [pytest.approx(400.0)]


def test_idle_is_one_minus_the_union_on_overlapping_streams():
    # two streams: [0, 40] and [30, 50] overlap; [60, 70] alone; window [0, 100]
    device = [(0, 40), (30, 50), (60, 70), (65, 68)]
    assert trace.busy_ns(device, 0, 100) == 60            # a sum would give 93
    assert trace.idle_gaps(device, 0, 100) == [(50, 60), (70, 100)]
    assert trace.busy_ns(device, 35, 65) == 20            # clipped to the window
    host = [trace.Span("entropy decode", 45, 58), trace.Span("dispatch", 55, 62),
            trace.Span("entropy decode", 75, 99)]
    assert trace.label_gap((50, 60), host) == "entropy decode"
    assert trace.label_gap((70, 100), []) == trace.NO_HOST_WORK


def test_kernels_are_attributed_to_the_dispatch_that_launched_them():
    spans = [trace.Span("dispatch", 0, 10, thread=1, bucket=8),
             trace.Span("dispatch", 5, 20, thread=2, bucket=32)]
    api = {1: trace.Event("cudaLaunchKernel", 6, 7, False, 1, thread=2),
           2: trace.Event("cudaLaunchKernel", 3, 4, False, 2, thread=1)}
    kernels = [trace.Event("k", 30, 31, True, 1), trace.Event("k", 32, 33, True, 2),
               trace.Event("k", 40, 41, True, 99)]
    owners = trace.attribute(kernels, api, spans)
    assert [o.bucket for o in owners] == [32, 8, 32]


def test_bound_of_the_flash_call_in_the_kernel_table():
    n_bytes, n_ops = roofline.flash_work(32, 12, 577, 64)
    b = roofline.bound(n_bytes, n_ops)
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(0.0339, abs=5e-5)


def test_chain_work_of_both_resnet50_chains_at_bucket_32():
    # PERF.md's row 3 counts the operations of the five launches: 0.0707 ms
    ops = 2 * roofline.chain_launch_work(32, 56, 56, 256, 64)[1] \
        + 3 * roofline.chain_launch_work(32, 28, 28, 512, 128)[1]
    assert ops / roofline.BF16_FLOPS * 1e3 == pytest.approx(0.0707, abs=5e-5)


def _config(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def test_resnet50_flops_against_a_hand_count():
    # the 53 convolutions of ResNet-50 v1.5 at 224 and the head, one by one
    macs = 112 * 112 * 7 * 7 * 3 * 64
    for (s_in, s_out, cin, width, blocks) in ((56, 56, 64, 64, 3), (56, 28, 256, 128, 4),
                                              (28, 14, 512, 256, 6), (14, 7, 1024, 512, 3)):
        out = 4 * width
        macs += s_in * s_in * cin * width + s_out * s_out * 9 * width * width \
            + s_out * s_out * width * out + s_out * s_out * cin * out
        macs += (blocks - 1) * s_out * s_out * (out * width + 9 * width * width + width * out)
    macs += 2048 * 1000
    assert models.macs(_config("resnet50")) == macs
    assert roofline.model_flops(_config("resnet50")) / 1e9 == pytest.approx(8.18, abs=0.01)


def test_vit_l16_flops_against_a_hand_count():
    tokens, d = 577, 1024
    macs = 576 * 768 * d + 24 * (tokens * 12 * d * d + 2 * tokens * tokens * d) + d * 1000
    assert models.macs(_config("vit_l16")) == macs
    assert roofline.model_flops(_config("vit_l16")) / 1e9 == pytest.approx(382.6, abs=0.5)
