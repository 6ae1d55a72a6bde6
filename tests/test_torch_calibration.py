"""The port's evaluation and calibration (``ics_tpu_torch/train/finetune.py``)
against the JAX package's, mirroring ``tests/test_calibration.py``.

The numpy functions (metrics, ECE, temperature and threshold fits) take the
same seeded inputs and must give the same numbers (1e-12: the same float64
arithmetic). The eval steps run a ResNet (1, 1, 1, 1) with the same weights
over the same uint8 batches, fp32: logits at atol 2e-4, rtol 1e-4, counts
equal. ``fold_temperature`` is held to the reference's on mapped weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ics_tpu.models import resnet as jax_resnet
from ics_tpu.train import finetune as jft
from ics_tpu_torch import weights
from ics_tpu_torch.models import resnet as torch_resnet
from ics_tpu_torch.train import finetune as tft


def _logits(seed, n=40, c=4, scale=3.0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, c, n)
    logits = rng.normal(0, 1, (n, c))
    logits[np.arange(n), labels] += scale * rng.random(n)
    return logits, labels


def _assert_same(ours, ref):
    if isinstance(ref, dict):
        assert ours.keys() == ref.keys()
        for k in ref:
            _assert_same(ours[k], ref[k])
    elif isinstance(ref, (list, tuple)):
        assert len(ours) == len(ref)
        for a, b in zip(ours, ref):
            _assert_same(a, b)
    else:
        np.testing.assert_allclose(ours, ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("seed,n", [(0, 40), (1, 5), (2, 200)])
def test_single_label_calibration_matches_the_reference(seed, n):
    logits, labels = _logits(seed, n)
    _assert_same(tft.calibrate_temperature(logits, labels), jft.calibrate_temperature(logits,
                                                                                     labels))
    _assert_same(tft.calibrate_temperature(logits * 4, labels),
                 jft.calibrate_temperature(logits * 4, labels))
    _assert_same(tft.per_class_metrics(logits, labels, 5),
                 jft.per_class_metrics(logits, labels, 5))
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    _assert_same(tft.expected_calibration_error(probs, labels),
                 jft.expected_calibration_error(probs, labels))
    _assert_same(tft.nll_np(logits, labels, 1.7), jft.nll_np(logits, labels, 1.7))


@pytest.mark.parametrize("seed", [0, 1])
def test_multilabel_calibration_matches_the_reference(seed):
    rng = np.random.default_rng(seed)
    targets = (rng.random((30, 4)) < 0.4).astype(np.float32)
    probs = np.clip(targets * 0.5 + rng.random((30, 4)) * 0.6, 0, 1)
    _assert_same(tft.calibrate_multilabel_threshold(probs, targets),
                 jft.calibrate_multilabel_threshold(probs, targets))
    _assert_same(tft.calibrate_multilabel_threshold(probs[:3], targets[:3]),
                 jft.calibrate_multilabel_threshold(probs[:3], targets[:3]))
    for t in (0.3, 0.5, 0.8):
        _assert_same(tft.multilabel_metrics(probs, targets, t),
                     jft.multilabel_metrics(probs, targets, t))
        _assert_same(tft.multilabel_per_class_metrics(probs, targets, t),
                     jft.multilabel_per_class_metrics(probs, targets, t))


COUNTS, CLASSES = (1, 1, 1, 1), 4


@pytest.fixture(scope="module")
def pair():
    jmodel = jax_resnet.ResNet(COUNTS, CLASSES)
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(3)))
    rng = np.random.default_rng(3)
    variables["state"] = jax.tree_util.tree_map(      # running statistics to evaluate with
        lambda x: (rng.uniform(0.5, 1.5, x.shape) if x.mean() > 0.5
                   else rng.normal(0, 0.1, x.shape)).astype(np.float32), variables["state"])
    model = torch_resnet.ResNet(COUNTS, CLASSES)
    model.load_state_dict(weights.from_jax_variables(variables), strict=True)
    return jmodel, variables, model


def _eval_batches(n=3, b=4, seed=0, multi=False):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        canvas = rng.integers(0, 256, (b, 48, 48, 3), np.uint8)
        sizes = rng.integers(32, 49, (b, 2)).astype(np.int32)
        labels = ((rng.random((b, CLASSES)) < 0.4).astype(np.float32) if multi
                  else rng.integers(0, CLASSES, b).astype(np.int32))
        out.append((canvas, sizes, labels, b - (i == n - 1)))   # the last batch padded
    return out


def test_eval_steps_match_the_reference(pair):
    jmodel, variables, model = pair
    kw = dict(image_size=32, resize_short=36)
    batches = _eval_batches()
    jv = jax.tree_util.tree_map(jnp.asarray, variables)
    ours = tft.collect_logits(model, batches, compute_dtype=torch.float32, **kw)
    ref = jft.collect_logits(jmodel, jv, batches, compute_dtype=jnp.float32, **kw)
    np.testing.assert_allclose(ours[0], ref[0], atol=2e-4, rtol=1e-4)
    np.testing.assert_array_equal(ours[1], ref[1])
    assert ours[0].shape == (11, CLASSES)
    assert tft.evaluate(model, batches, compute_dtype=torch.float32, **kw) == \
        jft.evaluate(jmodel, jv, batches, compute_dtype=jnp.float32, **kw)
    multi = _eval_batches(seed=1, multi=True)
    probs, targets = tft.collect_multilabel_scores(model, multi, compute_dtype=torch.float32,
                                                   **kw)
    ref_p, ref_t = jft.collect_multilabel_scores(jmodel, jv, multi, compute_dtype=jnp.float32,
                                                 **kw)
    np.testing.assert_allclose(probs, ref_p, atol=2e-4, rtol=1e-4)
    np.testing.assert_array_equal(targets, ref_t)
    metrics, total = tft.evaluate_multilabel(model, multi, compute_dtype=torch.float32, **kw)
    assert total == 11 and metrics.keys() == {"f1_micro", "exact_match", "precision", "recall"}
    assert tft.collect_logits(model, [], **kw) == (None, None)
    assert tft.evaluate(model, [], **kw) == (None, 0)


def test_fold_temperature_matches_the_reference(pair):
    _, variables, model = pair
    folded = tft.fold_temperature(model.state_dict(), 1.7)
    ref = weights.from_jax_variables(jft.fold_temperature(variables, 1.7))
    for name, value in ref.items():
        np.testing.assert_allclose(folded[name].numpy(), value.numpy(), rtol=1e-6, err_msg=name)
    sd = model.state_dict()
    assert tft.fold_temperature(sd, 1.0) is sd and tft.fold_temperature(sd, None) is sd
