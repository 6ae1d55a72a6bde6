"""``FineTuner.run``'s loop in the port, mirroring ``tests/test_train.py``'s
``TestEarlyStopping``: the periodic eval, the best snapshot on the host,
patience, ``should_stop`` and ``on_step``, and the multi-label step (held to
the reference's one step of the same ConvNeXt at atol 2e-4, rtol 1e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ics_tpu.models import convnext as jax_convnext
from ics_tpu.train import finetune as jft
from ics_tpu_torch import weights
from ics_tpu_torch.models import convnext as torch_convnext
from ics_tpu_torch.models import resnet
from ics_tpu_torch.train import finetune as tft


def _tuner_and_batch():
    model = resnet.ResNet((1, 1, 1, 1), 2)
    model.init_weights(torch.Generator().manual_seed(0))
    tuner = tft.FineTuner(model, tft.make_optimizer(lr=0.05), image_size=32, resize_short=32,
                          compute_dtype=torch.float32)
    rng = np.random.default_rng(0)
    batch = (rng.integers(0, 256, (4, 64, 64, 3), np.uint8), np.full((4, 2), 48, np.int32),
             np.asarray([0, 1, 0, 1], np.int32))
    return tuner, batch


@pytest.mark.parametrize("metrics,patience,steps,stopped,best", [
    ([0.9, 0.5, 0.4, 0.3, 0.2, 0.1], 2, 3, True, (0.9, 1)),       # two misses stop it
    ([0.1, 0.2, 0.3, 0.4, 0.5], 2, 5, False, (0.5, 5)),           # improving never stops
    ([None, None, None], 1, 3, False, None),                       # no metric, no patience
])
def test_patience_and_the_best_snapshot(metrics, patience, steps, stopped, best):
    tuner, batch = _tuner_and_batch()
    values, seen = iter(metrics), []

    def eval_fn(model, opt_state, step):
        seen.append(step)
        return next(values), model.state_dict()

    batches = 10 if stopped else len(metrics)
    _, _, history = tuner.run(iter([batch] * batches), eval_every=1, eval_fn=eval_fn,
                              patience=patience)
    assert seen == list(range(1, steps + 1)) and len(history) == steps
    assert tuner.stopped_early is stopped
    if best is None:
        assert tuner.best is None and all("eval" not in h for h in history)
        return
    assert (tuner.best["metric"], tuner.best["step"]) == best
    snapshot = tuner.best["state_dict"]
    assert all(v.device.type == "cpu" for v in snapshot.values())
    live = tuner.model.state_dict()
    assert any(not torch.equal(snapshot[k], live[k]) for k in live) == (best[1] != steps)
    assert history[0]["eval"] == metrics[0]


def test_eval_every_spacing_should_stop_and_on_step():
    tuner, batch = _tuner_and_batch()
    seen, records = [], []

    def eval_fn(model, opt_state, step):
        seen.append(step)
        return 1.0, model.state_dict()

    _, _, history = tuner.run(iter([batch] * 6), eval_every=3, eval_fn=eval_fn,
                              on_step=records.append)
    assert seen == [3, 6] and records == history and not tuner.stopped_early
    assert [h["step"] for h in history] == list(range(1, 7))
    _, _, history = tuner.run(iter([batch] * 6), should_stop=lambda: len(records) >= 8,
                              on_step=records.append)
    assert len(history) == 2


CONVNEXT = dict(depths=(1, 1, 1, 1), dims=(8, 16, 24, 32))


def test_multilabel_step_matches_jax():
    jmodel = jax_convnext.ConvNeXt(num_classes=4, **CONVNEXT)
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(2)))
    rng = np.random.default_rng(3)
    canvas = rng.integers(0, 256, (4, 48, 48, 3), np.uint8)
    sizes = rng.integers(32, 49, (4, 2)).astype(np.int32)
    hot = (rng.random((4, 4)) < 0.4).astype(np.float32)
    optimizer = jft.make_optimizer(lr=0.05)
    step = jft.make_preproc_train_step(jmodel, optimizer, image_size=32, resize_short=36,
                                       compute_dtype=jnp.float32, multi_label=True,
                                       donate=False)
    v = jax.tree_util.tree_map(jnp.asarray, variables)
    v, _, metrics = step(v, optimizer.init(v["params"]), canvas, sizes, hot)
    model = torch_convnext.ConvNeXt(num_classes=4, **CONVNEXT)
    model.load_state_dict(weights.from_jax_variables(variables), strict=True)
    ours = tft.make_preproc_train_step(model, tft.TrainOptimizer(model, tft.make_optimizer(
        lr=0.05)), 32, 36, torch.float32, multi_label=True)(canvas, sizes, hot)
    for key in ("loss", "accuracy"):
        np.testing.assert_allclose(float(ours[key]), float(metrics[key]), atol=2e-4, rtol=1e-4)
    sd = model.state_dict()
    for name, ref in weights.from_jax_variables(jax.tree_util.tree_map(np.asarray, v)).items():
        np.testing.assert_allclose(sd[name].numpy(), ref.numpy(), atol=2e-4, rtol=1e-4,
                                   err_msg=name)
