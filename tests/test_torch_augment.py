"""The port's training augmentation (``ics_tpu_torch/ops/augment.py``) against
the JAX package's, mirroring ``tests/test_augment.py``.

JAX keys and torch generators give different bits from one seed, so the plan
the JAX functions draw (crop boxes, flips, jitter factors, the mix lambda
and box) is rebuilt here from the same keys and handed to the port's apply
functions; their outputs are held to the JAX outputs at 1e-5 (fp32; the
images relative to their largest magnitude, the fp32 sums of a resize of
0-255 pixels rounding at about that level). The port's own draws are tested
by their ranges and statistics. One augmented train step of a small ConvNeXt, fed the JAX plan,
is held to the reference's step at atol 2e-4, rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ics_tpu.models import convnext as jax_convnext
from ics_tpu.ops import augment as jaug
from ics_tpu.train import finetune as jft
from ics_tpu_torch import weights
from ics_tpu_torch.models import convnext as torch_convnext
from ics_tpu_torch.ops import augment as taug
from ics_tpu_torch.train import finetune as tft

CANVAS, OUT = 64, 32


def _canvas_batch(n=3, seed=0):
    rng = np.random.default_rng(seed)
    canvas = np.zeros((n, CANVAS, CANVAS, 3), np.uint8)
    sizes = np.zeros((n, 2), np.int32)
    for i in range(n):
        h, w = rng.integers(30, CANVAS + 1, 2)
        canvas[i, :h, :w] = rng.integers(0, 256, (h, w, 3), np.uint8)
        sizes[i] = (h, w)
    return canvas, sizes


def _jax_plan(key, sizes, cfg, out=OUT):
    """The plan ``ics_tpu.ops.augment.augment_batch`` draws from ``key``."""
    rows = []
    for i, (h, w) in enumerate(sizes):
        k_geom, k_color = jax.random.split(jax.random.fold_in(key, i))
        (sy, oy), (sx, ox), flip = jaug._crop_flip_plan(k_geom, h, w, out, cfg)
        k_b, k_c, k_s = jax.random.split(k_color, 3)
        jit = [float(jax.random.uniform(k, (), minval=1.0 - x, maxval=1.0 + x)) if x > 0 else 1.0
               for k, x in ((k_b, cfg.brightness), (k_c, cfg.contrast), (k_s, cfg.saturation))]
        rows.append([float(sy), float(oy), float(sx), float(ox), bool(flip), *jit])
    cols = list(zip(*rows))
    return taug.AugmentPlan(*(torch.tensor(c, dtype=torch.bool if j == 4 else torch.float32)
                              for j, c in enumerate(cols)))


CONFIGS = {
    "identity": jaug.AugmentConfig(scale_range=(1.0, 1.0), ratio_range=(1.0, 1.0),
                                   flip_prob=0.0),
    "crop_flip": jaug.AugmentConfig(flip_prob=0.5),
    "all_flips": jaug.AugmentConfig(scale_range=(0.2, 0.9), flip_prob=1.0),
    "jitter": jaug.AugmentConfig(brightness=0.4, contrast=0.4, saturation=0.4),
}


def _port_cfg(cfg):
    return taug.AugmentConfig(**{f: getattr(cfg, f) for f in
                                 taug.AugmentConfig.__dataclass_fields__})


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("seed", [0, 1])
def test_augment_from_the_jax_plan_matches_jax(name, seed):
    cfg = CONFIGS[name]
    canvas, sizes = _canvas_batch(seed=seed)
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(jaug.augment_batch(jnp.asarray(canvas), jnp.asarray(sizes), key,
                                        out_size=OUT, cfg=cfg, dtype=jnp.float32))
    plan = _jax_plan(key, sizes, cfg)
    ours = taug.apply_plan(torch.from_numpy(canvas), torch.from_numpy(sizes), plan, OUT,
                           _port_cfg(cfg), dtype=torch.float32)
    assert np.abs(ours.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def _images(seed=0, n=4, h=8, w=8):
    rng = np.random.default_rng(seed)
    images = rng.normal(0, 1, (n, h, w, 3)).astype(np.float32)
    targets = rng.dirichlet(np.ones(5), n).astype(np.float32)
    return images, targets


@pytest.mark.parametrize("alpha", [0.2, 1.0])
def test_mixup_from_the_jax_lambda_matches_jax(alpha):
    images, targets = _images(1)
    key = jax.random.PRNGKey(3)
    ref_i, ref_t = jaug.mixup(key, jnp.asarray(images), jnp.asarray(targets), alpha)
    lam = float(jax.random.beta(key, alpha, alpha))
    lam = max(lam, 1.0 - lam)
    ours_i, ours_t = taug.mix_batch(torch.from_numpy(images), torch.from_numpy(targets),
                                    taug.MixPlan("mixup", lam))
    np.testing.assert_allclose(ours_i.numpy(), np.asarray(ref_i), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ours_t.numpy(), np.asarray(ref_t), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_cutmix_from_the_jax_box_matches_jax(seed):
    images, targets = _images(seed, h=12, w=10)
    key = jax.random.PRNGKey(seed)
    ref_i, ref_t = jaug.cutmix(key, jnp.asarray(images), jnp.asarray(targets), 1.0)
    k_lam, k_y, k_x = jax.random.split(key, 3)
    lam = float(jax.random.beta(k_lam, 1.0, 1.0))
    plan = taug.MixPlan("cutmix", max(lam, 1.0 - lam), float(jax.random.uniform(k_y, ())),
                        float(jax.random.uniform(k_x, ())))
    ours_i, ours_t = taug.mix_batch(torch.from_numpy(images), torch.from_numpy(targets), plan)
    np.testing.assert_allclose(ours_i.numpy(), np.asarray(ref_i), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ours_t.numpy(), np.asarray(ref_t), atol=1e-5, rtol=1e-5)
    assert not np.allclose(ours_t.numpy(), targets)          # something was pasted


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_label_smoothing_matches_jax(smoothing):
    labels = np.array([0, 3, 1, 4], np.int32)
    hot = np.eye(5, dtype=np.float32)[[0, 3, 1, 4]]
    np.testing.assert_allclose(
        taug.smooth_labels(torch.from_numpy(labels), 5, smoothing).numpy(),
        np.asarray(jaug.smooth_labels(jnp.asarray(labels), 5, smoothing)), atol=1e-7)
    np.testing.assert_allclose(
        taug.smooth_multilabel(torch.from_numpy(hot), smoothing).numpy(),
        np.asarray(jaug.smooth_multilabel(jnp.asarray(hot), smoothing)), atol=1e-7)


def test_drawn_plans_keep_to_their_ranges_and_odds():
    cfg = taug.AugmentConfig(scale_range=(0.3, 0.9), ratio_range=(0.5, 2.0), flip_prob=0.3,
                             brightness=0.2, contrast=0.3, saturation=0.4)
    n = 4000
    sizes = torch.tensor([[400, 500]] * n)
    plan = taug.draw_plan(sizes, 224, cfg, torch.Generator().manual_seed(0))
    crop_h, crop_w = plan.scale_y * 224, plan.scale_x * 224
    y0, x0 = plan.offset_y * plan.scale_y, plan.offset_x * plan.scale_x
    assert bool((y0 >= 0).all() and (y0 + crop_h <= 400 + 1e-3).all())
    assert bool((x0 >= 0).all() and (x0 + crop_w <= 500 + 1e-3).all())
    area = crop_h * crop_w / (400 * 500)
    assert float(area.max()) <= 0.9 + 1e-5 and float(area.min()) >= 0.0
    unclamped = (crop_h < 400) & (crop_w < 500)
    np.testing.assert_allclose(float(area[unclamped].min()), 0.3, atol=0.01)
    ratio = (crop_w / crop_h)[unclamped]
    assert float(ratio.min()) >= 0.5 - 1e-4 and float(ratio.max()) <= 2.0 + 1e-4
    assert abs(float(plan.flip.float().mean()) - 0.3) < 0.03
    for factor, x in ((plan.brightness, 0.2), (plan.contrast, 0.3), (plan.saturation, 0.4)):
        assert float(factor.min()) >= 1 - x and float(factor.max()) <= 1 + x
        assert abs(float(factor.mean()) - 1.0) < 0.02
    again = taug.draw_plan(sizes, 224, cfg, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(again, plan))    # the seed decides


@pytest.mark.parametrize("alpha", [0.2, 1.0])
def test_drawn_mix_lambdas_follow_the_folded_beta(alpha):
    g = torch.Generator().manual_seed(1)
    cfg = taug.AugmentConfig(mixup_alpha=alpha, cutmix_alpha=alpha)
    plans = [taug.draw_mix(cfg, g) for _ in range(3000)]
    lams = np.array([p.lam for p in plans])
    assert lams.min() >= 0.5 and lams.max() <= 1.0
    ref = np.random.default_rng(0).beta(alpha, alpha, 200_000)
    ref = np.maximum(ref, 1 - ref)
    assert abs(lams.mean() - ref.mean()) < 0.01
    assert abs(np.median(lams) - np.median(ref)) < 0.02
    kinds = [p.kind for p in plans]
    assert abs(kinds.count("mixup") / len(kinds) - 0.5) < 0.04
    assert {p.kind for p in plans} == {"mixup", "cutmix"}
    assert all(0.0 <= p.cy < 1.0 and 0.0 <= p.cx < 1.0 for p in plans)
    assert taug.draw_mix(taug.AugmentConfig(), g) == taug.MixPlan(None)


def test_config_rejects_what_the_reference_rejects():
    for bad in (dict(scale_range=(0.0, 1.0)), dict(ratio_range=(2.0, 1.0)),
                dict(flip_prob=1.5), dict(brightness=1.0), dict(mixup_alpha=-1.0),
                dict(cutmix_alpha=-0.1), dict(label_smoothing=1.0)):
        with pytest.raises(ValueError):
            taug.AugmentConfig(**bad)
        with pytest.raises(ValueError):
            jaug.AugmentConfig(**bad)


CONVNEXT = dict(depths=(1, 1, 1, 1), dims=(8, 16, 24, 32))


def test_augmented_step_from_the_jax_plan_matches_jax():
    """One augmented step (crop, flip, jitter, label smoothing, mixup or
    CutMix) of a small ConvNeXt: the JAX step draws from its key, the port's
    takes the plan drawn from that key."""
    cfg = jaug.AugmentConfig(flip_prob=0.5, brightness=0.2, mixup_alpha=0.4,
                             cutmix_alpha=1.0, label_smoothing=0.1)
    jmodel = jax_convnext.ConvNeXt(num_classes=5, **CONVNEXT)
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(4)))
    canvas, sizes = _canvas_batch(n=4, seed=6)
    labels = np.array([0, 2, 4, 1], np.int32)
    key = jax.random.PRNGKey(8)
    optimizer = jft.make_optimizer(lr=0.05)
    step = jft.make_augmented_train_step(jmodel, optimizer, cfg, image_size=OUT,
                                         compute_dtype=jnp.float32, donate=False)
    v = jax.tree_util.tree_map(jnp.asarray, variables)
    v, _, metrics = step(v, optimizer.init(v["params"]), canvas, sizes, labels, key)

    k_aug, k_mix = jax.random.split(key)
    k_pick, k_m = jax.random.split(k_mix)
    if bool(jax.random.bernoulli(k_pick)):
        lam = float(jax.random.beta(k_m, cfg.mixup_alpha, cfg.mixup_alpha))
        mix = taug.MixPlan("mixup", max(lam, 1.0 - lam))
    else:
        k_lam, k_y, k_x = jax.random.split(k_m, 3)
        lam = float(jax.random.beta(k_lam, cfg.cutmix_alpha, cfg.cutmix_alpha))
        mix = taug.MixPlan("cutmix", max(lam, 1.0 - lam), float(jax.random.uniform(k_y, ())),
                           float(jax.random.uniform(k_x, ())))
    model = torch_convnext.ConvNeXt(num_classes=5, **CONVNEXT)
    model.load_state_dict(weights.from_jax_variables(variables), strict=True)
    opt = tft.TrainOptimizer(model, tft.make_optimizer(lr=0.05))
    ours = tft.make_augmented_train_step(model, opt, _port_cfg(cfg), OUT, torch.float32)(
        canvas, sizes, labels, plan=_jax_plan(k_aug, sizes, cfg), mix=mix)
    np.testing.assert_allclose(float(ours["loss"]), float(metrics["loss"]), atol=2e-4,
                               rtol=1e-4)
    sd = model.state_dict()
    for name, ref in weights.from_jax_variables(jax.tree_util.tree_map(np.asarray,
                                                                       v)).items():
        np.testing.assert_allclose(sd[name].numpy(), ref.numpy(), atol=2e-4, rtol=1e-4,
                                   err_msg=name)
