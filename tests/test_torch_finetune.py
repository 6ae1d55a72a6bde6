"""The port's fine-tuner against the JAX package's (``ics_tpu/train/finetune.py``),
mirroring ``tests/test_train.py``: the same seeded numpy inputs and the same
weights (bridged by ``weights.py``) through both.

- Losses and the schedule: against the reference's functions, 1e-6 and 1e-5.
- Steps: one and three SGD steps of a ConvNeXt and a ResNet (1, 1, 1, 1) and
  one AdamW step of the ConvNeXt through the preprocessing train step, fp32:
  the loss, every parameter and every BatchNorm statistic at atol 2e-4, rtol
  1e-4. A randomly initialised ResNet's gradient is shattered: where a ReLU
  or a max-pool window sits on its kink, a rounding-size change of the input
  moves it (chip_smoke.py [9b] reads how far for ResNet-50), so its steps are
  taken at lr 0.01 on batches of 8 at 32 px, where the two frameworks'
  rounding crosses no kink.
- The optimizer's parts (EMA, gradient accumulation, the linear probe, LLRD
  with AdamW, a scheduled rate) fed the same random gradients as the optax
  chains the reference builds: parameters and the EMA shadow at atol 1e-6,
  rtol 1e-5 (the sums differ only in their order).
- LLRD multipliers equal by parameter name on every family that has blocks or
  stages; every port parameter has the rank of its JAX leaf (the decay mask).
- Port-side semantics: accumulation over two halves equals one step on the
  whole batch, the probe leaves the backbone and its statistics alone, a
  resumed run equals an uninterrupted one, and the kernels that have no
  backward are turned off by name.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ics_tpu.models import convnext as jax_convnext
from ics_tpu.models import resnet as jax_resnet
from ics_tpu.models import swin as jax_swin
from ics_tpu.models import vit as jax_vit
from ics_tpu.train import finetune as jft
from ics_tpu_torch import weights
from ics_tpu_torch.models import convnext as torch_convnext
from ics_tpu_torch.models import resnet as torch_resnet
from ics_tpu_torch.models import swin as torch_swin
from ics_tpu_torch.models import vit as torch_vit
from ics_tpu_torch.ops.augment import AugmentConfig
from ics_tpu_torch.train import finetune as tft
from ics_tpu_torch.train.pretrained import native_flat, unflatten_variables

ATOL, RTOL = 2e-4, 1e-4
COUNTS, CLASSES = (1, 1, 1, 1), 5
CONVNEXT = dict(depths=(1, 2, 1, 1), dims=(8, 16, 24, 32))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(build, variables):
    model = build()
    model.load_state_dict(weights.from_jax_variables(variables), strict=True)
    return model


def _port_resnet(variables):
    return _port(lambda: torch_resnet.ResNet(COUNTS, CLASSES), variables)


def _assert_same(model, variables, atol=ATOL, rtol=RTOL):
    ours = model.state_dict()
    for name, ref in weights.from_jax_variables(variables).items():
        np.testing.assert_allclose(ours[name].detach().numpy(), ref.numpy(), atol=atol,
                                   rtol=rtol, err_msg=name)


def _batches(n, b=8, canvas=48, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (b, canvas, canvas, 3), np.uint8),
             rng.integers(32, canvas + 1, (b, 2)).astype(np.int32),
             rng.integers(0, CLASSES, b).astype(np.int32)) for _ in range(n)]


# -- losses and schedule ---------------------------------------------------------------

def test_losses_match_the_reference():
    rng = np.random.default_rng(1)
    logits = rng.normal(0, 2, (6, 7)).astype(np.float32)
    labels = rng.integers(0, 7, 6).astype(np.int32)
    probs = rng.dirichlet(np.ones(7), 6).astype(np.float32)
    hot = (rng.random((6, 7)) < 0.3).astype(np.float32)
    hot[0] = (logits[0] >= 0)                       # one exact match at least
    t = torch.from_numpy
    pairs = [
        (tft.cross_entropy_loss(t(logits), t(labels)), jft.cross_entropy_loss(logits, labels)),
        (tft.soft_cross_entropy_loss(t(logits), t(probs)),
         jft.soft_cross_entropy_loss(logits, probs)),
        (tft.sigmoid_bce_loss(t(logits), t(hot)), jft.sigmoid_bce_loss(logits, hot)),
        (tft.multilabel_exact_match(t(logits), t(hot)), jft.multilabel_exact_match(logits, hot)),
    ]
    for ours, ref in pairs:
        np.testing.assert_allclose(float(ours), float(ref), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("lr,total", [(0.1, 50), (3e-4, 7), (0.01, 2)])
def test_schedule_matches_optax_at_every_step(lr, total):
    ours = tft.make_lr_schedule(lr, total)
    ref = jft.make_lr_schedule(lr, total)
    for i in range(total + 5):
        np.testing.assert_allclose(ours(i), float(ref(i)), rtol=1e-5, atol=1e-9, err_msg=i)
    assert ours(0) == 0.0
    assert tft.make_lr_schedule(0.1, 10, "constante") == 0.1
    with pytest.raises(ValueError, match="agenda_lr"):
        tft.make_lr_schedule(0.1, 10, "linear")
    with pytest.raises(ValueError, match="otimizador"):
        tft.make_optimizer(kind="lamb")


# -- whole steps against the reference --------------------------------------------------

# ConvNeXt (LayerNorm and GELU, smooth) for the optimizer steps at full strength;
# ResNet for the BatchNorm statistics, at a rate that keeps its ReLU and
# max-pool kinks from amplifying rounding between the two frameworks
FAMILIES = {
    "convnext": (lambda: jax_convnext.ConvNeXt(num_classes=CLASSES, **CONVNEXT),
                 lambda: torch_convnext.ConvNeXt(num_classes=CLASSES, **CONVNEXT), 0.05),
    "resnet": (lambda: jax_resnet.ResNet(COUNTS, CLASSES),
               lambda: torch_resnet.ResNet(COUNTS, CLASSES), 0.01),
}


@pytest.fixture(scope="module")
def family_vars():
    return {name: _np_tree(build().init(jax.random.PRNGKey(0)))
            for name, (build, _, _) in FAMILIES.items()}


def _jax_preproc_run(family, variables, optimizer, n):
    step = jft.make_preproc_train_step(FAMILIES[family][0](), optimizer, image_size=32,
                                       resize_short=36, compute_dtype=jnp.float32,
                                       donate=False)
    v = jax.tree_util.tree_map(jnp.asarray, variables)
    state = optimizer.init(v["params"])
    snaps, losses = {}, []
    for i, (canvas, sizes, labels) in enumerate(_batches(n)):
        v, state, metrics = step(v, state, canvas, sizes, labels)
        losses.append(float(metrics["loss"]))
        snaps[i + 1] = _np_tree(v)
    return snaps, losses


@pytest.fixture(scope="module")
def jax_steps(family_vars):
    """{(family, kind): (snapshots after each step, losses)}"""
    runs = {}
    for family, (_, _, lr) in FAMILIES.items():
        runs[family, "sgd"] = _jax_preproc_run(family, family_vars[family],
                                               jft.make_optimizer(lr=lr), 3)
    runs["convnext", "adamw"] = _jax_preproc_run(
        "convnext", family_vars["convnext"], jft.make_optimizer(lr=1e-3, kind="adamw"), 1)
    return runs


def _port_run(family, variables, config, n):
    model = _port(FAMILIES[family][1], variables)
    opt = tft.TrainOptimizer(model, config)
    step = tft.make_preproc_train_step(model, opt, 32, 36, torch.float32)
    losses = [float(step(*batch)["loss"]) for batch in _batches(n)]
    return model, losses


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("steps", [1, 3])
def test_sgd_steps_match_jax(family_vars, jax_steps, family, steps):
    snaps, ref_losses = jax_steps[family, "sgd"]
    model, losses = _port_run(family, family_vars[family],
                              tft.make_optimizer(lr=FAMILIES[family][2]), steps)
    np.testing.assert_allclose(losses, ref_losses[:steps], atol=ATOL, rtol=RTOL)
    _assert_same(model, snaps[steps])


def test_adamw_step_matches_jax(family_vars, jax_steps):
    snaps, ref_losses = jax_steps["convnext", "adamw"]
    model, losses = _port_run("convnext", family_vars["convnext"],
                              tft.make_optimizer(lr=1e-3, kind="adamw"), 1)
    np.testing.assert_allclose(losses, ref_losses, atol=ATOL, rtol=RTOL)
    _assert_same(model, snaps[1])


def test_finetuner_run_matches_jax(family_vars, tmp_path):
    """The slice as a whole: both FineTuners over the same batches, fp32."""
    batches = _batches(2, seed=5)
    variables = family_vars["resnet"]
    jtuner = jft.FineTuner(jax_resnet.ResNet(COUNTS, CLASSES), jft.make_optimizer(lr=0.01),
                           image_size=32, resize_short=36, compute_dtype=jnp.float32)
    jvars, _, jhist = jtuner.run(jax.tree_util.tree_map(jnp.asarray, variables), batches)
    model = _port_resnet(variables)
    tuner = tft.FineTuner(model, tft.make_optimizer(lr=0.01), image_size=32, resize_short=36,
                          compute_dtype=torch.float32, checkpoint_dir=tmp_path / "ck")
    _, _, hist = tuner.run(batches, checkpoint_every=1)
    assert [h["step"] for h in hist] == [h["step"] for h in jhist] == [1, 2]
    np.testing.assert_allclose([h["loss"] for h in hist], [h["loss"] for h in jhist],
                               atol=ATOL, rtol=RTOL)
    _assert_same(model, _np_tree(jvars))
    assert tuner.checkpoint.steps() == [1, 2]


# -- the optimizer's parts, fed the same gradients ---------------------------------------

def _grad_tree(model, seed):
    """Seeded random gradients for every parameter: (port dict, JAX tree)."""
    rng = np.random.default_rng(seed)
    grads = {n: torch.from_numpy(rng.normal(0, 1, tuple(p.shape)).astype(np.float32))
             for n, p in model.named_parameters()}
    return grads, jax.tree_util.tree_map(jnp.asarray,
                                         unflatten_variables(native_flat(grads))["params"])


def _convnext_vars():
    return _np_tree(jax_convnext.ConvNeXt(num_classes=CLASSES, **CONVNEXT).init(
        jax.random.PRNGKey(1)))


CASES = {
    "ema": (lambda: optax.chain(jft.make_optimizer(lr=0.1), jft.ema_params_transform(0.9)),
            dict(ema_decay=0.9), 3),
    "accum": (lambda: jft.make_grad_accum(jft.make_optimizer(lr=0.1), 2), dict(grad_accum=2), 4),
    "accum_ema": (lambda: jft.make_grad_accum(optax.chain(
        jft.make_optimizer(lr=0.1), jft.ema_params_transform(0.8)), 2),
        dict(grad_accum=2, ema_decay=0.8), 4),
    "probe": (lambda: jft.make_probe_optimizer(jft.make_optimizer(lr=0.1)),
              dict(linear_probe=True), 2),
    "llrd_adamw": (lambda: optax.chain(jft.make_optimizer(lr=1e-2, kind="adamw"),
                                       jft.llrd_transform(0.75)), dict(llrd=0.75), 2),
    "schedule": (lambda: jft.make_optimizer(lr=jft.make_lr_schedule(0.1, 6)), {}, 3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_parts_match_optax(case):
    make_ref, kw, updates = CASES[case]
    variables = _convnext_vars()
    model = _port(lambda: torch_convnext.ConvNeXt(num_classes=CLASSES, **CONVNEXT), variables)
    if case == "llrd_adamw":
        config = tft.make_optimizer(lr=1e-2, kind="adamw")
    elif case == "schedule":
        config = tft.make_optimizer(lr=tft.make_lr_schedule(0.1, 6))
    else:
        config = tft.make_optimizer(lr=0.1)
    opt = tft.TrainOptimizer(model, config, **kw)
    ref = make_ref()
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = ref.init(params)
    for i in range(updates):
        grads, jgrads = _grad_tree(model, i)
        for name, p in model.named_parameters():     # as backward would: accumulated
            p.grad = grads[name].clone() if p.grad is None else p.grad + grads[name]
        applied = opt.step()
        upd, state = ref.update(jgrads, state, params)
        params = optax.apply_updates(params, upd)
        assert applied == (i % kw.get("grad_accum", 1) == kw.get("grad_accum", 1) - 1)
        _assert_same(model, {"params": _np_tree(params), "state": {}}, atol=1e-6, rtol=1e-5)
    shadow = jft.find_ema_params(state)
    if "ema_decay" in kw:
        ours = tft.find_ema_params(opt.state_dict())
        ref_sd = weights.from_jax_variables({"params": _np_tree(shadow)})
        for name, e in ours.items():
            np.testing.assert_allclose(e.numpy(), ref_sd[name].numpy(), atol=1e-6, rtol=1e-5,
                                       err_msg=name)
    else:
        assert shadow is None and tft.find_ema_params(opt.state_dict()) is None


def test_replace_ema_params_reanchors_the_shadow():
    model = torch_convnext.ConvNeXt(num_classes=CLASSES, **CONVNEXT)
    model.init_weights(torch.Generator().manual_seed(0))
    opt = tft.TrainOptimizer(model, ema_decay=0.9)
    new = {n: torch.full_like(p, 0.5) for n, p in model.named_parameters()}
    state = tft.replace_ema_params(opt.state_dict(), new)
    assert all(torch.equal(e, new[n]) for n, e in state["ema"].items())
    plain = tft.TrainOptimizer(model).state_dict()
    assert tft.replace_ema_params(plain, new) is plain
    with pytest.raises(ValueError, match="ema_decay"):
        tft.TrainOptimizer(model, ema_decay=1.0)
    with pytest.raises(ValueError, match="acumular_gradientes"):
        tft.TrainOptimizer(model, grad_accum=0)


# -- LLRD and the decay mask by name --------------------------------------------------

def _families():
    return {
        "resnet": (jax_resnet.ResNet(COUNTS, CLASSES),
                   lambda: torch_resnet.ResNet(COUNTS, CLASSES)),
        "convnext": (jax_convnext.ConvNeXt(num_classes=CLASSES, **CONVNEXT),
                     lambda: torch_convnext.ConvNeXt(num_classes=CLASSES, **CONVNEXT)),
        "swin": (jax_swin.swin_micro(CLASSES), lambda: torch_swin.swin_micro(CLASSES)),
        "vit": (jax_vit.vit_tiny(CLASSES), lambda: torch_vit.vit_tiny(CLASSES)),
    }


@pytest.mark.parametrize("family", ["convnext", "resnet", "swin", "vit"])
def test_llrd_multipliers_and_decay_mask_match_by_name(family):
    jmodel, build = _families()[family]
    variables = _np_tree(jmodel.init(jax.random.PRNGKey(2)))
    model = _port(build, variables)
    params = variables["params"]
    names = [name for name, _, _ in weights._entries({"params": params})]
    ref = dict(zip(names, (float(m) for _, m in weights._walk(jft.llrd_multipliers(params,
                                                                                     0.8)))))
    assert tft.llrd_multipliers(model, 0.8) == pytest.approx(ref, rel=1e-12)
    assert len(set(ref.values())) > 2
    ranks = {name: leaf.ndim for name, leaf, _ in weights._entries({"params": params})}
    ours = dict(model.named_parameters())
    assert {n: p.dim() for n, p in ours.items()} == ranks
    opt = tft.TrainOptimizer(model, tft.make_optimizer(kind="adamw"), llrd=0.8)
    decayed = {id(p) for g in opt.optimizer.param_groups if g["weight_decay"] > 0
               for p in g["params"]}
    for name, p in ours.items():
        assert (id(p) in decayed) == (p.dim() > 1), name
    for name in ("rel_bias", "cls_token", "pos_embed"):
        hits = [n for n in ours if n.endswith(name)]
        assert all(id(ours[n]) in decayed for n in hits)
    with pytest.raises(ValueError, match="llrd"):
        tft.llrd_multipliers(model, 1.5)


# -- port-side semantics ------------------------------------------------------------------

def _convnext_pair():
    a = torch_convnext.ConvNeXt(num_classes=CLASSES, **CONVNEXT)
    a.init_weights(torch.Generator().manual_seed(3))
    b = torch_convnext.ConvNeXt(num_classes=CLASSES, **CONVNEXT)
    b.load_state_dict(a.state_dict())
    return a, b


def test_accumulating_two_halves_equals_one_step_on_the_whole_batch():
    a, b = _convnext_pair()
    rng = np.random.default_rng(4)
    images = torch.from_numpy(rng.normal(0, 1, (8, 32, 32, 3)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, CLASSES, 8))
    accum = tft.make_train_step(a, tft.TrainOptimizer(a, tft.make_optimizer(lr=0.1),
                                                      grad_accum=2), torch.float32)
    whole = tft.make_train_step(b, tft.TrainOptimizer(b, tft.make_optimizer(lr=0.1)),
                                torch.float32)
    accum(images[:4], labels[:4])
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))
    accum(images[4:], labels[4:])
    whole(images, labels)
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), atol=1e-6,
                                   rtol=1e-5, err_msg=name)


def test_probe_moves_the_head_only_and_freezes_the_statistics(family_vars):
    model = _port_resnet(family_vars["resnet"])
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = tft.TrainOptimizer(model, tft.make_optimizer(lr=0.1), linear_probe=True)
    step = tft.make_preproc_train_step(model, opt, 32, 36, torch.float32, train_backbone=False)
    for batch in _batches(2):
        step(*batch)
    for name, value in model.state_dict().items():
        moved = not torch.equal(value, before[name])
        assert moved == name.startswith("head."), name


def _resume_tuner(model, directory):
    return tft.FineTuner(
        model, tft.make_optimizer(lr=tft.make_lr_schedule(0.05, 4), kind="adamw"),
        image_size=32, compute_dtype=torch.float32, checkpoint_dir=directory, seed=7,
        augment=AugmentConfig(brightness=0.2, mixup_alpha=0.2, cutmix_alpha=1.0,
                              label_smoothing=0.1),
        ema_decay=0.9, grad_accum=2, llrd=0.8)


def test_a_resumed_run_equals_an_uninterrupted_one(tmp_path):
    a, b = _convnext_pair()
    batches = _batches(5, seed=9)
    whole_sd, whole_opt, whole = _resume_tuner(a, tmp_path / "a").run(batches)
    first = _resume_tuner(b, tmp_path / "b")
    first.run(batches[:3])                         # stops mid-accumulation
    c, _ = _convnext_pair()                        # fresh weights: all from the checkpoint
    c.init_weights(torch.Generator().manual_seed(11))
    sd, opt_state, rest = _resume_tuner(c, tmp_path / "b").run(batches[3:])
    assert [h["step"] for h in rest] == [4, 5]
    np.testing.assert_allclose([h["loss"] for h in rest], [h["loss"] for h in whole[3:]],
                               rtol=1e-6, atol=1e-7)
    for name, value in whole_sd.items():
        torch.testing.assert_close(sd[name], value, rtol=1e-6, atol=1e-7, msg=name)
    for name, e in whole_opt["ema"].items():
        torch.testing.assert_close(opt_state["ema"][name], e, rtol=1e-6, atol=1e-7, msg=name)
    assert opt_state["count"] == whole_opt["count"] == 2 and opt_state["micro"] == 1


def test_kernels_without_a_backward_are_turned_off_by_name(caplog):
    vit = torch_vit.vit_tiny(CLASSES)
    swin = torch_swin.swin_micro(CLASSES)
    convnext = torch_convnext.ConvNeXt(num_classes=CLASSES, **CONVNEXT)
    with caplog.at_level(logging.INFO, logger=tft.__name__):
        tuner = tft.FineTuner(vit)
        tft.FineTuner(swin)
        tft.FineTuner(convnext)
    assert vit.use_flash is False
    assert tuner.kernels == {"depthwise_conv": True, "window_attention": True,
                             "flash_attention": False, "bottleneck_chain": False}
    assert all(m.use_kernel for m in list(swin.modules()) + list(convnext.modules())
               if hasattr(m, "use_kernel"))
    notes = [r.getMessage() for r in caplog.records if r.name == tft.__name__]
    assert len(notes) == 3 and "flash_attention, bottleneck_chain off" in notes[0]
    # a mesh is taken since the training mesh was ported; one the step cannot
    # split a batch over (no 'data' axis, no 'sp' axis) is refused
    from ics_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(ValueError, match="'data' axis"):
        tft.FineTuner(convnext, mesh=make_mesh((2,), ("pp",), devices=["cpu"] * 2))
