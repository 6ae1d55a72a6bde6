"""The port's training mesh (``TPU_TRAIN_DEVICES``, ``train.finetune.DataParallel``)
against the JAX package's, on the CPU, mirroring ``tests/test_train_mesh.py``.

- ``train_mesh_from_settings`` takes the reference's decisions on every case
  of the reference's test (which devices, by position; the exception types
  and messages), and warns of an overlap with the serving mesh as it does.
- A data-parallel step of ``resnet_tiny``'s shape (a ResNet of one bottleneck
  a stage) at fp32 on 2 and 4 CPU positions equals both the port's
  unsharded step and the JAX package's sharded step over
  ``jax.devices()[4:4+n]`` (``train_mesh_from_settings``): losses,
  parameters and BatchNorm statistics at atol 2e-4, rtol 1e-4, plain, with
  augment and mixup (the port fed the plan the JAX key draws, as
  ``tests/test_torch_augment.py`` does), and with ``remat`` on (held to the
  JAX sharded step with it off: ``jax.checkpoint`` computes the same
  function). The copies on the positions hold the same bits after each
  step. The random ResNet's gradient is shattered (``tests/test_torch_finetune.py``),
  so these steps run at lr 0.01 on batches of 8 at 32 px, that file's recipe,
  and the augment case against JAX crops the whole image (flips, mixup and
  label smoothing on): a crop's resize differs between the two frameworks by
  rounding, which this ResNet amplifies past the tolerance in the port's
  unsharded step as much as in its data-parallel one (about 11x at the
  default crop range, either way). The data-parallel step at the default
  crop range is held to the port's unsharded step below.
- The same step with BatchNorm's statistics taken per position misses the
  unsharded step: the check bites.
- A ConvNeXt and a Swin at micro widths, and every option ``FineTuner``
  takes (AdamW with LLRD, EMA, gradient accumulation, the linear probe,
  multi-label, augment with CutMix, and the ResNet with augment and mixup at
  the default crop range), give the unsharded run's losses and weights on a
  data mesh (1e-4).
- A ``("data", "model")`` mesh trains the head whole on each data position
  where the reference splits it by classes (a deliberate divergence): the
  same function, held to the JAX sharded step.
- Evaluation, ``self.best`` and the checkpoint after mesh training (one copy
  of the weights), a resume on the mesh equal to an uninterrupted run
  (1e-5), and a job that refuses a batch the training mesh's device count
  does not divide (and trains on the mesh where it divides).
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ics_tpu.core.config import Settings as JaxSettings
from ics_tpu.models import resnet as jax_resnet
from ics_tpu.ops import augment as jaug
from ics_tpu.parallel import mesh as jax_mesh
from ics_tpu.train import finetune as jft
from ics_tpu_torch import weights
from ics_tpu_torch.core.config import Settings
from ics_tpu_torch.models import convnext as torch_convnext
from ics_tpu_torch.models import resnet as torch_resnet
from ics_tpu_torch.models import swin as torch_swin
from ics_tpu_torch.nn import layers
from ics_tpu_torch.ops import augment as taug
from ics_tpu_torch.parallel import mesh as port_mesh
from ics_tpu_torch.train import finetune as tft
from ics_tpu_torch.train.pretrained import native_flat, unflatten_variables

ATOL, RTOL = 2e-4, 1e-4
COUNTS, CLASSES, LR, STEPS = (1, 1, 1, 1), 6, 0.01, 2
SIZE, SHORT = 32, 36
JAX_AUG = jaug.AugmentConfig(scale_range=(1.0, 1.0), ratio_range=(1.0, 1.0), flip_prob=0.5,
                             mixup_alpha=0.4, label_smoothing=0.1)
PORT_AUG = taug.AugmentConfig(scale_range=(1.0, 1.0), ratio_range=(1.0, 1.0), flip_prob=0.5,
                              mixup_alpha=0.4, label_smoothing=0.1)
AUG_SEED = 7


class _S:
    def __init__(self, spec):
        self.TPU_TRAIN_DEVICES = spec


def _cuda(n):
    return [torch.device("cuda", i) for i in range(n)]


def _cpu(n):
    return ["cpu"] * n


# -- TPU_TRAIN_DEVICES ------------------------------------------------------------------

_SPECS = ["", "all", "4:8", "7:8", "x,y", "9:12", "6", ":3", "5:", "3:3", "a:b"]


@pytest.mark.parametrize("spec", _SPECS)
def test_train_mesh_from_settings_decides_as_the_reference(spec):
    try:
        ref, ref_exc = jax_mesh.train_mesh_from_settings(_S(spec)), None
    except (ValueError, RuntimeError) as exc:
        ref, ref_exc = None, exc
    if ref_exc is not None:
        with pytest.raises(type(ref_exc)) as got:
            port_mesh.train_mesh_from_settings(_S(spec), devices=_cuda(8))
        assert str(got.value) == str(ref_exc)
        return
    port = port_mesh.train_mesh_from_settings(_S(spec), devices=_cuda(8))
    if ref is None:
        assert port is None
        return
    assert port.axis_names == ref.axis_names == ("data",)
    assert [d.index for d in port.devices.flat] == [d.id for d in ref.devices.flat]
    # CPU positions share one name: the slice is taken by position
    cpu = port_mesh.train_mesh_from_settings(_S(spec), devices=_cpu(8))
    assert cpu.size == ref.devices.size


_OVERLAPS = [
    ({"TPU_TRAIN_DEVICES": "6:8"}, True),                            # auto serves on all 8
    ({"TPU_TRAIN_DEVICES": "6:8", "TPU_MESH_SHAPE": "6"}, False),   # isolated
    ({"TPU_TRAIN_DEVICES": "4:8", "TPU_MESH_SHAPE": "6"}, True),
    ({"TPU_TRAIN_DEVICES": "all", "TPU_PP_STAGES": "2"}, True),
    ({"TPU_TRAIN_DEVICES": "2:4", "TPU_MESH_SHAPE": "16"}, False),  # serving raises alone
]


@pytest.mark.parametrize("env,overlaps", _OVERLAPS, ids=[str(e) for e, _ in _OVERLAPS])
@pytest.mark.parametrize("devices", ["cuda", "cpu"])
def test_an_overlap_with_the_serving_mesh_is_warned_as_the_reference(caplog, env, overlaps,
                                                                     devices):
    with caplog.at_level(logging.WARNING):
        ref = jax_mesh.train_mesh_from_settings(JaxSettings(**env))
        port = port_mesh.train_mesh_from_settings(Settings(**env), devices=_cuda(8) if
                                                  devices == "cuda" else _cpu(8))
    assert port.size == ref.devices.size
    said = {r.name: r.getMessage() for r in caplog.records if "overlaps" in r.getMessage()}
    assert said.get("ics_tpu_torch.parallel.mesh") == said.get("ics_tpu.parallel.mesh")
    assert ("ics_tpu_torch.parallel.mesh" in said) == overlaps


# -- the data-parallel step against the unsharded one and the JAX sharded one ------------

def _batches(n=STEPS, b=8, canvas=48, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (b, canvas, canvas, 3), np.uint8),
             rng.integers(32, canvas + 1, (b, 2)).astype(np.int32),
             rng.integers(0, CLASSES, b).astype(np.int32)) for _ in range(n)]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def variables():
    """A seeded ResNet's variables as the JAX tree (``native_flat``, the
    inverse of ``weights.from_jax_variables``)."""
    model = torch_resnet.ResNet(COUNTS, CLASSES).init_weights(torch.Generator().manual_seed(0))
    return unflatten_variables(native_flat(model.state_dict()))


def _jax_plan_and_mix(i, sizes):
    """The plan and the mixup the JAX augmented step draws at step ``i``
    (``FineTuner.run``'s key), as the port's ``AugmentPlan`` and ``MixPlan``."""
    key = jax.random.fold_in(jax.random.PRNGKey(AUG_SEED), i)
    k_aug, k_mix = jax.random.split(key)
    rows = []
    for j, (h, w) in enumerate(sizes):
        k_geom, k_color = jax.random.split(jax.random.fold_in(k_aug, j))
        (sy, oy), (sx, ox), flip = jaug._crop_flip_plan(k_geom, h, w, SIZE, JAX_AUG)
        rows.append([float(sy), float(oy), float(sx), float(ox), bool(flip), 1.0, 1.0, 1.0])
    plan = taug.AugmentPlan(*(torch.tensor(c, dtype=torch.bool if j == 4 else torch.float32)
                              for j, c in enumerate(zip(*rows))))
    lam = float(jax.random.beta(k_mix, JAX_AUG.mixup_alpha, JAX_AUG.mixup_alpha))
    return plan, taug.MixPlan("mixup", max(lam, 1.0 - lam)), key


_JAX_RUNS: dict = {}


def _jax_sharded(variables, n, augment):
    """(variables after each step, losses) of the JAX package's sharded step on
    the training slice ``4:4+n``, cached for the module."""
    key = (n, augment)
    if key not in _JAX_RUNS:
        mesh = jax_mesh.train_mesh_from_settings(_S(f"4:{4 + n}"))
        model = jax_resnet.ResNet(COUNTS, CLASSES)
        optimizer = jft.make_optimizer(lr=LR)
        if augment:
            jit_step, shard = jft.make_sharded_augmented_train_step(
                model, optimizer, mesh, JAX_AUG, SIZE, jnp.float32)
        else:
            jit_step, shard = jft.make_sharded_preproc_train_step(
                model, optimizer, mesh, SIZE, SHORT, jnp.float32)
        v = jax.tree_util.tree_map(jnp.asarray, variables)
        v, state, _ = shard(v, optimizer.init(v["params"]))
        step = jit_step(v, state)
        snaps, losses = [], []
        for i, (canvas, sizes, labels) in enumerate(_batches()):
            extra = (_jax_plan_and_mix(i, sizes)[2],) if augment else ()
            v, state, metrics = step(v, state, canvas, sizes, labels, *extra)
            losses.append(float(metrics["loss"]))
            snaps.append(_np_tree(v))
        _JAX_RUNS[key] = (snaps, losses)
    return _JAX_RUNS[key]


def _port_model(variables, remat=False):
    model = torch_resnet.ResNet(COUNTS, CLASSES)
    model.load_state_dict(weights.from_jax_variables(variables), strict=True)
    model.remat = remat
    return model


def _port_run(variables, mesh, augment=False, remat=False):
    """(model, losses, step) of the port's step over ``mesh`` (None:
    unsharded), fp32."""
    model = _port_model(variables, remat)
    opt = tft.TrainOptimizer(model, tft.make_optimizer(lr=LR))
    if augment:
        step = (tft.make_sharded_augmented_train_step(model, opt, mesh, PORT_AUG, SIZE,
                                                      torch.float32) if mesh is not None
                else tft.make_augmented_train_step(model, opt, PORT_AUG, SIZE, torch.float32))
    else:
        step = (tft.make_sharded_preproc_train_step(model, opt, mesh, SIZE, SHORT, torch.float32)
                if mesh is not None
                else tft.make_preproc_train_step(model, opt, SIZE, SHORT, torch.float32))
    losses = []
    for i, batch in enumerate(_batches()):
        if augment:
            plan, mix, _ = _jax_plan_and_mix(i, batch[1])
            losses.append(float(step(*batch, plan=plan, mix=mix)["loss"]))
        else:
            losses.append(float(step(*batch)["loss"]))
        if mesh is not None:
            _assert_copies_equal(step.data_parallel)
    return model, losses, step


def _assert_copies_equal(dp):
    master = dp.copies[0].state_dict()
    for other in dp.copies[1:]:
        for name, t in other.state_dict().items():
            assert torch.equal(t, master[name]), name


def _assert_same(model, variables, atol=ATOL, rtol=RTOL):
    ours = model.state_dict()
    for name, ref in weights.from_jax_variables(variables).items():
        np.testing.assert_allclose(ours[name].detach().numpy(), ref.numpy(), atol=atol,
                                   rtol=rtol, err_msg=name)


def _dp_mesh(n):
    return port_mesh.train_mesh_from_settings(_S(f"4:{4 + n}"), devices=_cpu(8))


_VARIANTS = {"plain": (False, False), "augment_mixup": (True, False), "remat": (False, True)}


@pytest.mark.parametrize("variant", sorted(_VARIANTS))
@pytest.mark.parametrize("n", [2, 4])
def test_dp_step_matches_the_unsharded_and_the_jax_sharded_step(variables, n, variant):
    augment, remat = _VARIANTS[variant]
    snaps, jax_losses = _jax_sharded(variables, n, augment)
    model, losses, step = _port_run(variables, _dp_mesh(n), augment, remat)
    assert [len(c.state_dict()) for c in step.data_parallel.copies] == [len(model.state_dict())] * n
    np.testing.assert_allclose(losses, jax_losses, atol=ATOL, rtol=RTOL)
    _assert_same(model, snaps[-1])
    single, single_losses, _ = _port_run(variables, None, augment, remat)
    np.testing.assert_allclose(losses, single_losses, atol=ATOL, rtol=RTOL)
    for name, t in single.state_dict().items():
        np.testing.assert_allclose(model.state_dict()[name].numpy(), t.numpy(), atol=ATOL,
                                   rtol=RTOL, err_msg=name)


def test_batch_statistics_per_position_would_miss_the_unsharded_step(variables, monkeypatch):
    """The check of the test above bites: each position's BatchNorm taking its
    own chunk's statistics (no meeting) moves the losses and the running
    statistics past the tolerance."""
    monkeypatch.setattr(layers._SharedStatistics, "current", classmethod(lambda cls: None))
    model, losses, _ = _port_run(variables, _dp_mesh(4))
    single, single_losses, _ = _port_run(variables, None)
    loss_gap = np.abs(np.asarray(losses) - single_losses)
    stats = [n for n in single.state_dict() if n.endswith("running_var")]
    stat_gap = max(float((model.state_dict()[n] - single.state_dict()[n]).abs().max())
                   for n in stats)
    assert loss_gap.max() > ATOL + RTOL * max(single_losses) and stat_gap > 10 * ATOL


def test_a_data_model_mesh_trains_the_head_whole_on_each_data_position(variables):
    """(data 2, model 2), a head of 6 classes: the reference lays the head out
    split by classes over 'model' (``shard_head_for_tp``); the port trains it
    whole on each of the two data positions, the model positions beyond the
    first idle. A layout, not another function: the step equals the JAX
    sharded step over two data positions."""
    jmesh = jax_mesh.make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4])
    layout = jax_mesh.shard_head_for_tp(jmesh, variables["params"])["head"]["w"]
    assert tuple(layout.spec) == (None, "model")
    snaps, jax_losses = _jax_sharded(variables, 2, False)
    mesh = port_mesh.make_mesh((2, 2), ("data", "model"), devices=_cpu(4))
    model, losses, step = _port_run(variables, mesh)
    dp = step.data_parallel
    assert dp.positions == [mesh.positions[0, 0], mesh.positions[1, 0]]
    assert all(c.head.weight.shape == (CLASSES, 2048) for c in dp.copies)
    np.testing.assert_allclose(losses, jax_losses, atol=ATOL, rtol=RTOL)
    _assert_same(model, snaps[-1])


# -- other families and every option of FineTuner -----------------------------------------

CONVNEXT = dict(depths=(1, 2, 1, 1), dims=(8, 16, 24, 32))
_OPTIONS = {
    "convnext_adamw_llrd": ("convnext", dict(optimizer=("adamw", 1e-3), llrd=0.75)),
    "convnext_ema_accum": ("convnext", dict(ema_decay=0.9, grad_accum=2)),
    "convnext_cutmix": ("convnext", dict(augment=taug.AugmentConfig(cutmix_alpha=1.0,
                                                                    label_smoothing=0.1))),
    "swin_micro": ("swin", {}),
    "resnet_augment_mixup": ("resnet", dict(augment=taug.AugmentConfig(
        flip_prob=0.5, mixup_alpha=0.4, label_smoothing=0.1))),
    "resnet_linear_probe": ("resnet", dict(linear_probe=True)),
    "resnet_multi_label": ("resnet", dict(multi_label=True)),
}


def _family(name):
    gen = torch.Generator().manual_seed(3)
    if name == "convnext":
        return torch_convnext.ConvNeXt(num_classes=CLASSES, **CONVNEXT).init_weights(gen)
    if name == "swin":
        return torch_swin.swin_micro(CLASSES).init_weights(gen)
    return torch_resnet.ResNet(COUNTS, CLASSES).init_weights(gen)


@pytest.mark.parametrize("option", sorted(_OPTIONS))
def test_finetuner_on_a_data_mesh_composes_with_every_option(option):
    family, kw = _OPTIONS[option]
    kw = dict(kw)
    kind, lr = kw.pop("optimizer", ("sgd", LR))
    size = 32 if family != "swin" else 64
    rng = np.random.default_rng(4)
    batches = []
    for _ in range(2):
        canvas = rng.integers(0, 256, (8, size + 16, size + 16, 3), np.uint8)
        sizes = rng.integers(size, size + 17, (8, 2)).astype(np.int32)
        labels = ((rng.random((8, CLASSES)) < 0.4).astype(np.float32)
                  if kw.get("multi_label") else rng.integers(0, CLASSES, 8).astype(np.int32))
        batches.append((canvas, sizes, labels))
    runs = []
    for mesh in (None, port_mesh.make_mesh((2,), ("data",), devices=_cpu(2))):
        model = _family(family)
        tuner = tft.FineTuner(model, tft.make_optimizer(lr=lr, kind=kind), image_size=size,
                              resize_short=size + 4, compute_dtype=torch.float32, mesh=mesh,
                              seed=2, **kw)
        sd, opt, hist = tuner.run(iter(batches))
        runs.append((sd, opt, [h["loss"] for h in hist], [h["accuracy"] for h in hist]))
    (sd0, opt0, l0, a0), (sd1, opt1, l1, a1) = runs
    np.testing.assert_allclose(l1, l0, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(a1, a0, atol=1e-6)
    for name, t in sd0.items():
        np.testing.assert_allclose(sd1[name].numpy(), t.numpy(), atol=1e-4, rtol=1e-4,
                                   err_msg=name)
    if kw.get("ema_decay"):
        assert opt1["count"] == opt0["count"] == 1
        for name, e in opt0["ema"].items():
            np.testing.assert_allclose(opt1["ema"][name].numpy(), e.numpy(), atol=1e-4,
                                       rtol=1e-4, err_msg=name)


# -- after mesh training: eval, checkpoint, the job -------------------------------------

def test_eval_and_checkpoint_accept_the_mesh_trained_model(tmp_path):
    """Three steps on the training slice 4:8 of eight CPU positions, then
    ``evaluate`` and the checkpoint: one copy of the weights (the model's own
    names), restored equal to the model."""
    from ics_tpu_torch.train.checkpoint import CheckpointManager

    model = torch_resnet.resnet_tiny(num_classes=4).init_weights(torch.Generator().manual_seed(0))
    tuner = tft.FineTuner(model, image_size=64, resize_short=64, compute_dtype=torch.float32,
                          mesh=port_mesh.train_mesh_from_settings(_S("4:8"), devices=_cpu(8)),
                          checkpoint_dir=str(tmp_path / "ckpt"))
    rng = np.random.default_rng(0)
    batches = [(rng.integers(0, 256, (8, 64, 64, 3), np.uint8), np.full((8, 2), 64, np.int32),
                rng.integers(0, 4, (8,)).astype(np.int32)) for _ in range(3)]
    seen = []

    def eval_fn(m, opt_state, step):
        seen.append(m is model)
        return float(step), m.state_dict()

    sd, opt_state, history = tuner.run(iter(batches), eval_every=1, eval_fn=eval_fn)
    assert len(history) == 3 and all(np.isfinite(h["loss"]) for h in history)
    assert seen == [True] * 3 and tuner.best["step"] == 3
    eval_batches = [(rng.integers(0, 256, (4, 64, 64, 3), np.uint8), np.full((4, 2), 64, np.int32),
                     rng.integers(0, 4, (4,)).astype(np.int32), 4) for _ in range(2)]
    acc, total = tft.evaluate(model, iter(eval_batches), image_size=64, resize_short=64,
                              compute_dtype=torch.float32)
    assert total == 8 and 0.0 <= acc <= 1.0
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.newest_step() == 3
    restored = mgr.restore(3)
    assert set(restored["state_dict"]) == set(model.state_dict())
    for name, t in model.state_dict().items():
        assert torch.equal(restored["state_dict"][name], t), name
    assert restored["opt_state"]["count"] == opt_state["count"] == 3
    # a run on the mesh resumes from that checkpoint as an uninterrupted one would
    more = (rng.integers(0, 256, (8, 64, 64, 3), np.uint8), np.full((8, 2), 64, np.int32),
            rng.integers(0, 4, (8,)).astype(np.int32))
    resumed = torch_resnet.resnet_tiny(num_classes=4)
    tuner = tft.FineTuner(resumed, image_size=64, resize_short=64, compute_dtype=torch.float32,
                          mesh=port_mesh.train_mesh_from_settings(_S("4:8"), devices=_cpu(8)),
                          checkpoint_dir=str(tmp_path / "ckpt"))
    _, _, hist = tuner.run(iter([more]))
    whole = torch_resnet.resnet_tiny(num_classes=4).init_weights(torch.Generator().manual_seed(0))
    tuner = tft.FineTuner(whole, image_size=64, resize_short=64, compute_dtype=torch.float32,
                          mesh=port_mesh.train_mesh_from_settings(_S("4:8"), devices=_cpu(8)))
    _, _, whole_hist = tuner.run(iter(batches + [more]))
    assert [h["step"] for h in hist] == [4]
    np.testing.assert_allclose(hist[0]["loss"], whole_hist[-1]["loss"], rtol=1e-5, atol=1e-6)
    for name, t in whole.state_dict().items():
        np.testing.assert_allclose(resumed.state_dict()[name].numpy(), t.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_a_job_on_the_training_mesh_refuses_a_batch_it_cannot_split(tmp_path, monkeypatch):
    """``TPU_TRAIN_DEVICES=all`` over three CPU positions and a batch of 4: the
    job fails with the reference's message; over two it trains on the mesh."""
    from ics_tpu_torch.core.config import reload_settings
    from tests.test_torch_job import TINY, seeded_manager, wait

    manager, id_amb = seeded_manager(tmp_path)
    reload_settings(TPU_TRAIN_DEVICES="all")
    try:
        monkeypatch.setattr(port_mesh, "visible_devices", lambda: _cpu(3))
        job = wait(manager.start(id_amb, "resnet_tiny", **TINY))
        assert job.status == "falhou"
        assert job.error == ("batch_size=4 não divide pelos 3 devices de treino "
                             "(TPU_TRAIN_DEVICES='all')")
        monkeypatch.setattr(port_mesh, "visible_devices", lambda: _cpu(2))
        built = []
        real = tft.DataParallel.__init__

        def spy(self, model, mesh):
            built.append(mesh.shape)
            real(self, model, mesh)

        monkeypatch.setattr(tft.DataParallel, "__init__", spy)
        job = wait(manager.start(id_amb, "resnet_tiny", **TINY))
        assert job.status == "concluido", job.to_dict()
        assert built == [{"data": 2}] and len(job.history) == TINY["max_steps"]
    finally:
        reload_settings()


def test_an_error_on_one_position_is_raised_and_the_group_runs_again():
    """A position that fails while another waits at the meeting: the error is
    raised by ``run`` (no position left waiting), and the same group, on the
    same threads, runs the next step."""
    group = port_mesh.Rendezvous(port_mesh.make_mesh((2,), ("data",), devices=_cpu(2))
                                 .positions.flat)

    def fails_on_one(i):
        if i == 1:
            raise ValueError("position 1 failed")
        return group.gather(i, torch.ones(1))

    with pytest.raises(ValueError, match="position 1 failed"):
        group.run(fails_on_one)
    import threading

    names = group.run(lambda i: (threading.current_thread().name,
                                 float(torch.stack(group.gather(i, torch.full((1,), i + 1.0)))
                                       .sum())))
    assert [total for _, total in names] == [3.0, 3.0]
    assert all(name.startswith("position") for name, _ in names)
    assert {n for n, _ in names} == {n for n, _ in group.run(
        lambda i: (threading.current_thread().name, group.gather(i, torch.ones(1))))}


def test_the_meetings_hand_each_position_every_part_under_thread_switches():
    """Sixteen positions (more than this machine's cores) meet 50 times with
    the interpreter switching threads every microsecond: every position gets
    every position's part, in position order, each time."""
    import sys

    n = 16
    group = port_mesh.Rendezvous(port_mesh.make_mesh((n,), ("data",), devices=_cpu(n))
                                 .positions.flat)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = group.run(lambda i: [[float(t) for t in group.gather(i, torch.tensor(
            float(i * 1000 + k)))] for k in range(50)])
    finally:
        sys.setswitchinterval(interval)
    want = [[float(j * 1000 + k) for j in range(n)] for k in range(50)]
    assert got == [want] * n
