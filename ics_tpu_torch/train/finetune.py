"""The fine-tuner (counterpart of ``ics_tpu/train/finetune.py``,
BASELINE.json config 5): losses, optimizers, train steps, the ``FineTuner``
loop, evaluation and calibration.

PyTorch's idiom in place of the reference's pure functions: the model holds
its weights and BatchNorm statistics, a ``TrainOptimizer`` (``torch.optim``
with parameter groups) updates them in place, and a step is a function of
(model, optimizer, batch). Mixed precision is the reference's: fp32 master
parameters and a forward in ``compute_dtype`` (the layers cast their
parameters to the activations' dtype, as the JAX layers do).

On the card the depthwise and window-attention kernels run forward and
backward in training. The flash-attention kernel and the fused bottleneck
chains have no backward, as the TPU kernels they replace have none: the
``FineTuner`` turns them off by name (``training_kernels``), as the
reference trains ViT on its plain attention and ResNet unfolded.

On a device mesh (``FineTuner(mesh=...)``, ``TPU_TRAIN_DEVICES``) the step is
the reference's sharded step, the same function as the unsharded step over
the whole batch, run the PyTorch way (``DataParallel``): the batch is split
into equal row chunks over the ``data`` positions, each position runs its
chunk through a copy of the model on its device, on a host thread and CUDA
stream of its own (``parallel.mesh.Rendezvous``), and BatchNorm takes its
statistics over the whole batch (``nn.layers.BatchNorm``). One backward over
the sum of the positions' losses (each its chunk's mean over the number of
positions) gives each copy its part of the gradient; the parts are summed
into the first copy, the model itself, whose one optimizer steps, and the
other copies take its parameters and statistics again. Augment draws its
plan for the whole batch on the host, and mixup's roll by one crosses the
chunks' edges through the positions' meeting. With a ``model`` axis the
head is not split by classes as the reference's ``shard_head_for_tp``
splits it: each ``data`` position trains the whole head, and the positions
of the ``model`` axis beyond the first stay idle (a deliberate divergence,
the same function; ``ROADMAP.md`` §3). A pure ``sp`` mesh is sequence
parallelism: the ViT blocks' attention rings the tokens over its positions
(``parallel.ring_attention``) and the batch stays whole.

The numpy parts (metrics, calibration) are the reference's, unchanged in
behaviour. ``fold_temperature`` works on the port's state dicts.
"""

from __future__ import annotations

import copy
import logging
import math
from typing import Any, Callable, NamedTuple, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# losses and step metrics
# ---------------------------------------------------------------------------

def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(logits.float(), labels.long())


def soft_cross_entropy_loss(logits: torch.Tensor, target_probs: torch.Tensor) -> torch.Tensor:
    """CE against probability rows [B, C], the mixup and label-smoothing form
    (``cross_entropy_loss`` on one-hot targets)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return (-(target_probs * logp).sum(dim=-1)).mean()


def sigmoid_bce_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Multi-label objective: per-class sigmoid BCE against [B, C] target
    probabilities, summed over classes and averaged over the batch."""
    per = F.binary_cross_entropy_with_logits(logits.float(), targets.float(), reduction="none")
    return per.sum(dim=-1).mean()


def multilabel_exact_match(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Fraction of rows whose 0.5-thresholded prediction equals the
    thresholded target set."""
    return ((logits >= 0.0) == (targets >= 0.5)).all(dim=-1).float().mean()


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

Schedule = Union[float, Callable[[int], float]]


class OptimizerConfig(NamedTuple):
    """What ``make_optimizer`` returns: the update rule, its learning rate (a
    float or a schedule of the update count), SGD's momentum and the weight
    decay of the parameters of rank 2 and more."""

    kind: str
    lr: Schedule
    momentum: float
    weight_decay: float


def make_optimizer(lr: Schedule = 0.01, momentum: float = 0.9,
                   weight_decay: Optional[float] = None, kind: str = "sgd") -> OptimizerConfig:
    """``"sgd"`` (momentum SGD, the conv recipe) or ``"adamw"`` (decoupled
    decay, the transformers' recipe). ``weight_decay=None`` is 1e-4 for SGD,
    0.05 for AdamW. Parameters of rank 1 (norm scales and shifts, biases) are
    not decayed: the reference's mask is ``ndim > 1`` of its leaves, and a
    port parameter has the rank of its JAX leaf."""
    if kind not in ("sgd", "adamw"):
        raise ValueError(f"otimizador desconhecido: {kind!r} (esperado 'sgd' ou 'adamw')")
    if weight_decay is None:
        weight_decay = 1e-4 if kind == "sgd" else 0.05
    return OptimizerConfig(kind, lr, float(momentum), float(weight_decay))


def make_lr_schedule(lr: float, total_steps: int, kind: str = "cosseno",
                     warmup_frac: float = 0.1) -> Schedule:
    """Linear warmup from 0 over about 10 % of the run, then cosine decay to
    1 % of the peak at ``total_steps`` (``optax.warmup_cosine_decay_schedule``).
    ``"constante"`` returns the float. The count is the optimizer's (updates
    applied), so a resumed run continues mid-curve."""
    if kind == "constante":
        return lr
    if kind != "cosseno":
        raise ValueError(f"agenda_lr desconhecida: {kind!r} (esperado 'cosseno' ou 'constante')")
    total = max(int(total_steps), 2)
    warmup = min(max(1, int(total * warmup_frac)), total - 1)
    peak, end = float(lr), float(lr) * 0.01

    def schedule(count: int) -> float:
        if count < warmup:
            return peak * count / warmup
        t = min(count - warmup, total - warmup) / (total - warmup)
        alpha = end / peak if peak else 0.0
        return peak * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * t)) + alpha)

    return schedule


# parameters that sit before the first block (depth 0, the smallest rate)
_LLRD_STEM_KEYS = {"stem", "stem_ln", "patch_embed", "patch_norm", "cls_token", "pos_embed"}
# stage boundaries (ConvNeXt's down[s] precedes stage s + 1, Swin's merges[s]
# follows stage s): pinned between the two stages
_LLRD_BOUNDARY_KEYS = {"down", "merges"}


def llrd_multipliers(names, decay: float) -> dict[str, float]:
    """Layer-wise learning-rate decay: the rate multiplier of each parameter
    name (``model.named_parameters()`` names, or a module), ``decay ** (L + 1
    - depth)`` with L the number of blocks.

    The depths are the reference's (``llrd_multipliers``): ``stem``-like keys
    0, ``blocks.i`` i + 1, ``stages.s.b`` the block's ordinal + 1,
    ``down.s``/``merges.s`` the first block of the next stage, anything else
    (head, final norms) L + 1. They read only a name's module path, which the
    port shares with the JAX tree: ``weights.py`` renames only the leaf."""
    if not (0.0 < decay <= 1.0):
        raise ValueError(f"llrd fora de (0, 1]: {decay!r}")
    if isinstance(names, nn.Module):
        names = [n for n, _ in names.named_parameters()]
    paths = [n.split(".") for n in names]
    stage_sizes: dict[int, int] = {}
    blocks = 0
    for p in paths:
        if p[0] == "stages" and len(p) > 1 and p[1].isdigit():
            s = int(p[1])
            size = int(p[2]) + 1 if len(p) > 2 and p[2].isdigit() else 1
            stage_sizes[s] = max(stage_sizes.get(s, 0), size)
        elif p[0] == "blocks" and len(p) > 1 and p[1].isdigit():
            blocks = max(blocks, int(p[1]) + 1)
    offs = [0]
    for s in range(max(stage_sizes) + 1 if stage_sizes else 0):
        offs.append(offs[-1] + stage_sizes.get(s, 0))
    total = offs[-1] if stage_sizes else blocks

    def depth_of(p) -> int:
        if p[0] in _LLRD_STEM_KEYS:
            return 0
        if p[0] == "blocks" and len(p) > 1 and p[1].isdigit():
            return int(p[1]) + 1
        if p[0] == "stages" and len(p) > 2 and p[1].isdigit() and p[2].isdigit():
            return offs[int(p[1])] + int(p[2]) + 1
        if p[0] in _LLRD_BOUNDARY_KEYS and len(p) > 1 and p[1].isdigit():
            return offs[min(int(p[1]) + 1, len(offs) - 1)]
        return total + 1

    return {".".join(p): float(decay) ** (total + 1 - depth_of(p)) for p in paths}


def _check_grad_accum(every: int) -> int:
    every = int(every)
    if every < 1:
        raise ValueError(f"acumular_gradientes deve ser >= 1: {every!r}")
    return every


def _check_ema_decay(decay: float) -> float:
    decay = float(decay)
    if decay and not (0.0 < decay < 1.0):
        raise ValueError(f"ema_decay fora de (0, 1): {decay!r}")
    return decay


class TrainOptimizer:
    """``torch.optim.SGD`` or ``AdamW`` over ``model``'s parameters in groups,
    with what the reference chains around its optax rule:

    - the learning rate from the config's schedule at the update count,
      which counts applied updates only;
    - ``llrd``: each group's rate times its layer-wise multiplier (after
      the base rule, so AdamW's decoupled decay is scaled too, as the
      reference's post-update scaling is);
    - ``linear_probe``: only ``head.*`` parameters train; the others get
      ``requires_grad_(False)``, so no gradient and no decay reaches them;
    - ``ema_decay``: a shadow of every parameter, ``e * d + p * (1 - d)``
      of the post-update parameters, at apply cadence;
    - ``grad_accum``: ``step`` applies on every ``grad_accum``-th call the
      mean of the gradients accumulated since (``optax.MultiSteps``); the
      calls between leave the parameters, the count and the shadow as they
      are.

    Weight decay as ``make_optimizer`` says: on the parameters of rank 2 and
    more only."""

    def __init__(self, model: nn.Module, config: Optional[OptimizerConfig] = None,
                 llrd: float = 0.0, linear_probe: bool = False, ema_decay: float = 0.0,
                 grad_accum: int = 1):
        self.config = config or make_optimizer()
        self.every = _check_grad_accum(grad_accum)
        self.ema_decay = _check_ema_decay(ema_decay)
        self.linear_probe = bool(linear_probe)
        self.params = dict(model.named_parameters())
        mults = (llrd_multipliers(list(self.params), llrd)
                 if llrd and llrd != 1.0 else {})
        groups: dict[tuple, list] = {}
        for name, p in self.params.items():
            if self.linear_probe and not name.startswith("head."):
                p.requires_grad_(False)
                continue
            key = (mults.get(name, 1.0), p.dim() > 1)
            groups.setdefault(key, []).append(p)
        param_groups = [
            {"params": ps, "lr_mult": mult,
             "weight_decay": self.config.weight_decay if decayed else 0.0}
            for (mult, decayed), ps in groups.items()
        ]
        if self.config.kind == "sgd":
            self.optimizer = torch.optim.SGD(param_groups, lr=0.0,
                                             momentum=self.config.momentum)
        else:
            self.optimizer = torch.optim.AdamW(param_groups, lr=0.0, betas=(0.9, 0.999),
                                               eps=1e-8)
        self.count = 0      # updates applied
        self.micro = 0      # gradients accumulated since the last update
        self.ema = ({n: p.detach().clone() for n, p in self.params.items()}
                    if self.ema_decay else None)
        self.optimizer.zero_grad(set_to_none=True)

    def step(self) -> bool:
        """One micro-step after ``backward``: applies the update on every
        ``grad_accum``-th call and returns whether it did."""
        self.micro += 1
        if self.micro < self.every:
            return False
        self.micro = 0
        if self.every > 1:
            with torch.no_grad():
                for group in self.optimizer.param_groups:
                    for p in group["params"]:
                        if p.grad is not None:
                            p.grad.div_(self.every)
        lr = self.config.lr
        lr = float(lr(self.count) if callable(lr) else lr)
        for group in self.optimizer.param_groups:
            group["lr"] = lr * group["lr_mult"]
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.count += 1
        if self.ema is not None:
            d = self.ema_decay
            with torch.no_grad():
                for name, e in self.ema.items():
                    e.mul_(d).add_(self.params[name].detach().to(e.dtype), alpha=1.0 - d)
        return True

    def state_dict(self) -> dict:
        """The optimizer's state, the update count, the EMA shadow and any
        gradients accumulated since the last update: what a resume needs to
        continue as an uninterrupted run would."""
        state: dict[str, Any] = {"optimizer": self.optimizer.state_dict(), "count": self.count,
                                 "micro": self.micro, "ema": self.ema}
        if self.micro:
            state["accumulated"] = {n: p.grad for n, p in self.params.items()
                                    if p.grad is not None}
        return state

    def load_state_dict(self, state: dict) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        self.count = int(state["count"])
        self.micro = int(state.get("micro", 0))
        if (state.get("ema") is None) != (self.ema is None):
            raise ValueError("the checkpoint's EMA setting differs from this run's")
        if self.ema is not None:
            for name, e in state["ema"].items():
                self.ema[name].copy_(e)
        for name, g in (state.get("accumulated") or {}).items():
            p = self.params[name]
            p.grad = g.to(device=p.device, dtype=p.dtype).clone()


def find_ema_params(opt_state: dict) -> Optional[dict]:
    """The EMA shadow of a ``TrainOptimizer.state_dict()``, or None."""
    return opt_state.get("ema") if isinstance(opt_state, dict) else None


def replace_ema_params(opt_state: dict, new_ema: dict) -> dict:
    """``opt_state`` with its EMA shadow replaced by copies of ``new_ema``
    (parameter name -> tensor); unchanged where it has no shadow. An
    early-stopped job that writes its best snapshot re-anchors the shadow on
    it, so that a resume does not average toward discarded weights."""
    if not isinstance(opt_state, dict) or opt_state.get("ema") is None:
        return opt_state
    out = dict(opt_state)
    out["ema"] = {k: new_ema[k].detach().clone() for k in opt_state["ema"]}
    return out


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

def _device_of(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _as_tensor(x, device: torch.device) -> torch.Tensor:
    t = torch.as_tensor(x) if not isinstance(x, torch.Tensor) else x
    return t.to(device, non_blocking=True)


def _accuracy(logits: torch.Tensor, labels: torch.Tensor, multi_label: bool) -> torch.Tensor:
    if multi_label:
        return multilabel_exact_match(logits, labels)
    return (logits.argmax(dim=-1) == labels).float().mean()


def _objective(logits: torch.Tensor, labels: torch.Tensor, targets: Optional[torch.Tensor],
               multi_label: bool) -> torch.Tensor:
    if multi_label:
        return sigmoid_bce_loss(logits, labels if targets is None else targets)
    if targets is None:
        return cross_entropy_loss(logits, labels)
    return soft_cross_entropy_loss(logits, targets)


def make_train_step(model: nn.Module, optimizer: TrainOptimizer,
                    compute_dtype: torch.dtype = torch.bfloat16, train_backbone: bool = True,
                    multi_label: bool = False):
    """``step(images, labels) -> {"loss", "accuracy"}`` (0-d tensors): one
    forward in ``compute_dtype`` on preprocessed [B, H, W, 3] images, the
    backward, and ``optimizer.step()``. BatchNorm runs in training mode and
    updates its running statistics; ``train_backbone=False`` (linear probe)
    runs the forward in eval mode instead. ``multi_label`` takes multi-hot
    [B, C] float targets, trains with per-class sigmoid BCE and reports the
    exact-match accuracy."""

    def step(images: torch.Tensor, labels: torch.Tensor, targets: Optional[torch.Tensor] = None):
        model.train(train_backbone)
        logits = model(images.to(compute_dtype))
        loss = _objective(logits, labels, targets, multi_label)
        loss.backward()
        optimizer.step()
        logits = logits.detach()
        return {"loss": loss.detach(), "accuracy": _accuracy(logits, labels, multi_label)}

    return step


def make_preproc_train_step(model: nn.Module, optimizer: TrainOptimizer, image_size: int = 224,
                            resize_short: int = 256,
                            compute_dtype: torch.dtype = torch.bfloat16,
                            train_backbone: bool = True, multi_label: bool = False):
    """``step(canvas_u8, sizes, labels)``: the uint8 canvas batch of
    ``train.data.batch_iterator`` preprocessed on the model's device
    (``ops.preproc.preprocess_batch``), then ``make_train_step``'s step."""
    from ics_tpu_torch.ops.preproc import preprocess_batch

    base_step = make_train_step(model, optimizer, compute_dtype, train_backbone, multi_label)
    device = _device_of(model)

    def step(canvas_u8, sizes, labels):
        canvas_u8, sizes, labels = (_as_tensor(t, device) for t in (canvas_u8, sizes, labels))
        images = preprocess_batch(canvas_u8, sizes, out_size=image_size,
                                  resize_short=resize_short, dtype=compute_dtype)
        return base_step(images, labels)

    return step


def make_augmented_train_step(model: nn.Module, optimizer: TrainOptimizer, augment,
                              image_size: int = 224,
                              compute_dtype: torch.dtype = torch.bfloat16,
                              train_backbone: bool = True, multi_label: bool = False):
    """``step(canvas_u8, sizes, labels, generator=None, plan=None, mix=None)``:
    the augmented step. The crop, flip and jitter (``plan``, an
    ``ops.augment.AugmentPlan``) and the mixing (``mix``, a ``MixPlan``) are
    drawn from ``generator`` where not given; the crop is taken from the
    image's full extent (``resize_short`` does not apply). Targets are the
    smoothed labels, mixed; the reported accuracy is against the original
    hard labels (mixup's lambda is folded to >= 0.5, so each row's own label
    stays the argmax target)."""
    from ics_tpu_torch.ops.augment import (
        apply_plan,
        draw_mix,
        draw_plan,
        mix_batch,
        smooth_labels,
        smooth_multilabel,
    )

    base_step = make_train_step(model, optimizer, compute_dtype, train_backbone, multi_label)
    device = _device_of(model)
    num_classes = model.num_classes

    def step(canvas_u8, sizes, labels, generator: Optional[torch.Generator] = None,
             plan=None, mix=None):
        canvas_u8, sizes, labels = (_as_tensor(t, device) for t in (canvas_u8, sizes, labels))
        if plan is None:
            plan = draw_plan(sizes, image_size, augment, generator)
        if mix is None:
            mix = draw_mix(augment, generator)
        images = apply_plan(canvas_u8, sizes, plan, image_size, augment, dtype=compute_dtype)
        if multi_label:
            targets = smooth_multilabel(labels.float(), augment.label_smoothing)
        else:
            targets = smooth_labels(labels, num_classes, augment.label_smoothing)
        images, targets = mix_batch(images, targets, mix)
        return base_step(images, labels, targets)

    return step


class DataParallel:
    """``model`` trained over the ``data`` positions of ``mesh``
    (``parallel.mesh.data_positions``; the module's docstring): ``model``
    itself, moved to the first position's device, and a copy of it on each
    other position's device. ``step`` runs one data-parallel step; after it
    every copy holds the model's parameters and statistics, bit for bit."""

    def __init__(self, model: nn.Module, mesh):
        from ics_tpu_torch.parallel.mesh import Rendezvous, data_positions

        self.positions = data_positions(mesh)
        model.to(self.positions[0].device)
        self.copies = [model] + [copy.deepcopy(model).to(pos.device)
                                 for pos in self.positions[1:]]
        self.group = Rendezvous(self.positions)

    def chunk(self, t: torch.Tensor, i: int) -> torch.Tensor:
        """Position ``i``'s rows of ``t``: equal chunks in position order, as
        ``batch_sharding`` lays a batch out; a batch they do not divide
        raises."""
        n = len(self.positions)
        if t.shape[0] % n:
            raise ValueError(f"dimension 0 of {tuple(t.shape)} does not split over data={n}")
        size = t.shape[0] // n
        return t.narrow(0, i * size, size)

    def rows(self, i: int, tensors) -> list:
        """Position ``i``'s chunk of each of ``tensors`` on its device (in its
        thread: the copy is ordered on its stream)."""
        dev = self.positions[i].device
        return [self.chunk(torch.as_tensor(t), i).to(dev, non_blocking=True) for t in tensors]

    def step(self, optimizer: TrainOptimizer, prepare: Callable, compute_dtype: torch.dtype,
             train_backbone: bool, multi_label: bool) -> dict:
        """One step: ``prepare(i, group) -> (images, labels, targets or None)``
        makes position ``i``'s chunk on its device (in its thread, under its
        stream); the forward, one backward, the gradients summed into the
        model, ``optimizer.step()``, and the copies made equal to the model
        again. Returns the step's metrics over the whole batch."""
        from ics_tpu_torch.nn.layers import release_statistics
        from ics_tpu_torch.parallel.mesh import Position, send

        group = self.group
        n = group.size

        def run(i: int):
            model = self.copies[i]
            model.train(train_backbone)
            images, labels, targets = prepare(i, group)
            logits = model(images.to(compute_dtype))
            loss = _objective(logits, labels, targets, multi_label) / n
            return loss, _accuracy(logits.detach(), labels, multi_label) / n

        parts = group.run(run)
        home = Position.current(self.positions[0].device)
        loss = torch.stack([send(l, pos, home) for (l, _), pos in zip(parts, self.positions)]).sum()
        accuracy = torch.stack([send(a, pos, home)
                                for (_, a), pos in zip(parts, self.positions)]).sum()
        try:
            loss.backward()
        finally:
            for model in self.copies:
                release_statistics(model)
        master = self.copies[0]
        for other in self.copies[1:]:
            for p, q in zip(master.parameters(), other.parameters()):
                if q.grad is not None:
                    g = q.grad.to(p.device)
                    p.grad = g if p.grad is None else p.grad.add_(g)
                    q.grad = None
        optimizer.step()
        with torch.no_grad():
            for other in self.copies[1:]:
                for p, q in zip(master.parameters(), other.parameters()):
                    q.copy_(p)
                for b, c in zip(master.buffers(), other.buffers()):
                    c.copy_(b)
        return {"loss": loss.detach(), "accuracy": accuracy}


def make_sharded_preproc_train_step(model: nn.Module, optimizer: TrainOptimizer, mesh,
                                    image_size: int = 224, resize_short: int = 256,
                                    compute_dtype: torch.dtype = torch.bfloat16,
                                    train_backbone: bool = True, multi_label: bool = False):
    """``make_preproc_train_step`` over the ``data`` positions of ``mesh``
    (``DataParallel``): the same ``step(canvas_u8, sizes, labels)``, each
    position preprocessing its rows. ``step.data_parallel`` is the copies."""
    from ics_tpu_torch.ops.preproc import preprocess_batch

    dp = DataParallel(model, mesh)

    def step(canvas_u8, sizes, labels):
        def prepare(i, group):
            canvas, sz, lab = dp.rows(i, (canvas_u8, sizes, labels))
            images = preprocess_batch(canvas, sz, out_size=image_size,
                                      resize_short=resize_short, dtype=compute_dtype)
            return images, lab, None

        return dp.step(optimizer, prepare, compute_dtype, train_backbone, multi_label)

    step.data_parallel = dp
    return step


def make_sharded_augmented_train_step(model: nn.Module, optimizer: TrainOptimizer, mesh,
                                      augment, image_size: int = 224,
                                      compute_dtype: torch.dtype = torch.bfloat16,
                                      train_backbone: bool = True, multi_label: bool = False):
    """``make_augmented_train_step`` over the ``data`` positions of ``mesh``:
    the same ``step(canvas_u8, sizes, labels, generator=None, plan=None,
    mix=None)``. The plan and the mixing are drawn for the whole batch on
    the host, as the unsharded step draws them, and each position takes its
    rows of the plan; mixup's and CutMix's roll by one takes each chunk's
    first neighbour from the previous position (``mix_batch``'s
    ``rolled``), so every row is mixed with the row the unsharded step mixes
    it with."""
    from ics_tpu_torch.ops.augment import (
        AugmentPlan,
        apply_plan,
        draw_mix,
        draw_plan,
        mix_batch,
        smooth_labels,
        smooth_multilabel,
    )

    dp = DataParallel(model, mesh)
    num_classes = model.num_classes

    def step(canvas_u8, sizes, labels, generator: Optional[torch.Generator] = None,
             plan=None, mix=None):
        if plan is None:
            plan = draw_plan(torch.as_tensor(sizes), image_size, augment, generator)
        if mix is None:
            mix = draw_mix(augment, generator)

        def prepare(i, group):
            canvas, sz, lab = dp.rows(i, (canvas_u8, sizes, labels))
            rows = AugmentPlan(*(dp.chunk(t, i) for t in plan))
            images = apply_plan(canvas, sz, rows, image_size, augment, dtype=compute_dtype)
            if multi_label:
                targets = smooth_multilabel(lab.float(), augment.label_smoothing)
            else:
                targets = smooth_labels(lab, num_classes, augment.label_smoothing)
            rolled = None
            if mix.kind is not None:
                prev = (i - 1) % group.size
                rolled = tuple(torch.cat([group.gather(i, t[-1:])[prev], t[:-1]])
                               for t in (images, targets))
            images, targets = mix_batch(images, targets, mix, rolled)
            return images, lab, targets

        return dp.step(optimizer, prepare, compute_dtype, train_backbone, multi_label)

    step.data_parallel = dp
    return step


def step_generator(seed: int, step: int) -> torch.Generator:
    """The augmentation's generator for step ``step`` (absolute) of a run
    seeded ``seed``: a resumed run draws the crops it would have drawn
    uninterrupted."""
    return torch.Generator().manual_seed(((int(seed) & 0xFFFFFFFF) << 32) | (int(step) & 0xFFFFFFFF))


def training_kernels(model: nn.Module) -> dict[str, bool]:
    """Set ``model``'s hand-written kernels for training, by name, and return
    which are on: the depthwise and window-attention kernels (forward and
    backward) stay on; the flash-attention kernel (``use_flash``) and the
    fused bottleneck chains (packed by ``fold`` for serving) have no
    backward and are turned off, as the reference trains ViT on its plain
    attention and ResNet unfolded."""
    for m in model.modules():
        if hasattr(m, "use_flash"):
            m.use_flash = False
        if isinstance(getattr(m, "chains", None), nn.ModuleDict):
            m.chains = nn.ModuleDict()
    return {"depthwise_conv": True, "window_attention": True,
            "flash_attention": False, "bottleneck_chain": False}


class FineTuner:
    """End-to-end fine-tune driver (BASELINE config 5): labelled batches ->
    steps -> checkpoints of the port (``train.checkpoint``)."""

    def __init__(self, model: nn.Module, optimizer: Optional[OptimizerConfig] = None,
                 image_size: int = 224, resize_short: int = 256,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 checkpoint_dir: Optional[str] = None, remat: Optional[bool] = None,
                 mesh: Any = None, augment: Any = None, seed: int = 0,
                 linear_probe: bool = False, multi_label: bool = False,
                 ema_decay: float = 0.0, grad_accum: int = 1, llrd: float = 0.0):
        # a mesh with an 'sp' axis is sequence parallelism: the ViT blocks'
        # attention rings the tokens over it and the step runs unsharded, the
        # batch whole. Pure-SP only, as the reference (DPxSP would gather the
        # batch across 'data' in every block; compose DP with grad_accum)
        if mesh is not None and "sp" in mesh.axis_names:
            if set(mesh.axis_names) != {"sp"}:
                raise ValueError(
                    "mesh de treino com 'sp' deve ser puro-SP (eixos "
                    f"{mesh.axis_names}) — DPxSP não é suportado"
                )
            blocks = getattr(model, "blocks", None)
            if not blocks or not hasattr(blocks[0], "attn") \
                    or not hasattr(blocks[0].attn, "ring"):
                raise ValueError(
                    "sequence parallelism requer um tronco transformer "
                    "com atenção ring-capaz (família ViT)"
                )
            for blk in blocks:
                blk.attn.ring = (mesh, "sp")
            mesh = None
        elif mesh is not None:
            from ics_tpu_torch.parallel.mesh import data_positions

            # the model lives on the first data position (data_positions
            # refuses a mesh with no 'data' axis)
            model.to(data_positions(mesh)[0].device)
        self.mesh = mesh
        self.model = model
        # per-block rematerialisation: the backward recomputes a block's
        # internals instead of keeping them. None leaves model.remat as it is
        if remat is not None:
            model.remat = bool(remat)
        self.optimizer = optimizer or make_optimizer()
        self._llrd = float(llrd)
        self._linear_probe = bool(linear_probe)
        self._ema_decay = _check_ema_decay(ema_decay)
        self._grad_accum = _check_grad_accum(grad_accum)
        self._multi_label = bool(multi_label)
        self._image_size = image_size
        self._resize_short = resize_short
        self._compute_dtype = compute_dtype
        self._augment = augment
        self._seed = int(seed)
        self.kernels = training_kernels(model)
        logger.info("fine-tune kernels: %s on (forward and backward); %s off (no backward, "
                    "as in the reference)",
                    ", ".join(k for k, on in self.kernels.items() if on),
                    ", ".join(k for k, on in self.kernels.items() if not on))
        self.checkpoint = None
        if checkpoint_dir:
            from ics_tpu_torch.train.checkpoint import CheckpointManager

            self.checkpoint = CheckpointManager(checkpoint_dir)
        self.best: Optional[dict] = None
        self.stopped_early = False

    def make_optimizer(self) -> TrainOptimizer:
        return TrainOptimizer(self.model, self.optimizer, llrd=self._llrd,
                              linear_probe=self._linear_probe, ema_decay=self._ema_decay,
                              grad_accum=self._grad_accum)

    def make_step(self, optimizer: TrainOptimizer):
        """The step over this tuner's mesh (``DataParallel``; its copies are
        made now, from the model's present state) or on the model's device."""
        if self.mesh is not None:
            if self._augment is not None:
                return make_sharded_augmented_train_step(
                    self.model, optimizer, self.mesh, self._augment, self._image_size,
                    self._compute_dtype, train_backbone=not self._linear_probe,
                    multi_label=self._multi_label)
            return make_sharded_preproc_train_step(
                self.model, optimizer, self.mesh, self._image_size, self._resize_short,
                self._compute_dtype, train_backbone=not self._linear_probe,
                multi_label=self._multi_label)
        if self._augment is not None:
            return make_augmented_train_step(
                self.model, optimizer, self._augment, self._image_size, self._compute_dtype,
                train_backbone=not self._linear_probe, multi_label=self._multi_label)
        return make_preproc_train_step(
            self.model, optimizer, self._image_size, self._resize_short, self._compute_dtype,
            train_backbone=not self._linear_probe, multi_label=self._multi_label)

    def run(self, batches, max_steps: Optional[int] = None, checkpoint_every: int = 100,
            start_step: int = 0, on_step: Optional[Callable] = None,
            should_stop: Optional[Callable] = None, eval_every: Optional[int] = None,
            eval_fn: Optional[Callable] = None, patience: int = 0):
        """Train on ``batches`` ((canvas, sizes, labels) of
        ``train.data.batch_iterator``) -> (the model's state dict, the
        optimizer's state, the history: one ``{"step", "loss", "accuracy"[,
        "eval"]}`` a step).

        A checkpoint directory that holds a step resumes from its newest:
        weights, BatchNorm statistics, optimizer state, schedule count and EMA
        shadow. Where that step is the JAX trainer's (orbax) it raises
        ``UnconvertedCheckpointError``, and where it holds no optimizer state
        (a step ``convert_checkpoints.py`` wrote) ``UnresumableCheckpointError``:
        neither trains from the start in its place.
        ``eval_fn(model, opt_state, step) -> (metric, state_dict)`` runs every
        ``eval_every`` steps (higher is better); the best eval's state dict
        is kept on the host in ``self.best``; with ``patience > 0`` the loop
        stops after that many evals without improvement
        (``self.stopped_early``)."""
        self.best = None
        self.stopped_early = False
        evals_since_best = 0
        optimizer = self.make_optimizer()
        newest = self.checkpoint.newest_step() if self.checkpoint is not None else None
        if newest is not None:
            restored = self.checkpoint.restore(newest)
            if restored.get("opt_state") is None:
                from ics_tpu_torch.train.checkpoint import UnresumableCheckpointError

                raise UnresumableCheckpointError(self.checkpoint.directory, newest)
            self.model.load_state_dict(restored["state_dict"])
            optimizer.load_state_dict(restored["opt_state"])
            start_step = int(restored.get("metadata", {}).get("step", 0))
        step_fn = self.make_step(optimizer)
        history = []
        step_num = start_step
        for canvas, sizes, labels in batches:
            if self._augment is not None:
                metrics = step_fn(canvas, sizes, labels, step_generator(self._seed, step_num))
            else:
                metrics = step_fn(canvas, sizes, labels)
            step_num += 1
            record = {"step": step_num, "loss": float(metrics["loss"]),
                      "accuracy": float(metrics["accuracy"])}
            early_exhausted = False
            if eval_fn is not None and eval_every and step_num % eval_every == 0:
                metric, eval_state = eval_fn(self.model, optimizer.state_dict(), step_num)
                if metric is not None:
                    record["eval"] = float(metric)
                    if self.best is None or float(metric) > self.best["metric"]:
                        self.best = {
                            "metric": float(metric), "step": step_num,
                            "state_dict": {k: v.detach().cpu().clone()
                                           for k, v in eval_state.items()},
                        }
                        evals_since_best = 0
                    else:
                        evals_since_best += 1
                        early_exhausted = patience > 0 and evals_since_best >= patience
            history.append(record)
            if on_step is not None:
                on_step(record)
            if self.checkpoint is not None and step_num % checkpoint_every == 0:
                self.checkpoint.save(step_num, self.model.state_dict(), optimizer.state_dict(),
                                     {"step": step_num})
            if early_exhausted:
                self.stopped_early = True
                break
            if max_steps is not None and step_num - start_step >= max_steps:
                break
            if should_stop is not None and should_stop():
                # cooperative cancellation between steps; the final
                # checkpoint below still runs, so the work is resumable
                break
        if self.checkpoint is not None and history:
            self.checkpoint.save(step_num, self.model.state_dict(), optimizer.state_dict(),
                                 {"step": step_num})
        return self.model.state_dict(), optimizer.state_dict(), history


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------

def _eval_logits(model: nn.Module, canvas_u8, sizes, image_size: int, resize_short: int,
                 compute_dtype: torch.dtype) -> torch.Tensor:
    from ics_tpu_torch.ops.preproc import preprocess_batch

    device = _device_of(model)
    model.eval()
    with torch.no_grad():
        images = preprocess_batch(_as_tensor(canvas_u8, device), _as_tensor(sizes, device),
                                  out_size=image_size, resize_short=resize_short,
                                  dtype=compute_dtype)
        return model(images).float()


def make_preproc_eval_step(model: nn.Module, image_size: int = 224, resize_short: int = 256,
                           compute_dtype: torch.dtype = torch.bfloat16):
    """``step(canvas_u8, sizes, labels, valid) -> (n_correct, n)``: the
    forward in eval mode, counted over the ``valid`` rows."""

    def step(canvas_u8, sizes, labels, valid):
        logits = _eval_logits(model, canvas_u8, sizes, image_size, resize_short, compute_dtype)
        labels = _as_tensor(labels, logits.device)
        valid = _as_tensor(valid, logits.device)
        correct = (logits.argmax(dim=-1) == labels) & valid
        return int(correct.sum()), int(valid.sum())

    return step


def evaluate(model: nn.Module, batches, image_size: int = 224, resize_short: int = 256,
             compute_dtype: torch.dtype = torch.bfloat16):
    """Accuracy over an eval iterator yielding (canvas, sizes, labels,
    n_real), ``batch_iterator(..., with_counts=True)``; padded rows masked."""
    step = make_preproc_eval_step(model, image_size, resize_short, compute_dtype)
    correct = total = 0
    for canvas, sizes, labels, n_real in batches:
        valid = torch.arange(len(labels)) < n_real
        c, t = step(canvas, sizes, labels, valid)
        correct += c
        total += t
    return (correct / total) if total else None, total


def make_multilabel_eval_step(model: nn.Module, image_size: int = 224,
                              resize_short: int = 256,
                              compute_dtype: torch.dtype = torch.bfloat16):
    """``step(canvas_u8, sizes) -> sigmoid probabilities [B, C]`` (fp32)."""

    def step(canvas_u8, sizes):
        return torch.sigmoid(_eval_logits(model, canvas_u8, sizes, image_size, resize_short,
                                          compute_dtype))

    return step


def collect_multilabel_scores(model: nn.Module, batches, image_size: int = 224,
                              resize_short: int = 256,
                              compute_dtype: torch.dtype = torch.bfloat16):
    """(probs [N, C], targets [N, C]) float32 numpy over the valid rows of an
    iterator yielding (canvas, sizes, multi_hot, n_real); (None, None) when
    it is empty."""
    step = make_multilabel_eval_step(model, image_size, resize_short, compute_dtype)
    probs_parts, target_parts = [], []
    for canvas, sizes, targets, n_real in batches:
        n = int(n_real)
        if n <= 0:
            continue
        probs_parts.append(step(canvas, sizes).cpu().numpy()[:n])
        target_parts.append(np.asarray(targets, np.float32)[:n])
    if not probs_parts:
        return None, None
    return np.concatenate(probs_parts), np.concatenate(target_parts)


def multilabel_metrics(probs, targets, threshold: float = 0.5) -> dict:
    """Micro-averaged multi-label metrics of ``probs >= threshold`` against
    multi-hot ``targets`` (both [N, C] numpy)."""
    pred = np.asarray(probs) >= threshold
    true = np.asarray(targets) >= 0.5
    tp = int(np.sum(pred & true))
    fp = int(np.sum(pred & ~true))
    fn = int(np.sum(~pred & true))
    precision = tp / (tp + fp) if (tp + fp) else 0.0
    recall = tp / (tp + fn) if (tp + fn) else 0.0
    f1 = (2 * precision * recall / (precision + recall) if (precision + recall) else 0.0)
    return {
        "f1_micro": f1,
        "exact_match": float(np.mean(np.all(pred == true, axis=-1))),
        "precision": precision,
        "recall": recall,
    }


# calibration needs enough positive labels to generalise: below this the
# sweep memorises the eval split and 0.5 is the safer serving choice
MIN_POSITIVES_FOR_CALIBRATION = 8


def make_logits_eval_step(model: nn.Module, image_size: int = 224, resize_short: int = 256,
                          compute_dtype: torch.dtype = torch.bfloat16):
    """``step(canvas_u8, sizes) -> logits [B, C]`` (fp32): one forward serves
    accuracy and temperature calibration."""

    def step(canvas_u8, sizes):
        return _eval_logits(model, canvas_u8, sizes, image_size, resize_short, compute_dtype)

    return step


def collect_logits(model: nn.Module, batches, image_size: int = 224, resize_short: int = 256,
                   compute_dtype: torch.dtype = torch.bfloat16):
    """(logits [N, C] float32, labels [N] int64) numpy over the valid rows of
    an iterator yielding (canvas, sizes, labels, n_real); (None, None) when
    it is empty."""
    step = make_logits_eval_step(model, image_size, resize_short, compute_dtype)
    logit_parts, label_parts = [], []
    for canvas, sizes, labels, n_real in batches:
        n = int(n_real)
        if n <= 0:
            continue
        logit_parts.append(step(canvas, sizes).cpu().numpy()[:n])
        label_parts.append(np.asarray(labels, np.int64)[:n])
    if not logit_parts:
        return None, None
    return np.concatenate(logit_parts), np.concatenate(label_parts)


def _log_softmax_np(logits):
    z = logits - logits.max(axis=-1, keepdims=True)
    return z - np.log(np.sum(np.exp(z), axis=-1, keepdims=True))


def nll_np(logits, labels, temperature: float = 1.0) -> float:
    """Mean negative log-likelihood of ``labels`` under
    ``softmax(logits / temperature)`` (numpy, numerically stable)."""
    logp = _log_softmax_np(np.asarray(logits, np.float64) / float(temperature))
    return float(-np.mean(logp[np.arange(len(labels)), labels]))


def per_class_metrics(logits, labels, num_classes: int) -> dict:
    """Confusion matrix (rows true, columns predicted) and per-class
    precision, recall, F1 and support; ``f1_macro`` over the classes with
    eval support only."""
    pred = np.asarray(logits).argmax(-1)
    true = np.asarray(labels)
    cm = np.zeros((num_classes, num_classes), np.int64)
    np.add.at(cm, (true, pred), 1)
    tp = np.diag(cm).astype(np.float64)
    support = cm.sum(axis=1)
    predicted = cm.sum(axis=0)
    with np.errstate(invalid="ignore", divide="ignore"):
        precision = np.where(predicted > 0, tp / np.maximum(predicted, 1), 0.0)
        recall = np.where(support > 0, tp / np.maximum(support, 1), 0.0)
        denom = precision + recall
        f1 = np.where(denom > 0, 2 * precision * recall / np.maximum(denom, 1e-12), 0.0)
    seen = support > 0
    por_classe = [
        {"classe": i, "precisao": float(precision[i]), "revocacao": float(recall[i]),
         "f1": float(f1[i]), "suporte": int(support[i])}
        for i in range(num_classes)
    ]
    return {
        "matriz_confusao": cm.tolist(),
        "por_classe": por_classe,
        "f1_macro": float(f1[seen].mean()) if seen.any() else 0.0,
    }


def multilabel_per_class_metrics(probs, targets, threshold: float = 0.5) -> list[dict]:
    """Per-class precision, recall, F1 and support of multi-label eval at the
    serving threshold."""
    pred = np.asarray(probs) >= threshold
    true = np.asarray(targets) >= 0.5
    tp = (pred & true).sum(axis=0).astype(np.float64)
    fp = (pred & ~true).sum(axis=0).astype(np.float64)
    fn = (~pred & true).sum(axis=0).astype(np.float64)
    out = []
    for i in range(pred.shape[1]):
        p = tp[i] / (tp[i] + fp[i]) if (tp[i] + fp[i]) else 0.0
        r = tp[i] / (tp[i] + fn[i]) if (tp[i] + fn[i]) else 0.0
        f1 = 2 * p * r / (p + r) if (p + r) else 0.0
        out.append({"classe": i, "precisao": float(p), "revocacao": float(r),
                    "f1": float(f1), "suporte": int(tp[i] + fn[i])})
    return out


def expected_calibration_error(probs, labels, bins: int = 10) -> float:
    """ECE: confidence-binned |accuracy - mean confidence| weighted by bin
    occupancy."""
    probs = np.asarray(probs)
    labels = np.asarray(labels)
    conf = probs.max(axis=-1)
    correct = (probs.argmax(axis=-1) == labels).astype(np.float64)
    edges = np.linspace(0.0, 1.0, bins + 1)
    n = len(labels)
    ece = 0.0
    for lo, hi in zip(edges[:-1], edges[1:]):
        mask = (conf > lo) & (conf <= hi) if lo > 0 else (conf <= hi)
        k = int(mask.sum())
        if k == 0:
            continue
        ece += (k / n) * abs(correct[mask].mean() - conf[mask].mean())
    return float(ece)


def calibrate_temperature(logits, labels,
                          min_examples: int = MIN_POSITIVES_FOR_CALIBRATION
                          ) -> tuple[float, dict]:
    """The softmax temperature minimising the eval split's NLL (golden-section
    search over s = 1/T, where the NLL is convex). Returns ``(T, metrics)``
    with NLL and ECE before and after; T = 1 when the split is smaller than
    ``min_examples`` or the fit does not improve the NLL."""
    logits = np.asarray(logits, np.float64)
    labels = np.asarray(labels)
    nll_t1 = nll_np(logits, labels, 1.0)
    probs_t1 = np.exp(_log_softmax_np(logits))
    ece_t1 = expected_calibration_error(probs_t1, labels)
    metrics = {
        "nll_sem_calibracao": nll_t1,
        "ece_sem_calibracao": ece_t1,
        "nll": nll_t1,
        "ece": ece_t1,
        "exemplos": int(len(labels)),
    }
    if len(labels) < min_examples:
        return 1.0, metrics

    def f(s: float) -> float:  # NLL over inverse temperature
        return nll_np(logits, labels, 1.0 / s)

    lo, hi = 0.05, 20.0  # T in [0.05, 20]
    phi = (math.sqrt(5.0) - 1.0) / 2.0
    a, b = lo, hi
    c, d = b - phi * (b - a), a + phi * (b - a)
    fc, fd = f(c), f(d)
    for _ in range(80):
        if fc < fd:
            b, d, fd = d, c, fc
            c = b - phi * (b - a)
            fc = f(c)
        else:
            a, c, fc = c, d, fd
            d = a + phi * (b - a)
            fd = f(d)
    s = (a + b) / 2.0
    temperature = 1.0 / s
    nll_t = nll_np(logits, labels, temperature)
    if nll_t >= nll_t1 - 1e-9:  # no real improvement: keep the identity
        return 1.0, metrics
    probs_t = np.exp(_log_softmax_np(logits / temperature))
    metrics["nll"] = nll_t
    metrics["ece"] = expected_calibration_error(probs_t, labels)
    return float(temperature), metrics


def fold_temperature(state_dict: dict, temperature) -> dict:
    """Fold a fitted softmax temperature into the classifier head:
    ``softmax(logits / T) == softmax((W / T) x + b / T)`` exactly, so
    calibrated serving costs nothing. A no-op for T None or 1. Returns a new
    dict; the tensors of the input are not written."""
    if not temperature or abs(float(temperature) - 1.0) < 1e-9:
        return state_dict
    inv = 1.0 / float(temperature)
    return {k: (v * inv if k in ("head.weight", "head.bias") else v)
            for k, v in state_dict.items()}


def calibrate_multilabel_threshold(probs, targets, grid=None,
                                   min_positives: int = MIN_POSITIVES_FOR_CALIBRATION
                                   ) -> tuple[float, dict]:
    """The global decision threshold maximising micro-F1 on the eval split
    (0.05..0.95; ties toward 0.5). 0.5 when the split has fewer than
    ``min_positives`` positive labels."""
    probs = np.asarray(probs)
    targets = np.asarray(targets)
    if int(np.sum(targets >= 0.5)) < min_positives:
        return 0.5, multilabel_metrics(probs, targets, 0.5)
    if grid is None:
        grid = np.round(np.arange(0.05, 0.951, 0.05), 2)
    best_t, best_m = 0.5, multilabel_metrics(probs, targets, 0.5)
    for t in grid:
        m = multilabel_metrics(probs, targets, float(t))
        better = m["f1_micro"] > best_m["f1_micro"] + 1e-12
        tie = abs(m["f1_micro"] - best_m["f1_micro"]) <= 1e-12
        if better or (tie and abs(t - 0.5) < abs(best_t - 0.5)):
            best_t, best_m = float(t), m
    return best_t, best_m


def evaluate_multilabel(model: nn.Module, batches, image_size: int = 224,
                        resize_short: int = 256, compute_dtype: torch.dtype = torch.bfloat16):
    """Multi-label metrics at the 0.5 threshold over an iterator yielding
    (canvas, sizes, multi_hot, n_real): ``(metrics, total)``, ``(None, 0)``
    when it is empty."""
    probs, targets = collect_multilabel_scores(model, batches, image_size, resize_short,
                                               compute_dtype)
    if probs is None:
        return None, 0
    return multilabel_metrics(probs, targets, 0.5), probs.shape[0]
