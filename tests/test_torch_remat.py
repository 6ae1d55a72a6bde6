"""``remat`` in the port's models (``nn.layers.run_block``), mirroring
``tests/test_remat.py``: a rematerialised training step gives the same loss
and gradients as the plain one (fp32 on the CPU: the recomputation repeats
the same operations, 1e-6), every BatchNorm's running statistics move once
(equal to the plain step's, and moved), and each block's forward really runs
a second time in the backward."""

import numpy as np
import pytest
import torch

from ics_tpu_torch.models import convnext, densenet, regnet, resnet, swin, vit
from ics_tpu_torch.train.finetune import training_kernels

MODELS = {
    "resnet": (lambda: resnet.ResNet((1, 2, 1, 1), 6), 32, "stages"),
    "vit": (lambda: vit.vit_tiny(6), 64, "blocks"),
    "convnext": (lambda: convnext.ConvNeXt((1, 2, 1, 1), (8, 16, 24, 32), 6), 32, "stages"),
    "swin": (lambda: swin.swin_micro(6), 64, "stages"),
    "densenet": (lambda: densenet.densenet_micro(6), 32, "stages"),
    "regnet": (lambda: regnet.regnet_micro(6), 32, "stages"),
}


def _count_calls(model, where) -> list:
    first = getattr(model, where)[0]
    block = first[0] if isinstance(first, torch.nn.ModuleList) else first
    calls, forward = [], block.forward

    def counted(*args):
        calls.append(1)
        return forward(*args)

    block.forward = counted
    return calls


def _step(model, images, labels):
    model.train()
    loss = torch.nn.functional.cross_entropy(model(images), labels)
    loss.backward()
    return float(loss.detach()), {n: p.grad.clone() for n, p in model.named_parameters()
                         if p.grad is not None}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_remat_step_equals_the_plain_step(name):
    build, size, where = MODELS[name]
    plain = build()
    plain.init_weights(torch.Generator().manual_seed(0))
    training_kernels(plain)
    rematted = build()
    training_kernels(rematted)
    rematted.load_state_dict(plain.state_dict())
    rematted.remat = True
    before = {k: v.clone() for k, v in plain.state_dict().items() if "running" in k}
    calls = _count_calls(rematted, where)
    rng = np.random.default_rng(1)
    images = torch.from_numpy(rng.normal(0, 1, (4, size, size, 3)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 6, 4))
    loss, grads = _step(plain, images, labels)
    loss_r, grads_r = _step(rematted, images, labels)
    assert len(calls) == 2                          # the forward, and the backward's again
    assert loss_r == pytest.approx(loss, rel=1e-6)
    assert grads.keys() == grads_r.keys() and len(grads) == len(list(plain.parameters()))
    for n in grads:
        torch.testing.assert_close(grads_r[n], grads[n], rtol=1e-6, atol=1e-6, msg=n)
    stats, stats_r = plain.state_dict(), rematted.state_dict()
    for k, v in before.items():
        assert not torch.equal(stats[k], v), k      # moved ...
        torch.testing.assert_close(stats_r[k], stats[k], rtol=0, atol=0, msg=k)   # ... once
    assert (len(before) > 0) == (name in ("resnet", "densenet", "regnet"))


def test_remat_off_without_autograd():
    model = resnet.ResNet((1, 1, 1, 1), 6)
    model.init_weights(torch.Generator().manual_seed(0))
    model.remat = True
    calls = _count_calls(model, "stages")
    with torch.no_grad():
        model.eval()(torch.zeros(1, 32, 32, 3))
    assert len(calls) == 1
