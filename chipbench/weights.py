"""Weights from the seed, made on the device in a few large calls, as the
state dict that both the program and the reference are given.

Every tensor of the reference's parameter list is drawn from one normal
sample: He's scale for convolutions (sqrt(2 / fan_in)), 1 / sqrt(fan_in)
for dense layers and the head, 0.02 for biases and embeddings, 1 +- 0.1
for the normalisations' scales. Random weights alone make a classifier
whose answer hardly depends on the image (a random ResNet maps every image
to nearly one direction), and then no comparison of answers could see a
fault in decoding or preprocessing. So the start is data-dependent, done by
the reference on a batch of the run's own images: every BatchNorm's
running statistics are set to that batch's, and the head is centred on the
batch's mean feature and scaled to logits of standard deviation
``LOGIT_STD``.

Random filters on the pixels pass a pixel's rounding as strongly as the
image's content, and a random ResNet then swings its answer on a
least-significant bit of input. So the filters that read the pixels (the
stem convolution, the patch embedding) are drawn smooth: each spatial
kernel blurred by a Gaussian of ``STEM_BLUR`` pixels and brought back to
its drawn standard deviation.
"""

from __future__ import annotations

import math

import torch

from chipbench.reference import models, preprocess

LOGIT_STD = 3.0
STEM_BLUR = 1.5
BRANCH_SCALE = 0.5
CALIBRATION_IMAGES = 32

_SCALES = {
    # kind: (mean, std); None means std from the fan-in
    "conv": (0.0, None), "stem": (0.0, None), "dense": (0.0, None), "head": (0.0, None),
    "bn_weight": (1.0, 0.1), "bn_weight_branch": (BRANCH_SCALE, 0.1 * BRANCH_SCALE), "bn_bias": (0.0, 0.1), "ln_weight": (1.0, 0.1),
    "bias": (0.0, 0.02), "embed": (0.0, 0.02), "zero": (0.0, 0.0), "one": (1.0, 0.0),
}


def _smooth(w: torch.Tensor) -> torch.Tensor:
    """Each [k, k] kernel of ``w`` [O, I, k, k] blurred (zero padding), at
    the tensor's standard deviation."""
    o, i, k, _ = w.shape
    x = torch.arange(k, dtype=torch.float32, device=w.device) - (k - 1) / 2
    g = torch.exp(-0.5 * (x / STEM_BLUR) ** 2)
    g = (g[:, None] * g[None, :]) / g.sum() ** 2
    out = torch.nn.functional.conv2d(w.reshape(o * i, 1, k, k), g[None, None], padding=k // 2)
    out = out[..., :k, :k].reshape(w.shape)
    return out * (w.std() / out.std().clamp_min(1e-30))


class Weights:
    """The parameters as float32 views of one buffer, made on ``device``;
    ``to_host`` moves the buffer off the card while the program runs, and
    ``on(device)`` brings the views back for the reference."""

    def __init__(self, cfg: dict, seed: int, device) -> None:
        self.cfg = cfg
        self.spec = models.param_spec(cfg)
        self.device = device
        numels = [math.prod(shape) for _, shape, _, _ in self.spec]
        means, stds = [], []
        for _, _, kind, fan_in in self.spec:
            mean, std = _SCALES[kind]
            if std is None:
                gain = math.sqrt(2.0) if kind == "conv" else 1.0
                std = gain / math.sqrt(fan_in)
            means.append(mean)
            stds.append(std)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed % 2**64)
        counts = torch.tensor(numels, device=device)
        flat = torch.randn(sum(numels), generator=gen, device=device, dtype=torch.float32)
        flat.mul_(torch.repeat_interleave(torch.tensor(stds, device=device), counts))
        flat.add_(torch.repeat_interleave(torch.tensor(means, device=device), counts))
        self.flat = flat
        self._numels = numels
        with torch.no_grad():
            for (name, _, kind, _), w in zip(self.spec, self.state_dict().values()):
                if kind == "stem":
                    w.copy_(_smooth(w))

    def state_dict(self, flat: torch.Tensor | None = None) -> dict:
        flat = self.flat if flat is None else flat
        out, at = {}, 0
        for (name, shape, _, _), n in zip(self.spec, self._numels):
            out[name] = flat[at:at + n].view(shape)
            at += n
        return out

    @torch.no_grad()
    def calibrate(self, blobs: list[bytes]) -> None:
        """The data-dependent start, in place (see the module's docstring)."""
        sd = self.state_dict()
        x = preprocess.preprocess(blobs[:CALIBRATION_IMAGES], self.cfg, self.device)
        f = models.features(self.cfg, sd, x, calibrate=True)
        mean = f.mean(dim=0)
        w = sd["head.weight"]
        centred = (f - mean) @ w.t()
        w.mul_(LOGIT_STD / centred.std().clamp_min(1e-12))
        sd["head.bias"].copy_(-(w @ mean))

    def to_host(self) -> None:
        self.flat = self.flat.cpu()

    def on(self, device) -> dict:
        return self.state_dict(self.flat.to(device))
