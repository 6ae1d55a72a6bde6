"""The layers of the ported models, as PyTorch modules (counterpart of
``ics_tpu/nn/layers.py``).

Activations stay NHWC at the public functions, as in the JAX package, so
the tests compare like with like. Parameters use PyTorch's layouts (conv
OIHW, linear [out, in]); ``ics_tpu_torch.weights`` maps the JAX layouts
(HWIO, [in, out]) onto them. ``reset_parameters(generator)`` draws the same
distributions as the JAX initialisers, from a ``torch.Generator``.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Union

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ics_tpu_torch.ops.depthwise import depthwise_conv_taps, flip_taps, kernel_taps


def trunc_normal_(t: torch.Tensor, generator: Optional[torch.Generator],
                  std: float = 0.02) -> torch.Tensor:
    """JAX's ``truncated_normal``: a unit normal cut at +-2, times ``std``."""
    return nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                                 generator=generator)


def kaiming_normal_(t: torch.Tensor, fan_in: int,
                    generator: Optional[torch.Generator]) -> torch.Tensor:
    return nn.init.normal_(t, std=math.sqrt(2.0 / fan_in), generator=generator)


def reset_all_parameters(model: nn.Module,
                         generator: Optional[torch.Generator]) -> nn.Module:
    """Seeded random weights with the JAX initialisers' distributions, for
    every layer of ``model`` that has ``reset_parameters``."""
    for module in model.modules():
        if module is not model and hasattr(module, "reset_parameters"):
            module.reset_parameters(generator)
    return model


class Conv2D(nn.Module):
    """Convolution on NHWC input, weight OIHW, computed by cuDNN: the JAX
    package left its convolutions to XLA, outside Pallas.

    The one exception is the depthwise convolution the JAX package wrote a
    kernel for: stride 1, odd kernel, ``groups == in_ch == out_ch``, padding
    ``k // 2``. On a CUDA tensor it goes to the hand-written kernel
    (``ics_tpu_torch.ops.depthwise``), bias included; on the CPU it is the
    same ``F.conv2d`` as every other convolution. ``use_kernel = False``
    (``set_use_kernels``) sends it to cuDNN on the card too, for measuring
    the two side by side. The kernel reads its taps as a dense [k * k, C]
    tensor in the activation's dtype: the module makes it once beside its
    weight (``kernel_operands``) and again only when the weight has moved,
    been cast or been written; the parameter and the state dict stay OIHW.
    The flipped taps of the input gradient (``flip_taps``) are kept beside
    them, under the same key: under autograd the kernel's backward launches
    the kernel on them for the input gradient, and the parameter-gradient
    kernel for the weight's and the bias's (in fp32, in their layout). An
    optimizer step writes the parameters in place, which moves their version
    counters: the next forward makes the taps anew.

    ``padding`` is symmetric, as an int; ``"SAME"`` is taken where it is
    symmetric too (stride 1 with an odd kernel, or a 1x1 kernel at any
    stride). XLA's asymmetric SAME at stride 2 is not ported: the models
    that stride a 3x3 or 7x7 name their padding (``k // 2``). An NHWC tensor
    seen as NCHW is ``channels_last`` memory, so the two permutes are views
    and cuDNN runs its NHWC kernels without a copy.
    """

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 padding: Union[int, str] = 0, groups: int = 1,
                 use_bias: bool = True, device=None):
        super().__init__()
        if padding == "SAME":
            if kernel != 1 and (stride != 1 or kernel % 2 == 0):
                raise ValueError(
                    f"SAME padding is asymmetric for kernel {kernel} at stride "
                    f"{stride}; name the padding"
                )
            padding = kernel // 2
        self.stride = stride
        self.padding = int(padding)
        self.groups = groups
        self.depthwise = (
            groups == in_ch == out_ch and stride == 1 and kernel > 1
            and kernel % 2 == 1 and self.padding == kernel // 2
        )
        self.use_kernel = True
        self.kernel_size = kernel
        self._kernel_operands: Optional[tuple] = None   # (key, taps, bias, flipped taps)
        self.weight = nn.Parameter(
            torch.empty(out_ch, in_ch // groups, kernel, kernel, device=device)
        )
        if use_bias:
            self.bias = nn.Parameter(torch.empty(out_ch, device=device))
        else:
            self.register_parameter("bias", None)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        kaiming_normal_(self.weight, self.weight[0].numel(), generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def _apply(self, fn, *args, **kwargs):
        self._kernel_operands = None   # a move or a cast: the taps are made anew
        return super()._apply(fn, *args, **kwargs)

    def kernel_operands(self, dtype: torch.dtype) -> tuple:
        """(taps [k * k, C], bias [C] or None) in ``dtype`` on the weight's
        device, as the depthwise kernel reads them. Kept until the weight or
        the bias is replaced or written in place (``load_state_dict`` writes
        in place: the version counter tells)."""
        return self._operands(dtype)[:2]

    def _operands(self, dtype: torch.dtype) -> tuple:
        """(taps, bias, flipped taps) of ``kernel_operands``, made and kept
        together."""
        w, b = self.weight, self.bias
        # (a tensor made under inference_mode has no version counter: it
        # cannot be written in place either)
        key = (dtype,) + tuple(
            (t.data_ptr(), 0 if t.is_inference() else t._version)
            for t in (w, b) if t is not None)
        cached = self._kernel_operands
        if cached is None or cached[0] != key:
            with torch.no_grad():
                taps = kernel_taps(w.detach(), w.shape[0], dtype)
                bias = None if b is None else b.detach().to(dtype).contiguous()
                flipped = flip_taps(taps, self.kernel_size)
            cached = self._kernel_operands = (key, taps, bias, flipped)
        return cached[1:]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.depthwise and self.use_kernel and x.is_cuda:
            taps, bias, flipped = self._operands(x.dtype)
            return depthwise_conv_taps(x.contiguous(), taps, bias, self.kernel_size, flipped,
                                       self.weight, self.bias)
        bias = None if self.bias is None else self.bias.to(x.dtype)
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype), bias,
                     self.stride, self.padding, 1, self.groups)
        return y.permute(0, 2, 3, 1)


class Dense(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, use_bias: bool = True,
                 init: str = "xavier", device=None):
        super().__init__()
        self.init_kind = init
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim, device=device))
        if use_bias:
            self.bias = nn.Parameter(torch.empty(out_dim, device=device))
        else:
            self.register_parameter("bias", None)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        if self.init_kind == "trunc_normal":
            trunc_normal_(self.weight, generator)
        elif self.init_kind == "kaiming":
            kaiming_normal_(self.weight, self.weight.shape[1], generator)
        else:
            nn.init.xavier_uniform_(self.weight, generator=generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class LayerNorm(nn.Module):
    """LayerNorm with fp32 statistics and affine, cast back to the input
    dtype (``ics_tpu/nn/layers.py:181-187``)."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim, device=device))
        self.bias = nn.Parameter(torch.empty(dim, device=device))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.weight.shape, self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(x.dtype)


class BatchNorm(nn.Module):
    """BatchNorm with running statistics (``ics_tpu/nn/layers.py:126-162``),
    over the last (channel) dimension of an NHWC tensor. ``momentum`` is
    PyTorch's: 0.1 here is the JAX package's 0.9. The forward normalises
    with the running statistics unless the module is in training mode;
    serving folds it away (``fold_batchnorm``).

    In a data-parallel step (``statistics_over``) the batch statistics are
    the whole batch's, as in the reference's one program over the mesh: the
    mean from every position's sums, then the variance from every
    position's sums of squared deviations from it (two passes, as
    ``jnp.var``). The parts come through the group's ``gather``, so the
    gradient reaches every position's rows. The backward's recomputation of
    a rematerialised block meets no other position: it takes the parts the
    forward gathered, with its own part recomputed, and so repeats the
    forward's operations on the same values."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, device=None):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.empty(num_features, device=device))
        self.bias = nn.Parameter(torch.empty(num_features, device=device))
        self.register_buffer("running_mean", torch.empty(num_features, device=device))
        self.register_buffer("running_var", torch.empty(num_features, device=device))
        self._shared: Optional[_SharedStatistics] = None   # this step's, in a DP step

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)
        nn.init.zeros_(self.running_mean)
        nn.init.ones_(self.running_var)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            x32 = x.float().reshape(-1, x.shape[-1])
            mean, var = self._batch_statistics(x32)
            # the backward's recomputation of a rematerialised block sees the
            # same batch again: the statistics move once a step
            if not recomputing():
                with torch.no_grad():
                    self.running_mean.lerp_(mean.to(self.running_mean.dtype), self.momentum)
                    self.running_var.lerp_(var.to(self.running_var.dtype), self.momentum)
        else:
            mean, var = self.running_mean.float(), self.running_var.float()
        scale = self.weight.float() * torch.rsqrt(var + self.eps)
        bias = self.bias.float() - mean * scale
        return x * scale.to(x.dtype) + bias.to(x.dtype)

    def _batch_statistics(self, x32: torch.Tensor) -> tuple:
        """(mean, biased variance) per channel of the batch: of ``x32``'s rows,
        or in a data-parallel step of every position's (the class's
        docstring)."""
        if not recomputing():
            self._shared = _SharedStatistics.current()
        shared = self._shared
        if shared is None:
            return x32.mean(dim=0), x32.var(dim=0, unbiased=False)
        rows = x32.shape[0] * shared.group.size      # the chunks are equal
        mean = shared.total(0, x32.sum(dim=0)) / rows
        d = x32 - mean
        return mean, shared.total(1, (d * d).sum(dim=0)) / rows


_statistics = threading.local()


@contextlib.contextmanager
def statistics_over(group, index: int):
    """In this thread, BatchNorm in training mode takes its batch statistics
    over every position of ``group`` (``parallel.mesh.Rendezvous``), this
    thread being position ``index``."""
    before = getattr(_statistics, "at", None)
    _statistics.at = (group, index)
    try:
        yield
    finally:
        _statistics.at = before


class _SharedStatistics:
    """One BatchNorm call's meeting with the other positions: ``total(k,
    part)`` sums every position's ``part`` in position order. In the forward
    the parts come from ``group.gather`` and are kept; the backward's
    recomputation takes the kept parts with its own ``part`` in its place."""

    def __init__(self, group, index: int):
        self.group = group
        self.index = index
        self.kept: list = [None, None]

    @classmethod
    def current(cls) -> Optional["_SharedStatistics"]:
        at = getattr(_statistics, "at", None)
        return None if at is None else cls(*at)

    def total(self, k: int, part: torch.Tensor) -> torch.Tensor:
        if recomputing():
            parts = list(self.kept[k])
            parts[self.index] = part
        else:
            parts = self.group.gather(self.index, part)
            self.kept[k] = [p.detach() for p in parts]
        return torch.stack(parts).sum(dim=0)

    def __deepcopy__(self, memo):
        return None     # a step's meeting is no part of a copy of the model


def release_statistics(model: nn.Module) -> None:
    """Drop what a data-parallel step's BatchNorm layers kept for the
    backward (call after it)."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m._shared = None


_remat = threading.local()


def recomputing() -> bool:
    """Whether this thread is inside the backward's recomputation of a
    rematerialised block (``run_block``)."""
    return getattr(_remat, "on", False)


@contextlib.contextmanager
def _recomputation():
    before = recomputing()
    _remat.on = True
    try:
        yield
    finally:
        _remat.on = before


def run_block(remat: bool, block, *args):
    """``block(*args)``; with ``remat`` and autograd recording, rematerialised
    (the ``remat`` flag of the JAX models, ``jax.checkpoint`` per block): the
    block keeps only its inputs for the backward, which runs its forward
    again. BatchNorm updates its running statistics in the first forward
    only (``recomputing``)."""
    if not (remat and torch.is_grad_enabled()):
        return block(*args)
    return torch.utils.checkpoint.checkpoint(
        block, *args, use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(), _recomputation()))


def fold_batchnorm(bn: BatchNorm) -> tuple[torch.Tensor, torch.Tensor]:
    """(scale, bias) in fp32 of a BatchNorm at its running statistics, with
    the layer's own eps (``ics_tpu/nn/layers.py:165-169``)."""
    scale = bn.weight.detach().float() * torch.rsqrt(bn.running_var.float() + bn.eps)
    bias = bn.bias.detach().float() - bn.running_mean.float() * scale
    return scale, bias


def max_pool(x: torch.Tensor, window: int = 3, stride: int = 2,
             padding: int = 1) -> torch.Tensor:
    """Max pooling on NHWC with symmetric padding that never wins the max
    (PyTorch's implicit -inf), as ``ics_tpu/nn/layers.py:190-203``."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride, padding)
    return y.permute(0, 2, 3, 1)


def avg_pool(x: torch.Tensor, window: int = 2, stride: int = 2) -> torch.Tensor:
    """Average pooling on NHWC, unpadded (VALID), every window counted whole:
    the torch ``AvgPool2d(k, s)`` of DenseNet's transitions
    (``ics_tpu/nn/layers.py:206-217``). The sums are taken in fp32 and the
    mean rounded once to the input's dtype, as the reference's are."""
    y = F.avg_pool2d(x.permute(0, 3, 1, 2).float(), window, stride)
    return y.to(x.dtype).permute(0, 2, 3, 1)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=(1, 2))


relu = F.relu
silu = F.silu


def gelu(x: torch.Tensor, exact: bool = True) -> torch.Tensor:
    """GELU whose exactness follows the dtype, as in the JAX package: erf
    under fp32, the tanh approximation under bf16/fp16, where its error is
    below rounding. ``exact=False`` takes the approximation whatever the
    dtype."""
    approximate = (not exact) or x.dtype in (torch.bfloat16, torch.float16)
    return F.gelu(x, approximate="tanh" if approximate else "none")


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)


def hard_swish(x: torch.Tensor) -> torch.Tensor:
    return x * hard_sigmoid(x)


def set_use_kernels(module: nn.Module, on: bool) -> nn.Module:
    """Send every layer of ``module`` that has a hand-written kernel to it
    (the default) or, with ``on=False``, to its library or plain counterpart
    on the card too: the depthwise ``Conv2D`` to cuDNN, Swin's window
    attention to its plain version. For measuring the two side by side;
    nothing on a served path turns the kernels off."""
    for m in module.modules():
        if hasattr(m, "use_kernel"):
            m.use_kernel = on
    return module
