"""Kernels of the port and their plain PyTorch versions.

Each kernel wrapper counts its launches in ``LAUNCHES`` (one per kernel
launch, nowhere else), so a run can show that a path went through the
kernel and not through the plain version. ``/inferencia/status`` reports
the counts and ``chip_smoke.py`` reads them. The backward passes count apart
from their forwards: ``depthwise_conv_dx`` (the depthwise kernel on flipped
taps) and ``window_attention_bwd``.

Gradients: every kernel entry either runs under a ``torch.autograd.Function``
whose backward is a kernel too (depthwise, window attention), or raises
``KernelHasNoGradient`` when grad mode is on and an input requires grad
(flash attention, the bottleneck chain), on the CPU as on the card. None
returns an output cut off from its inputs.
"""

from __future__ import annotations

import threading


class LaunchCounter:
    """Launch count of one kernel. Engine steps run on executor threads, so
    the increment takes a lock."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0

    @property
    def value(self) -> int:
        return self._value

    def add(self) -> None:
        with self._lock:
            self._value += 1

    def reset(self) -> int:
        """Set the count to 0 and return what it was."""
        with self._lock:
            value, self._value = self._value, 0
            return value


LAUNCHES: dict[str, LaunchCounter] = {
    name: LaunchCounter()
    for name in ("flash_attention", "bottleneck_chain", "normalize_u8",
                 "depthwise_conv", "window_attention", "flash_attention_bf16_exp",
                 "depthwise_conv_dx", "window_attention_bwd", "depthwise_conv_dw",
                 "window_attention_dtable")
}


class KernelHasNoGradient(RuntimeError):
    """A kernel entry with no backward was called with grad mode on and an
    input that requires grad: flash attention and the bottleneck chain, whose
    TPU kernels have no backward either."""


def wants_grad(*tensors) -> bool:
    """Whether autograd would record a call on these tensors: grad mode is on
    and one of them (None is skipped) requires grad."""
    import torch

    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def refuse_grad(name: str, *tensors) -> None:
    """Raise ``KernelHasNoGradient`` for the entry ``name`` where autograd
    would record a call on ``tensors``."""
    if wants_grad(*tensors):
        raise KernelHasNoGradient(
            f"{name} has no backward: its kernel computes the forward only, as the TPU "
            "kernel it replaces does; run it with grad off, or with inputs that do not "
            "require grad")


def stream_and_device(t) -> tuple[int, int]:
    """(handle of PyTorch's current CUDA stream on the tensor's device, device
    index), as the kernels' C interfaces take them. The raw-stream call is
    what PyTorch's own compiled code uses; it saves the ``Stream`` object that
    ``torch.cuda.current_stream`` builds on every launch."""
    import torch

    index = t.device.index if t.device.index is not None else torch.cuda.current_device()
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(index), index
    return torch.cuda.current_stream(index).cuda_stream, index


def launch_counts() -> dict[str, int]:
    return {name: counter.value for name, counter in LAUNCHES.items()}


def reset_launch_counts() -> dict[str, int]:
    """Zero every kernel's count; returns the counts as they were."""
    return {name: counter.reset() for name, counter in LAUNCHES.items()}
