"""Depthwise convolution, NHWC: a hand-written CUDA kernel for Hopper and its
plain version.

Counterpart of ``ics_tpu/ops/pallas_depthwise.py``. ``depthwise_conv`` on CUDA
tensors launches ``csrc/depthwise_conv.cu``; on CPU tensors, and only there,
it computes ``depthwise_reference``. Both follow the TPU kernel's contract:
stride 1, zero padding ``k // 2`` for any odd ``k``, the ``k * k``
multiply-adds of an output and its bias summed in fp32, one rounding to
``x.dtype``. Nothing is padded in device memory: the kernel masks its own
borders and reads and writes the unpadded tensor.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from ics_tpu_torch.ops import LAUNCHES, stream_and_device

_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}

_launches = LAUNCHES["depthwise_conv"]


def _kernel():
    from ics_tpu_torch.ops import _build

    lib = _build.load("depthwise_conv")
    fn = lib.ics_depthwise_conv
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_int,
        ]
        fn.restype = ctypes.c_int
        lib.ics_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ics_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _taps(w: torch.Tensor, channels: int) -> torch.Tensor:
    """The taps as a [k*k, C] view (no copy) of ``w``: [k, k, C], HWIO
    [k, k, 1, C], or a module's OIHW [C, 1, k, k]."""
    if w.dim() == 4 and w.shape[1] == 1 and w.shape[0] == channels \
            and w.shape[2] == w.shape[3]:
        k = w.shape[2]
        # size-1 dimensions carry arbitrary strides (channels_last does
        # that), so the view is built from the three strides that matter
        taps = w.as_strided((k, k, channels), (w.stride(2), w.stride(3), w.stride(0)))
    elif w.dim() == 4 and w.shape[2] == 1 and w.shape[0] == w.shape[1]:
        taps = w[:, :, 0, :]
    else:
        taps = w
    if taps.dim() != 3 or taps.shape[0] != taps.shape[1] or taps.shape[0] % 2 == 0 \
            or taps.shape[2] != channels:
        raise ValueError(
            f"depthwise_conv wants w as [k, k, C] or [C, 1, k, k] with odd k and "
            f"C = {channels}; got {tuple(w.shape)}"
        )
    return taps


def depthwise_conv(x: torch.Tensor, w: torch.Tensor,
                   b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [B, H, W, C], w [k, k, C] (or [C, 1, k, k]), optional bias [C]
    -> [B, H, W, C] in ``x.dtype``: stride 1, zero padding ``k // 2``.

    CUDA tensors go through the kernel (bf16 or fp32, x contiguous, w and b
    of x's dtype, fewer than 2^31 elements); anything it does not take
    raises. CPU tensors take the plain version.
    """
    if x.dim() != 4:
        raise ValueError(f"depthwise_conv wants x as [B, H, W, C]; got {tuple(x.shape)}")
    bsz, h, wd, c = x.shape
    taps = _taps(w, c)
    k = taps.shape[0]
    if b is not None and tuple(b.shape) != (c,):
        raise ValueError(f"depthwise_conv wants a bias of shape [{c}]; got {tuple(b.shape)}")
    tensors = [x, w] + ([] if b is None else [b])
    devices = {t.device for t in tensors}
    if devices == {torch.device("cpu")}:
        return depthwise_reference(x, w, b)
    if len(devices) != 1 or x.device.type != "cuda":
        raise ValueError(f"depthwise_conv wants x, w, b on one CUDA device; got {devices}")
    if x.dtype not in _DTYPE_CODES or any(t.dtype != x.dtype for t in tensors):
        raise ValueError(
            "depthwise_conv takes bf16 or fp32 x, w, b of one dtype; got "
            + ", ".join(str(t.dtype) for t in tensors)
        )
    if not x.is_contiguous():
        raise ValueError("depthwise_conv wants a contiguous NHWC x")
    if b is not None and not b.is_contiguous():
        raise ValueError("depthwise_conv wants a contiguous bias")
    if x.numel() >= 2**31:
        raise ValueError(f"depthwise_conv: shape {tuple(x.shape)} is too large")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    tap_stride = taps.stride(1)
    if taps.stride(0) != k * tap_stride:
        raise ValueError(f"depthwise_conv wants dense taps; w has strides {w.stride()}")
    lib = _kernel()
    rc = lib.ics_depthwise_conv(
        _DTYPE_CODES[x.dtype], x.data_ptr(), taps.data_ptr(),
        None if b is None else b.data_ptr(), out.data_ptr(), bsz, h, wd, c, k,
        tap_stride, taps.stride(2), *stream_and_device(x),
    )
    if rc != 0:
        msg = lib.ics_cuda_error_string(rc).decode()
        raise RuntimeError(f"depthwise_conv kernel launch failed: {msg} (cudaError {rc})")
    _launches.add()
    return out


def depthwise_reference(x: torch.Tensor, w: torch.Tensor,
                        b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch depthwise convolution with the kernel's numerics:
    ``F.conv2d(groups=C)`` in full fp32 on the upcast input, the bias added
    in fp32, one rounding to ``x.dtype``."""
    c = x.shape[-1]
    taps = _taps(w, c)
    k = taps.shape[0]
    weight = taps.float().permute(2, 0, 1).reshape(c, 1, k, k)
    bias = None if b is None else b.float()
    with torch.backends.cudnn.flags(allow_tf32=False):
        y = F.conv2d(x.float().permute(0, 3, 1, 2), weight, bias, 1, k // 2, 1, c)
    return y.permute(0, 2, 3, 1).contiguous().to(x.dtype)
