"""uint8 -> normalized bf16/fp32 in one pass: a hand-written CUDA kernel for
Hopper and its plain version.

Counterpart of ``ics_tpu/ops/pallas_preproc.py``. ``normalize_u8`` on a CUDA
tensor launches ``csrc/normalize_u8.cu``; on a CPU tensor, and only there,
it computes ``normalize_only`` (``ops/preproc.py``). The kernel computes
``x * 1/(255*std) + (-mean/std)`` in fp32, the plain version
``(x - 255*mean) / (255*std)``: the two agree to fp32 rounding (1e-5), as
the TPU kernel and its reference do.

The input may be a window of a larger canvas (``canvas[:, :S, :S]``): the
kernel takes a row stride and an image stride, so nothing is copied.
"""

from __future__ import annotations

import ctypes

import torch

from ics_tpu_torch.ops import LAUNCHES, stream_and_device
from ics_tpu_torch.ops.preproc import IMAGENET_MEAN, IMAGENET_STD, normalize_only

_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}

_launches = LAUNCHES["normalize_u8"]


def _kernel():
    from ics_tpu_torch.ops import _build

    lib = _build.load("normalize_u8")
    fn = lib.ics_normalize_u8
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_void_p, ctypes.c_int,
        ]
        fn.restype = ctypes.c_int
        lib.ics_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ics_cuda_error_string.restype = ctypes.c_char_p
    return lib


def affine(mean=IMAGENET_MEAN, std=IMAGENET_STD) -> tuple[list[float], list[float]]:
    """(scale, bias) per channel, computed in fp32 as the TPU wrapper does:
    ``scale = 1 / (255 * std)``, ``bias = -mean / std``."""
    mean_t = torch.tensor(mean, dtype=torch.float32)
    std_t = torch.tensor(std, dtype=torch.float32)
    return (1.0 / (255.0 * std_t)).tolist(), (-mean_t / std_t).tolist()


def normalize_u8(x: torch.Tensor, mean=IMAGENET_MEAN, std=IMAGENET_STD,
                 dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x uint8 [B, H, W, 3] -> normalized [B, H, W, 3] in ``dtype``, contiguous.

    The last two dimensions of ``x`` must be dense (strides 3 and 1); the
    row and image strides are free. CUDA tensors go through the kernel
    (bf16 or fp32 out); anything it does not take raises. CPU tensors take
    the plain version.
    """
    if x.dim() != 4 or x.shape[-1] != 3 or x.dtype != torch.uint8:
        raise ValueError(
            f"normalize_u8 wants a uint8 [B, H, W, 3] tensor; got {x.dtype} {tuple(x.shape)}"
        )
    if x.device.type == "cpu":
        return normalize_only(x, mean, std, dtype)
    if x.device.type != "cuda":
        raise ValueError(f"normalize_u8 wants a CUDA or CPU tensor; got {x.device}")
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"normalize_u8 writes bf16 or fp32; got {dtype}")
    b, h, w, _ = x.shape
    out = torch.empty((b, h, w, 3), dtype=dtype, device=x.device)
    if out.numel() == 0:
        return out
    if x.stride(3) != 1 or x.stride(2) != 3 or min(x.stride(0), x.stride(1)) < 0:
        raise ValueError(
            f"normalize_u8 wants dense pixels (strides 3 and 1 on the last two "
            f"dimensions); got strides {x.stride()}"
        )
    if max(b, h, w) >= 2**31:
        raise ValueError(f"normalize_u8: shape {tuple(x.shape)} is too large")
    scale, bias = affine(mean, std)
    lib = _kernel()
    rc = lib.ics_normalize_u8(
        _DTYPE_CODES[dtype], x.data_ptr(), out.data_ptr(), b, h, w,
        x.stride(0), x.stride(1), (ctypes.c_float * 3)(*scale),
        (ctypes.c_float * 3)(*bias),
        *stream_and_device(x),
    )
    if rc != 0:
        msg = lib.ics_cuda_error_string(rc).decode()
        raise RuntimeError(f"normalize_u8 kernel launch failed: {msg} (cudaError {rc})")
    _launches.add()
    return out
