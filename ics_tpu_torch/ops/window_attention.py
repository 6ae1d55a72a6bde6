"""Window attention (Swin): a hand-written CUDA kernel for Hopper and its plain
version.

Counterpart of ``scripts/proto_window_attn.py::pallas_window_attention``.
``window_attention`` on CUDA tensors launches ``csrc/window_attention.cu``;
on CPU tensors, and only there, it computes ``window_attention_reference``.
Both follow the TPU kernel's contract: per (window, head) QK^T with q
pre-scaled by the caller, plus the relative-position bias [H, ww, ww] and
the shift mask [nW, ww, ww] (window index = row mod nW, rows image-major),
all in fp32; an fp32 softmax; P divided by its row sum and then rounded to
``v.dtype``; P·V accumulated in fp32; one rounding of the output. The
mask's -1e4 entries are finite on purpose and are added as they are. The
[Bn, H, ww, ww] score tensor never reaches device memory.

bf16 inputs run the products on the tensor cores (``mma.sync`` m16n8k16);
fp32 inputs take a SIMT kernel of plain fp32 FMAs (no TF32).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ics_tpu_torch.ops import LAUNCHES, stream_and_device

HEAD_DIMS = (16, 32)
MAX_TOKENS = 64
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}

_launches = LAUNCHES["window_attention"]


def _kernel():
    from ics_tpu_torch.ops import _build

    lib = _build.load("window_attention")
    fn = lib.ics_window_attention
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int,
        ]
        fn.restype = ctypes.c_int
        lib.ics_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ics_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_shapes(q, k, v, bias, mask) -> None:
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            f"window_attention wants q, k, v of one [Bn, H, ww, hd] shape; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    bn, h, ww, _ = q.shape
    if tuple(bias.shape) != (h, ww, ww):
        raise ValueError(
            f"window_attention wants bias as [H, ww, ww] = {[h, ww, ww]}; got {tuple(bias.shape)}"
        )
    if mask is not None:
        if mask.dim() != 3 or tuple(mask.shape[1:]) != (ww, ww) or mask.shape[0] < 1 \
                or bn % mask.shape[0]:
            raise ValueError(
                f"window_attention wants mask as [nW, ww, ww] with nW dividing Bn = {bn} "
                f"and ww = {ww}; got {tuple(mask.shape)}"
            )


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q, k, v [Bn, H, ww, hd] (Bn = B·nW, image-major; q pre-scaled), bias
    [H, ww, ww] fp32, mask [nW, ww, ww] fp32 or None -> [Bn, H, ww, hd].

    CUDA tensors go through the kernel (bf16 or fp32 q, k, v, contiguous and
    16-byte aligned, hd in 16/32, ww <= 64, fp32 bias and mask); anything it
    does not take raises. CPU tensors take the plain version.
    """
    _check_shapes(q, k, v, bias, mask)
    tensors = [q, k, v, bias] + ([] if mask is None else [mask])
    devices = {t.device for t in tensors}
    if devices == {torch.device("cpu")}:
        return window_attention_reference(q, k, v, bias, mask)
    if len(devices) != 1 or q.device.type != "cuda":
        raise ValueError(f"window_attention wants all tensors on one CUDA device; got {devices}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"window_attention takes bf16 or fp32 q, k, v of one dtype; got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if bias.dtype != torch.float32 or (mask is not None and mask.dtype != torch.float32):
        raise ValueError("window_attention takes fp32 bias and mask")
    bn, h, ww, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"window_attention takes head_dim in {HEAD_DIMS}; got {hd}")
    if ww > MAX_TOKENS:
        raise ValueError(f"window_attention takes windows of at most {MAX_TOKENS} tokens; got {ww}")
    for name, t in (("q", q), ("k", k), ("v", v), ("bias", bias), ("mask", mask)):
        if t is None:
            continue
        if not t.is_contiguous():
            raise ValueError(f"window_attention wants contiguous tensors; {name} is not")
        if t.data_ptr() % 16:
            raise ValueError(f"window_attention wants 16-byte aligned tensors; {name} is not")
    if bn * h >= 2**31:
        raise ValueError(f"window_attention: shape {tuple(q.shape)} is too large")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _kernel()
    rc = lib.ics_window_attention(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        None if mask is None else mask.data_ptr(), out.data_ptr(), bn, h, ww, hd,
        1 if mask is None else mask.shape[0], *stream_and_device(q),
    )
    if rc != 0:
        msg = lib.ics_cuda_error_string(rc).decode()
        raise RuntimeError(f"window_attention kernel launch failed: {msg} (cudaError {rc})")
    _launches.add()
    return out


def window_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               bias: torch.Tensor,
                               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch window attention with the kernel's numerics: the same
    steps with ``torch.matmul`` on fp32 upcasts and the same rounding points."""
    _check_shapes(q, k, v, bias, mask)
    bn, h, ww, _ = q.shape
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) + bias.float()
    if mask is not None:
        n_w = mask.shape[0]
        scores = (scores.reshape(bn // n_w, n_w, h, ww, ww)
                  + mask.float()[None, :, None]).reshape(bn, h, ww, ww)
    p = torch.softmax(scores, dim=-1)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)
