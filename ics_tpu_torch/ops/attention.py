"""Flash attention: a hand-written CUDA kernel for Hopper and its plain version.

Counterpart of ``ics_tpu/ops/attention.py``. ``flash_attention`` on CUDA
tensors launches ``csrc/flash_attention.cu``; on CPU tensors, and only
there, it computes ``attention_reference``. Both follow the flash contract
of the TPU kernel: non-causal softmax(QK^T/sqrt(d))·V over [B, H, S, D],
keys at or past ``seq_len`` masked, fully masked rows exactly zero, q
pre-scaled in its own dtype, P rounded to the input dtype before P·V, fp32
accumulation and softmax statistics.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ics_tpu_torch.ops import LAUNCHES, tensor_device_index

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}

_launches = LAUNCHES["flash_attention"]


def _kernel():
    from ics_tpu_torch.ops import _build

    lib = _build.load("flash_attention")
    fn = lib.ics_flash_attention
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ]
        fn.restype = ctypes.c_int
        lib.ics_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ics_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _valid_len(seq_len: Optional[int], s: int) -> int:
    return s if seq_len is None else max(0, min(int(seq_len), s))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    seq_len: Optional[int] = None) -> torch.Tensor:
    """q, k, v: [B, H, S, D] -> [B, H, S, D].

    ``seq_len``: number of valid tokens; keys at or past it are masked.
    CUDA tensors go through the kernel (bf16 or fp32, D in 16/32/64/128,
    contiguous); anything it does not take raises. CPU tensors take the
    plain version.
    """
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            f"flash_attention wants q, k, v of one [B, H, S, D] shape; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    devices = {q.device, k.device, v.device}
    if devices == {torch.device("cpu")}:
        return attention_reference(q, k, v, seq_len)
    if len(devices) != 1 or q.device.type != "cuda":
        raise ValueError(f"flash_attention wants q, k, v on one CUDA device; got {devices}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"flash_attention takes bf16 or fp32 q, k, v of one dtype; got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    b, h, s, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention takes head_dim in {HEAD_DIMS}; got {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention wants contiguous tensors; {name} is not")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention wants 16-byte aligned tensors; {name} is not")
    if b * h >= 2**31 or s >= 2**31:
        raise ValueError(f"flash_attention: shape {tuple(q.shape)} is too large")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _kernel()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.ics_flash_attention(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), b * h, s, d, _valid_len(seq_len, s), stream,
        tensor_device_index(q),
    )
    if rc != 0:
        msg = lib.ics_cuda_error_string(rc).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: {msg} (cudaError {rc})")
    _launches.add()
    return out


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        seq_len: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch attention with the kernel's numerics and contract.

    Unlike the JAX package's ``attention_reference`` (which returns the
    mean of V on a fully masked row), this follows the flash kernel: such
    rows are exact zeros.
    """
    s, d = q.shape[-2], q.shape[-1]
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=q.dtype)
    scores = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
    valid = torch.arange(s, device=q.device) < _valid_len(seq_len, s)
    scores = scores.masked_fill(~valid, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(scores - m), 0.0)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.matmul(p.to(v.dtype).float(), v.float()) / denom
    return out.to(q.dtype)
