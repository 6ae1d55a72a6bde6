"""Flash attention: a hand-written CUDA kernel for Hopper and its plain version.

Counterpart of ``ics_tpu/ops/attention.py``. ``flash_attention`` on CUDA
tensors launches ``csrc/flash_attention.cu``; on CPU tensors, and only
there, it computes ``attention_reference``. Both follow the flash contract
of the TPU kernel: non-causal softmax(QK^T/sqrt(d))·V over [B, H, S, D],
keys at or past ``seq_len`` masked, fully masked rows exactly zero, q
pre-scaled in its own dtype, P rounded to the input dtype before P·V, fp32
accumulation and softmax statistics.

``bf16_exp=True`` (bf16 inputs only) is the counterpart of the ``bf16_exp``
variant of ``scripts/bench_vit_attn.py::make_variant``: ``exp`` is taken on
``(s - m)`` rounded to bf16 and the row sum stays fp32. On the card that is
``2^x`` in bf16 (``ex2.approx.ftz.bf16x2``) on ``(s - m)·log2(e)`` rounded to
bf16, with ``m`` the running max of the kernel's 64-key tiles; the plain
version walks the same tiles and takes ``torch.exp2`` on the same bf16
argument, so the two differ by the hardware approximation alone (at most
2^-7 relative on each p, one bf16 ulp). ViT serving keeps it off.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ics_tpu_torch.ops import LAUNCHES, stream_and_device

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}

KEY_TILE = 64         # keys per tile of the kernel's online softmax
LOG2E = 1.4426950408889634

_launches = {False: LAUNCHES["flash_attention"], True: LAUNCHES["flash_attention_bf16_exp"]}


def _kernel():
    from ics_tpu_torch.ops import _build

    lib = _build.load("flash_attention")
    fn = lib.ics_flash_attention
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ]
        fn.restype = ctypes.c_int
        lib.ics_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ics_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _valid_len(seq_len: Optional[int], s: int) -> int:
    return s if seq_len is None else max(0, min(int(seq_len), s))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    seq_len: Optional[int] = None,
                    bf16_exp: bool = False) -> torch.Tensor:
    """q, k, v: [B, H, S, D] -> [B, H, S, D].

    ``seq_len``: number of valid tokens; keys at or past it are masked.
    ``bf16_exp``: take exp in bf16 (bf16 inputs only; see the module text).
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
        return attention_reference(q, k, v, seq_len, bf16_exp)
    if len(devices) != 1 or q.device.type != "cuda":
        raise ValueError(f"flash_attention wants q, k, v on one CUDA device; got {devices}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"flash_attention takes bf16 or fp32 q, k, v of one dtype; got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if bf16_exp and q.dtype != torch.bfloat16:
        raise ValueError(f"flash_attention: bf16_exp needs bf16 inputs; got {q.dtype}")
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
    rc = lib.ics_flash_attention(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), b * h, s, d, _valid_len(seq_len, s), int(bool(bf16_exp)),
        *stream_and_device(q),
    )
    if rc != 0:
        msg = lib.ics_cuda_error_string(rc).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: {msg} (cudaError {rc})")
    _launches[bool(bf16_exp)].add()
    return out


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        seq_len: Optional[int] = None,
                        bf16_exp: bool = False) -> torch.Tensor:
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
    if bf16_exp:
        if q.dtype != torch.bfloat16:
            raise ValueError(f"attention_reference: bf16_exp needs bf16 inputs; got {q.dtype}")
        return _bf16_exp_reference(scores, valid, v)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(scores - m), 0.0)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.matmul(p.to(v.dtype).float(), v.float()) / denom
    return out.to(q.dtype)


def _bf16_exp_reference(scores: torch.Tensor, valid: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """The bf16-exp variant on masked fp32 scores, over the kernel's tiles of
    ``KEY_TILE`` keys: per tile the running max ``m``, ``p = 2^x`` in bf16 on
    ``x = (s - m)·log2(e)`` rounded to bf16, the fp32 sum of those bf16 values,
    and the earlier sum and accumulator rescaled by ``exp(m_old - m)`` in fp32."""
    m = torch.full_like(scores[..., :1], NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros(scores.shape[:-1] + v.shape[-1:], dtype=torch.float32,
                      device=scores.device)
    for k0 in range(0, int(valid.sum()), KEY_TILE):
        tile = scores[..., k0:k0 + KEY_TILE]
        m_new = torch.maximum(m, tile.amax(dim=-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp2(((tile - m_new) * LOG2E).to(torch.bfloat16))
        p = torch.where(valid[k0:k0 + KEY_TILE], p, 0.0).float()
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.matmul(p, v[..., k0:k0 + KEY_TILE, :].float())
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(v.dtype)
