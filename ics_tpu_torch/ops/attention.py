"""Flash attention: a hand-written CUDA kernel for Hopper and its plain version.

Counterpart of ``ics_tpu/ops/attention.py``. ``flash_attention`` on CUDA
tensors launches ``csrc/flash_attention.cu``; on CPU tensors, and only
there, it computes ``attention_reference``. Both follow the flash contract
of the TPU kernel: non-causal softmax(QK^T/sqrt(d))·V over [B, H, S, D],
keys at or past ``seq_len`` masked, fully masked rows exactly zero, q
pre-scaled in its own dtype, P rounded to the input dtype before P·V, fp32
accumulation and softmax statistics.

The kernel reads q, k and v by their batch, head and row strides, so any
[B, H, S, D] views whose last dimension is contiguous will do.
``flash_attention_qkv`` takes a fused qkv product viewed as [B, S, 3, H, D]
and returns [B, S, H, D] through the same kernel and the same launch count:
no copy of q, k or v before the launch and none of the output after it.

``bf16_exp=True`` (bf16 inputs only) is the counterpart of the ``bf16_exp``
variant of ``scripts/bench_vit_attn.py::make_variant``: ``exp`` is taken on
``(s - m)`` rounded to bf16 and the row sum stays fp32. On the card that is
``2^x`` in bf16 (``ex2.approx.ftz.bf16x2``) on ``(s - m)·log2(e)`` rounded to
bf16, with ``m`` the running max of the kernel's key tiles (``KEY_TILE``
keys, by head_dim); the plain version walks the same tiles and takes
``torch.exp2`` on the same bf16 argument, so the two differ by the hardware
approximation alone (at most 2^-7 relative on each p, one bf16 ulp). ViT
serving keeps it off.
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

# keys per tile of the kernel's online softmax, by head_dim: 128 where the
# bf16 kernel is the wgmma one, 64 where it is the mma.sync one
KEY_TILE = {16: 64, 32: 64, 64: 128, 128: 128}
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
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong),
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ]
        fn.restype = ctypes.c_int
        lib.ics_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ics_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _valid_len(seq_len: Optional[int], s: int) -> int:
    return s if seq_len is None else max(0, min(int(seq_len), s))


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
            seq_len: Optional[int], bf16_exp: bool, mma_sync: bool = False) -> None:
    """Check [B, H, S, D] views q, k, v on one CUDA device and launch the
    kernel into the view ``out``; raises on anything the kernel does not take.
    ``mma_sync`` sends head_dim 64 and 128 to the ``mma.sync`` kernel that
    head_dim 16 and 32 always take (``tools.bench_vit_attn`` times it)."""
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
    if b * h * (s // 64 + 1) >= 2**31 - 2**16:    # blocks and work items are counted in an int
        raise ValueError(f"flash_attention: shape {tuple(q.shape)} is too large")
    if out.numel() == 0:
        return
    per_16_bytes = 16 // q.element_size()
    strides = []
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if t.stride(3) != 1:
            raise ValueError(
                f"flash_attention wants the last dimension contiguous; {name} has "
                f"strides {t.stride()}")
        if t.data_ptr() % 16 or any(
                t.stride(i) % per_16_bytes or t.stride(i) <= 0
                for i in range(3) if t.shape[i] > 1):
            raise ValueError(
                f"flash_attention wants 16-byte aligned rows; {name} has strides "
                f"{t.stride()} at address {t.data_ptr():#x}")
        strides.extend(t.stride()[:3])
    lib = _kernel()
    rc = lib.ics_flash_attention(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, s, d, _valid_len(seq_len, s), (ctypes.c_longlong * 12)(*strides),
        int(bool(bf16_exp)), int(bool(mma_sync)), *stream_and_device(q),
    )
    if rc != 0:
        msg = lib.ics_cuda_error_string(rc).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: {msg} (cudaError {rc})")
    _launches[bool(bf16_exp)].add()


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU; raises unless they share one
    CUDA device otherwise."""
    devices = {t.device for t in tensors}
    if devices == {torch.device("cpu")}:
        return True
    if len(devices) != 1 or tensors[0].device.type != "cuda":
        raise ValueError(f"flash_attention wants q, k, v on one CUDA device; got {devices}")
    return False


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    seq_len: Optional[int] = None,
                    bf16_exp: bool = False) -> torch.Tensor:
    """q, k, v: [B, H, S, D] -> [B, H, S, D] (contiguous).

    ``seq_len``: number of valid tokens; keys at or past it are masked.
    ``bf16_exp``: take exp in bf16 (bf16 inputs only; see the module text).
    CUDA tensors go through the kernel (bf16 or fp32, D in 16/32/64/128, any
    strides with the last dimension contiguous and rows 16-byte aligned);
    anything it does not take raises. CPU tensors take the plain version.
    """
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            f"flash_attention wants q, k, v of one [B, H, S, D] shape; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if _on_cpu(q, k, v):
        return attention_reference(q, k, v, seq_len, bf16_exp)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(q, k, v, out, seq_len, bf16_exp)
    return out


def flash_attention_qkv(qkv: torch.Tensor, seq_len: Optional[int] = None,
                        bf16_exp: bool = False) -> torch.Tensor:
    """qkv: [B, S, 3, H, D], the fused q/k/v product as it lies -> [B, S, H, D]
    (contiguous, so ``.reshape(B, S, H * D)`` is a view).

    The same function as ``flash_attention`` on the three slices, through the
    same kernel: it reads q, k and v by their strides and writes the output
    in the layout the projection after it wants. CPU tensors take the plain
    version."""
    if qkv.dim() != 5 or qkv.shape[2] != 3:
        raise ValueError(
            f"flash_attention_qkv wants qkv as [B, S, 3, H, D]; got {tuple(qkv.shape)}")
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)          # [B, H, S, D] views
    if _on_cpu(qkv):
        return attention_reference(q, k, v, seq_len, bf16_exp).transpose(1, 2).contiguous()
    b, s, _, h, d = qkv.shape
    out = torch.empty((b, s, h, d), dtype=qkv.dtype, device=qkv.device)
    _launch(q, k, v, out.transpose(1, 2), seq_len, bf16_exp)
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
    ``KEY_TILE[head_dim]`` keys: per tile the running max ``m``, ``p = 2^x`` in
    bf16 on ``x = (s - m)·log2(e)`` rounded to bf16, the fp32 sum of those bf16
    values, and the earlier sum and accumulator rescaled by ``exp(m_old - m)``
    in fp32."""
    m = torch.full_like(scores[..., :1], NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros(scores.shape[:-1] + v.shape[-1:], dtype=torch.float32,
                      device=scores.device)
    step = KEY_TILE.get(v.shape[-1], 64)
    for k0 in range(0, int(valid.sum()), step):
        tile = scores[..., k0:k0 + step]
        m_new = torch.maximum(m, tile.amax(dim=-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp2(((tile - m_new) * LOG2E).to(torch.bfloat16))
        p = torch.where(valid[k0:k0 + step], p, 0.0).float()
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.matmul(p, v[..., k0:k0 + step, :].float())
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(v.dtype)
