"""The yardstick's arithmetic: the card's published peaks, the least time a
kernel launch could take (``bound``), the work of the port's kernels at
the shapes they are launched at, and the model FLOPs of an image.

Peaks: NVIDIA's data sheet for one H100 SXM, dense, without sparsity, at
the full 700 W power limit. A card set below that limit runs slower under
load; every share computed here is against the published peak, and the
run prints the card's power limit beside it.

Kernel work counts each input byte read once and each output byte written
once, whatever the kernel reads again, and the operations the algorithm
needs at that shape: the rule of the port's kernel table.
"""

from __future__ import annotations

from chipbench.reference import models

HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12

# kernel names of the port, by group: every __global__ of the port's CUDA
# sources, then the library kernels by the words their names carry
GROUPS = (
    ("port kernels", ("flash_wgmma", "flash_mma", "flash_f32", "bottleneck_wgmma",
                      "normalize_vec", "normalize_scalar", "dw_strip", "dw_tile", "dw_direct",
                      "window_bf16", "window_f32", "window_bwd", "dw_grad", "table_sum",
                      "table_gather")),
    ("convolution and GEMM", ("gemm", "cutlass", "nvjet", "xmma", "conv", "cudnn", "wgrad",
                              "implicit", "sm90_", "sm80_")),
    ("pooling, softmax, top-k", ("pool", "softmax", "topk", "sort", "gather", "reduce")),
)
GLUE = "elementwise glue and copies"


def group_of(kernel_name: str) -> str:
    lowered = kernel_name.lower()
    for group, needles in GROUPS:
        if any(n in lowered for n in needles):
            return group
    return GLUE


def bound(n_bytes: float, n_ops: float, peak_ops: float = BF16_FLOPS) -> dict:
    """The least time the card could take: the bytes at the memory rate or
    the operations at the peak rate of their type, whichever is longer."""
    by_bytes = n_bytes / HBM_BYTES_S * 1e3
    by_ops = n_ops / peak_ops * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def flash_work(batch: int, heads: int, seq: int, head_dim: int, elem_bytes: int = 2) -> tuple:
    """(bytes, operations) of one flash-attention launch on [B, H, S, D]:
    q, k and v read once and the output written once; QK^T and PV."""
    n = batch * heads * seq * head_dim
    return 4 * n * elem_bytes, 4.0 * batch * heads * seq * seq * head_dim


def chain_launch_work(batch: int, height: int, width: int, channels: int, inner: int) -> tuple:
    """(bytes, operations) of one launch of the bottleneck-chain kernel, which
    runs one identity bottleneck (1x1 C->Cm, 3x3 Cm->Cm, 1x1 Cm->C) over
    [B, H, W, C] in bf16: the input read and the output written once, the
    block's bf16 weights and its fp32 scales and biases read once."""
    pixels = batch * height * width
    c, cm = channels, inner
    weights = 2 * (c * cm + 9 * cm * cm + cm * c) + 4 * 2 * (cm + cm + c)
    n_bytes = 2 * pixels * c * 2 + weights
    n_ops = 2.0 * pixels * (2 * c * cm + 9 * cm * cm)
    return n_bytes, n_ops


def model_flops(cfg: dict) -> float:
    """FLOPs of one image's forward pass (two a multiply-accumulate), from the
    multiply-accumulates that the configuration's reference architecture
    counts (``chipbench/reference/<architecture>.py``)."""
    return 2.0 * models.macs(cfg)
