"""Fused chain of stride-1 ResNet bottlenecks: a hand-written CUDA kernel for
Hopper and its plain version.

Counterpart of ``ics_tpu/ops/pallas_bottleneck.py``. ``bottleneck_chain`` on
a CUDA tensor launches ``csrc/bottleneck_chain.cu`` once per bottleneck of
the chain; on a CPU tensor, and only there, it computes
``bottleneck_chain_reference``. Both follow the TPU kernel's contract per
bottleneck: 1x1 -> BN -> ReLU -> 3x3 SAME -> BN -> ReLU -> 1x1 -> BN ->
+ shortcut -> ReLU, with operands in the activation dtype, fp32
accumulation, BN scale and bias in fp32 on the accumulator, and one
rounding each for ``a``, ``cmid`` and the output. (The unfused blocks round
the convolution's output first and apply scale and bias in the activation
dtype, so the two paths differ by bf16 rounding.)

``pack_chain_weights`` stacks a chain's folded weights in the JAX
package's layouts; ``ChainWeights`` carries them in a model and keeps the
kernel's own (transposed) layout beside them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ics_tpu_torch.ops import LAUNCHES, stream_and_device

# inner widths the kernel is built for; the block's width is C = 4 * Cm in
# ResNet, and any multiple of Cm here
KERNEL_INNER_WIDTHS = (64, 128, 256)
# what one thread block may ask for in shared memory on sm_90
_SMEM_MAX = 232448
# the wgmma kernel's ring: 2 to 4 stages of a [128 pixels, 64] x tile and a
# [Cm, 64] weight tile
_X_TILE_ROWS = 128
_MAX_STAGES = 4
_MIN_STAGES = 2
_H100_MULTIPROCESSORS = 132  # what pick_tile_rows counts with where no device is named
_WEIGHT_KEYS = ("w1", "w2", "w3")
_KEYS = ("w1", "s1", "b1", "w2", "s2", "b2", "w3", "s3", "b3")

_launches = LAUNCHES["bottleneck_chain"]


def pack_chain_weights(blocks: Sequence[nn.Module],
                       dtype: torch.dtype = torch.bfloat16) -> dict[str, torch.Tensor]:
    """Stack the folded weights of a chain of identity bottlenecks, in the
    JAX package's layouts: ``w1`` [n, C, Cm], ``w2`` [n, 9*Cm, Cm] (the 3x3
    taps stacked along K, tap-major), ``w3`` [n, Cm, C] in ``dtype``; ``s*``
    and ``b*`` [n, 1, width] in fp32.

    ``blocks``: folded ``Bottleneck`` modules without a downsample
    projection, with dense (ungrouped) convolutions.
    """
    packed = {key: [] for key in _KEYS}
    for blk in blocks:
        if blk.down is not None:
            raise ValueError("the chain kernel takes identity blocks only "
                             "(no downsample projection)")
        for i, cb in enumerate((blk.cbr1, blk.cbr2, blk.cbr3), start=1):
            if cb.scale is None:
                raise ValueError("pack_chain_weights wants folded blocks (call fold() first)")
            if cb.conv.groups != 1 or cb.conv.stride != 1:
                raise ValueError("the chain kernel takes dense stride-1 convolutions only")
            w = cb.conv.weight.detach().float()              # OIHW
            if i == 2:
                cm = w.shape[0]
                w = w.permute(2, 3, 1, 0).reshape(9 * cm, cm)  # HWIO, taps along K
            else:
                w = w[:, :, 0, 0].t()                          # [in, out]
            packed[f"w{i}"].append(w.to(dtype))
            packed[f"s{i}"].append(cb.scale.detach().float()[None, :])
            packed[f"b{i}"].append(cb.bias.detach().float()[None, :])
    return {key: torch.stack(vals).contiguous() for key, vals in packed.items()}


class ChainWeights(nn.Module):
    """A packed chain inside a model. The tensors follow the model to its
    device but keep their dtypes when the model is cast: the weights stay in
    the dtype they were packed in, scale and bias stay fp32 (the kernel
    applies them to the fp32 accumulator)."""

    def __init__(self, packed: dict[str, torch.Tensor]):
        super().__init__()
        for key in _KEYS:
            self.register_buffer(key, packed[key], persistent=False)
        self._kernel_layout: Optional[tuple] = None

    def _apply(self, fn, *args, **kwargs):
        # a cast (model.to(dtype)) must not touch these tensors, not even
        # there and back: fp32 scales would come back rounded to bf16
        for key in _KEYS:
            t = getattr(self, key)
            moved = fn(t)
            setattr(self, key, moved if moved.dtype == t.dtype else t.to(moved.device))
        self._kernel_layout = None
        return self

    def packed(self) -> dict[str, torch.Tensor]:
        return {key: getattr(self, key) for key in _KEYS}

    def kernel_layout(self) -> tuple:
        """(w1t [n, Cm, C], w2t [n, Cm, 9*Cm], w3t [n, C, Cm] with its rows in
        ``expand_row_order``): the output channel outermost and K contiguous,
        which is how the kernel reads them. Made once per device placement."""
        if self._kernel_layout is None:
            self._kernel_layout = _kernel_layout(self.packed())
        return self._kernel_layout


def expand_row_order(c: int) -> torch.Tensor:
    """The order of the last 1x1's output channels in the wgmma kernel's
    weight tile. A thread of an accumulator fragment holds columns 8 j + 2 t
    and 8 j + 2 t + 1 of every 8-column block j (t: its place in its quad of
    lanes). With channel ``32 G + 8 t + 2 jj + e`` in column ``32 G + 8 jj +
    2 t + e`` its eight values of four blocks are eight neighbouring channels:
    16 bytes of the shortcut and of the output, read and written as they
    lie, where the natural order costs two transpositions among the quad's
    lanes for every such block. Returns ``order`` with ``order[column] =
    channel``; ``c`` is a multiple of 32."""
    column = torch.arange(c)
    group, jj, t, e = column // 32, (column % 32) // 8, (column % 8) // 2, column % 2
    return 32 * group + 8 * t + 2 * jj + e


def _kernel_layout(weights: dict[str, torch.Tensor]) -> tuple:
    w1t, w2t, w3t = (weights[key].transpose(1, 2) for key in _WEIGHT_KEYS)
    order = expand_row_order(w3t.shape[1]).to(w3t.device)
    return w1t.contiguous(), w2t.contiguous(), w3t.index_select(1, order).contiguous()


def _as_packed(packed) -> dict[str, torch.Tensor]:
    return packed.packed() if isinstance(packed, ChainWeights) else packed


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _stage_bytes(cm: int) -> int:
    return _X_TILE_ROWS * 128 + cm * 128


def _smem_bytes(th: int, w: int, cm: int, stages: int = _MIN_STAGES) -> int:
    """Shared memory of one thread block of the wgmma kernel at ``th`` tile
    rows and ``stages`` ring stages (the formula of ``launch_wgmma`` in
    ``csrc/bottleneck_chain.cu``): room to align the ring to 1024 bytes, the
    ring, ``a`` with its halo rows and zero columns, ``cmid``, the barriers."""
    arow = cm + 8
    cmid = _ceil_div(2 * th * w * arow, 16) * 16
    return 1024 + stages * _stage_bytes(cm) + 2 * (th + 2) * (w + 2) * arow + cmid \
        + 2 * 8 * _MAX_STAGES


def ring_stages(th: int, w: int, cm: int) -> int:
    """Ring stages of the wgmma kernel at ``th`` tile rows: as many of 2 to 4
    as fit beside ``a`` and ``cmid``; 0 if two do not fit."""
    for stages in range(_MAX_STAGES, _MIN_STAGES - 1, -1):
        if _smem_bytes(th, w, cm, stages) <= _SMEM_MAX:
            return stages
    return 0


@functools.lru_cache(maxsize=None)
def pick_tile_rows(h: int, w: int, cm: int, batch: int = 32,
                   multiprocessors: int = _H100_MULTIPROCESSORS) -> int:
    """Image rows per thread block (cached: the serving path asks for the
    same few shapes on every step).

    The wgmma kernel runs each product in passes: 128 pixels a pass for the
    first 1x1 (over the tile and its two halo rows), ``512 * 64 / cm`` pixels
    a pass for the 3x3 and the last 1x1, and a pass costs its full size
    whatever share of it is pixels. Per tile that is ``4 * passes * 128 + 13
    * passes * pass size`` (the weights are the products' FLOP shares, 4 : 9
    : 4), and the ``batch * tiles`` blocks, one a multiprocessor at a time,
    run in whole rounds of the card's ``multiprocessors``. The cheapest tiling
    that leaves the ring at least three stages wins; if none does, the
    cheapest with two."""
    big = 512 * 64 // cm

    def cost(th: int) -> int:
        rounds = _ceil_div(_ceil_div(h, th) * batch, multiprocessors)
        return rounds * (4 * _ceil_div((th + 2) * w, _X_TILE_ROWS) * _X_TILE_ROWS
                         + 13 * _ceil_div(th * w, big) * big)

    for least in (3, _MIN_STAGES):
        fits = [th for th in range(1, h + 1) if ring_stages(th, w, cm) >= least]
        if fits:
            return min(fits, key=lambda th: (cost(th), -th))
    raise ValueError(f"bottleneck_chain: a row of width {w} at Cm={cm} does not fit "
                     "a thread block's shared memory")


def _kernel():
    from ics_tpu_torch.ops import _build

    lib = _build.load("bottleneck_chain")
    fn = lib.ics_bottleneck_block
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [ctypes.c_void_p, ctypes.c_int]
        fn.restype = ctypes.c_int
        lib.ics_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ics_cuda_error_string.restype = ctypes.c_char_p
    return lib


def bottleneck_chain(x: torch.Tensor, packed, tile_rows: Optional[int] = None) -> torch.Tensor:
    """Run a chain of stride-1 identity bottlenecks over x [B, H, W, C].

    ``packed``: a ``ChainWeights`` or the dict of ``pack_chain_weights``.
    CUDA tensors go through the kernel, one launch per bottleneck (bf16,
    contiguous NHWC, Cm in 64/128/256); anything it does not take raises.
    CPU tensors take the plain version. A shape whose tile does not fit the
    kernel's shared memory raises.
    """
    weights = _as_packed(packed)
    n, c, cm = weights["w1"].shape
    if x.dim() != 4 or x.shape[-1] != c:
        raise ValueError(f"bottleneck_chain wants x [B, H, W, {c}]; got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return bottleneck_chain_reference(x, weights)
    if x.device.type != "cuda":
        raise ValueError(f"bottleneck_chain wants a CUDA or CPU tensor; got {x.device}")
    if any(t.device != x.device for t in weights.values()):
        raise ValueError("bottleneck_chain wants x and the packed weights on one device")
    if x.dtype != torch.bfloat16 or weights["w1"].dtype != torch.bfloat16:
        raise ValueError(
            f"the bottleneck_chain kernel takes bf16 activations and weights; got "
            f"{x.dtype} and {weights['w1'].dtype}"
        )
    if cm not in KERNEL_INNER_WIDTHS or c % cm:  # (so C is a multiple of 64)
        raise ValueError(
            f"the bottleneck_chain kernel takes Cm in {KERNEL_INNER_WIDTHS} and C a "
            f"multiple of Cm; got Cm={cm}, C={c}"
        )
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("bottleneck_chain wants a contiguous, 16-byte aligned NHWC tensor")
    b, h, w, _ = x.shape
    if b > 65535 or h * w * c >= 2**31:
        raise ValueError(f"bottleneck_chain: shape {tuple(x.shape)} is too large")
    if x.numel() == 0 or n == 0:
        return x.clone()
    if tile_rows is None:
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        th = pick_tile_rows(h, w, cm, b, sms)
    else:
        th = int(tile_rows)
    stages = ring_stages(th, w, cm)
    if not 1 <= th <= h or stages < _MIN_STAGES:
        raise ValueError(f"bottleneck_chain: tile_rows={th} does not fit (H={h}, W={w}, Cm={cm})")
    layout = packed.kernel_layout() if isinstance(packed, ChainWeights) else _kernel_layout(weights)
    w1t, w2t, w3t = layout
    scales = [weights[k].contiguous() for k in ("s1", "b1", "s2", "b2", "s3", "b3")]
    if any(t.dtype != torch.float32 for t in scales):
        raise ValueError("bottleneck_chain wants fp32 scale and bias")
    lib = _kernel()
    stream, device = stream_and_device(x)
    # each bottleneck reads its neighbours' halo rows of the input while
    # other thread blocks write the output: never in place, two buffers in turn
    bufs = [torch.empty_like(x), torch.empty_like(x) if n > 1 else None]
    cur = x
    s1, b1, s2, b2, s3, b3 = scales
    for j in range(n):
        out = bufs[j % 2]
        rc = lib.ics_bottleneck_block(
            cur.data_ptr(), out.data_ptr(),
            w1t[j].data_ptr(), s1[j].data_ptr(), b1[j].data_ptr(),
            w2t[j].data_ptr(), s2[j].data_ptr(), b2[j].data_ptr(),
            w3t[j].data_ptr(), s3[j].data_ptr(), b3[j].data_ptr(),
            b, h, w, c, cm, th, stages, stream, device,
        )
        if rc != 0:
            msg = lib.ics_cuda_error_string(rc).decode()
            raise RuntimeError(
                f"bottleneck_chain kernel launch failed: {msg} (cudaError {rc})")
        _launches.add()
        cur = out
    return cur


def bottleneck_chain_reference(x: torch.Tensor, packed) -> torch.Tensor:
    """Plain PyTorch chain with the kernel's rounding points: every product
    on fp32 casts of the operands, scale and bias on the fp32 result, then
    ReLU, then one rounding to ``x.dtype``; the shortcut added in fp32."""
    weights = _as_packed(packed)
    dtype = x.dtype
    n, _, cm = weights["w1"].shape
    cur = x
    for j in range(n):
        flat = cur.float()                                          # [B, H, W, C]
        a = torch.matmul(flat, weights["w1"][j].float())
        a = torch.relu(a * weights["s1"][j] + weights["b1"][j]).to(dtype)
        # w2 [9*Cm, Cm] is HWIO with the taps along K -> OIHW
        w2 = weights["w2"][j].float().reshape(3, 3, cm, cm).permute(3, 2, 0, 1)
        cmid = F.conv2d(a.float().permute(0, 3, 1, 2), w2, padding=1).permute(0, 2, 3, 1)
        cmid = torch.relu(cmid * weights["s2"][j] + weights["b2"][j]).to(dtype)
        y = torch.matmul(cmid.float(), weights["w3"][j].float())
        y = y * weights["s3"][j] + weights["b3"][j]
        cur = torch.relu(y + flat).to(dtype)
    return cur
