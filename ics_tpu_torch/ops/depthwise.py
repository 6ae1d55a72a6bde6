"""Depthwise convolution, NHWC: a hand-written CUDA kernel for Hopper and its
plain version.

Counterpart of ``ics_tpu/ops/pallas_depthwise.py``. ``depthwise_conv`` on CUDA
tensors launches ``csrc/depthwise_conv.cu``; on CPU tensors, and only there,
it computes ``depthwise_reference``. Both follow the TPU kernel's contract:
stride 1, zero padding ``k // 2`` for any odd ``k``, the ``k * k``
multiply-adds of an output and its bias summed in fp32, one rounding to
``x.dtype``. Nothing is padded in device memory: the kernel masks its own
borders and reads and writes the unpadded tensor.

The source holds three kernels. Which one a call takes, and the strip
kernel's thread shape and block geometry, is decided here (``pick_plan``,
``strip_geometry``), where the CPU tests reach it. The kernels read the taps
as a dense ``[k * k, C]`` tensor: ``kernel_taps`` makes it from any of the
weight layouts, and a ``Conv2D`` module keeps it beside its weight, so the
serving path (``depthwise_conv_taps``) makes no copy and repeats no check
that depends on the module alone.

The input gradient is the same kernel on flipped taps: for SAME padding, odd
k and stride 1, ``dx = depthwise_conv(dy, taps flipped in both spatial
axes)`` (``flip_taps``), with the same fp32 sums and one rounding. Where
autograd would record a call on the card, the entries run under
``_DepthwiseConv``, whose backward launches it (counted apart, as
``depthwise_conv_dx``). The gradients of the taps and the bias come from a
kernel of their own, ``csrc/depthwise_conv_dw.cu`` (``depthwise_conv_dw``,
counted as ``depthwise_conv_dw``): fp32 sums over the batch and the image,
taken in a fixed order, from tiles of x and dy staged in shared memory; its
grid is planned here from the card's occupancy (``dw_grad_plan``). On the
CPU the plain version is differentiated as it is.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from ics_tpu_torch.ops import LAUNCHES, stream_and_device, wants_grad

_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
_ITEMSIZE = {torch.bfloat16: 2, torch.float32: 4}
VARIANTS = {"direct": 0, "strip": 1, "tile": 2}
# What a thread of the strip kernel owns, by (bytes a value, k): (CH
# neighbouring channels, Q neighbouring columns), the wide shape first and
# the narrow one second (``strip_by_shape`` in the source builds these). The
# kernel is bound by the instructions it issues, so the wide shapes give a
# thread as many multiply-adds a row as its registers hold (Q * k * k * CH: 144,
# 200, 343), each input value it reads from shared memory feeding up to k * k of
# them; their threads are few and walk long, so a call too small to fill the
# card with them takes the narrow shape (one column a thread), and a smaller
# one still the tile kernel (``pick_plan``).
STRIP_SHAPES = {(2, 3): ((4, 4), (8, 1)), (2, 5): ((2, 4), (4, 1)), (2, 7): ((1, 7), (2, 1)),
                (4, 3): ((2, 4), (4, 1)), (4, 5): ((2, 4), (4, 1)), (4, 7): ((1, 7), (2, 1))}
STRIP_STAGES = 6            # row buffers of the strip kernel's ring
STRIP_MAX_PIECES = 4        # 16-byte pieces a thread copies for one row, at most
STRIP_MAX_SMEM = 48 * 1024
STRIP_MAX_THREADS = 128
# a block's share of a pixel, unless it is all of C: two sectors, and four at
# k 3, where bytes are the bound ((cb, tw) = (8, 16) against (4, 32) on
# [32, 95, 95, 192] bf16 on an H100: 0.098 against 0.106 ms)
STRIP_MIN_RUN_BYTES = {3: 128, 5: 64, 7: 64}
# H is cut into strips until the grid has this many blocks (about 8, 4 and 1.5
# for each of the card's 132 multiprocessors: the more registers a thread
# holds, the fewer blocks fit), in strips no shorter than this many rows (a
# strip computes k - 1 rows of halo that its neighbour computes too)
STRIP_TARGET_BLOCKS = {3: 1056, 5: 528, 7: 192}
STRIP_MIN_ROWS = {3: 12, 5: 20, 7: 14}
# Which grids a thread shape serves (``pick_plan``), from times taken in turns on
# an H100 (``tools.bench_depthwise --bucket 1 8 32``). The wide shape wants about
# a block a multiprocessor, and at k 5 a block and a half: [32, 7, 7, 576] with 192
# and [32, 14, 14, 240] with 160 blocks lose to the narrow shape, [8, 12, 12, 1632]
# with 208 wins. The narrow shape wants about a block a multiprocessor too (a
# whole one at k 3: [1, 95, 95, 192] with 126 loses to the tile kernel), but no
# more than one round of two blocks a multiprocessor (past that the tile kernel
# is the faster of the two); at k 5 and 7 it also takes a smaller grid whose
# blocks walk at most 12 rows, where its walk is shorter than the tile kernel's
# one pass.
STRIP_MIN_BLOCKS_WIDE = {3: 120, 5: 200, 7: 120}
STRIP_MIN_BLOCKS_NARROW = {3: 132, 5: 120, 7: 120}
STRIP_MAX_BLOCKS_NARROW = 264
STRIP_SHORT_ROWS = 12

_launches = LAUNCHES["depthwise_conv"]
_dx_launches = LAUNCHES["depthwise_conv_dx"]
_dw_launches = LAUNCHES["depthwise_conv_dw"]
_lib = None
# the parameter-gradient kernel: a block is a slice of 32 channels by k tap rows
# over one tile of at most DW_TILE_COLS columns and a run of rows of the batch;
# a channel slice writes at most DW_MAX_RUNS partial rows (``dw_grad_plan``)
DW_CHANNELS = 32
DW_TILE_COLS = 64
DW_MAX_RUNS = 512
DW_KERNEL_SIZES = (3, 5, 7, 9, 11)


def _kernel():
    global _lib
    if _lib is None:
        from ics_tpu_torch.ops import _build

        lib = _build.load("depthwise_conv")
        fn = lib.ics_depthwise_conv
        fn.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ]   # dtype, variant, x, taps, bias, y, B, H, W, C, k, ch, cols, cb, tw, rh, ...
        fn.restype = ctypes.c_int
        lib.ics_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ics_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _taps(w: torch.Tensor, channels: int) -> torch.Tensor:
    """The taps as a [k, k, C] view (no copy) of ``w``: [k, k, C], HWIO
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


def kernel_taps(w: torch.Tensor, channels: int,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The taps as the kernels read them: a dense [k * k, C] tensor in
    ``dtype`` (default: ``w``'s), tap (dy, dx) of channel c at
    ``[dy * k + dx, c]``. A view where ``w`` already lies so, else a copy."""
    taps = _taps(w, channels)
    k = taps.shape[0]
    if dtype is not None:
        taps = taps.to(dtype)
    return taps.reshape(k * k, channels).contiguous()


def flip_taps(taps: torch.Tensor, k: int) -> torch.Tensor:
    """Dense [k * k, C] taps flipped in both spatial axes: tap (dy, dx) moves to
    (k - 1 - dy, k - 1 - dx). The depthwise convolution of ``dy`` with them is
    the input gradient of the convolution with ``taps``."""
    return taps.reshape(k, k, -1).flip(0, 1).reshape(k * k, -1).contiguous()


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def strip_geometry(b: int, h: int, w: int, c: int, k: int, itemsize: int, ch: int,
                   cols: int) -> Optional[tuple[int, int, int, int, int]]:
    """(ch, cols, cb, tw, rh) of the strip kernel for a [b, h, w, c] call
    with threads of ``ch`` channels by ``cols`` columns, or None where the
    kernel does not take the shape so.

    A block is ``tw`` threads side by side along W (``tw * cols`` output
    columns) by ``cb`` along C (``cb * ch`` channels) and walks down ``rh``
    rows. The cheapest (cb, tw) wins, counting per row of a block the columns
    its threads compute (whole warps) and the 16-byte pieces it stages,
    ``tw * cols + k - 1`` columns of them, over all blocks of a row; a block's
    share of a pixel is at least ``STRIP_MIN_RUN_BYTES``, or all of C. ``rh``
    cuts H as ``STRIP_TARGET_BLOCKS`` and ``STRIP_MIN_ROWS`` say."""
    if c % ch or (c * itemsize) % 16 or w * c * itemsize >= 2**31 or b > 65535:
        return None
    unit = ch * itemsize
    units = c // ch
    best = None
    for cb in range(1, min(units, STRIP_MAX_THREADS) + 1):
        run = cb * unit
        if run % 16 or (cb < units and run < STRIP_MIN_RUN_BYTES[k]):
            continue
        for tw in range(1, min(_ceil_div(w, cols), STRIP_MAX_THREADS // cb) + 1):
            threads = cb * tw
            pieces = (tw * cols + k - 1) * run // 16
            if not strip_fits((ch, cols, cb, tw, 1), k, itemsize):
                continue
            blocks = _ceil_div(units, cb) * _ceil_div(w, tw * cols)
            cost = blocks * (_ceil_div(threads, 32) * 32 * cols + pieces)
            if best is None or (cost, -threads) < best[0]:
                best = ((cost, -threads), cb, tw, blocks)
    if best is None:
        return None
    _, cb, tw, blocks = best
    strips = max(1, min(_ceil_div(STRIP_TARGET_BLOCKS[k], blocks * b), h // STRIP_MIN_ROWS[k]))
    rh = _ceil_div(h, strips)
    if _ceil_div(h, rh) > 65535:
        return None
    return ch, cols, cb, tw, rh


def strip_fits(geometry, k: int, itemsize: int) -> bool:
    """Whether a block of ``geometry`` is within what ``launch_strip`` in the
    source takes: whole 16-byte pieces, at most ``STRIP_MAX_PIECES`` of them a
    thread and row, at most 256 threads, the ring within ``STRIP_MAX_SMEM``."""
    ch, cols, cb, tw, rh = geometry
    run = cb * ch * itemsize
    pieces = (tw * cols + k - 1) * run // 16
    return (run % 16 == 0 and 1 <= cb * tw <= 256 and rh >= 1
            and pieces <= STRIP_MAX_PIECES * cb * tw
            and STRIP_STAGES * pieces * 16 <= STRIP_MAX_SMEM)


def strip_blocks(geometry, b: int, h: int, w: int, c: int) -> int:
    """Thread blocks of a strip-kernel launch with ``geometry``."""
    ch, cols, cb, tw, rh = geometry
    return _ceil_div(c, cb * ch) * _ceil_div(w, tw * cols) * _ceil_div(h, rh) * b


@functools.lru_cache(maxsize=None)
def pick_plan(b: int, h: int, w: int, c: int, k: int, itemsize: int,
              aligned: bool = True) -> tuple[str, Optional[tuple]]:
    """(variant, geometry) of a [b, h, w, c] call (cached: a model asks for the
    same few shapes on every step): the strip kernel with the first of its
    thread shapes (``STRIP_SHAPES``: wide, then narrow) whose grid is one that
    the shape serves (``STRIP_MIN_BLOCKS_WIDE`` and the constants beside it); for
    any other call, or a pixel that is no multiple of 16 bytes, the tile
    kernel, whose threads are many and short (k 3, 5, 7 and an even C); and
    "direct" (one thread an output: any odd k, any C, any alignment) for what
    neither takes."""
    for i, (ch, cols) in enumerate(STRIP_SHAPES.get((itemsize, k), ()) if aligned else ()):
        geometry = strip_geometry(b, h, w, c, k, itemsize, ch, cols)
        if geometry is None:
            continue
        blocks = strip_blocks(geometry, b, h, w, c)
        if i == 0:
            serves = blocks >= STRIP_MIN_BLOCKS_WIDE[k]
        else:
            serves = blocks <= STRIP_MAX_BLOCKS_NARROW and (
                blocks >= STRIP_MIN_BLOCKS_NARROW[k] or (k >= 5 and geometry[4] <= STRIP_SHORT_ROWS))
        if serves:
            return "strip", geometry
    if aligned and k in (3, 5, 7) and c % 2 == 0:
        return "tile", None
    return "direct", None


def pick_variant(x_shape, k: int, dtype: torch.dtype, aligned: bool = True) -> str:
    """Which kernel of the source a call takes (see ``pick_plan``)."""
    return pick_plan(*x_shape, k, _ITEMSIZE[dtype], aligned)[0]


def pick_geometry(b: int, h: int, w: int, c: int, k: int,
                  itemsize: int) -> Optional[tuple[int, int, int, int, int]]:
    """The strip kernel's geometry for a call that ``pick_plan`` gives to it,
    else the geometry of the first thread shape that takes the call, or None."""
    variant, geometry = pick_plan(b, h, w, c, k, itemsize)
    if variant == "strip":
        return geometry
    for ch, cols in STRIP_SHAPES.get((itemsize, k), ()):
        geometry = strip_geometry(b, h, w, c, k, itemsize, ch, cols)
        if geometry is not None:
            return geometry
    return None


def _launch(x: torch.Tensor, taps: torch.Tensor, b: Optional[torch.Tensor], k: int,
            variant: Optional[str] = None,
            geometry: Optional[tuple[int, int, int, int, int]] = None,
            counter=_launches) -> torch.Tensor:
    """One launch on CUDA tensors that the caller has checked: x contiguous
    [B, H, W, C] in bf16 or fp32, taps dense [k * k, C] and b [C] of x's
    dtype on x's device. ``counter`` counts it."""
    bsz, h, wd, c = x.shape
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    bias_ptr = None if b is None else b.data_ptr()
    if variant is None:
        aligned = not ((x.data_ptr() | out.data_ptr() | taps.data_ptr() | (bias_ptr or 0)) & 15)
        variant, geometry = pick_plan(bsz, h, wd, c, k, x.element_size(), aligned)
    ch = cols = cb = tw = rh = 0
    if variant == "strip":
        geometry = geometry or pick_geometry(bsz, h, wd, c, k, x.element_size())
        if geometry is None:
            raise ValueError(f"depthwise_conv: the strip kernel does not take {tuple(x.shape)} "
                             f"at k={k} in {x.dtype}")
        if not strip_fits(geometry, k, x.element_size()):
            raise ValueError(f"depthwise_conv: the strip kernel does not take the geometry "
                             f"{geometry} at k={k} in {x.dtype}")
        ch, cols, cb, tw, rh = geometry
    lib = _kernel()
    rc = lib.ics_depthwise_conv(
        _DTYPE_CODES[x.dtype], VARIANTS[variant], x.data_ptr(), taps.data_ptr(), bias_ptr,
        out.data_ptr(), bsz, h, wd, c, k, ch, cols, cb, tw, rh, *stream_and_device(x),
    )
    if rc != 0:
        msg = lib.ics_cuda_error_string(rc).decode()
        raise RuntimeError(f"depthwise_conv kernel ({variant}) launch failed: {msg} "
                           f"(cudaError {rc})")
    counter.add()
    return out


def _dw_kernel():
    from ics_tpu_torch.ops import _build

    lib = _build.load("depthwise_conv_dw")
    fn = lib.ics_depthwise_conv_dw
    if fn.argtypes is None:
        c_int, ptr = ctypes.c_int, ctypes.c_void_p
        fn.argtypes = [c_int] + [ptr] * 5 + [c_int] * 8 + [ptr, c_int]
        fn.restype = c_int
        resident = lib.ics_depthwise_conv_dw_resident
        resident.argtypes = [c_int] * 4
        resident.restype = c_int
        lib.ics_cuda_error_string.argtypes = [c_int]
        lib.ics_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _dw_resident(dtype_code: int, k: int, tile_w: int, device: int) -> int:
    """Blocks of the parameter-gradient kernel that fit the card at once (the
    source's occupancy query, asked once a shape)."""
    lib = _dw_kernel()
    got = lib.ics_depthwise_conv_dw_resident(dtype_code, k, tile_w, device)
    if got <= 0:
        msg = lib.ics_cuda_error_string(-got).decode()
        raise RuntimeError(f"depthwise_conv_dw: no occupancy at k={k}, tile {tile_w}: {msg}")
    return got


def dw_grad_tile(w: int) -> int:
    """Columns a tile of the parameter-gradient kernel: W cut into the fewest
    tiles of at most ``DW_TILE_COLS``, of equal width but the last."""
    return _ceil_div(w, _ceil_div(w, DW_TILE_COLS))


def dw_grad_plan(b: int, h: int, w: int, c: int, resident: int) -> tuple[int, int, int]:
    """(tile_w, rows, runs) of a [b, h, w, c] call of the parameter-gradient
    kernel: W in tiles of ``tile_w`` columns, the b * h rows in ``runs`` runs of
    ``rows`` rows (the last may be shorter), a block for each (channel slice,
    tile, run). As many blocks as fit the card at once (``resident``), at most
    ``DW_MAX_RUNS`` partial rows a channel slice (tiles times runs), at least one
    run a tile and no more runs than rows."""
    tile_w = dw_grad_tile(w)
    tiles = _ceil_div(w, tile_w)
    per_tile = resident // (_ceil_div(c, DW_CHANNELS) * tiles)
    runs = max(1, min(per_tile, DW_MAX_RUNS // tiles, b * h))
    rows = _ceil_div(b * h, runs)
    return tile_w, rows, _ceil_div(b * h, rows)


def _launch_dw(x: torch.Tensor, dy: torch.Tensor, k: int,
               with_bias: bool) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One call of the parameter-gradient kernel (its partial pass and its
    reduction, counted once) on CUDA tensors that the caller has checked: x
    and dy contiguous [B, H, W, C] of one dtype -> (dtaps [k * k, C], dbias
    [C] or None), fp32."""
    bsz, h, wd, c = x.shape
    stream, device = stream_and_device(x)
    code = _DTYPE_CODES[x.dtype]
    tile_w, rows, runs = dw_grad_plan(bsz, h, wd, c,
                                      _dw_resident(code, k, dw_grad_tile(wd), device))
    slots = _ceil_div(wd, tile_w) * runs
    part = torch.empty(slots * (k * k + 1) * c, dtype=torch.float32, device=x.device)
    dtaps = torch.empty(k * k, c, dtype=torch.float32, device=x.device)
    dbias = torch.empty(c, dtype=torch.float32, device=x.device) if with_bias else None
    lib = _dw_kernel()
    rc = lib.ics_depthwise_conv_dw(
        code, x.data_ptr(), dy.data_ptr(), part.data_ptr(), dtaps.data_ptr(),
        None if dbias is None else dbias.data_ptr(), bsz, h, wd, c, k, tile_w, rows, runs,
        stream, device,
    )
    if rc != 0:
        msg = lib.ics_cuda_error_string(rc).decode()
        raise RuntimeError(f"depthwise_conv_dw kernel launch failed: {msg} (cudaError {rc})")
    _dw_launches.add()
    return dtaps, dbias


def _taps_grad(dtaps: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """dtaps [k * k, C] laid out as the weight ``like`` ([k * k, C], [k, k,
    C], HWIO [k, k, 1, C] or OIHW [C, 1, k, k]), in its dtype."""
    c = dtaps.shape[1]
    if like.dim() == 2:
        return dtaps.to(like.dtype)
    k = math.isqrt(dtaps.shape[0])
    grad = torch.empty(like.shape, dtype=like.dtype, device=dtaps.device)
    _taps(grad, c).copy_(dtaps.view(k, k, c))
    return grad


class _DepthwiseConv(torch.autograd.Function):
    """The kernel under autograd: the forward launch, and a backward that
    launches the kernel on the flipped taps for the input gradient and the
    parameter-gradient kernel for the taps and the bias. ``weight`` and
    ``bias_param`` are the parameters that ``taps`` and ``bias`` were made
    from (None where those are the operands themselves): their gradients
    come back in their layout and dtype."""

    @staticmethod
    def forward(ctx, x, taps, bias, flipped, k, weight, bias_param):
        # a constant of the backward, kept as an attribute: a module's cached
        # taps may be made under inference_mode, and such a tensor cannot be
        # saved for backward
        ctx.flipped, ctx.k = flipped, k
        needs = ctx.needs_input_grad
        ctx.taps_like = weight if needs[5] else taps if needs[1] else None
        ctx.bias_like = bias_param if needs[6] else bias if needs[2] else None
        if ctx.taps_like is not None or ctx.bias_like is not None:
            ctx.save_for_backward(x)
        return _launch(x, taps, bias, k)

    @staticmethod
    def backward(ctx, dy):
        dy = dy.contiguous()
        needs = ctx.needs_input_grad
        grads = [None] * 7
        if needs[0]:
            grads[0] = _launch(dy, ctx.flipped, None, ctx.k, counter=_dx_launches)
        if ctx.taps_like is not None or ctx.bias_like is not None:
            (x,) = ctx.saved_tensors
            dtaps, dbias = _launch_dw(x, dy.to(x.dtype), ctx.k, ctx.bias_like is not None)
            if ctx.taps_like is not None:
                grads[5 if needs[5] else 1] = _taps_grad(dtaps, ctx.taps_like)
            if ctx.bias_like is not None:
                grads[6 if needs[6] else 2] = dbias.to(ctx.bias_like.dtype)
        return tuple(grads)


def depthwise_conv_taps(x: torch.Tensor, taps: torch.Tensor, b: Optional[torch.Tensor],
                        k: int, flipped: torch.Tensor, weight: torch.Tensor,
                        bias_param: Optional[torch.Tensor]) -> torch.Tensor:
    """The serving path of a module that keeps its own ``kernel_taps``: CUDA
    tensors only, ``taps``, ``b`` and ``flipped`` (``flip_taps`` of ``taps``)
    made for ``x.dtype`` on ``x``'s device by the module from its parameters
    ``weight`` and ``bias_param``. Checks what changes from call to call and
    launches; where autograd would record the call, it runs under
    ``_DepthwiseConv``, whose backward gives the gradients of ``x``,
    ``weight`` and ``bias_param``."""
    if not x.is_cuda or x.dtype not in _DTYPE_CODES or taps.dtype != x.dtype \
            or x.dim() != 4 or taps.shape[1] != x.shape[3] or not x.is_contiguous() \
            or x.numel() >= 2**31:
        raise ValueError(
            f"depthwise_conv_taps wants a contiguous CUDA [B, H, W, {taps.shape[1]}] x of "
            f"{taps.dtype} with fewer than 2^31 elements; got {tuple(x.shape)} {x.dtype} "
            f"on {x.device}")
    if wants_grad(x, weight, bias_param):
        return _DepthwiseConv.apply(x, taps, b, flipped, k, weight, bias_param)
    return _launch(x, taps, b, k)


def depthwise_conv(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
                   variant: Optional[str] = None,
                   geometry: Optional[tuple[int, int, int, int, int]] = None) -> torch.Tensor:
    """x [B, H, W, C], w [k, k, C] (or [C, 1, k, k]), optional bias [C]
    -> [B, H, W, C] in ``x.dtype``: stride 1, zero padding ``k // 2``.

    CUDA tensors go through the kernel (bf16 or fp32, x contiguous, w and b
    of x's dtype, fewer than 2^31 elements); anything it does not take
    raises. CPU tensors take the plain version. ``variant`` ("strip",
    "tile", "direct") and ``geometry`` (the strip kernel's (ch, cols, cb, tw,
    rh)) override ``pick_plan``, for measurements.
    """
    if x.dim() != 4:
        raise ValueError(f"depthwise_conv wants x as [B, H, W, C]; got {tuple(x.shape)}")
    c = x.shape[3]
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
    if variant is not None and variant not in VARIANTS:
        raise ValueError(f"depthwise_conv: variant must be one of {sorted(VARIANTS)}")
    if variant == "tile" and (k not in (3, 5, 7) or c % 2):
        raise ValueError(f"depthwise_conv: the tile kernel does not take C={c} at k={k}")
    taps = kernel_taps(w, c)
    if wants_grad(x, taps, b):
        return _DepthwiseConv.apply(x, taps, b, flip_taps(taps, k), k, None, None)
    return _launch(x, taps, b, k, variant, geometry)


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


def depthwise_dx_reference(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain version of the input gradient that ``_DepthwiseConv``'s
    backward launches: dy [B, H, W, C], w as ``depthwise_conv`` takes it ->
    dx, autograd of ``depthwise_reference`` with respect to its input (the
    convolution is linear in x, so any x of dy's shape will do)."""
    with torch.enable_grad():
        x = torch.zeros_like(dy, requires_grad=True)
        (dx,) = torch.autograd.grad(depthwise_reference(x, w.detach()), x, dy)
    return dx


def depthwise_conv_dw(x: torch.Tensor, dy: torch.Tensor, k: int,
                      with_bias: bool = True) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The gradients of ``depthwise_conv(x, w, b)``'s taps and bias given
    ``dy``: x and dy [B, H, W, C] -> (dtaps [k * k, C], dbias [C] or None),
    fp32, tap (i, j) of channel c at ``dtaps[i * k + j, c]``.

    CUDA tensors go through the kernel (bf16 or fp32 x and dy of one dtype,
    contiguous, odd k from 3 to 11); anything it does not take raises. CPU
    tensors take the plain version, ``depthwise_dw_reference``."""
    if x.dim() != 4 or dy.shape != x.shape:
        raise ValueError(f"depthwise_conv_dw wants x and dy of one [B, H, W, C] shape; got "
                         f"{tuple(x.shape)}, {tuple(dy.shape)}")
    if {x.device, dy.device} == {torch.device("cpu")}:
        dtaps, dbias = depthwise_dw_reference(x, dy, k)
        return dtaps, dbias if with_bias else None
    if x.device != dy.device or x.device.type != "cuda":
        raise ValueError(f"depthwise_conv_dw wants x and dy on one CUDA device; got "
                         f"{x.device}, {dy.device}")
    if x.dtype not in _DTYPE_CODES or dy.dtype != x.dtype:
        raise ValueError(f"depthwise_conv_dw takes bf16 or fp32 x and dy of one dtype; got "
                         f"{x.dtype}, {dy.dtype}")
    if k not in DW_KERNEL_SIZES:
        raise ValueError(f"depthwise_conv_dw takes k in {DW_KERNEL_SIZES}; got {k}")
    if not (x.is_contiguous() and dy.is_contiguous()) or x.numel() >= 2**31:
        raise ValueError(f"depthwise_conv_dw wants contiguous x and dy with fewer than 2^31 "
                         f"elements; got {tuple(x.shape)}")
    if _ceil_div(x.shape[3], DW_CHANNELS) > 65535:
        raise ValueError(f"depthwise_conv_dw: {x.shape[3]} channels are too many")
    return _launch_dw(x, dy, k, with_bias)


def depthwise_dw_reference(x: torch.Tensor, dy: torch.Tensor,
                           k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of ``depthwise_conv_dw``: autograd of
    ``depthwise_reference`` with respect to its taps and bias, in fp32 (no
    TF32) -> (dtaps [k * k, C], dbias [C])."""
    c = x.shape[-1]
    with torch.enable_grad(), torch.backends.cudnn.flags(allow_tf32=False):
        w = torch.zeros(k, k, c, dtype=torch.float32, device=x.device, requires_grad=True)
        b = torch.zeros(c, dtype=torch.float32, device=x.device, requires_grad=True)
        y = depthwise_reference(x.detach().float(), w, b)
        dw, db = torch.autograd.grad(y, (w, b), dy.float())
    return dw.reshape(k * k, c), db
