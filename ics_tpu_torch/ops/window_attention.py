"""Window attention (Swin): a hand-written CUDA kernel for Hopper and its plain
versions, behind two entries.

Counterpart of ``scripts/proto_window_attn.py::pallas_window_attention``.
Both entries launch ``csrc/window_attention.cu`` on CUDA tensors; on CPU
tensors, and only there, they compute their plain versions. The kernel
follows the TPU kernel's contract: per (window, head) QK^T with q pre-scaled,
plus the relative-position bias and the shift mask, all in fp32; an fp32
softmax; P divided by its row sum and then rounded to the input's type; P·V
accumulated in fp32; one rounding of the output. The mask's -1e4 entries are
finite on purpose and are added as they are. The [Bn, H, ww, ww] score
tensor never reaches device memory.

- ``window_attention(q, k, v, bias, mask)``: the JAX contract, [Bn, H, ww, hd]
  with rows image-major (window index = row mod nW), bias [H, ww, ww].
- ``window_attention_qkv(qkv, rel_table, rel_index, mask, window, shift,
  scale)``: what Swin serves. It reads q, k and v by strides from the qkv
  product [B, G, G, 3, H, hd] as it leaves its GEMM and returns the merged
  heads [B, G, G, H·hd] in image order: the same function as roll by -shift,
  window partition, q/k/v split, ``q * scale`` rounded to the input's type,
  ``window_attention``, head merge, window merge and roll by +shift, which
  is its plain version, step for step. The bias is gathered from the
  [(2w-1)², H] table through the [ww, ww] index.

bf16 runs on the tensor cores (``mma.sync`` m16n8k16); fp32 takes a SIMT
kernel of plain fp32 FMAs (no TF32). How many heads of a window a work item
of the bf16 kernel takes is picked here from the shape (``pick_head_group``).

Gradients: where autograd would record a call of ``window_attention_qkv`` on
the card, it runs under ``_WindowAttentionQKV``, whose backward is the kernel
of ``csrc/window_attention_bwd.cu`` (``window_attention_qkv_bwd``, counted as
``window_attention_bwd``): the gradient with respect to qkv, S and P
recomputed in the kernel as the forward computes them, one rounding of dqkv
(bf16 on the tensor cores, fp32 SIMT). Its grid is heads x G blocks, each
walking windows of one head; G comes from the card's occupancy
(``backward_groups``). Where the table requires grad, the same launch also
sums dS over each block's windows, and a second entry of the source
(``window_attention_dtable``) reduces those sums and gathers them back
through the index into the table's gradient, fp32, in a fixed order. The
mask takes no gradient. The 4-D entry has no backward and raises
``KernelHasNoGradient``. On the CPU the plain versions are differentiated as
they are.
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from typing import Optional

import torch

from ics_tpu_torch.ops import LAUNCHES, KernelHasNoGradient, stream_and_device, wants_grad

HEAD_DIMS = (16, 32)
MAX_TOKENS = 64
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
_WARPS = 4                   # a block of the bf16 kernel: 16 query rows a warp
_SMEM_MAX = 232448 - 256     # what one thread block may ask for on sm_90, less the
                             # kernel's static token table
_H100_MULTIPROCESSORS = 132  # what pick_head_group counts with where no device is named

_launches = LAUNCHES["window_attention"]
_bwd_launches = LAUNCHES["window_attention_bwd"]
_dtable_launches = LAUNCHES["window_attention_dtable"]
_identity_index: dict = {}
# (order, offsets) of an index tensor for the table's gradient, kept while the
# tensor lives (Swin's are buffers): a dozen small launches a call otherwise
_index_runs: dict = {}


def _kernel():
    from ics_tpu_torch.ops import _build

    lib = _build.load("window_attention")
    fn = lib.ics_window_attention
    if fn.argtypes is None:
        c_int, c_ll, ptr = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
        fn.argtypes = (
            [c_int] + [ptr] * 4 + [c_ll] * 8 + [c_int] * 8 + [ptr, c_ll, c_ll, c_int]
            + [ptr, ptr, c_int, ctypes.c_float, c_int, ptr, c_int]
        )
        fn.restype = ctypes.c_int
        lib.ics_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ics_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _bwd_kernel():
    from ics_tpu_torch.ops import _build

    lib = _build.load("window_attention_bwd")
    fn = lib.ics_window_attention_bwd
    if fn.argtypes is None:
        c_int, c_ll, ptr = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
        fn.argtypes = ([c_int] + [ptr] * 7 + [c_ll] * 12 + [c_int] * 8 + [ptr, c_ll, c_ll, c_int]
                       + [ptr, ptr, c_int, ctypes.c_float, ptr, c_int, ptr, c_int])
        fn.restype = ctypes.c_int
        resident = lib.ics_window_attention_bwd_resident
        resident.argtypes = [c_int] * 7
        resident.restype = c_int
        table = lib.ics_window_attention_dtable
        table.argtypes = [ptr, c_int, c_int, c_int, ptr, ptr, ptr, c_int, ptr, ptr, c_int]
        table.restype = ctypes.c_int
        lib.ics_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ics_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_resident(dtype_code: int, hd: int, ww: int, table_rows: int, masked: bool,
                  mask_fixed: bool, device: int) -> int:
    """Blocks of the backward kernel that fit the card at once at this shape
    (the source's occupancy query, asked once a shape)."""
    lib = _bwd_kernel()
    got = lib.ics_window_attention_bwd_resident(dtype_code, hd, ww, table_rows, int(masked),
                                                int(mask_fixed), device)
    if got <= 0:
        msg = lib.ics_cuda_error_string(-got).decode()
        raise RuntimeError(f"window_attention_bwd: no occupancy for ww={ww}, hd={hd}: {msg}")
    return got


def backward_groups(windows: int, heads: int, n_mask: int, resident_shared: int,
                    resident_per_item: int) -> int:
    """G, the blocks a head of the backward's grid of heads x G: block g of a
    head walks windows g, g + G, ... of that head and, with the table's
    gradient, writes one [ww, ww] partial sum of dS. As many blocks as fit the
    card at once (one wave), at least one a head and at most one a window.
    Window n takes mask n mod ``n_mask``, so where G is a multiple of
    ``n_mask`` all of a block's windows share one mask, which the block then
    stages once: G is such a multiple wherever that keeps at least as many
    blocks as staging a mask with every item would fit.
    ``resident_shared``: blocks that fit with the mask kept once (or none);
    ``resident_per_item``: with a mask in each stage of the ring."""
    per_item = max(1, min(windows, resident_per_item // heads))
    shared = min(windows, resident_shared // heads)
    if n_mask <= 1:
        return max(1, shared)
    shared = shared // n_mask * n_mask
    return shared if shared >= per_item else per_item


def _plan_backward(dtype: torch.dtype, hd: int, window: int, table_rows: int, windows: int,
                   heads: int, mask: Optional[torch.Tensor], device: int) -> int:
    """G of a backward launch from the card's occupancy (``backward_groups``)."""
    code, ww = _DTYPE_CODES[dtype], window * window
    masked = mask is not None
    shared = _bwd_resident(code, hd, ww, table_rows, masked, True, device)
    per_item = _bwd_resident(code, hd, ww, table_rows, masked, False, device) if masked else shared
    return backward_groups(windows, heads, mask.shape[0] if masked else 1, shared, per_item)


def _index_order(rel_index: torch.Tensor, rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(order, offsets) of the [ww, ww] index, int32 on its device: the
    positions sorted by the table row they read (stable), and where each row's
    run starts, [rows + 1]. Kept per index tensor while it lives and is not
    written."""
    key = (0 if rel_index.is_inference() else rel_index._version, rows)
    runs = _index_runs.get(id(rel_index))
    if runs is None or runs[0]() is not rel_index or runs[1] != key:
        if runs is None or runs[0]() is not rel_index:
            weakref.finalize(rel_index, _index_runs.pop, id(rel_index), None)
        flat = rel_index.reshape(-1).long()
        order = torch.sort(flat, stable=True).indices.to(torch.int32)
        offsets = torch.zeros(rows + 1, dtype=torch.int32, device=flat.device)
        offsets[1:] = torch.cumsum(torch.bincount(flat, minlength=rows), 0)
        runs = _index_runs[id(rel_index)] = (weakref.ref(rel_index), key, order, offsets)
    return runs[2:]


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def key_tiles(ww: int) -> int:
    """8-key tiles of the scores the bf16 kernel is built for at ``ww``."""
    return 2 if ww <= 16 else 4 if ww <= 32 else 7 if ww <= 56 else 8


def index_stride(ww: int) -> int:
    """Row stride (elements) of the index in shared memory: the keys of the
    kernel's tiles as an odd multiple of 8, so that the eight rows a quad of
    lanes reads in pairs lie on distinct banks."""
    keys = 8 * key_tiles(ww)
    return keys + 8 if keys % 16 == 0 else keys


def smem_bytes(ww: int, hd: int, head_group: int, table_rows: int, masked: bool) -> int:
    """Dynamic shared memory of one block of the bf16 kernel (the formula of
    ``ics_window_attention``): the int16 index, then two ring stages, each
    with q, k and v of ``head_group`` heads (the tiles' keys rounded up to 16
    rows, padded by 8 bf16), their fp32 table columns and, with a mask, the
    16-byte pieces of the window's fp32 [ww, ww] block (from up to 3 floats
    before it to the last row's keys past ww, which are read and dropped)."""
    keys = 8 * key_tiles(ww)
    rows = _round_up(keys, 16)
    stage = head_group * 3 * rows * (hd + 8) * 2 + _round_up(head_group * table_rows * 4, 16)
    if masked:
        stage += _round_up((3 + (ww - 1) * ww + keys) * 4, 16)
    return _round_up(ww * index_stride(ww) * 2, 16) + 2 * stage


@functools.lru_cache(maxsize=None)
def pick_head_group(windows: int, heads: int, ww: int, hd: int, table_rows: int, masked: bool,
              multiprocessors: int = _H100_MULTIPROCESSORS) -> int:
    """Heads a work item of the bf16 kernel takes, for ``windows`` windows of
    ``heads`` heads (cached: the serving path asks for the same few shapes on
    every step).

    A work item is a window and ``head_group`` of its heads; each of a
    block's four warps takes 16 query rows of one head. The group is the
    largest divisor of ``heads`` whose rows still leave no warp a second task
    (``head_group * ceil(ww / 16) <= 4``) and that still makes two items for
    every multiprocessor; one head where none does. A larger group stages a
    window's mask once for more heads; a smaller one keeps the card full at
    small batches."""
    row_tiles = -(-ww // 16)
    if smem_bytes(ww, hd, 1, table_rows, masked) > _SMEM_MAX:
        raise ValueError(f"window_attention: a table of {table_rows} rows does not fit a "
                         "thread block's shared memory")
    fits = [g for g in range(1, heads + 1)
            if heads % g == 0 and g * row_tiles <= _WARPS
            and smem_bytes(ww, hd, g, table_rows, masked) <= _SMEM_MAX]
    busy = [g for g in fits if windows * (heads // g) >= 2 * multiprocessors]
    return max(busy) if busy else 1


def _identity(ww: int, device: torch.device) -> torch.Tensor:
    """[ww, ww] int16 index j = r * ww + c: the 4-D entry's bias as a table."""
    key = (ww, device)
    if key not in _identity_index:
        _identity_index[key] = torch.arange(ww * ww, dtype=torch.int16, device=device).view(ww, ww)
    return _identity_index[key]


def _launch(q_ptr: int, k_ptr: int, v_ptr: int, out: torch.Tensor, strides, out_strides,
            grid: tuple, window: tuple, shift: int, heads: int, hd: int, dtype: torch.dtype,
            table: torch.Tensor, table_rows: int, table_strides: tuple, index: torch.Tensor,
            mask: Optional[torch.Tensor], scale: float) -> None:
    """One launch of the kernel: ``grid`` (batch, gy, gx) tokens in windows of
    ``window`` (wh, wwid), strides in elements; row j of head h of the table
    at ``j * table_strides[0] + h * table_strides[1]``; the heads a work item
    takes from ``pick_head_group``."""
    batch, gy, gx = grid
    wh, wwid = window
    windows = batch * (gy // wh) * (gx // wwid)
    sms = torch.cuda.get_device_properties(out.device).multi_processor_count
    head_group = pick_head_group(windows, heads, wh * wwid, hd, table_rows, mask is not None, sms)
    if mask is not None and mask.data_ptr() % 16:
        raise ValueError("window_attention wants a 16-byte aligned mask")
    lib = _kernel()
    rc = lib.ics_window_attention(
        _DTYPE_CODES[dtype], q_ptr, k_ptr, v_ptr, out.data_ptr(), *strides, *out_strides,
        batch, gy, gx, wh, wwid, shift, heads, hd, table.data_ptr(), *table_strides,
        table_rows, index.data_ptr(), None if mask is None else mask.data_ptr(),
        1 if mask is None else mask.shape[0], scale, head_group,
        *stream_and_device(out),
    )
    if rc != 0:
        msg = lib.ics_cuda_error_string(rc).decode()
        raise RuntimeError(f"window_attention kernel launch failed: {msg} (cudaError {rc})")
    _launches.add()


def _check_device_and_types(name: str, tensors: list, dtype: torch.dtype, hd: int,
                            ww: int) -> None:
    devices = {t.device for t in tensors}
    if len(devices) != 1 or tensors[0].device.type != "cuda":
        raise ValueError(f"{name} wants all tensors on one CUDA device; got {devices}")
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"{name} takes bf16 or fp32 q, k, v of one dtype; got {dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name} takes head_dim in {HEAD_DIMS}; got {hd}")
    if ww > MAX_TOKENS:
        raise ValueError(f"{name} takes windows of at most {MAX_TOKENS} tokens; got {ww}")


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
                     bias: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q, k, v [Bn, H, ww, hd] (Bn = B·nW, image-major; q pre-scaled), bias
    [H, ww, ww] fp32, mask [nW, ww, ww] fp32 or None -> [Bn, H, ww, hd].

    CUDA tensors go through the kernel (bf16 or fp32 q, k, v, contiguous and
    16-byte aligned, hd in 16/32, ww <= 64, fp32 bias and mask); anything it
    does not take raises. CPU tensors take the plain version.
    """
    _check_shapes(q, k, v, bias, mask)
    tensors = [q, k, v, bias] + ([] if mask is None else [mask])
    if {t.device for t in tensors} == {torch.device("cpu")}:
        return window_attention_reference(q, k, v, bias, mask)
    bn, h, ww, hd = q.shape
    _check_device_and_types("window_attention", tensors, q.dtype, hd, ww)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"window_attention takes bf16 or fp32 q, k, v of one dtype; got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if bias.dtype != torch.float32 or (mask is not None and mask.dtype != torch.float32):
        raise ValueError("window_attention takes fp32 bias and mask")
    for name, t in (("q", q), ("k", k), ("v", v), ("bias", bias), ("mask", mask)):
        if t is None:
            continue
        if not t.is_contiguous():
            raise ValueError(f"window_attention wants contiguous tensors; {name} is not")
        if t.data_ptr() % 16:
            raise ValueError(f"window_attention wants 16-byte aligned tensors; {name} is not")
    if bn * h >= 2**31:
        raise ValueError(f"window_attention: shape {tuple(q.shape)} is too large")
    if wants_grad(*tensors):
        raise KernelHasNoGradient(
            "window_attention (the [Bn, H, ww, hd] entry) has no backward on the card; "
            "window_attention_qkv, the entry Swin serves, has one")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    # a window a row: one image row of ww tokens, heads ww * hd apart
    strides = (q.stride(0), 0, q.stride(2), q.stride(1))
    _launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out, strides, strides, (bn, 1, ww),
            (1, ww), 0, h, hd, q.dtype, bias, ww * ww, (1, ww * ww), _identity(ww, q.device), mask,
            1.0)
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


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """[B, H, W, C] -> [B*nH*nW, ww, C]."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)


def window_merge(x: torch.Tensor, window: int, grid: int, batch: int) -> torch.Tensor:
    """Inverse of ``window_partition``."""
    n = grid // window
    x = x.reshape(batch, n, n, window, window, x.shape[-1])
    return x.permute(0, 1, 3, 2, 4, 5).reshape(batch, grid, grid, x.shape[-1])


def relative_bias(rel_table: torch.Tensor, rel_index: torch.Tensor) -> torch.Tensor:
    """The relative-position bias [H, ww, ww] in fp32: the [(2w-1)², H] table
    gathered through the [ww, ww] index."""
    return rel_table.float()[rel_index.long()].permute(2, 0, 1).contiguous()


def _check_qkv_shapes(qkv, rel_table, rel_index, mask, window: int, shift: int) -> None:
    if qkv.dim() != 6 or qkv.shape[3] != 3 or qkv.shape[1] != qkv.shape[2]:
        raise ValueError(
            f"window_attention_qkv wants qkv as [B, G, G, 3, H, hd]; got {tuple(qkv.shape)}")
    grid, heads = qkv.shape[1], qkv.shape[4]
    ww = window * window
    if window < 1 or grid % window:
        raise ValueError(f"window_attention_qkv: grid {grid} is not a multiple of the window "
                         f"{window}")
    if not 0 <= shift < window:
        raise ValueError(f"window_attention_qkv wants 0 <= shift < window {window}; got {shift}")
    if rel_table.dim() != 2 or rel_table.shape[1] != heads:
        raise ValueError(f"window_attention_qkv wants rel_table as [rows, H = {heads}]; got "
                         f"{tuple(rel_table.shape)}")
    if tuple(rel_index.shape) != (ww, ww) or rel_index.dtype.is_floating_point:
        raise ValueError(f"window_attention_qkv wants an integer rel_index [ww, ww] = "
                         f"{[ww, ww]}; got {tuple(rel_index.shape)} {rel_index.dtype}")
    n_w = (grid // window) ** 2
    if mask is not None and tuple(mask.shape) != (n_w, ww, ww):
        raise ValueError(f"window_attention_qkv wants mask as [nW, ww, ww] = {[n_w, ww, ww]}; "
                         f"got {tuple(mask.shape)}")


def check_qkv_layout(qkv: torch.Tensor) -> None:
    """What the kernel asks of the qkv product's layout: its last dimension
    contiguous, its base and every other stride 16-byte aligned (each head's
    row moves as 16-byte pieces). Raises ValueError otherwise."""
    size = qkv.element_size()
    if qkv.stride(-1) != 1:
        raise ValueError("window_attention_qkv wants qkv's last dimension contiguous")
    if qkv.data_ptr() % 16:
        raise ValueError("window_attention_qkv wants qkv 16-byte aligned")
    if any(qkv.stride(d) * size % 16 for d in range(qkv.dim() - 1) if qkv.shape[d] > 1):
        raise ValueError(f"window_attention_qkv wants qkv's strides in 16-byte steps; got "
                         f"{qkv.stride()} of {size}-byte elements")


def _check_qkv_call(name: str, qkv, rel_table, rel_index, mask, window: int, *others) -> None:
    """What the kernels of the qkv entry ask of a call on the card besides
    qkv's layout: every tensor (``others`` too) on one CUDA device, the
    types, a contiguous mask and int16 index, a shape whose work items an int
    counts."""
    tensors = [qkv, rel_table, rel_index, *others] + ([] if mask is None else [mask])
    b, grid, _, _, h, hd = qkv.shape
    _check_device_and_types(name, tensors, qkv.dtype, hd, window * window)
    if rel_table.dtype != torch.float32 or (mask is not None and mask.dtype != torch.float32):
        raise ValueError(f"{name} takes fp32 rel_table and mask")
    if rel_index.dtype != torch.int16 or not rel_index.is_contiguous():
        raise ValueError(f"{name} takes a contiguous int16 rel_index")
    if mask is not None and not mask.is_contiguous():
        raise ValueError(f"{name} wants a contiguous mask")
    if b * (grid // window) ** 2 * h >= 2**31:
        raise ValueError(f"{name}: shape {tuple(qkv.shape)} is too large")


def window_attention_qkv(qkv: torch.Tensor, rel_table: torch.Tensor, rel_index: torch.Tensor,
                         mask: Optional[torch.Tensor], window: int, shift: int,
                         scale: float) -> torch.Tensor:
    """qkv [B, G, G, 3, H, hd] (any strides, the last dimension contiguous),
    rel_table [(2w-1)², H] fp32, rel_index [ww, ww] int16 (values below the
    table's rows), mask [nW, ww, ww] fp32 or None, ``shift`` the cyclic shift
    of the block -> [B, G, G, H·hd] in image order.

    CUDA tensors go through the kernel (bf16 or fp32 qkv with the layout of
    ``check_qkv_layout``, hd in 16/32, ww <= 64, fp32 table and mask, int16
    index); anything it does not take raises. Where autograd would record
    the call, the gradient with respect to qkv comes from the backward kernel
    (``window_attention_qkv_bwd``). CPU tensors take the plain version.
    """
    _check_qkv_shapes(qkv, rel_table, rel_index, mask, window, shift)
    tensors = [qkv, rel_table, rel_index] + ([] if mask is None else [mask])
    if {t.device for t in tensors} == {torch.device("cpu")}:
        return window_attention_qkv_reference(qkv, rel_table, rel_index, mask, window, shift,
                                              scale)
    _check_qkv_call("window_attention_qkv", qkv, rel_table, rel_index, mask, window)
    check_qkv_layout(qkv)
    if wants_grad(qkv, rel_table, mask):
        return _WindowAttentionQKV.apply(qkv, rel_table, mask, rel_index, window, shift, scale)
    return _qkv_forward(qkv, rel_table, rel_index, mask, window, shift, scale)


def _qkv_forward(qkv, rel_table, rel_index, mask, window: int, shift: int,
                 scale: float) -> torch.Tensor:
    """The forward launch of ``window_attention_qkv`` on checked tensors."""
    b, grid, _, _, h, hd = qkv.shape
    out = torch.empty((b, grid, grid, h * hd), dtype=qkv.dtype, device=qkv.device)
    if out.numel() == 0:
        return out
    step = qkv.stride(3) * qkv.element_size()
    q_ptr = qkv.data_ptr()
    strides = (qkv.stride(0), qkv.stride(1), qkv.stride(2), qkv.stride(4))
    out_strides = (out.stride(0), out.stride(1), out.stride(2), hd)
    _launch(q_ptr, q_ptr + step, q_ptr + 2 * step, out, strides, out_strides, (b, grid, grid),
            (window, window), shift, h, hd, qkv.dtype, rel_table, rel_table.shape[0],
            (rel_table.stride(0), rel_table.stride(1)), rel_index, mask, scale)
    return out


class _WindowAttentionQKV(torch.autograd.Function):
    """``window_attention_qkv`` under autograd: the forward kernel, and the
    backward kernel for the gradients with respect to qkv and, where it
    requires grad, the table (the mask takes none). Nothing of the forward is
    kept but its inputs: the backward recomputes S and P."""

    @staticmethod
    def forward(ctx, qkv, rel_table, mask, rel_index, window, shift, scale):
        ctx.save_for_backward(qkv)
        # the table, mask and index are constants of the backward, kept as
        # attributes: a module's cached copies may be made under
        # inference_mode, and such a tensor cannot be saved for backward
        ctx.args = (rel_table, rel_index, mask, window, shift, scale)
        return _qkv_forward(qkv, rel_table, rel_index, mask, window, shift, scale)

    @staticmethod
    def backward(ctx, dout):
        (qkv,) = ctx.saved_tensors
        dqkv, dtable = _qkv_backward(qkv, dout, *ctx.args, with_table=ctx.needs_input_grad[1])
        return dqkv, dtable, None, None, None, None, None


def _qkv_backward(qkv, dout, rel_table, rel_index, mask, window: int, shift: int,
                  scale: float, with_table: bool = False):
    """The backward launch on checked tensors: (dqkv, contiguous, in qkv's
    shape and dtype; the table's gradient [rows, H] fp32, or None unless
    ``with_table``)."""
    b, grid, _, _, h, hd = qkv.shape
    if tuple(dout.shape) != (b, grid, grid, h * hd):
        raise ValueError(f"window_attention_qkv_bwd wants dout as {[b, grid, grid, h * hd]}; "
                         f"got {tuple(dout.shape)}")
    dout = dout.to(qkv.dtype).contiguous()
    if dout.data_ptr() % 16:
        dout = dout.clone()
    dqkv = torch.empty(qkv.shape, dtype=qkv.dtype, device=qkv.device)
    if dqkv.numel() == 0:
        return dqkv, torch.zeros_like(rel_table) if with_table else None
    ww = window * window
    windows = b * (grid // window) ** 2
    stream, device = stream_and_device(qkv)
    groups = _plan_backward(qkv.dtype, hd, window, rel_table.shape[0], windows, h, mask, device)
    part = (torch.empty(h * groups * ww * ww, dtype=torch.float32, device=qkv.device)
            if with_table else None)
    size = qkv.element_size()
    q_ptr, g_ptr = qkv.data_ptr(), dqkv.data_ptr()
    step, g_step = qkv.stride(3) * size, dqkv.stride(3) * size
    lib = _bwd_kernel()
    rc = lib.ics_window_attention_bwd(
        _DTYPE_CODES[qkv.dtype], q_ptr, q_ptr + step, q_ptr + 2 * step, dout.data_ptr(),
        g_ptr, g_ptr + g_step, g_ptr + 2 * g_step,
        qkv.stride(0), qkv.stride(1), qkv.stride(2), qkv.stride(4),
        dout.stride(0), dout.stride(1), dout.stride(2), hd,
        dqkv.stride(0), dqkv.stride(1), dqkv.stride(2), dqkv.stride(4),
        b, grid, grid, window, window, shift, h, hd,
        rel_table.data_ptr(), rel_table.stride(0), rel_table.stride(1), rel_table.shape[0],
        rel_index.data_ptr(), None if mask is None else mask.data_ptr(),
        1 if mask is None else mask.shape[0], scale,
        None if part is None else part.data_ptr(), groups, stream, device,
    )
    if rc != 0:
        msg = lib.ics_cuda_error_string(rc).decode()
        raise RuntimeError(f"window_attention_bwd kernel launch failed: {msg} (cudaError {rc})")
    _bwd_launches.add()
    if not with_table:
        return dqkv, None
    rows = rel_table.shape[0]
    order, offsets = _index_order(rel_index, rows)
    dbias = torch.empty(h * ww * ww, dtype=torch.float32, device=qkv.device)
    dtable = torch.empty(rows, h, dtype=torch.float32, device=qkv.device)
    rc = lib.ics_window_attention_dtable(
        part.data_ptr(), groups, h, ww, dbias.data_ptr(), order.data_ptr(), offsets.data_ptr(),
        rows, dtable.data_ptr(), stream, device)
    if rc != 0:
        msg = lib.ics_cuda_error_string(rc).decode()
        raise RuntimeError(f"window_attention_dtable kernel launch failed: {msg} (cudaError {rc})")
    _dtable_launches.add()
    return dqkv, dtable


def window_attention_qkv_bwd(qkv: torch.Tensor, dout: torch.Tensor, rel_table: torch.Tensor,
                             rel_index: torch.Tensor, mask: Optional[torch.Tensor],
                             window: int, shift: int, scale: float, with_table: bool = False):
    """The gradient of ``window_attention_qkv(qkv, ...)`` with respect to qkv,
    given ``dout`` [B, G, G, H·hd] -> dqkv in qkv's shape and dtype; with
    ``with_table``, (dqkv, the gradient of ``rel_table`` [rows, H] fp32).

    CUDA tensors go through the backward kernel (what the forward entry
    takes, and dout of qkv's dtype); CPU tensors take the plain version,
    ``window_attention_qkv_bwd_reference``."""
    _check_qkv_shapes(qkv, rel_table, rel_index, mask, window, shift)
    tensors = [qkv, dout, rel_table, rel_index] + ([] if mask is None else [mask])
    if {t.device for t in tensors} == {torch.device("cpu")}:
        return window_attention_qkv_bwd_reference(qkv, dout, rel_table, rel_index, mask, window,
                                                  shift, scale, with_table)
    _check_qkv_call("window_attention_qkv_bwd", qkv, rel_table, rel_index, mask, window, dout)
    if dout.dtype != qkv.dtype:
        raise ValueError(f"window_attention_qkv_bwd wants dout of qkv's dtype {qkv.dtype}; "
                         f"got {dout.dtype}")
    if qkv.dtype == torch.bfloat16:
        check_qkv_layout(qkv)            # the bf16 kernel moves rows as 16-byte pieces
        if mask is not None and mask.data_ptr() % 16:
            raise ValueError("window_attention_qkv_bwd wants a 16-byte aligned mask")
    elif qkv.stride(-1) != 1:
        raise ValueError("window_attention_qkv_bwd wants qkv's last dimension contiguous")
    dqkv, dtable = _qkv_backward(qkv, dout, rel_table, rel_index, mask, window, shift, scale,
                                 with_table)
    return (dqkv, dtable) if with_table else dqkv


def window_attention_qkv_bwd_reference(qkv: torch.Tensor, dout: torch.Tensor,
                                       rel_table: torch.Tensor, rel_index: torch.Tensor,
                                       mask: Optional[torch.Tensor], window: int, shift: int,
                                       scale: float, with_table: bool = False):
    """The plain version of ``window_attention_qkv_bwd``: autograd of
    ``window_attention_qkv_reference`` with respect to qkv (and the table)."""
    with torch.enable_grad():
        x = qkv.detach().requires_grad_()
        table = rel_table.detach().requires_grad_(with_table)
        y = window_attention_qkv_reference(x, table, rel_index, mask, window, shift, scale)
        grads = torch.autograd.grad(y, (x, table) if with_table else (x,), dout)
    return grads if with_table else grads[0]


def window_attention_qkv_reference(qkv: torch.Tensor, rel_table: torch.Tensor,
                                   rel_index: torch.Tensor, mask: Optional[torch.Tensor],
                                   window: int, shift: int, scale: float) -> torch.Tensor:
    """The plain version of ``window_attention_qkv``: the chain of PyTorch ops
    it replaces, step for step."""
    _check_qkv_shapes(qkv, rel_table, rel_index, mask, window, shift)
    b, grid, _, _, h, hd = qkv.shape
    x = qkv.reshape(b, grid, grid, 3 * h * hd)
    if shift > 0:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
    windows = window_partition(x, window)                          # [Bn, ww, 3C]
    bn, ww, _ = windows.shape
    q, k, v = (t.contiguous()
               for t in windows.reshape(bn, ww, 3, h, hd).permute(2, 0, 3, 1, 4).unbind(0))
    q = q * scale                                                  # rounded in its own dtype
    out = window_attention_reference(q, k, v, relative_bias(rel_table, rel_index), mask)
    y = window_merge(out.transpose(1, 2).reshape(bn, ww, h * hd), window, grid, b)
    if shift > 0:
        y = torch.roll(y, (shift, shift), dims=(1, 2))
    return y
