"""Window attention of the port against the JAX prototype it replaces.

``scripts/proto_window_attn.py`` is loaded from its path. On CPU tensors the
port's ``window_attention`` computes its plain version,
``window_attention_reference``; the JAX side runs the Pallas kernel in
interpret mode and the script's XLA reference with fp32 scores. Inputs come
from numpy with a seed. fp32 tolerance 1e-4, the script's own bar: the same
fp32 softmax with sums in another order. The qkv entry's plain version is
held against the JAX path it replaces (roll, the JAX package's window
partition, the Pallas prototype in interpret mode, merge, roll back) at
1e-5. The CUDA kernel itself runs only on the card (``tests/test_torch_cuda.py``).
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ics_tpu.models import swin as jax_swin
from ics_tpu.models.swin import _relative_position_index, _shift_attn_mask
from ics_tpu_torch.ops import LAUNCHES, window_attention as wa

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def proto():
    spec = importlib.util.spec_from_file_location(
        "proto_window_attn", REPO / "scripts" / "proto_window_attn.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _inputs(grid, window, heads, hd, batch, seed, masked=True):
    ww = window * window
    n_w = (grid // window) ** 2
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((batch * n_w, heads, ww, hd)).astype(np.float32)
               for _ in range(3))
    q *= hd ** -0.5
    bias = rng.standard_normal((heads, ww, ww)).astype(np.float32)
    mask = _shift_attn_mask(grid, window, window // 2) if masked and n_w > 1 else None
    return q, k, v, bias, mask


def _port(q, k, v, bias, mask, dtype=torch.float32):
    return wa.window_attention(
        *(torch.from_numpy(a).to(dtype) for a in (q, k, v)), torch.from_numpy(bias),
        None if mask is None else torch.from_numpy(mask))


@pytest.mark.parametrize("grid,window,heads,hd,batch", [
    (14, 7, 4, 32, 2),      # the script's own check: 4 windows of 49 tokens
    (28, 7, 2, 32, 1),      # 16 windows
    (8, 4, 2, 16, 2),       # swin_micro: windows of 16 tokens, head_dim 16
])
def test_reference_matches_the_pallas_prototype_and_its_xla_reference_fp32(
        proto, grid, window, heads, hd, batch):
    q, k, v, bias, mask = _inputs(grid, window, heads, hd, batch, seed=grid)
    args = tuple(jnp.asarray(a) for a in (q, k, v, bias, mask))
    xla = np.asarray(proto.xla_window_attention(*args, score_dtype_is_input=False))
    pallas = np.asarray(proto.pallas_window_attention(*args, tile=4, interpret=True))
    before = LAUNCHES["window_attention"].value
    out = _port(q, k, v, bias, mask)
    assert LAUNCHES["window_attention"].value == before    # the plain version, no launch
    assert out.shape == xla.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), pallas, atol=1e-4, rtol=0)
    np.testing.assert_allclose(out.numpy(), xla, atol=1e-4, rtol=0)


def test_no_mask_equals_a_mask_of_zeros(proto):
    """Unshifted blocks and single-window grids pass no mask."""
    q, k, v, bias, _ = _inputs(7, 7, 3, 32, 3, seed=1, masked=False)
    zeros = np.zeros((1, 49, 49), np.float32)
    ref = np.asarray(proto.xla_window_attention(
        *(jnp.asarray(a) for a in (q, k, v, bias, zeros)), score_dtype_is_input=False))
    np.testing.assert_allclose(_port(q, k, v, bias, None).numpy(), ref, atol=1e-4, rtol=0)
    torch.testing.assert_close(_port(q, k, v, bias, zeros), _port(q, k, v, bias, None),
                               atol=0, rtol=0)


def test_mask_window_follows_row_mod_n_windows_and_cuts_attention():
    """Rows are image-major: row b uses mask[b mod nW]. A masked pair gets
    probability 0, so moving the values of the cut keys changes nothing."""
    q, k, v, bias, mask = _inputs(14, 7, 2, 16, 2, seed=2)
    out = _port(q, k, v, bias, mask)
    assert np.any(mask[3] != 0) and not np.any(mask[0] != 0)
    row = 4 + 3                                   # second image, window 3
    cut = mask[3][0] != 0                         # keys cut off from query 0
    v2 = v.copy()
    v2[row, :, cut] += 100.0
    out2 = _port(q, k, v2, bias, mask)
    torch.testing.assert_close(out2[row, :, 0], out[row, :, 0], atol=1e-5, rtol=0)
    assert (out2[row, :, 1:] - out[row, :, 1:]).abs().max() > 1.0


def test_reference_in_bf16_rounds_p_and_the_output_once(proto):
    q, k, v, bias, mask = _inputs(14, 7, 4, 32, 1, seed=3)
    out = _port(q, k, v, bias, mask, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    qb, kb, vb = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    ref = np.asarray(proto.pallas_window_attention(
        qb, kb, vb, jnp.asarray(bias), jnp.asarray(mask), tile=4, interpret=True
    ).astype(jnp.float32))
    # outputs are O(1); one bf16 ulp at 1.0 is 7.8e-3
    np.testing.assert_allclose(out.float().numpy(), ref, atol=1e-2, rtol=0)


def test_wrapper_rejects_mismatched_shapes():
    q = torch.zeros(4, 2, 16, 16)
    bias = torch.zeros(2, 16, 16)
    with pytest.raises(ValueError, match="one \\[Bn, H, ww, hd\\] shape"):
        wa.window_attention(q, q, torch.zeros(4, 2, 16, 32), bias)
    with pytest.raises(ValueError, match="bias as \\[H, ww, ww\\]"):
        wa.window_attention(q, q, q, torch.zeros(3, 16, 16))
    with pytest.raises(ValueError, match="nW dividing Bn"):
        wa.window_attention(q, q, q, bias, torch.zeros(3, 16, 16))
    with pytest.raises(ValueError, match="nW dividing Bn"):
        wa.window_attention(q, q, q, bias, torch.zeros(4, 16, 8))


# ---- the qkv entry: q, k, v read from the un-partitioned qkv product -------------
#
# fp32 tolerance 1e-5: the same fp32 softmax and products as the JAX path,
# with sums taken in another order (outputs are O(1)).

QKV_TOL = 1e-5


def _qkv_inputs(batch, grid, window, heads, hd, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((batch, grid, grid, 3, heads, hd)).astype(np.float32)
    table = rng.standard_normal(((2 * window - 1) ** 2, heads)).astype(np.float32)
    index = _relative_position_index(window)
    return qkv, table, index


def _jax_qkv_path(proto, qkv, table, index, window, shift):
    """roll by -shift -> the JAX package's window partition -> q, k, v and
    q * scale -> the Pallas prototype in interpret mode (a zero mask where the
    block has none) -> merge -> roll back."""
    b, grid, _, _, heads, hd = qkv.shape
    c = heads * hd
    ww = window * window
    n_w = (grid // window) ** 2
    x = jnp.asarray(qkv.reshape(b, grid, grid, 3 * c))
    if shift:
        x = jnp.roll(x, (-shift, -shift), axis=(1, 2))
    win = jax_swin._window_partition(x, window).reshape(-1, ww, 3, heads, hd)
    q, k, v = (jnp.transpose(win[:, :, i], (0, 2, 1, 3)) for i in range(3))
    bias = jnp.asarray(table)[jnp.asarray(index)].transpose(2, 0, 1)
    mask = (_shift_attn_mask(grid, window, shift) if shift
            else np.zeros((n_w, ww, ww), np.float32))
    out = proto.pallas_window_attention(q * hd ** -0.5, k, v, bias, jnp.asarray(mask),
                                        tile=n_w, interpret=True)
    out = jnp.transpose(out, (0, 2, 1, 3)).reshape(-1, ww, c)
    y = jax_swin._window_merge(out, window, grid, b)
    if shift:
        y = jnp.roll(y, (shift, shift), axis=(1, 2))
    return np.asarray(y)


@pytest.mark.parametrize("batch,grid,window,heads,hd,shift", [
    (2, 8, 4, 2, 16, 0), (2, 8, 4, 2, 16, 2),       # swin_micro's windows
    (1, 14, 7, 2, 32, 0), (1, 14, 7, 2, 32, 3),     # Swin-T's windows, wrapped at the edge
])
def test_qkv_reference_matches_the_jax_path(proto, batch, grid, window, heads, hd, shift):
    qkv, table, index = _qkv_inputs(batch, grid, window, heads, hd, seed=grid + shift)
    ref = _jax_qkv_path(proto, qkv, table, index, window, shift)
    mask = torch.from_numpy(_shift_attn_mask(grid, window, shift)) if shift else None
    before = LAUNCHES["window_attention"].value
    out = wa.window_attention_qkv(torch.from_numpy(qkv), torch.from_numpy(table),
                                  torch.from_numpy(index).to(torch.int16), mask, window, shift,
                                  hd ** -0.5)
    assert LAUNCHES["window_attention"].value == before     # the plain version, no launch
    assert out.shape == (batch, grid, grid, heads * hd) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=QKV_TOL, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grid,window,shift", [(8, 4, 0), (8, 4, 2), (14, 7, 3)])
def test_qkv_reference_equals_the_4d_entry_on_partitioned_inputs(dtype, grid, window, shift):
    """The qkv entry is the 4-D entry behind roll, partition, split and scale,
    and before merge and roll back: equal bit for bit, in both dtypes."""
    heads, hd = 2, 16
    qkv, table, index = _qkv_inputs(2, grid, window, heads, hd, seed=7)
    qkv = torch.from_numpy(qkv).to(dtype)
    table, index = torch.from_numpy(table), torch.from_numpy(index)
    mask = torch.from_numpy(_shift_attn_mask(grid, window, shift)) if shift else None
    out = wa.window_attention_qkv(qkv, table, index.to(torch.int16), mask, window, shift,
                                  hd ** -0.5)
    x = torch.roll(qkv.reshape(2, grid, grid, -1), (-shift, -shift), dims=(1, 2))
    win = wa.window_partition(x, window)
    bn, ww, _ = win.shape
    q, k, v = (t.contiguous()
               for t in win.reshape(bn, ww, 3, heads, hd).permute(2, 0, 3, 1, 4).unbind(0))
    bias = table[index].permute(2, 0, 1).contiguous()
    four_d = wa.window_attention(q * hd ** -0.5, k, v, bias, mask)
    merged = wa.window_merge(four_d.transpose(1, 2).reshape(bn, ww, heads * hd), window, grid, 2)
    torch.testing.assert_close(out, torch.roll(merged, (shift, shift), dims=(1, 2)),
                               atol=0, rtol=0)


def test_table_and_index_gather_equals_window_attention_bias():
    from ics_tpu_torch.models.swin import WindowAttention

    attn = WindowAttention(32, 2, 7)
    attn.reset_parameters(torch.Generator().manual_seed(0))
    assert attn.rel_index16.dtype == torch.int16
    assert torch.equal(attn.rel_index16.long(), attn.rel_index)
    torch.testing.assert_close(wa.relative_bias(attn.table(), attn.rel_index16), attn.bias(),
                               atol=0, rtol=0)
    assert attn.table().data_ptr() == attn.rel_bias.data_ptr()    # fp32: no copy
    # in a cast module the kernel's fp32 table is made once, and again only
    # when the parameter is written
    attn.to(torch.bfloat16)
    first = attn.table()
    assert first.dtype == torch.float32 and attn.table() is first
    torch.testing.assert_close(first, attn.rel_bias.float(), atol=0, rtol=0)
    with torch.no_grad():
        attn.rel_bias.mul_(2)
    assert torch.equal(attn.table(), attn.rel_bias.float()) and attn.table() is not first
    torch.testing.assert_close(wa.relative_bias(attn.table(), attn.rel_index16), attn.bias(),
                               atol=0, rtol=0)
    # a write through .data (as reset_parameters writes) leaves the version as it was
    second = attn.table()
    attn.reset_parameters(torch.Generator().manual_seed(1))
    assert torch.equal(attn.table(), attn.rel_bias.float()) and attn.table() is not second
    assert not torch.equal(attn.table(), second)


def test_qkv_wrapper_rejects_mismatched_shapes():
    qkv = torch.zeros(2, 8, 8, 3, 2, 16)
    table, index = torch.zeros(49, 2), torch.zeros(16, 16, dtype=torch.int16)
    attend = wa.window_attention_qkv
    with pytest.raises(ValueError, match=r"\[B, G, G, 3, H, hd\]"):
        attend(torch.zeros(2, 8, 8, 2, 2, 16), table, index, None, 4, 0, 0.25)
    with pytest.raises(ValueError, match=r"\[B, G, G, 3, H, hd\]"):
        attend(torch.zeros(2, 8, 4, 3, 2, 16), table, index, None, 4, 0, 0.25)
    with pytest.raises(ValueError, match="not a multiple of the window"):
        attend(torch.zeros(2, 6, 6, 3, 2, 16), table, index, None, 4, 0, 0.25)
    with pytest.raises(ValueError, match="0 <= shift < window"):
        attend(qkv, table, index, None, 4, 4, 0.25)
    with pytest.raises(ValueError, match="rel_table"):
        attend(qkv, torch.zeros(49, 3), index, None, 4, 0, 0.25)
    with pytest.raises(ValueError, match="integer rel_index"):
        attend(qkv, table, index.float(), None, 4, 0, 0.25)
    with pytest.raises(ValueError, match="integer rel_index"):
        attend(qkv, table, torch.zeros(16, 8, dtype=torch.int16), None, 4, 0, 0.25)
    with pytest.raises(ValueError, match=r"mask as \[nW, ww, ww\]"):
        attend(qkv, table, index, torch.zeros(2, 16, 16), 4, 2, 0.25)


def test_qkv_layout_check_rejects_what_the_kernel_cannot_read():
    """The kernel moves each head's row as 16-byte pieces: the last dimension
    contiguous, the base and every other stride on 16 bytes."""
    fused = torch.zeros(2, 8, 8, 3 * 2 * 16, dtype=torch.bfloat16)
    wa.check_qkv_layout(fused.view(2, 8, 8, 3, 2, 16))           # the qkv GEMM's output
    with pytest.raises(ValueError, match="last dimension contiguous"):
        wa.check_qkv_layout(fused.view(2, 8, 8, 3, 2, 16).transpose(4, 5))
    flat = torch.zeros(2 * 8 * 8 * 96 + 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        wa.check_qkv_layout(flat[1:1 + 2 * 8 * 8 * 96].view(2, 8, 8, 3, 2, 16))
    wider = torch.zeros(2, 8, 8, 100, dtype=torch.bfloat16)      # tokens 200 bytes apart
    with pytest.raises(ValueError, match="16-byte steps"):
        wa.check_qkv_layout(wider[..., :96].unflatten(-1, (3, 2, 16)))


# ---- the plan: heads a work item of the bf16 kernel takes -------------------------

_SWIN_T_CALLS = [(56, 3), (28, 6), (14, 12), (7, 24)]      # (grid, heads), window 7, hd 32


@pytest.mark.parametrize("bucket", [1, 8, 32])
@pytest.mark.parametrize("masked", [False, True])
def test_pick_head_group_at_every_swin_t_call(bucket, masked):
    for grid, heads in _SWIN_T_CALLS:
        windows = bucket * (grid // 7) ** 2
        # 49 rows are four tiles of 16: one head an item keeps each warp on one tile
        assert wa.pick_head_group(windows, heads, 49, 32, 169, masked) == 1
        assert wa.smem_bytes(49, 32, 1, 169, masked) <= 232448 - 256


def test_pick_head_group_groups_heads_where_windows_are_small_and_many():
    # swin_micro's 16-token windows are one tile: four heads an item fill the
    # four warps where the windows still make two items a multiprocessor
    assert wa.pick_head_group(32 * 16, 4, 16, 16, 49, True) == 4
    assert wa.pick_head_group(32 * 16, 2, 16, 16, 49, False) == 2
    assert wa.pick_head_group(4, 4, 16, 16, 49, False) == 1        # too few items: one head
    assert wa.pick_head_group(200, 6, 16, 16, 49, False) == 3      # a divisor of the heads
    # the 4-D entry's table is ww^2 rows a head
    assert wa.pick_head_group(8, 24, 64, 32, 4096, True) == 1
    with pytest.raises(ValueError, match="does not fit"):
        wa.pick_head_group(8, 2, 64, 32, 40000, True)


@pytest.mark.parametrize("ww,keys", [(1, 16), (9, 16), (16, 16), (25, 32), (33, 56), (49, 56),
                                     (57, 64), (64, 64)])
def test_key_tiles_cover_the_window_and_index_rows_avoid_bank_conflicts(ww, keys):
    assert 8 * wa.key_tiles(ww) == keys >= ww
    ld = wa.index_stride(ww)
    assert ld >= keys and ld % 16 == 8      # rows 8 words apart mod 32: a quad's pairs hit
    rows = {(g * ld // 2 + t) % 32 for g in range(8) for t in range(4)}   # distinct banks
    assert len(rows) == 32


@pytest.mark.parametrize("ww,hd,group,table_rows,masked", [
    (49, 32, 1, 169, True), (49, 32, 1, 169, False), (16, 16, 4, 49, True),
    (33, 16, 2, 1089, False), (64, 32, 1, 4096, True),
])
def test_smem_formula_of_the_bf16_kernel(ww, hd, group, table_rows, masked):
    """``smem_bytes`` against the layout written out: the int16 index with rows
    of ``index_stride`` (rounded to 16 bytes), then two stages of q, k and v
    rows (the tiles' keys rounded up to 16) of hd + 8 bf16 for each head of
    the group, the group's fp32 table columns (rounded to 16 bytes) and the
    mask's [ww, ww] fp32 block from up to 3 floats before it (its 16-byte
    pieces) to the keys of the last row's tiles."""
    ld = wa.index_stride(ww)
    keys = 8 * wa.key_tiles(ww)
    rows = -(-keys // 16) * 16
    index = -(-(ww * ld * 2) // 16) * 16
    stage = group * 3 * rows * (hd + 8) * 2 + -(-(group * table_rows * 4) // 16) * 16
    stage += -(-((3 + (ww - 1) * ww + keys) * 4) // 16) * 16 if masked else 0
    assert wa.smem_bytes(ww, hd, group, table_rows, masked) == index + 2 * stage


# ---- the gradient of the bias table (training) -------------------------------------
#
# The JAX package trains Swin through XLA (SwinBlock.apply, fp32 scores): its
# jax.grad against autograd of the port's SwinBlock on the CPU, whose window
# attention is the plain version the kernel is held to on the card. fp32, 1e-5
# of the largest gradient.

@pytest.mark.parametrize("grid,window,shift,heads,hd", [(8, 4, 2, 2, 16), (8, 4, 0, 2, 16),
                                                        (14, 7, 3, 2, 32)])
def test_table_and_qkv_gradients_match_jax(grid, window, shift, heads, hd):
    import jax

    from ics_tpu_torch import weights
    from ics_tpu_torch.models.swin import SwinBlock

    dim = heads * hd
    jblock = jax_swin.SwinBlock(dim, heads, window, shift, grid)
    params = jax.tree_util.tree_map(np.asarray, jblock.init(jax.random.PRNGKey(grid + shift)))
    rng = np.random.default_rng(shift)
    params["attn"]["rel_bias"] = rng.normal(0, 0.5, params["attn"]["rel_bias"].shape).astype(
        np.float32)
    x = rng.standard_normal((2, grid, grid, dim)).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    grads = jax.grad(lambda p: jnp.sum(jblock.apply(p, jnp.asarray(x)) * dy))(
        jax.tree_util.tree_map(jnp.asarray, params))
    ref = weights.from_jax_variables({"params": jax.tree_util.tree_map(np.asarray, grads)})
    block = SwinBlock(dim, heads, window, shift, grid)
    block.load_state_dict(weights.from_jax_variables({"params": params}))
    (block(torch.from_numpy(x)) * torch.from_numpy(dy)).sum().backward()
    ours = dict(block.named_parameters())
    assert ours["attn.rel_bias"].grad is not None
    for name in ("attn.rel_bias", "attn.qkv.weight", "attn.qkv.bias", "ln1.weight"):
        got, want = ours[name].grad.numpy(), ref[name].numpy()
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), name


@pytest.mark.parametrize("window", [4, 7])
def test_index_runs_gather_each_table_row_once(window):
    index = torch.from_numpy(_relative_position_index(window)).to(torch.int16)
    rows = (2 * window - 1) ** 2
    order, offsets = wa._index_order(index, rows)
    assert order.dtype == offsets.dtype == torch.int32 and offsets.shape == (rows + 1,)
    flat = index.reshape(-1).long()
    assert int(offsets[-1]) == flat.numel() and sorted(order.tolist()) == list(range(flat.numel()))
    for row in range(rows):
        run = order[offsets[row]:offsets[row + 1]].long()
        assert bool((flat[run] == row).all()) and run.tolist() == sorted(run.tolist())
    again = wa._index_order(index, rows)
    assert again[0] is order and again[1] is offsets        # kept while the index lives
    index[0, 0] = 1                                          # ... and is not written
    assert not torch.equal(wa._index_order(index, rows)[1], offsets)
    key = id(index)
    del index, again
    assert key not in wa._index_runs                         # nor kept after it


def test_index_runs_reached_from_threads_at_once_stay_each_indexs_own():
    """A job's backward is what reaches the runs (a served Swin version never
    asks for the table's gradient) and one job runs at a time; were threads
    to reach them at once, each index keeps its own runs: the cache is keyed
    by the index tensor's identity and each entry is written whole."""
    import threading

    indexes = [torch.from_numpy(_relative_position_index(w)).to(torch.int16)
               for w in (4, 7) for _ in range(4)]
    barrier = threading.Barrier(len(indexes))
    got: dict = {}

    def work(i, index):
        barrier.wait()
        for _ in range(50):
            got[i] = wa._index_order(index, int(index.max()) + 1)

    threads = [threading.Thread(target=work, args=(i, x)) for i, x in enumerate(indexes)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i, index in enumerate(indexes):
        flat = index.reshape(-1).long()
        order, offsets = got[i]
        assert torch.equal(order.long(), torch.sort(flat, stable=True).indices)
        assert torch.equal(offsets[1:].long(), torch.cumsum(torch.bincount(flat), 0))
        assert wa._index_runs[id(index)][2] is order


@pytest.mark.parametrize("windows,heads,n_mask,shared,per_item", [
    (2048, 3, 64, 396, 264),    # Swin-T's first stage at batch 32
    (512, 6, 16, 396, 264),
    (128, 12, 4, 396, 264),
    (32, 24, 1, 396, 396),      # no mask: the last stage
    (1, 2, 1, 396, 396),
    (64, 3, 64, 2, 1),          # fewer blocks fit than heads: one a head
    (1024, 3, 64, 150, 135),    # no multiple of the masks fits: a mask with every item
])
def test_backward_groups_fill_the_card_once_and_share_a_mask_where_they_can(
        windows, heads, n_mask, shared, per_item):
    groups = wa.backward_groups(windows, heads, n_mask, shared, per_item)
    fewest = max(1, min(windows, per_item // heads))
    assert fewest <= groups <= windows                     # every block has a window
    assert groups * heads <= max(shared, per_item, heads)  # one wave
    if groups % n_mask == 0:                               # each block's windows share one
        assert all(len({(g + m * groups) % n_mask for m in range(-(-windows // groups))}) == 1
                   for g in range(groups))
        assert groups * heads <= max(shared, heads)
    else:                                                  # a mask travels with each item
        assert groups == fewest


def test_qkv_backward_with_the_table_on_the_cpu_is_autograd_of_the_plain_version():
    qkv, table, index = _qkv_inputs(2, 8, 4, 2, 16, seed=3)
    qkv, table = torch.from_numpy(qkv), torch.from_numpy(table)
    index16 = torch.from_numpy(index).to(torch.int16)
    mask = torch.from_numpy(_shift_attn_mask(8, 4, 2))
    dout = torch.randn(2, 8, 8, 32, generator=torch.Generator().manual_seed(0))
    dqkv, dtable = wa.window_attention_qkv_bwd(qkv, dout, table, index16, mask, 4, 2, 0.25,
                                               with_table=True)
    x, t = qkv.clone().requires_grad_(), table.clone().requires_grad_()
    (wa.window_attention_qkv(x, t, index16, mask, 4, 2, 0.25) * dout).sum().backward()
    torch.testing.assert_close(dqkv, x.grad, atol=0, rtol=0)
    torch.testing.assert_close(dtable, t.grad, atol=0, rtol=0)
    assert torch.equal(wa.window_attention_qkv_bwd(qkv, dout, table, index16, mask, 4, 2, 0.25),
                       dqkv)
