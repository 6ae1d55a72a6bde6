"""The port's batched device-decode lane (``ics_tpu_torch/runtime/device_decode.py``
and the engine's coefficient step) against the JAX package's, on the CPU:
lane classification equal, staged batches byte-identical (the chroma-DC
replication into the edge and corner padding blocks included), the batched
canvas within 1 LSB on at most 0.1 % of each image's pixels, and the fused
step on a tiny ResNet with the same weights (carried across by
``weights.py``) giving the same top-5 with scores within atol 2e-4, rtol
1e-4. The port continues subsampled chroma past the image's edge where the
JAX package reads the block padding: that changes an image's last row
(column) where its height (width) is even and nothing else, and the tests
hold it so. Then the engine's padding, shape keys and compile accounting.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image, ImageFilter

from ics_tpu.native import imgcodec as ref_codec
from ics_tpu.runtime import device_decode as ref
from ics_tpu.runtime.engine import InferenceEngine as JaxEngine
from ics_tpu_torch import weights
from ics_tpu_torch.native import imgcodec
from ics_tpu_torch.runtime import device_decode as port
from ics_tpu_torch.runtime.engine import InferenceEngine

pytestmark = pytest.mark.skipif(not ref_codec.available(), reason="native imgcodec not built")

SUBSAMPLING = {"444": 0, "422": 1, "420": 2}


def coefficients(seed, h, w, mode="420", **kw):
    rng = np.random.default_rng(seed)
    img = Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).filter(
        ImageFilter.GaussianBlur(1))
    buf = io.BytesIO()
    if mode == "gray":
        img.convert("L").save(buf, "JPEG", quality=90, **kw)
    else:
        img.save(buf, "JPEG", quality=90, subsampling=SUBSAMPLING[mode], **kw)
    return imgcodec.jpeg_coefficients(buf.getvalue())


# sizes whose chroma planes stop short of the canvas on both axes, on one, on
# none (a canvas filled exactly), and sizes a 4:2:0 MCU does not divide
SIZES = [(100, 130), (37, 53), (128, 96), (16, 128), (121, 9)]


@pytest.mark.parametrize("mode", ["420", "422", "444", "gray"])
def test_classify_coefficients_agrees(mode):
    for i, (h, w) in enumerate(SIZES + [(600, 520), (1100, 80)]):
        co = coefficients(i, h, w, mode)
        assert port.classify_coefficients(co) == ref.classify_coefficients(co)
        assert port.classify_coefficients(co, luma_buckets=(16,)) == \
            ref.classify_coefficients(co, luma_buckets=(16,))
    assert port.classify_coefficients(None) is ref.classify_coefficients(None) is None


@pytest.mark.parametrize("luma_blocks", [16, 32])
@pytest.mark.parametrize("mode", ["420", "422", "444", "gray"])
def test_stage_coefficient_batch_is_byte_identical(mode, luma_blocks):
    batch = [coefficients(i, h, w, mode) for i, (h, w) in enumerate(SIZES)]
    batch = [co for co in batch if ref.classify_coefficients(co, (luma_blocks,))]
    assert len(batch) >= 3
    want = ref.stage_coefficient_batch(batch, luma_blocks=luma_blocks, mode=mode)
    got = port.stage_coefficient_batch(batch, luma_blocks=luma_blocks, mode=mode)
    assert set(got) == set(want) == set(port.STAGED_KEYS)
    for key in want:
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape
        assert got[key].tobytes() == want[key].tobytes(), key
    if mode != "gray":
        # the replicated DC is there: edge and corner padding blocks
        co = batch[0]
        ch, cw = co.components[1]["coeffs"].shape[:2]
        cb = got["cb"][0]
        if ch < cb.shape[0] and cw < cb.shape[1]:
            assert cb[ch, cw, 0] == co.components[1]["coeffs"][ch - 1, cw - 1, 0]


def test_stage_coefficient_batch_refuses_what_the_reference_refuses():
    co444 = coefficients(0, 40, 40, "444")
    big = coefficients(1, 200, 100, "420")
    for args in (([co444], 64, "420"), ([big], 16, "420")):
        assert ref.stage_coefficient_batch(args[0], luma_blocks=args[1], mode=args[2]) is None
        assert port.stage_coefficient_batch(args[0], luma_blocks=args[1], mode=args[2]) is None


def agreeing_region(h, w, mode):
    """(rows, cols) of an h x w image where the port's decode is the JAX
    package's function: all but the last row (column) of an even height
    (width) on a subsampled axis, where the port continues the chroma edge."""
    hr, vr = port.MODE_RATIOS.get(mode, (1, 1))
    return h - (vr == 2 and h % 2 == 0), w - (hr == 2 and w % 2 == 0)


@pytest.mark.parametrize("mode", ["420", "422", "444", "gray"])
def test_decode_batch_to_canvas_matches_jax(mode):
    batch = [coefficients(i, h, w, mode) for i, (h, w) in enumerate(SIZES[:3])]
    staged = port.stage_coefficient_batch(batch, luma_blocks=32, mode=mode)
    want = np.asarray(ref.decode_batch_to_canvas(
        {k: jnp.asarray(v) for k, v in staged.items()}, mode=mode))
    got = port.decode_batch_to_canvas(port.to_device(staged, "cpu"), mode=mode)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (3, 256, 256, 3)
    for i, (h, w) in enumerate(SIZES[:3]):
        rows, cols = agreeing_region(h, w, mode)
        assert (rows, cols) == (h, w) or mode in ("420", "422")
        diff = np.abs(got[i, :rows, :cols].numpy() - want[i, :rows, :cols])
        assert diff.max() <= 1 and np.count_nonzero(diff) <= 1e-3 * diff.size, (h, w)


def test_quant_tables_cross_as_their_bit_pattern():
    staged = port.stage_coefficient_batch([coefficients(0, 40, 40)], luma_blocks=16)
    staged["yq"][0, 0] = 40000                       # past int16
    dev = port.to_device(staged, "cpu")
    assert dev["yq"].dtype == torch.int16 and dev["y"].dtype == torch.int16
    from ics_tpu_torch.ops.jpeg_decode import widen_quant

    assert widen_quant(dev["yq"])[0, 0].item() == 40000.0


@pytest.fixture(scope="module")
def resnet_variables():
    from ics_tpu.models.resnet import resnet_tiny

    return jax.tree_util.tree_map(
        np.asarray, resnet_tiny(num_classes=10).init(jax.random.PRNGKey(5)))


@pytest.fixture(scope="module")
def engines(resnet_variables):
    jax_engine = JaxEngine("resnet_tiny", num_classes=10, precision="fp32", buckets=(1, 4),
                           canvas=64, variables=resnet_variables)
    engine = InferenceEngine("resnet_tiny", num_classes=10, precision="fp32", buckets=(1, 4),
                             canvas=64, state_dict=weights.from_jax_variables(resnet_variables),
                             device="cpu")
    return jax_engine, engine


def step_batch(mode, seed, edge=False):
    """Three images for the step's parity. For 4:2:0 and 4:2:2, by default
    ones whose chroma fills the 32-block canvas, where the chroma continued
    past the image's edge (the port) and the block padding read there (the
    JAX package) are the same samples. With ``edge``, 112 and 144 px
    squares (multiples of 16): the chroma ends on a block edge inside the
    canvas, so the JAX package reads the padding block (the edge block's DC
    alone); the last chroma block row and column are masked to their DC (AC
    zeroed), which makes it the continued edge sample again, on images whose
    edges reach the tiny model's input (64 px, no crop). See
    test_chroma_edge_continues_as_libjpeg for the edge itself."""
    if not edge:
        sizes = SIZES[:3] if mode in ("444", "gray") else [(256, 256)] * 3
        return [coefficients(seed + i, h, w, mode) for i, (h, w) in enumerate(sizes)]
    batch = []
    for i, side in enumerate((112, 144, 112)):
        co = coefficients(seed + i, side, side, mode)
        for comp in co.components[1:]:
            coeffs = comp["coeffs"].copy()
            coeffs[-1, :, 1:] = 0
            coeffs[:, -1, 1:] = 0
            comp["coeffs"] = coeffs
        batch.append(co)
    return batch


@pytest.mark.parametrize("edge", [False, True])
@pytest.mark.parametrize("mode", ["420", "422", "444", "gray"])
def test_fused_decode_infer_step_matches_jax(engines, mode, edge):
    jax_engine, engine = engines
    staged = port.stage_coefficient_batch(step_batch(mode, 10, edge), luma_blocks=32, mode=mode)
    ref_step = ref.make_fused_decode_infer_step(jax_engine.model, jax_engine.folded,
                                                jax_engine.spec, dtype=jnp.float32, mode=mode)
    want_idx, want_scores = ref_step(*(staged[k] for k in port.STAGED_KEYS))
    step = port.make_fused_decode_infer_step(engine.model, engine.spec, dtype=torch.float32,
                                             mode=mode)
    dev = port.to_device(staged, "cpu")
    idx, scores = step(*(dev[k] for k in port.STAGED_KEYS))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores), atol=2e-4, rtol=1e-4)


def test_engine_coeff_step_matches_the_jax_engine(engines):
    jax_engine, engine = engines
    staged = port.stage_coefficient_batch(step_batch("444", 20), luma_blocks=64, mode="444")
    want_idx, want_scores = jax_engine.predict_coeff_staged(dict(staged), mode="444")
    idx, scores = engine.predict_coeff_staged(dict(staged), mode="444")
    assert idx.shape == scores.shape == (3, 5)
    np.testing.assert_array_equal(idx, want_idx)
    np.testing.assert_allclose(scores, want_scores, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("mode", ["420", "422"])
def test_chroma_edge_continues_as_libjpeg(mode):
    """Where an image's chroma ends on a block edge (112 px: 7 chroma blocks
    at 4:2:0), the JAX package's fancy upsampling reads the next padding
    block, whose only content is the edge block's DC; libjpeg continues the
    edge sample, and so does the port: away from the last chroma sample it is
    the JAX function, and at the edge it is closer to PIL's decode (the host
    lane)."""
    rng = np.random.default_rng(3)
    img = Image.fromarray(rng.integers(0, 256, (112, 112, 3), np.uint8)).filter(
        ImageFilter.GaussianBlur(1))
    buf = io.BytesIO()
    img.save(buf, "JPEG", quality=90, subsampling=SUBSAMPLING[mode])
    staged = port.stage_coefficient_batch([imgcodec.jpeg_coefficients(buf.getvalue())],
                                          luma_blocks=16, mode=mode)
    dev = port.to_device(staged, "cpu")
    jax_canvas = np.asarray(ref.decode_batch_to_canvas(
        {k: jnp.asarray(v) for k, v in staged.items()}, mode=mode))[0, :112, :112]
    edged = port.decode_batch_to_canvas(dev, mode=mode)[0, :112, :112].numpy()
    rows, cols = agreeing_region(112, 112, mode)
    assert (rows, cols) == (111 if mode == "420" else 112, 111)
    np.testing.assert_allclose(edged[:rows, :cols], jax_canvas[:rows, :cols], atol=1)
    pil = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB")).astype(int)
    err_jax = np.abs(jax_canvas.astype(int) - pil).max()
    err_port = np.abs(edged.astype(int) - pil).max()
    assert err_port <= 3 < err_jax, (err_port, err_jax)


def test_engine_pads_counts_compiles_and_keys_by_lane():
    engine = InferenceEngine("resnet_tiny", num_classes=10, precision="fp32", buckets=(1, 4),
                             canvas=64, device="cpu")
    staged = port.stage_coefficient_batch(
        [coefficients(i, 60, 80, "422") for i in range(3)], luma_blocks=16, mode="422")
    seen = []
    real_step = engine._get_coeff_step("422")
    engine._coeff_steps["422"] = lambda *a: (seen.append(a), real_step(*a))[1]
    first = engine.predict_coeff_staged(staged, mode="422")
    second = engine.predict_coeff_staged(staged, mode="422")
    # padded to bucket 4 with zero rows, zero tables and sizes 64; results cut to 3
    y, yq, _, _, _, _, sizes = seen[0]
    assert y.shape[0] == 4 and int(yq[3].abs().sum()) == 0 and sizes[3].tolist() == [64, 64]
    assert first[0].shape == (3, 5)
    np.testing.assert_array_equal(first[0], second[0])
    assert ("coeff", "422", 16, 4) in engine._compiled_shapes
    st = engine.status()
    assert st["compiles"] == 1 and st["batches"] == 2 and st["images"] == 6
    # the pipelined resolver records on resolve
    resolve = engine.predict_coeff_staged_async(staged, mode="422")
    assert engine.status()["batches"] == 2
    resolve()
    assert engine.status()["batches"] == 3


def test_warmup_coeff_records_nothing_and_marks_the_shapes():
    engine = InferenceEngine("resnet_tiny", num_classes=10, precision="fp32", buckets=(1, 2),
                             canvas=64, device="cpu")
    engine.warmup_coeff("gray", luma_blocks=16)
    st = engine.status()
    assert (st["batches"], st["images"], st["compiles"]) == (0, 0, 0)
    assert {("coeff", "gray", 16, 1), ("coeff", "gray", 16, 2)} <= engine._compiled_shapes
    assert set(engine._coeff_steps) == {"gray"}
    staged = port.stage_coefficient_batch([coefficients(0, 40, 40, "gray")], luma_blocks=16,
                                          mode="gray")
    engine.predict_coeff_staged(staged, mode="gray")
    assert engine.status()["compiles"] == 0           # warmed: not a compile

