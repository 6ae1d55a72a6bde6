"""The port's engine on a device mesh against the JAX package's engine on a
mesh of the same shape, on the CPU.

The reference shards the batch over JAX's virtual CPU devices; the port's
mesh is made of CPU positions (``make_mesh(..., devices=["cpu"] * n)``),
which run the same machinery as cards do (the batch split into chunks, one
a ``data`` position, the head split by classes over ``model``, the results
gathered in row order) without the streams. Same bridged weights
(``weights.from_jax_variables``), same staged canvases, fp32: the top-5
equal and the scores within atol 2e-4, rtol 1e-4; the embeddings within the
same bars. The coefficient (device-decode) step of a mesh is held against
the port's own single-device step, exactly: the port decodes the last
row and column of an even-sized image as libjpeg does, where the reference
reads the block padding (``runtime/device_decode.py``).
"""

import io

import jax
import numpy as np
import pytest
from PIL import Image

from ics_tpu.parallel.mesh import make_mesh as jax_make_mesh
from ics_tpu.runtime.decode import stage_batch
from ics_tpu.runtime.engine import InferenceEngine as JaxEngine
from ics_tpu_torch import weights
from ics_tpu_torch.parallel.mesh import make_mesh
from ics_tpu_torch.runtime.engine import InferenceEngine

ATOL, RTOL = 2e-4, 1e-4
KW = dict(num_classes=8, precision="fp32", buckets=(1, 4), canvas=64)


@pytest.fixture(scope="module")
def variables():
    from ics_tpu.models.registry import get_model

    model = get_model("resnet_tiny").build(num_classes=8)
    return jax.tree_util.tree_map(np.asarray, model.init(jax.random.PRNGKey(11)))


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (h, w, 3), np.uint8)
              for h, w in [(64, 64), (120, 90), (40, 200), (33, 47)]]
    return stage_batch(images, canvas=None)


def _pair(variables, shape, axes):
    ref = JaxEngine("resnet_tiny", variables=variables,
                    mesh=jax_make_mesh(shape, axes, devices=jax.devices()[:int(np.prod(shape))]),
                    **KW)
    port = InferenceEngine("resnet_tiny", state_dict=weights.from_jax_variables(variables),
                           mesh=make_mesh(shape, axes, devices=["cpu"] * int(np.prod(shape))),
                           **KW)
    return ref, port


@pytest.mark.parametrize("shape,axes", [((2,), ("data",)), ((2, 2), ("data", "model"))],
                         ids=["dp2", "dp2xtp2"])
def test_mesh_engine_matches_the_jax_mesh_engine(variables, batch, shape, axes):
    ref, port = _pair(variables, shape, axes)
    assert port.buckets == ref.buckets == (2, 4)
    assert port._mesh_model.head_sharded == ("model" in axes)
    assert port.status()["devices"] == ref.status()["devices"] == int(np.prod(shape))
    canvas, sizes = batch
    for n in (4, 3, 1):                  # a full bucket, a padded one, one image
        ref_idx, ref_scores = ref.predict_staged(canvas[:n], sizes[:n])
        idx, scores = port.predict_staged(canvas[:n], sizes[:n])
        assert idx.shape == (n, 5)
        np.testing.assert_array_equal(idx, ref_idx)
        np.testing.assert_allclose(scores, ref_scores, atol=ATOL, rtol=RTOL)


def test_buckets_round_up_to_the_data_axis_as_the_reference(variables):
    for shape, axes in [((2,), ("data",)), ((4,), ("data",)), ((1, 2), ("data", "model"))]:
        n = int(np.prod(shape))
        kw = dict(KW, buckets=(1, 3, 5, 8))
        ref = JaxEngine("resnet_tiny", variables=variables,
                        mesh=jax_make_mesh(shape, axes, devices=jax.devices()[:n]), **kw)
        port = InferenceEngine("resnet_tiny", mesh=make_mesh(shape, axes, devices=["cpu"] * n),
                               **kw)
        assert port.buckets == ref.buckets


def test_dp_embed_matches_the_jax_mesh_embed(variables, batch):
    ref, port = _pair(variables, (2,), ("data",))
    canvas, sizes = batch
    want = ref.embed_staged(canvas[:3], sizes[:3])
    got = port.embed_staged(canvas[:3], sizes[:3])
    assert got.shape == (3, port.embed_dim)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_tp_head_of_an_indivisible_class_count_is_replicated(variables):
    """7 classes on a model axis of 2: the head is served whole, as the
    reference's, and the answers are the single engine's."""
    mesh = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    kw = dict(KW, num_classes=7, seed=4)
    port = InferenceEngine("resnet_tiny", mesh=mesh, **kw)
    single = InferenceEngine("resnet_tiny", device="cpu", **kw)
    assert not port._mesh_model.head_sharded
    canvas = np.random.default_rng(2).integers(0, 256, (4, 64, 64, 3), np.uint8)
    sizes = np.full((4, 2), 60, np.int32)
    for (a, b) in zip(port.predict_staged(canvas, sizes), single.predict_staged(canvas, sizes)):
        np.testing.assert_array_equal(a, b)


def _jpeg(seed, h, w):
    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)).save(
        buf, "JPEG", quality=90)
    return buf.getvalue()


def test_dp_tp_coefficient_step_matches_the_single_engine():
    from ics_tpu_torch.native import imgcodec
    from ics_tpu_torch.runtime import device_decode

    blobs = [_jpeg(i, h, w) for i, (h, w) in enumerate([(300, 400), (224, 224), (97, 333)])]
    staged = device_decode.stage_coefficient_batch(
        [imgcodec.jpeg_coefficients(b) for b in blobs], luma_blocks=64, mode="420")
    kw = dict(KW, seed=3)
    single = InferenceEngine("resnet_tiny", device="cpu", **kw)
    port = InferenceEngine("resnet_tiny", mesh=make_mesh((2, 2), ("data", "model"),
                                                         devices=["cpu"] * 4), **kw)
    want = single.predict_coeff_staged(dict(staged), mode="420")
    got = port.predict_coeff_staged(dict(staged), mode="420")
    assert got[0].shape == (3, 5)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_tta_and_explain_run_the_whole_batch_on_the_first_position():
    """As the reference's unsharded TTA and explain programs: the answers of
    the single engine on the same weights."""
    mesh = make_mesh((2,), ("data",), devices=["cpu", "cpu"])
    kw = dict(KW, seed=5)
    port, single = InferenceEngine("resnet_tiny", mesh=mesh, **kw), \
        InferenceEngine("resnet_tiny", device="cpu", **kw)
    canvas = np.random.default_rng(3).integers(0, 256, (3, 64, 64, 3), np.uint8)
    sizes = np.full((3, 2), 64, np.int32)
    for a, b in zip(port.predict_staged_tta(canvas, sizes), single.predict_staged_tta(canvas, sizes)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(port.explain_staged(canvas, sizes), single.explain_staged(canvas, sizes)):
        np.testing.assert_array_equal(a, b)


def test_mesh_engine_warms_every_bucket_and_refuses_a_device_off_the_mesh(monkeypatch):
    import torch

    mesh = make_mesh((2,), ("data",), devices=["cpu", "cpu"])
    engine = InferenceEngine("resnet_tiny", mesh=mesh, **KW)
    engine.warmup()
    assert {(2, 64), (4, 64)} <= engine._compiled_shapes
    assert engine.device.type == "cpu" and engine.mesh is mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)  # names only, no launch
    with pytest.raises(ValueError, match="first device"):
        InferenceEngine("resnet_tiny", mesh=make_mesh((2,), ("data",),
                                                      devices=["cuda:0", "cuda:1"]),
                        device="cpu", **KW)


def test_a_serving_mesh_needs_a_data_axis():
    """As the reference's sharded step, which splits every batch over 'data'."""
    with pytest.raises(ValueError, match="'data' axis"):
        InferenceEngine("resnet_tiny", mesh=make_mesh((2,), ("model",), devices=["cpu"] * 2),
                        **KW)
