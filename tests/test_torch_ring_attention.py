"""The port's ring attention (``ics_tpu_torch.parallel.ring_attention``) against
the JAX package's and the plain reference, on rings of CPU positions,
mirroring ``tests/test_ring_attention.py``.

The same numpy-seeded q, k, v go through the JAX ring (``shard_map`` over
``jax.devices()[:ring]``) and the port's (a ``("sp",)`` mesh of CPU
positions): outputs at 1e-5 (fp32, the same online softmax in another
framework), and against ``ops.attention.attention_reference`` at 1e-5 (1e-4
for scores of about +-100). Gradients through autograd against the plain
reference's at 1e-5. A ViT on a pure ``sp`` mesh trains with the unsharded
run's loss trajectory and the JAX package's at 1e-4 (its unsharded run:
``tests/test_ring_attention.py`` holds the JAX SP run to it, and a JAX SP
compile of the eight blocks costs about 30 s on this CPU); a mixed mesh and
a trunk with no ring-capable attention are refused with the reference's
messages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ics_tpu.parallel.mesh import make_mesh as jax_make_mesh
from ics_tpu.parallel.ring_attention import ring_attention as jax_ring
from ics_tpu.parallel.ring_attention import ring_attention_padded as jax_ring_padded
from ics_tpu_torch.models.resnet import resnet_tiny
from ics_tpu_torch.ops.attention import attention_reference
from ics_tpu_torch.parallel.mesh import Position, make_mesh
from ics_tpu_torch.parallel.ring_attention import (
    ring_attention,
    ring_attention_padded,
    ring_positions,
    shard_tokens,
)


def _qkv(rng, b=2, h=3, s=32, d=16, scale=1.0):
    return tuple(rng.standard_normal((b, h, s, d)).astype(np.float32) * (scale if i == 0 else 1.0)
                 for i in range(3))


def _sp(ring):
    return make_mesh((ring,), ("sp",), devices=["cpu"] * ring)


def _jax_sp(ring):
    return jax_make_mesh((ring,), ("sp",), devices=jax.devices()[:ring])


def _t(arrays, grad=False):
    return tuple(torch.tensor(a, requires_grad=grad) for a in arrays)


@pytest.mark.parametrize("ring", [2, 3, 4, 8])
def test_matches_the_reference_and_the_jax_ring(ring):
    rng = np.random.default_rng(ring)
    arrays = _qkv(rng, s=24 if ring == 3 else 32)
    out = ring_attention(*_t(arrays), _sp(ring))
    np.testing.assert_allclose(out.numpy(), attention_reference(*_t(arrays)).numpy(),
                               atol=1e-5, rtol=1e-5)
    ref = jax_ring(*(jnp.asarray(a) for a in arrays), _jax_sp(ring))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_extreme_logits_stay_stable():
    """Scores of about +-100, which a naive exp overflows: the online
    softmax's rescaling keeps them finite and exact."""
    arrays = _qkv(np.random.default_rng(0), s=16, d=8, scale=30.0)
    out = ring_attention(*_t(arrays), _sp(4))
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), attention_reference(*_t(arrays)).numpy(),
                               atol=1e-4, rtol=1e-4)


def test_an_indivisible_sequence_and_a_bad_valid_len_are_refused_as_the_reference():
    arrays = _qkv(np.random.default_rng(1), s=30)
    for port, ref in (
            (lambda: ring_attention(*_t(arrays), _sp(4)),
             lambda: jax_ring(*(jnp.asarray(a) for a in arrays), _jax_sp(4))),
            (lambda: ring_attention(*_t(arrays), _sp(2), valid_len=31),
             lambda: jax_ring(*(jnp.asarray(a) for a in arrays), _jax_sp(2), valid_len=31)),
            (lambda: ring_attention(*_t(arrays), _sp(2), valid_len=0),
             lambda: jax_ring(*(jnp.asarray(a) for a in arrays), _jax_sp(2), valid_len=0))):
        with pytest.raises(ValueError) as want:
            ref()
        with pytest.raises(ValueError) as got:
            port()
        assert str(got.value) == str(want.value)
    assert "anel" in str(got.value) or "valid_len" in str(got.value)


def test_each_position_holds_its_chunk_of_the_tokens():
    """S / ring tokens of K a position (the memory SP exists for), each chunk
    on its position, and the ring over those chunks equals full attention."""
    arrays = _qkv(np.random.default_rng(2), s=32)
    mesh = _sp(8)
    positions = ring_positions(mesh)
    chunks = shard_tokens(torch.tensor(arrays[1]), positions, Position.current("cpu"))
    assert [c.shape[2] for c in chunks] == [4] * 8
    assert [c.device for c in chunks] == [p.device for p in positions]
    np.testing.assert_allclose(torch.cat(chunks, dim=2).numpy(), arrays[1])
    out = ring_attention(*_t(arrays), mesh)
    np.testing.assert_allclose(out.numpy(), attention_reference(*_t(arrays)).numpy(),
                               atol=1e-5, rtol=1e-5)


def _grads(fn, arrays):
    q, k, v = _t(arrays, grad=True)
    (fn(q, k, v) ** 2).sum().backward()
    return [t.grad.numpy() for t in (q, k, v)]


@pytest.mark.parametrize("ring,s", [(4, 32), (2, 13), (4, 13)])
def test_gradients_match_the_reference(ring, s):
    """Ring attention is differentiable through autograd: the padded form
    (``ring_attention`` itself where S divides) against full attention."""
    arrays = _qkv(np.random.default_rng(4), b=1, h=2, s=s, d=8)
    mesh = _sp(ring)
    got = _grads(lambda q, k, v: ring_attention_padded(q, k, v, mesh), arrays)
    want = _grads(attention_reference, arrays)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)


def test_padded_matches_the_reference_and_the_jax_ring():
    """Sequences that do not divide the ring (ViT's P + 1 tokens)."""
    rng = np.random.default_rng(3)
    for s in (17, 65, 31):
        arrays = tuple(rng.standard_normal((2, 2, s, 8)).astype(np.float32) for _ in range(3))
        out = ring_attention_padded(*_t(arrays), _sp(4))
        np.testing.assert_allclose(out.numpy(), attention_reference(*_t(arrays)).numpy(),
                                   atol=1e-5, rtol=1e-5)
        if s == 17:
            ref = jax_ring_padded(*(jnp.asarray(a) for a in arrays), _jax_sp(4))
            np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_an_all_masked_chunk_is_finite():
    """valid_len under one chunk: the last positions hold keys that are all
    padding; no ghost key counts and no NaN comes out, rows past valid_len
    included."""
    arrays = tuple(np.random.default_rng(5).standard_normal((1, 1, 16, 8)).astype(np.float32)
                   for _ in range(3))
    out = ring_attention(*_t(arrays), _sp(4), valid_len=3)
    ref = attention_reference(*(torch.tensor(a[:, :, :3]) for a in arrays))
    np.testing.assert_allclose(out[:, :, :3].numpy(), ref.numpy(), atol=1e-5, rtol=1e-5)
    assert torch.isfinite(out).all()


def test_sp_finetune_matches_the_unsharded_run_and_the_jax_run():
    """``FineTuner`` on a pure ``sp`` mesh (every block's attention ringed,
    the batch whole): the loss trajectory of the unsharded run and of the
    JAX package's run, same weights, fp32."""
    from ics_tpu.models.vit import vit_tiny as jax_vit_tiny
    from ics_tpu.train import finetune as jft
    from ics_tpu_torch import weights
    from ics_tpu_torch.models.vit import vit_tiny
    from ics_tpu_torch.train import finetune as tft

    rng = np.random.default_rng(0)
    batches = [(rng.integers(0, 256, (4, 64, 64, 3), np.uint8), np.full((4, 2), 64, np.int32),
                (np.arange(4) % 8).astype(np.int32)) for _ in range(2)]
    jmodel = jax_vit_tiny(num_classes=8)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(1)))
    seeded = weights.from_jax_variables(variables)
    jtuner = jft.FineTuner(jmodel, optimizer=jft.make_optimizer(lr=0.05), image_size=64,
                           resize_short=64, compute_dtype=jnp.float32)
    _, _, jhist = jtuner.run(jax.tree_util.tree_map(jnp.asarray, variables), iter(batches))

    def run(mesh):
        model = vit_tiny(num_classes=8)
        model.load_state_dict(seeded, strict=True)
        tuner = tft.FineTuner(model, optimizer=tft.make_optimizer(lr=0.05), image_size=64,
                              resize_short=64, compute_dtype=torch.float32, mesh=mesh)
        _, _, hist = tuner.run(iter(batches))
        return model, [h["loss"] for h in hist]

    model, ringed = run(_sp(4))
    assert all(blk.attn.ring is not None for blk in model.blocks)
    _, plain = run(None)
    np.testing.assert_allclose(ringed, plain, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(ringed, [h["loss"] for h in jhist], atol=1e-4, rtol=1e-4)


def test_sp_refuses_a_mixed_mesh_and_a_trunk_without_ring_attention():
    from ics_tpu_torch.train.finetune import FineTuner

    mixed = make_mesh((2, 2), ("data", "sp"), devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="puro-SP") as got:
        FineTuner(resnet_tiny(num_classes=8), mesh=mixed)
    assert str(got.value) == ("mesh de treino com 'sp' deve ser puro-SP (eixos "
                              "('data', 'sp')) — DPxSP não é suportado")
    with pytest.raises(ValueError, match="ViT") as got:
        FineTuner(resnet_tiny(num_classes=8), mesh=_sp(4))
    assert str(got.value) == ("sequence parallelism requer um tronco transformer com "
                              "atenção ring-capaz (família ViT)")
