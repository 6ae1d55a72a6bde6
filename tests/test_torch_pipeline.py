"""The port's GPipe pipeline (``ics_tpu_torch.parallel.pipeline``) against the
JAX package's, on the CPU.

The depth-8 ViT of the reference's ``tests/test_pipeline.py`` (32 px, patch
8, dim 32, 2 heads, 5 classes), its weights carried across with
``weights.from_jax_variables``, the same input: at each of the reference's
(stages, microbatches) cases the port's pipelined forward over a mesh of
CPU positions equals the reference's pipelined forward and the sequential
forward, fp32 with plain attention, within atol 2e-4, rtol 1e-4; the
fill-drain alone (``pipeline_blocks``) likewise on the same tokens. Then
the raises, the blocks staged once, and the gradient through the schedule
against the sequential blocks'.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ics_tpu.models import vit as jax_vit
from ics_tpu.parallel import mesh as jax_mesh
from ics_tpu.parallel import pipeline as jax_pipeline
from ics_tpu_torch import weights
from ics_tpu_torch.models.vit import ViT
from ics_tpu_torch.parallel.mesh import make_mesh
from ics_tpu_torch.parallel.pipeline import (
    pipeline_blocks,
    pipeline_vit_forward,
    stage_block_params,
)

ATOL, RTOL = 2e-4, 1e-4
CFG = dict(image_size=32, patch_size=8, dim=32, depth=8, num_heads=2, num_classes=5)


@pytest.fixture(scope="module")
def setup():
    jmodel = jax_vit.ViT(**CFG)
    variables = jmodel.init(jax.random.PRNGKey(0))
    x = np.random.default_rng(0).standard_normal((8, 32, 32, 3)).astype(np.float32)
    ref, _ = jmodel.apply(variables, jnp.asarray(x), training=True)
    model = ViT(**CFG)
    model.load_state_dict(weights.from_jax_variables(
        jax.tree_util.tree_map(np.asarray, variables)), strict=True)
    return jmodel, jmodel.fold(variables), model.eval(), x, np.asarray(ref)


def _mesh(stages):
    return make_mesh((stages,), ("pp",), devices=["cpu"] * stages)


def _jax_mesh(stages):
    return jax_mesh.make_mesh((stages,), ("pp",), devices=jax.devices()[:stages])


@pytest.mark.parametrize("stages,microbatches", [(2, 2), (2, 8), (4, 4), (4, 8), (8, 4), (4, 1)])
def test_pipelined_vit_matches_the_reference(setup, stages, microbatches):
    jmodel, folded, model, x, ref = setup
    want = np.asarray(jax_pipeline.pipeline_vit_forward(
        jmodel, folded, jnp.asarray(x), _jax_mesh(stages), microbatches=microbatches,
        use_flash=False))
    with torch.no_grad():
        got = pipeline_vit_forward(model, torch.from_numpy(x), _mesh(stages),
                                   microbatches=microbatches, use_flash=False).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


def test_pipeline_blocks_matches_the_reference_on_the_same_tokens(setup):
    jmodel, folded, model, _, _ = setup
    tokens = np.random.default_rng(1).standard_normal((4, 17, 32)).astype(np.float32)
    want = np.asarray(jax_pipeline.pipeline_blocks(
        jmodel.blocks[0], jax_pipeline.stack_block_params(folded["blocks"]),
        jnp.asarray(tokens), _jax_mesh(4), microbatches=2))
    with torch.no_grad():
        got = pipeline_blocks(list(model.blocks), torch.from_numpy(tokens), _mesh(4),
                              microbatches=2).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_indivisible_depth_is_loud(setup):
    model = setup[2]
    tokens = torch.zeros(4, 17, 32)
    with pytest.raises(ValueError, match="estágios"):
        pipeline_blocks(list(model.blocks), tokens, _mesh(3), microbatches=2)
    with pytest.raises(ValueError, match="profundidade 8 não divide pelos 3 estágios"):
        stage_block_params(list(model.blocks), _mesh(3))


def test_indivisible_batch_is_loud(setup):
    model = setup[2]
    with pytest.raises(ValueError, match="microbatches"):
        pipeline_blocks(list(model.blocks), torch.zeros(5, 17, 32), _mesh(2), microbatches=3)


def test_stage_params_mismatch_is_loud(setup):
    model = setup[2]
    staged2 = stage_block_params(list(model.blocks), _mesh(2))   # staged for 2, mesh of 4
    with pytest.raises(ValueError, match="estagiados para 2 estágios, mesh tem 4"):
        pipeline_blocks(staged2, torch.zeros(4, 17, 32), _mesh(4), microbatches=2, staged=True)


def test_blocks_are_staged_once(setup):
    """``stage_block_params`` splits the model's own blocks into equal runs,
    in order; pipelined calls with the staged runs move no parameter."""
    _, _, model, x, ref = setup
    mesh = _mesh(4)
    stages = stage_block_params(list(model.blocks), mesh)
    assert [len(s) for s in stages] == [2, 2, 2, 2]
    assert [b for s in stages for b in s] == list(model.blocks)
    ptrs = [p.data_ptr() for p in model.parameters()]
    with torch.no_grad():
        for _ in range(2):
            got = pipeline_vit_forward(model, torch.from_numpy(x), mesh, microbatches=4,
                                       stages=stages).numpy()
            np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    assert [p.data_ptr() for p in model.parameters()] == ptrs


def test_grad_through_the_pipeline_matches_the_sequential_blocks(setup):
    """The schedule is differentiable: every parameter's gradient (the
    blocks of every stage included) equals the sequential forward's, as the
    reference's ``test_grad_through_pipeline_matches_sequential`` holds."""
    _, _, model, x, _ = setup
    labels = torch.arange(8) % 5
    xt = torch.from_numpy(x)

    def grads(forward):
        model.zero_grad()
        loss = torch.nn.functional.cross_entropy(forward(), labels)
        loss.backward()
        return {n: p.grad.clone() for n, p in model.named_parameters()}

    g_pp = grads(lambda: pipeline_vit_forward(model, xt, _mesh(4), microbatches=4))
    g_seq = grads(lambda: model(xt, use_flash=False))
    assert set(g_pp) == set(g_seq) and len(g_pp) == len(list(model.parameters()))
    for name in g_seq:
        np.testing.assert_allclose(g_pp[name].numpy(), g_seq[name].numpy(),
                                   atol=2e-5, rtol=2e-5, err_msg=name)
