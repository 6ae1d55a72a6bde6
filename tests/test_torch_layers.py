"""BatchNorm, its folding, max pooling, Conv+BN, the activations, Dense and
squeeze-excitation of the port against ``ics_tpu.nn``, in fp32: atol 2e-4, rtol 1e-4 (the repo's torch-gold bar,
``tests/test_pretrained.py``). Inputs and parameters come from a numpy seed
and cross as numpy arrays.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ics_tpu.nn import blocks as jax_blocks
from ics_tpu.nn import layers as jax_layers
from ics_tpu_torch import weights
from ics_tpu_torch.nn import blocks as torch_blocks
from ics_tpu_torch.nn import layers as torch_layers

TOL = dict(atol=2e-4, rtol=1e-4)


def _bn_trees(rng, n):
    params = {"gamma": rng.uniform(0.5, 1.5, n).astype(np.float32),
              "beta": rng.normal(0, 0.3, n).astype(np.float32)}
    state = {"mean": rng.normal(0, 0.5, n).astype(np.float32),
             "var": rng.uniform(0.2, 2.0, n).astype(np.float32)}
    return params, state


@pytest.mark.parametrize("eps", [1e-5, 1e-3])
def test_batchnorm_eval_and_fold_match_jax(eps):
    rng = np.random.default_rng(0)
    params, state = _bn_trees(rng, 24)
    x = rng.standard_normal((2, 5, 7, 24)).astype(np.float32)
    ref, _ = jax_layers.BatchNorm(24, eps=eps).apply(params, state, jnp.asarray(x), False)
    bn = torch_layers.BatchNorm(24, eps=eps)
    bn.load_state_dict(
        weights.from_jax_variables({"params": params, "state": state}), strict=True)
    with torch.inference_mode():
        out = bn.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)
    folded = jax_layers.fold_batchnorm(params, state, eps=eps)
    scale, bias = torch_layers.fold_batchnorm(bn)
    np.testing.assert_allclose(scale.numpy(), np.asarray(folded["scale"]), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(bias.numpy(), np.asarray(folded["bias"]), atol=1e-6, rtol=1e-6)


def test_batchnorm_training_updates_running_statistics_like_jax():
    rng = np.random.default_rng(1)
    params, state = _bn_trees(rng, 8)
    x = rng.standard_normal((4, 6, 6, 8)).astype(np.float32)
    ref, new_state = jax_layers.BatchNorm(8).apply(params, state, jnp.asarray(x), True)
    bn = torch_layers.BatchNorm(8)   # momentum 0.1 = the JAX layer's 0.9
    bn.load_state_dict({"weight": torch.tensor(params["gamma"]), "bias": torch.tensor(params["beta"]),
                        "running_mean": torch.tensor(state["mean"]),
                        "running_var": torch.tensor(state["var"])}, strict=True)
    out = bn.train()(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(new_state["mean"]), atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(new_state["var"]), atol=1e-6)


@pytest.mark.parametrize("size", [(7, 7), (8, 8), (15, 12), (32, 32)])
def test_max_pool_3_2_1_matches_jax(size):
    # all-negative input: zero padding would win the max where -inf must not
    x = -np.abs(np.random.default_rng(2).standard_normal((2, *size, 5))).astype(np.float32) - 0.1
    ref = np.asarray(jax_layers.max_pool(jnp.asarray(x), 3, 2, 1))
    out = torch_layers.max_pool(torch.from_numpy(x), 3, 2, 1).numpy()
    assert out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)


def test_global_avg_pool_matches_jax():
    x = np.random.default_rng(3).standard_normal((3, 7, 5, 11)).astype(np.float32)
    np.testing.assert_allclose(torch_layers.global_avg_pool(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_layers.global_avg_pool(jnp.asarray(x))), atol=1e-6)


CONVBN_CASES = {
    "1x1": dict(in_ch=16, out_ch=24, kernel=1),
    "1x1_stride2": dict(in_ch=16, out_ch=24, kernel=1, stride=2),
    "3x3_same": dict(in_ch=16, out_ch=16, kernel=3),
    "3x3_stride2_pad1": dict(in_ch=16, out_ch=16, kernel=3, stride=2, padding=1),
    "7x7_stride2_pad3": dict(in_ch=3, out_ch=8, kernel=7, stride=2, padding=3),
    "3x3_grouped": dict(in_ch=16, out_ch=16, kernel=3, padding=1, groups=4),
    "eps_1e-3": dict(in_ch=8, out_ch=8, kernel=3, padding=1, eps=1e-3),
}


@pytest.mark.parametrize("case", sorted(CONVBN_CASES))
def test_convbn_unfolded_and_folded_match_jax(case):
    cfg = CONVBN_CASES[case]
    rng = np.random.default_rng(4)
    jmod = jax_blocks.ConvBN(**cfg)
    kh = cfg["kernel"]
    w = rng.normal(0, 0.2, (kh, kh, cfg["in_ch"] // cfg.get("groups", 1), cfg["out_ch"]))
    bn_params, bn_state = _bn_trees(rng, cfg["out_ch"])
    params = {"conv": {"w": w.astype(np.float32)}, "bn": bn_params}
    state = {"bn": bn_state}
    x = rng.standard_normal((2, 13, 14, cfg["in_ch"])).astype(np.float32)
    ref, _ = jmod.apply(params, state, jnp.asarray(x), False)
    ref_folded = jmod.apply_folded(jmod.fold(params, state), jnp.asarray(x))

    tmod = torch_blocks.ConvBN(**cfg)
    tmod.load_state_dict(weights.from_jax_variables({"params": params, "state": state}),
                         strict=True)
    with torch.inference_mode():
        out = tmod.eval()(torch.from_numpy(x)).numpy()
        out_folded = tmod.fold().apply_folded(torch.from_numpy(x)).numpy()
    assert out.shape == np.asarray(ref).shape
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)
    np.testing.assert_allclose(out_folded, np.asarray(ref_folded), **TOL)
    np.testing.assert_allclose(out_folded, out, **TOL)


def test_same_padding_that_would_be_asymmetric_is_refused():
    with pytest.raises(ValueError, match="asymmetric"):
        torch_layers.Conv2D(8, 8, 3, stride=2, padding="SAME")
    with pytest.raises(ValueError, match="asymmetric"):
        torch_layers.Conv2D(8, 8, 4, stride=1, padding="SAME")
    assert torch_layers.Conv2D(8, 8, 1, stride=2, padding="SAME").padding == 0
    assert torch_layers.Conv2D(8, 8, 5, stride=1, padding="SAME").padding == 2


@pytest.mark.parametrize("name", ["hard_sigmoid", "hard_swish"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hard_activations_match_jax(name, dtype):
    x = np.linspace(-8, 8, 513, dtype=np.float32)
    ref = np.asarray(getattr(jax_layers, name)(jnp.asarray(x, dtype)).astype(jnp.float32))
    out = getattr(torch_layers, name)(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert out.dtype == getattr(torch, dtype)
    tol = 1e-6 if dtype == "float32" else 2.0 ** -6     # one bf16 ulp at |y| < 8: two roundings
    np.testing.assert_allclose(out.float().numpy(), ref, atol=tol, rtol=0)


def test_silu_matches_jax():
    import jax

    x = np.linspace(-8, 8, 257, dtype=np.float32)
    np.testing.assert_allclose(torch_layers.silu(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.silu(jnp.asarray(x))), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_exact_has_the_jax_meaning(exact, dtype):
    """erf only under fp32 with ``exact=True``; the tanh form otherwise."""
    x = np.linspace(-5, 5, 401, dtype=np.float32)
    ref = np.asarray(jax_layers.gelu(jnp.asarray(x, dtype), exact=exact).astype(jnp.float32))
    out = torch_layers.gelu(torch.from_numpy(x).to(getattr(torch, dtype)), exact=exact)
    tol = 4e-6 if dtype == "float32" else 2.0 ** -6     # bf16: one ulp at |y| < 8
    np.testing.assert_allclose(out.float().numpy(), ref, atol=tol, rtol=0)
    if dtype == "float32":
        erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
        assert bool(np.abs(out.numpy() - erf).max() < 1e-6) == exact


@pytest.mark.parametrize("use_bias", [True, False])
def test_dense_with_and_without_bias_matches_jax(use_bias):
    rng = np.random.default_rng(5)
    params = {"w": rng.normal(0, 0.2, (12, 7)).astype(np.float32)}
    if use_bias:
        params["b"] = rng.standard_normal(7).astype(np.float32)
    x = rng.standard_normal((3, 5, 12)).astype(np.float32)
    ref = np.asarray(jax_layers.Dense(12, 7, use_bias=use_bias).apply(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x)))
    dense = torch_layers.Dense(12, 7, use_bias=use_bias)
    state = weights.from_jax_variables(params)
    assert sorted(state) == (["bias", "weight"] if use_bias else ["weight"])
    dense.load_state_dict(state, strict=True)
    with torch.inference_mode():
        out = dense(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
    dense.reset_parameters(torch.Generator().manual_seed(0))
    assert (dense.bias is None) is (not use_bias)


@pytest.mark.parametrize("gate", ["hard", "sigmoid"])
def test_seblock_matches_jax(gate):
    import jax

    rng = np.random.default_rng(6)
    jmod = jax_blocks.SEBlock(24, 8, gate=gate)
    params = jax.tree_util.tree_map(np.asarray, jmod.init(jax.random.PRNGKey(0)))
    params["fc1"]["b"] = rng.normal(0, 0.5, 8).astype(np.float32)
    params["fc2"]["b"] = rng.normal(0, 0.5, 24).astype(np.float32)
    x = rng.standard_normal((2, 5, 6, 24)).astype(np.float32)
    ref = np.asarray(jmod.apply(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x)))
    tmod = torch_blocks.SEBlock(24, 8, gate=gate)
    tmod.load_state_dict(weights.from_jax_variables(params), strict=True)
    with torch.inference_mode():
        out = tmod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


CONVBN_DEPTHWISE_CASES = {
    "dw3_stride1": dict(in_ch=16, out_ch=16, kernel=3, groups=16, padding=1, eps=1e-3),
    "dw5_stride2": dict(in_ch=16, out_ch=16, kernel=5, stride=2, groups=16, padding=2),
    "dw5_stride1": dict(in_ch=24, out_ch=24, kernel=5, groups=24, padding=2),
}


@pytest.mark.parametrize("case", sorted(CONVBN_DEPTHWISE_CASES))
def test_depthwise_convbn_unfolded_and_folded_match_jax(case):
    """Symmetric ``k // 2`` padding at stride 1 and 2, as MobileNetV3 and
    EfficientNet name it; the folded form rounds after the convolution and
    applies scale and bias in the activation's dtype."""
    cfg = CONVBN_DEPTHWISE_CASES[case]
    rng = np.random.default_rng(7)
    jmod = jax_blocks.ConvBN(**cfg)
    k, c = cfg["kernel"], cfg["out_ch"]
    bn_params, bn_state = _bn_trees(rng, c)
    params = {"conv": {"w": rng.normal(0, 0.2, (k, k, 1, c)).astype(np.float32)},
              "bn": bn_params}
    state = {"bn": bn_state}
    x = rng.standard_normal((2, 13, 14, c)).astype(np.float32)
    ref, _ = jmod.apply(params, state, jnp.asarray(x), False)
    ref_folded = jmod.apply_folded(jmod.fold(params, state), jnp.asarray(x))
    tmod = torch_blocks.ConvBN(**cfg)
    tmod.load_state_dict(weights.from_jax_variables({"params": params, "state": state}),
                         strict=True)
    assert tmod.conv.depthwise is (cfg.get("stride", 1) == 1)
    with torch.inference_mode():
        out = tmod.eval()(torch.from_numpy(x)).numpy()
        out_folded = torch_blocks.fold_convbn(tmod).apply_folded(torch.from_numpy(x)).numpy()
    assert out.shape == np.asarray(ref).shape
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)
    np.testing.assert_allclose(out_folded, np.asarray(ref_folded), **TOL)


def test_set_use_kernels_reaches_every_layer_with_a_kernel():
    from ics_tpu_torch.models import mobilenetv3, swin

    model = mobilenetv3.mobilenetv3_small(num_classes=4, device="meta")
    flagged = [m for m in model.modules() if hasattr(m, "use_kernel")]
    assert all(m.use_kernel for m in flagged) and len(flagged) > 20
    torch_layers.set_use_kernels(model, False)
    assert not any(m.use_kernel for m in flagged)
    micro = torch_layers.set_use_kernels(swin.swin_micro(num_classes=4, device="meta"), False)
    attns = [m for m in micro.modules() if isinstance(m, swin.WindowAttention)]
    assert len(attns) == 3 and not any(a.use_kernel for a in attns)
