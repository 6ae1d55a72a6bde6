"""The port's pretrained import (``ics_tpu_torch.train.pretrained``) against
the reference's (``ics_tpu.train.pretrained``).

- Every model of the port's registry, in both layouts: a seeded tree of the
  reference's shapes is written as the torch/timm layout (the reference's
  own exporters, ``tests/test_pretrained.py::_EXPORTERS``) and as the native
  flat npz (the reference's ``save_npz``), each through a file, and loads
  into exactly the state dict that ``weights.from_jax_variables`` gives for
  the same tree, ``strict=True``. As in the reference, a model over 100M
  parameters goes through the mapper in memory.
- On one file, the reference's import and the port's give the same weights.
- The head re-initialisation, the ``PretrainedFormatError`` cases with the
  reference's messages, the native file written by the port read by the
  reference, and the position-embedding resize up and down within 1e-6 of
  ``jax.image.resize``.
"""

import functools
import json
import struct
import zlib

import jax
import numpy as np
import pytest
import torch

from ics_tpu.models import registry as jax_registry
from ics_tpu.train import pretrained as jax_pt
from ics_tpu_torch import weights
from ics_tpu_torch.models.registry import get_model, list_models
from ics_tpu_torch.train import pretrained as pt
from tests.test_pretrained import _EXPORTERS, _export_swin

BIG = 100_000_000   # parameters past which the reference maps in memory


@functools.lru_cache(maxsize=1)
def _seeded(name: str):
    """The reference's model at 6 classes and a tree of its shapes, each leaf
    a seeded normal draw (running variances positive). The leaves are views
    of one draw at leaf-dependent offsets, so a large model costs one buffer."""
    jmodel = jax_registry.get_model(name).build(num_classes=6)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    flat = jax_pt.flatten_variables(shapes)
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    base = rng.standard_normal(max(int(np.prod(s.shape)) for s in flat.values()) + 4099,
                               dtype=np.float32)
    tree = {}
    for i, (path, s) in enumerate(sorted(flat.items())):
        off = (i * 7919) % 4099
        leaf = base[off:off + int(np.prod(s.shape))].reshape(s.shape)
        tree[path] = np.abs(leaf) + 0.5 if path.endswith("/var") else leaf
    variables = jax_pt.unflatten_variables(tree)
    variables.setdefault("state", {})
    return jmodel, variables


def _n_params(variables) -> int:
    return sum(int(np.prod(v.shape)) for v in jax_pt.flatten_variables(variables["params"]).values())


def _assert_is_the_mapping_of(state_dict: dict, variables: dict) -> None:
    """``state_dict`` equals ``weights.from_jax_variables(variables)`` exactly,
    key for key (compared one tensor at a time)."""
    names = set()
    for name, leaf, perm in weights._entries(variables):
        arr = np.array(leaf, np.float32, copy=False)
        want = torch.from_numpy(arr).permute(perm) if perm else torch.from_numpy(arr)
        assert torch.equal(state_dict[name], want), name
        names.add(name)
    assert names == set(state_dict)


def _family(name: str) -> str:
    return next(f for f in _EXPORTERS if name.startswith(f))


@pytest.mark.parametrize("name,layout", [(n, lay) for n in list_models()
                                          for lay in ("torch", "native")])
def test_roundtrip_into_the_mapped_state_dict(name, layout, tmp_path):
    jmodel, variables = _seeded(name)
    if _n_params(variables) < BIG:
        path = tmp_path / f"{name}.npz"
        if layout == "torch":
            np.savez(path, **_EXPORTERS[_family(name)](jmodel, variables))
        else:
            jax_pt.save_npz(path, variables)
        model, state_dict = pt.load_pretrained(name, path)
        path.unlink()   # the zoo's files would fill the disk over a run
        assert model.num_classes == 6
        assert all(p.device.type == "cpu" for p in model.parameters())
        held = model.state_dict()
        assert all(held[k] is v or torch.equal(held[k], v) for k, v in state_dict.items())
    else:
        if layout == "torch":
            mapper, _ = pt._family(name)
            tree = mapper(get_model(name).build(num_classes=6, device="meta"),
                          _EXPORTERS[_family(name)](jmodel, variables))
        else:
            tree = pt.unflatten_variables(jax_pt.flatten_variables(variables))
            tree.setdefault("state", {})
        state_dict = weights.from_jax_variables(tree)
        get_model(name).build(num_classes=6, device="meta").load_state_dict(
            state_dict, strict=True, assign=True)
    _assert_is_the_mapping_of(state_dict, variables)


@pytest.mark.parametrize("name", ["swin_micro", "swin_tiny"])
def test_swin_new_timm_layout_roundtrip(name, tmp_path):
    jmodel, variables = _seeded(name)
    flat = _export_swin(jmodel, variables, new_timm=True)
    assert "head.fc.weight" in flat and "layers.0.downsample.reduction.weight" not in flat
    np.savez(tmp_path / "s.npz", **flat)
    _, state_dict = pt.load_pretrained(name, tmp_path / "s.npz")
    _assert_is_the_mapping_of(state_dict, variables)


@pytest.mark.parametrize("name,layout", [("densenet121", "torch"), ("regnet_y_400mf", "torch"),
                                          ("efficientnet_b0", "native"),
                                          ("resnet18", "safetensors")])
def test_the_reference_and_the_port_agree_on_one_file(name, layout, tmp_path):
    jmodel, variables = _seeded(name)
    if layout == "native":
        path = tmp_path / "w.npz"
        jax_pt.save_npz(path, variables)
    elif layout == "torch":
        path = tmp_path / "w.npz"
        np.savez(path, **_EXPORTERS[_family(name)](jmodel, variables))
    else:
        path = tmp_path / "w.safetensors"
        _write_safetensors(path, _EXPORTERS[_family(name)](jmodel, variables))
    _, ref = jax_pt.load_pretrained(name, path)
    _, state_dict = pt.load_pretrained(name, path)
    ref = jax.tree_util.tree_map(np.asarray, ref)
    _assert_is_the_mapping_of(state_dict, ref)


def test_a_timm_vit_b16_file_loads_into_the_h6d128_vit_as_in_the_reference(tmp_path):
    """Shared with the reference (``ROADMAP.md`` §3): the torch-layout mapper is
    picked by the ``vit`` prefix and checks shapes alone, so a timm ViT-B/16
    file (12 heads of 64) loads into ``vit_b16_h6d128`` (6 heads of 128) in
    both packages, and the port's state dict is the mapping of the
    reference's tree, which holds the file's weights unchanged."""
    jmodel, variables = _seeded("vit_b16")
    path = tmp_path / "b16.npz"
    np.savez(path, **_EXPORTERS["vit"](jmodel, variables))
    _, ref = jax_pt.load_pretrained("vit_b16_h6d128", path)
    model, state_dict = pt.load_pretrained("vit_b16_h6d128", path)
    path.unlink()
    assert model.blocks[0].attn.head_dim == 128 and model.num_classes == 6
    _assert_is_the_mapping_of(state_dict, jax.tree_util.tree_map(np.asarray, ref))
    _assert_is_the_mapping_of(state_dict, variables)


def test_a_resized_position_embedding_agrees_with_the_reference(tmp_path):
    jmodel, variables = _seeded("vit_tiny")
    flat = _EXPORTERS["vit"](jmodel, variables)
    dim = flat["pos_embed"].shape[-1]
    flat["pos_embed"] = np.random.default_rng(3).standard_normal(
        (1, 1 + 7 * 7, dim)).astype(np.float32)      # a 7x7 grid into the model's 4x4
    np.savez(tmp_path / "v.npz", **flat)
    _, ref = jax_pt.load_pretrained("vit_tiny", tmp_path / "v.npz")
    _, state_dict = pt.load_pretrained("vit_tiny", tmp_path / "v.npz")
    np.testing.assert_allclose(state_dict["pos_embed"].numpy(),
                               np.asarray(ref["params"]["pos_embed"]), atol=1e-6, rtol=0)
    ref = jax.tree_util.tree_map(np.asarray, ref)
    ref["params"]["pos_embed"] = state_dict["pos_embed"].numpy()
    _assert_is_the_mapping_of(state_dict, ref)


@pytest.mark.parametrize("g_old,g_new", [(14, 24), (24, 14), (7, 3), (3, 7), (4, 4)])
def test_resize_pos_embed_matches_jax_up_and_down(g_old, g_new):
    dim = 8
    pos = np.random.default_rng(g_old * 31 + g_new).standard_normal(
        (1, 1 + g_old * g_old, dim)).astype(np.float32)
    got = pt._resize_pos_embed(pos, g_new * g_new, dim)
    ref = np.asarray(jax_pt._resize_pos_embed(pos, g_new * g_new, dim))
    assert got.shape == (1, 1 + g_new * g_new, dim)
    np.testing.assert_array_equal(got[:, 0], pos[:, 0])          # the class token is kept
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_head_reinit_keeps_the_backbone(tmp_path):
    jmodel, variables = _seeded("mobilenetv3_small")
    jax_pt.save_npz(tmp_path / "m.npz", variables)
    model, sd = pt.load_pretrained("mobilenetv3_small", tmp_path / "m.npz", num_classes=7, seed=5)
    assert model.num_classes == 7
    assert tuple(sd["head.weight"].shape) == (7, 1024) and tuple(sd["head.bias"].shape) == (7,)
    mapped = weights.from_jax_variables(variables)
    for k, v in sd.items():
        if not k.startswith("head."):
            assert torch.equal(v, mapped[k]), k
    # the port model's own head initialisation, from a generator seeded with seed
    head = get_model("mobilenetv3_small").build(num_classes=7, device="meta").head
    head = head.to_empty(device="cpu")
    head.reset_parameters(torch.Generator().manual_seed(5))
    assert torch.equal(sd["head.weight"], head.weight) and not sd["head.bias"].any()
    _, again = pt.load_pretrained("mobilenetv3_small", tmp_path / "m.npz", num_classes=7, seed=5)
    _, other = pt.load_pretrained("mobilenetv3_small", tmp_path / "m.npz", num_classes=7, seed=6)
    assert torch.equal(again["head.weight"], sd["head.weight"])
    assert not torch.equal(other["head.weight"], sd["head.weight"])
    # the same class count keeps the checkpoint's head
    _, same = pt.load_pretrained("mobilenetv3_small", tmp_path / "m.npz", num_classes=6)
    assert torch.equal(same["head.weight"], mapped["head.weight"])


@pytest.mark.parametrize("name", ["resnet_tiny", "densenet121", "regnet_y_400mf", "swin_micro",
                                  "vit_tiny", "convnext_tiny"])
def test_the_ports_native_file_loads_in_the_reference(name, tmp_path):
    _, variables = _seeded(name)
    pt.save_npz(tmp_path / "p.npz", weights.from_jax_variables(variables))
    assert sorted(np.load(tmp_path / "p.npz").files) == \
        sorted(jax_pt.flatten_variables({k: v for k, v in variables.items() if v}))
    _, ref = jax_pt.load_pretrained(name, tmp_path / "p.npz")
    _assert_is_the_mapping_of(weights.from_jax_variables(variables),
                              jax.tree_util.tree_map(np.asarray, ref))
    _, state_dict = pt.load_pretrained(name, tmp_path / "p.npz")
    _assert_is_the_mapping_of(state_dict, variables)


# -- the error cases, with the reference's messages ---------------------------------

def _write_safetensors(path, flat):
    header, blobs, off = {}, [], 0
    dmap = {np.float32: "F32", np.int64: "I64", np.float16: "F16"}
    for name, arr in flat.items():
        b = np.ascontiguousarray(arr).tobytes()
        header[name] = {"dtype": dmap[arr.dtype.type], "shape": list(arr.shape),
                        "data_offsets": [off, off + len(b)]}
        blobs.append(b)
        off += len(b)
    hj = json.dumps(header).encode()
    path.write_bytes(struct.pack("<Q", len(hj)) + hj + b"".join(blobs))


def _raw_safetensors(path, header, data: bytes):
    hj = json.dumps(header).encode()
    path.write_bytes(struct.pack("<Q", len(hj)) + hj + data)


def _both_raise(call, *args, **kwargs) -> str:
    """Both packages raise their ``PretrainedFormatError`` on the same input,
    with the same message; returns it."""
    with pytest.raises(jax_pt.PretrainedFormatError) as ref:
        call(jax_pt)(*args, **kwargs)
    with pytest.raises(pt.PretrainedFormatError) as got:
        call(pt)(*args, **kwargs)
    assert str(got.value) == str(ref.value)
    return str(got.value)


def test_a_missing_file_is_loud(tmp_path):
    msg = _both_raise(lambda m: m.load_pretrained, "resnet_tiny", tmp_path / "nope.npz")
    assert "não encontrado" in msg


def test_a_wrong_model_is_loud(tmp_path):
    _, variables = _seeded("resnet_tiny")
    jax_pt.save_npz(tmp_path / "r.npz", variables)
    for m in (jax_pt, pt):
        with pytest.raises(m.PretrainedFormatError, match="^checkpoint incompatível com "
                                                          "mobilenetv3_small: faltando="):
            m.load_pretrained("mobilenetv3_small", tmp_path / "r.npz")


def test_a_missing_weight_and_a_missing_head_are_loud(tmp_path):
    jmodel, variables = _seeded("resnet_tiny")
    flat = _EXPORTERS["resnet"](jmodel, variables)
    np.savez(tmp_path / "a.npz", **{k: v for k, v in flat.items() if k != "layer2.0.bn1.bias"})
    assert "peso ausente no checkpoint: layer2.0.bn1.bias" in _both_raise(
        lambda m: m.load_pretrained, "resnet_tiny", tmp_path / "a.npz")
    np.savez(tmp_path / "b.npz", **{k: v for k, v in flat.items() if not k.startswith("fc.")})
    assert "checkpoint sem fc.weight" in _both_raise(
        lambda m: m.load_pretrained, "resnet_tiny", tmp_path / "b.npz")
    np.savez(tmp_path / "c.npz", **{"params/stem/conv/w": np.zeros((3, 3, 3, 4), np.float32)})
    assert "layout nativo sem params/head/w" in _both_raise(
        lambda m: m.load_pretrained, "resnet_tiny", tmp_path / "c.npz")
    assert "sem mapeador" in _both_raise(lambda m: m._family, "lenet5")


def test_torch_containers_load_or_fail_as_the_reference(tmp_path):
    jmodel, variables = _seeded("resnet_tiny")
    flat = _EXPORTERS["resnet"](jmodel, variables)
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in flat.items()}
    torch.save({"model": sd, "epoch": 12}, tmp_path / "wrapped.pth")
    _, state_dict = pt.load_pretrained("resnet_tiny", tmp_path / "wrapped.pth")
    _assert_is_the_mapping_of(state_dict, variables)
    torch.save({k: v.bfloat16() for k, v in sd.items()}, tmp_path / "bf16.pth")
    got, ref = pt.load_flat(tmp_path / "bf16.pth"), jax_pt.load_flat(tmp_path / "bf16.pth")
    assert got["fc.weight"].dtype == np.float32
    np.testing.assert_array_equal(got["fc.weight"], ref["fc.weight"])
    torch.save([1, 2, 3], tmp_path / "junk.pth")
    assert "state_dict" in _both_raise(lambda m: m.load_flat, tmp_path / "junk.pth")


def test_safetensors_load_or_fail_as_the_reference(tmp_path):
    jmodel, variables = _seeded("resnet_tiny")
    _write_safetensors(tmp_path / "r.safetensors", _EXPORTERS["resnet"](jmodel, variables))
    _, state_dict = pt.load_pretrained("resnet_tiny", tmp_path / "r.safetensors")
    _assert_is_the_mapping_of(state_dict, variables)
    vals = np.array([1.5, -2.0, 0.015625, 3.0], np.float32)
    bf16 = (vals.view(np.uint32) >> 16).astype(np.uint16)
    _raw_safetensors(tmp_path / "b.safetensors",
                     {"x": {"dtype": "BF16", "shape": [4], "data_offsets": [0, 8]}}, bf16.tobytes())
    np.testing.assert_array_equal(pt.load_safetensors(tmp_path / "b.safetensors")["x"], vals)
    cases = {
        "garbage": b"\x00",
        "truncated": ({"x": {"dtype": "F32", "shape": [64], "data_offsets": [0, 256]}},
                      b"\x00" * 16),
        "list": ([1, 2], b""),
        "bad_size": ({"x": {"dtype": "F32", "shape": [4], "data_offsets": [0, 10]}},
                     b"\x00" * 10),
        "dtype": ({"x": {"dtype": "C64", "shape": [1], "data_offsets": [0, 8]}}, b"\x00" * 8),
        "entry": ({"x": {"dtype": "F32"}}, b""),
    }
    for label, case in cases.items():
        path = tmp_path / f"{label}.safetensors"
        if isinstance(case, bytes):
            path.write_bytes(case)
        else:
            _raw_safetensors(path, *case)
        _both_raise(lambda m: m.load_safetensors, path)
