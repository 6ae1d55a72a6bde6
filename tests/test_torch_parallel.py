"""The port's device mesh and sharding layer (``ics_tpu_torch.parallel.mesh``)
against the JAX package's, on the CPU.

``make_mesh`` and ``mesh_from_settings`` must take the reference's decisions
(shape, axis names, which devices, in which order) on the same settings and
the same number of devices, and raise where it raises with its message. The
port's devices are ``cuda:i`` names here: a mesh only names devices, so no
card is needed to build one, and the indices stand for the JAX device ids
(JAX's 8 virtual CPU devices, sliced to the count). ``shard_head_for_tp``
splits the head by classes exactly as the reference lays it out.
"""

import logging

import jax
import numpy as np
import pytest
import torch

from ics_tpu.core.config import Settings as JaxSettings
from ics_tpu.parallel import mesh as jax_mesh
from ics_tpu_torch.core.config import Settings
from ics_tpu_torch.parallel import mesh as port_mesh


def _cuda(n):
    return [torch.device("cuda", i) for i in range(n)]


def _same_mesh(port, ref):
    if ref is None:
        assert port is None
        return
    assert port.axis_names == ref.axis_names
    assert port.shape == dict(ref.shape)
    assert [d.index for d in port.devices.flat] == [d.id for d in ref.devices.flat]


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8])
def test_make_mesh_defaults_as_the_reference(n):
    _same_mesh(port_mesh.make_mesh(devices=_cuda(n)), jax_mesh.make_mesh(devices=jax.devices()[:n]))
    _same_mesh(port_mesh.make_mesh((n,), devices=_cuda(n)),
               jax_mesh.make_mesh((n,), devices=jax.devices()[:n]))


def test_make_mesh_explicit_axes_and_a_prefix_of_the_devices():
    port = port_mesh.make_mesh((2, 2), ("model", "data"), devices=_cuda(8))
    ref = jax_mesh.make_mesh((2, 2), ("model", "data"), devices=jax.devices())
    _same_mesh(port, ref)
    assert port.size == 4 and port.shape == {"model": 2, "data": 2}


_CASES = [
    # (settings, visible devices)
    ({}, 1), ({}, 2), ({}, 8),
    ({"TPU_MESH_SHAPE": "1"}, 8),
    ({"TPU_MESH_SHAPE": "2"}, 8),
    ({"TPU_MESH_SHAPE": "4,2"}, 8),
    ({"TPU_MESH_SHAPE": "2,2", "TPU_MESH_AXES": "model,data"}, 8),
    ({"TPU_MESH_SHAPE": "1,2"}, 2),
    ({"TPU_MESH_SHAPE": "16"}, 8),                       # too few devices
    ({"TPU_MESH_SHAPE": "2"}, 1),                        # the one-card refusal
    ({"TPU_PP_STAGES": "4"}, 8),
    ({"TPU_PP_STAGES": "2"}, 2),
    ({"TPU_PP_STAGES": "2"}, 1),                         # the one-card refusal
    ({"TPU_PP_STAGES": "16"}, 8),
    ({"TPU_PP_STAGES": "4", "TPU_MESH_SHAPE": "4,2"}, 8),  # mutually exclusive
    ({"TPU_PP_STAGES": "1"}, 8),                         # 1 stage is no pipeline
]


@pytest.mark.parametrize("env,n", _CASES, ids=[f"{e}-{n}" for e, n in _CASES])
def test_mesh_from_settings_decides_as_the_reference(monkeypatch, env, n):
    visible = jax.devices()[:n]
    monkeypatch.setattr(jax, "devices", lambda *a: visible)
    try:
        ref, ref_exc = jax_mesh.mesh_from_settings(JaxSettings(**env)), None
    except RuntimeError as exc:
        ref, ref_exc = None, exc
    if ref_exc is not None:
        with pytest.raises(RuntimeError) as got:
            port_mesh.mesh_from_settings(Settings(**env), devices=_cuda(n))
        assert str(got.value) == str(ref_exc)
        return
    _same_mesh(port_mesh.mesh_from_settings(Settings(**env), devices=_cuda(n)), ref)


def test_mesh_from_settings_names_each_visible_card_once(monkeypatch):
    """With no devices given, the mesh spans ``cuda:0..n-1``; where no card is
    visible, "auto" is no mesh and an explicit shape is refused."""
    monkeypatch.setattr(port_mesh, "visible_devices", lambda: _cuda(4))
    mesh = port_mesh.mesh_from_settings(Settings())
    assert mesh.shape == {"data": 4} and [d.index for d in mesh.devices.flat] == [0, 1, 2, 3]
    monkeypatch.undo()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert port_mesh.visible_devices() == []
    assert port_mesh.mesh_from_settings(Settings()) is None
    with pytest.raises(RuntimeError, match="needs 2 devices, but only 0 are visible"):
        port_mesh.mesh_from_settings(Settings(TPU_MESH_SHAPE="2"))


def _head(classes, features=6, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((features, classes)).astype(np.float32),
            rng.standard_normal(classes).astype(np.float32))


@pytest.mark.parametrize("classes", [8, 6])
def test_shard_head_for_tp_splits_as_the_reference(classes):
    """Divisible classes: each position of a (data 2, model 2) mesh holds the
    reference's shard of the head (the port's weight is [classes, features],
    the reference's [features, classes]); every other tensor is whole."""
    w, b = _head(classes)
    other = np.arange(12, dtype=np.float32).reshape(3, 4)
    ref_mesh = jax_mesh.make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4])
    ref = jax_mesh.apply_shardings(
        {"head": {"w": w, "b": b}, "stem": other},
        jax_mesh.shard_head_for_tp(ref_mesh, {"head": {"w": w, "b": b}, "stem": other}))
    mesh = port_mesh.make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    params = {"head.weight": torch.from_numpy(w.T.copy()), "head.bias": torch.from_numpy(b),
              "stem.weight": torch.from_numpy(other)}
    shardings = port_mesh.shard_head_for_tp(mesh, params)
    assert shardings["head.weight"].spec == ("model",) == shardings["head.bias"].spec
    assert shardings["stem.weight"] == port_mesh.replicated_sharding(mesh)
    placed = port_mesh.apply_shardings(params, shardings)
    ref_w = {s.device.id: np.asarray(s.data) for s in ref["head"]["w"].addressable_shards}
    ref_b = {s.device.id: np.asarray(s.data) for s in ref["head"]["b"].addressable_shards}
    for index, dev in np.ndenumerate(ref_mesh.devices):
        assert placed["head.weight"][index].shape == (classes // 2, 6)
        np.testing.assert_array_equal(placed["head.weight"][index].numpy().T, ref_w[dev.id])
        np.testing.assert_array_equal(placed["head.bias"][index].numpy(), ref_b[dev.id])
        np.testing.assert_array_equal(placed["stem.weight"][index].numpy(), other)


def test_shard_head_for_tp_serves_an_indivisible_head_replicated(caplog):
    w, b = _head(7)
    ref_mesh = jax_mesh.make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4])
    ref = jax_mesh.shard_head_for_tp(ref_mesh, {"head": {"w": w, "b": b}})
    assert ref["head"]["w"].spec == jax.sharding.PartitionSpec()
    mesh = port_mesh.make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    params = {"head.weight": torch.from_numpy(w.T.copy()), "head.bias": torch.from_numpy(b)}
    with caplog.at_level(logging.INFO, logger=port_mesh.__name__):
        shardings = port_mesh.shard_head_for_tp(mesh, params)
    assert all(s.spec == () for s in shardings.values())
    assert any("not divisible by model axis (2)" in r.getMessage() for r in caplog.records)
    placed = port_mesh.apply_shardings(params, shardings)
    for index in np.ndindex(2, 2):
        assert placed["head.weight"][index].shape == (7, 6)


def test_a_mesh_without_a_model_axis_leaves_the_head_whole():
    w, b = _head(8)
    mesh = port_mesh.make_mesh((4,), ("data",), devices=["cpu"] * 4)
    params = {"head.weight": torch.from_numpy(w.T.copy()), "head.bias": torch.from_numpy(b)}
    assert all(s.spec == () for s in port_mesh.shard_head_for_tp(mesh, params).values())


def test_batch_sharding_splits_the_leading_dimension_as_the_reference():
    x = np.arange(16 * 2 * 3, dtype=np.float32).reshape(16, 2, 3)
    ref_mesh = jax_mesh.make_mesh((8,), ("data",))
    ref = jax.device_put(x, jax_mesh.batch_sharding(ref_mesh, 3))
    mesh = port_mesh.make_mesh((8,), ("data",), devices=["cpu"] * 8)
    sharding = port_mesh.batch_sharding(mesh, 3)
    assert sharding.spec == ("data", None, None)
    placed = port_mesh.place(torch.from_numpy(x), sharding)
    for shard in ref.addressable_shards:
        np.testing.assert_array_equal(placed[shard.device.id].numpy(), np.asarray(shard.data))
    with pytest.raises(ValueError, match="does not split"):
        port_mesh.place(torch.zeros(12, 2), port_mesh.batch_sharding(mesh, 2))


def test_cpu_positions_hand_tensors_on_as_they_are():
    """On the CPU a position has no stream; ``send`` is the tensor itself."""
    mesh = port_mesh.make_mesh((2,), ("data",), devices=["cpu", "cpu"])
    a, b = mesh.positions
    assert a.stream is None and a is not b
    x = torch.arange(4.0)
    assert port_mesh.send(x, a, b) is x
    with b.active():
        assert torch.equal(port_mesh.send(x * 2, b, a), x * 2)


def test_cuda_devices_resolve_with_their_index(monkeypatch):
    """``get_device`` gives a CUDA device its index (``cuda`` and no name at
    all are the current card), and so does an engine, so that a kernel
    launched on another card since leaves them where they were. No card
    here: CUDA's presence is mocked, and the engine's model stays on the CPU
    (``Module.to`` mocked), which nothing in this test launches on."""
    from ics_tpu_torch import get_device
    from ics_tpu_torch.runtime.engine import InferenceEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    assert get_device() == torch.device("cuda", 3) == get_device("cuda")
    assert get_device("cuda:1") == torch.device("cuda", 1)
    assert get_device("cpu") == torch.device("cpu")
    assert port_mesh.make_mesh((2,), devices=["cuda", "cuda:0"]).devices.tolist() == [
        torch.device("cuda", 3), torch.device("cuda", 0)]
    monkeypatch.setattr(torch.nn.Module, "to", lambda self, *a, **k: self)
    monkeypatch.setattr("ics_tpu_torch.runtime.engine.disable_tf32", lambda: None)
    engine = InferenceEngine("resnet_tiny", num_classes=8, precision="fp32", buckets=(1,),
                             canvas=64, device="cuda")
    assert engine.device == torch.device("cuda", 3)
    pinned = InferenceEngine("resnet_tiny", num_classes=8, precision="fp32", buckets=(1,),
                             canvas=64, mesh=port_mesh.make_mesh((1,), devices=["cuda:2"]))
    assert pinned.device == torch.device("cuda", 2)


def test_without_a_card_no_cuda_device_resolves(monkeypatch):
    from ics_tpu_torch import get_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        get_device()
    with pytest.raises(RuntimeError, match="requested but no CUDA device"):
        get_device("cuda:0")
