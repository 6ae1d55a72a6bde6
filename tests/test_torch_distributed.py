"""The port's multi-process start (``parallel.mesh.maybe_initialize_distributed``)
on the CPU, mirroring ``tests/test_dcn_distributed.py``.

Two local processes start ``torch.distributed`` through the function from
the ``TPU_COORDINATOR_ADDRESS`` / ``TPU_NUM_PROCESSES`` / ``TPU_PROCESS_ID``
settings (gloo for CPU tensors, PyTorch's default for them), sum across
the processes (24.0, the reference's number) and take the reference test's
data-parallel gradient step: each process's half of the global batch, the
gradients summed by ``all_reduce``, both landing on the global-batch step's
parameters (numpy, 1e-5) with the same bits. Each process has a time limit.
The meshes stay over each process's own devices (none here), where JAX's
``jax.devices()`` spans both processes: the port's deliberate divergence.
In this process: a no-op without an address (both packages), idempotent,
and called first by ``mesh_from_settings`` and
``HedgedInferenceService.from_settings`` as in the reference.
"""

import os
import socket
import subprocess
import sys
import textwrap

import pytest
import torch

from ics_tpu.core.config import Settings as JaxSettings
from ics_tpu.parallel import mesh as jax_mesh
from ics_tpu_torch.core.config import Settings
from ics_tpu_torch.parallel import mesh as mesh_mod

_CHILD = textwrap.dedent(
    """
    import sys

    import numpy as np
    import torch
    import torch.distributed as dist

    from ics_tpu_torch.core.config import Settings
    from ics_tpu_torch.parallel import mesh as mesh_mod

    pid = int(sys.argv[1])
    port = sys.argv[2]
    s = Settings(
        TPU_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
        TPU_NUM_PROCESSES=2,
        TPU_PROCESS_ID=pid,
    )
    assert mesh_mod.maybe_initialize_distributed(s) is True
    assert mesh_mod.maybe_initialize_distributed(s) is True      # idempotent
    assert dist.get_world_size() == 2 and dist.get_rank() == pid
    # the meshes stay over this process's own devices (no card here)
    assert mesh_mod.visible_devices() == []
    assert mesh_mod.mesh_from_settings(s) is None

    total = torch.full((2, 4), float(pid + 1)).sum()
    dist.all_reduce(total)
    # rows from p0 are 1s (sum 8), from p1 are 2s (sum 16)
    assert float(total) == 24.0, float(total)

    # the data-parallel step across the processes: each holds its half of
    # the global batch, its loss is its share of the global mean, and the
    # gradients are summed
    w = torch.tensor([1.0, -2.0, 0.5, 3.0], requires_grad=True)
    x = torch.arange(8, dtype=torch.float32).reshape(2, 4) + 10 * pid
    y = torch.tensor([1.0, -1.0]) + pid
    (((x @ w - y) ** 2).sum() / 4).backward()
    g = w.grad.clone()
    dist.all_reduce(g)
    new_w = w.detach() - 0.01 * g
    # the same step on the concatenated global batch (process 0's rows first)
    xg = np.concatenate([np.arange(8, dtype=np.float32).reshape(2, 4),
                         np.arange(8, dtype=np.float32).reshape(2, 4) + 10])
    yg = np.concatenate([[1.0, -1.0], [2.0, 0.0]]).astype(np.float32)
    wg = np.asarray([1.0, -2.0, 0.5, 3.0], np.float32)
    ref = wg - 0.01 * (2.0 / 4.0) * xg.T @ (xg @ wg - yg)
    np.testing.assert_allclose(new_w.numpy(), ref, rtol=1e-5)
    both = [torch.empty(4) for _ in range(2)]
    dist.all_gather(both, new_w)
    assert torch.equal(both[0], both[1])
    dist.destroy_process_group()
    print("INIT_OK PSUM_OK TRAIN_OK", flush=True)
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_processes_start_sum_and_take_a_data_parallel_step(tmp_path):
    child = tmp_path / "child.py"
    child.write_text(_CHILD)
    port = _free_port()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {
        "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
        "PYTHONPATH": repo,
        "HOME": os.environ.get("HOME", str(tmp_path)),
        "TMPDIR": str(tmp_path),
        "CUDA_VISIBLE_DEVICES": "",
        "OMP_NUM_THREADS": "1",
    }
    procs = [subprocess.Popen([sys.executable, str(child), str(rank), str(port)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in (0, 1)]
    outputs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            outputs.append(out)
    except subprocess.TimeoutExpired:
        pytest.fail("the multi-process start deadlocked (coordinator handshake)")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
        assert "INIT_OK PSUM_OK TRAIN_OK" in out, f"rank {rank}:\n{out}"


def test_no_address_is_a_no_op_in_both_packages(monkeypatch):
    monkeypatch.setattr(mesh_mod, "_distributed_initialized", False)
    monkeypatch.setattr(jax_mesh, "_distributed_initialized", False)
    started = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda **kw: started.append(kw))
    assert mesh_mod.maybe_initialize_distributed(Settings()) is False
    assert jax_mesh.maybe_initialize_distributed(JaxSettings()) is False
    assert started == []


def test_the_start_runs_once_with_the_settings(monkeypatch):
    """The coordinator's address as a TCP init method, the process count and
    this process's rank, once however many callers ask."""
    monkeypatch.setattr(mesh_mod, "_distributed_initialized", False)
    started = []
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: bool(started))
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda **kw: started.append(kw))
    s = Settings(TPU_COORDINATOR_ADDRESS="127.0.0.1:8476", TPU_NUM_PROCESSES=4,
                 TPU_PROCESS_ID=3)
    assert mesh_mod.maybe_initialize_distributed(s) is True
    assert mesh_mod.maybe_initialize_distributed(s) is True
    assert mesh_mod.maybe_initialize_distributed(Settings()) is True
    assert started == [{"init_method": "tcp://127.0.0.1:8476", "world_size": 4, "rank": 3}]


class _Started(Exception):
    pass


@pytest.mark.parametrize("caller", ["mesh_from_settings", "hedged_from_settings"])
def test_the_serving_builders_start_the_processes_first(monkeypatch, caller):
    from ics_tpu_torch.runtime.hedging import HedgedInferenceService

    seen = []

    def start(settings):
        seen.append(settings.TPU_COORDINATOR_ADDRESS)
        raise _Started

    monkeypatch.setattr(mesh_mod, "maybe_initialize_distributed", start)
    s = Settings(TPU_COORDINATOR_ADDRESS="127.0.0.1:8476", TPU_SERVING_REPLICAS=2)
    with pytest.raises(_Started):
        if caller == "mesh_from_settings":
            mesh_mod.mesh_from_settings(s, devices=["cpu"] * 2)
        else:
            HedgedInferenceService.from_settings(s, devices=["cpu"] * 2)
    assert seen == ["127.0.0.1:8476"]
