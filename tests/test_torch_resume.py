"""Resuming a fine-tune in the port from a directory the JAX trainer wrote.

The reference's ``FineTuner.run`` resumes from the newest orbax step of its
checkpoint directory. The port reads no orbax, so where the newest step is an
orbax one it must refuse (``UnconvertedCheckpointError``, naming the
conversion tool), never train from step 0 beside it; and a converted step,
which holds the weights alone, must be refused for a resume
(``UnresumableCheckpointError``: the optimizer state was not converted), never
continued with a fresh optimizer. A job (``retomar_de``) ends ``falhou`` with
the same message.
"""

import jax
import numpy as np
import pytest
import torch

from ics_tpu.train import finetune as jft
from ics_tpu.train.checkpoint import CheckpointManager as JaxManager
from ics_tpu_torch.models.registry import get_model
from ics_tpu_torch.train import finetune as tft
from ics_tpu_torch.train.checkpoint import (
    CheckpointManager,
    UnconvertedCheckpointError,
    UnresumableCheckpointError,
)
from tests.test_torch_engine_pairs import variables_of


def _jax_step(directory, step: int = 3, classes: int = 2, model: str = "resnet_tiny") -> None:
    """One orbax step of ``model`` as the JAX trainer writes it: variables,
    optax state and the step's metadata."""
    variables = variables_of(model, classes, seed=1)
    opt_state = jft.make_optimizer(lr=0.01).init(
        jax.tree_util.tree_map(np.asarray, variables["params"]))
    mgr = JaxManager(directory)
    mgr.save(step, variables, opt_state, {"step": step})
    mgr.close()


def _tuner(directory, classes: int = 2) -> tft.FineTuner:
    model = get_model("resnet_tiny").build(num_classes=classes)
    model.init_weights(torch.Generator().manual_seed(0))
    return tft.FineTuner(model, tft.make_optimizer(lr=0.05), image_size=32, resize_short=32,
                         compute_dtype=torch.float32, checkpoint_dir=str(directory))


def _batches(n: int = 2):
    rng = np.random.default_rng(0)
    batch = (rng.integers(0, 256, (4, 64, 64, 3), np.uint8), np.full((4, 2), 48, np.int32),
             np.asarray([0, 1, 0, 1], np.int32))
    return iter([batch] * n)


def test_a_directory_of_orbax_steps_is_refused_not_trained_from_the_start(tmp_path):
    _jax_step(tmp_path / "job")
    tuner = _tuner(tmp_path / "job")
    before = {k: v.clone() for k, v in tuner.model.state_dict().items()}
    with pytest.raises(UnconvertedCheckpointError, match="convert_checkpoints.py") as err:
        tuner.run(_batches(), max_steps=2)
    assert err.value.steps == [3]
    assert CheckpointManager(tmp_path / "job").steps() == []          # nothing written beside
    after = tuner.model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)      # no step taken


def test_an_orbax_step_newer_than_the_ports_is_the_one_resumed(tmp_path):
    """The newest step is the JAX trainer's: it is refused even where an
    older step of the port sits beside it."""
    tuner = _tuner(tmp_path / "job")
    tuner.run(_batches(1), max_steps=1)
    assert CheckpointManager(tmp_path / "job").steps() == [1]
    _jax_step(tmp_path / "job", step=4)
    with pytest.raises(UnconvertedCheckpointError):
        _tuner(tmp_path / "job").run(_batches(), max_steps=1)


def test_a_converted_step_is_refused_for_a_resume(tmp_path):
    import convert_checkpoints

    _jax_step(tmp_path / "job")
    assert convert_checkpoints.convert_directory(tmp_path / "job") == [3]
    restored = CheckpointManager(tmp_path / "job").restore()
    assert "opt_state" not in restored                                 # it serves: weights alone
    tuner = _tuner(tmp_path / "job")
    before = {k: v.clone() for k, v in tuner.model.state_dict().items()}
    with pytest.raises(UnresumableCheckpointError,
                       match="optimizer state was not converted") as err:
        tuner.run(_batches(), max_steps=2)
    assert err.value.step == 3
    assert CheckpointManager(tmp_path / "job").steps() == [3]
    after = tuner.model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)


def test_a_resume_of_the_ports_own_step_continues(tmp_path):
    """The repair leaves the port's own resume as it was: the count goes on."""
    _tuner(tmp_path / "job").run(_batches(2), max_steps=2)
    _, _, history = _tuner(tmp_path / "job").run(_batches(2), max_steps=2)
    assert [h["step"] for h in history] == [3, 4]


@pytest.mark.parametrize("converted", [False, True], ids=["orbax", "converted"])
def test_a_job_resuming_a_jax_directory_fails_with_the_message(tmp_path, converted):
    """``retomar_de`` on a directory the JAX trainer wrote: the job ends
    ``falhou`` with the checkpoint's error, registers nothing, frees the slot."""
    import convert_checkpoints
    from tests.test_torch_job import ID_JOB_OLD, seeded_manager, wait

    manager, id_amb = seeded_manager(tmp_path)
    directory = manager.checkpoint_root / id_amb / "resnet_tiny" / ID_JOB_OLD
    _jax_step(directory)
    if converted:
        convert_checkpoints.convert_directory(directory)
    job = manager.start(id_amb, "resnet_tiny", max_steps=2, batch_size=4, canvas=64,
                        compute_dtype="fp32", retomar_de=ID_JOB_OLD)
    wait(job)
    assert job.status == "falhou" and job.id_mod is None
    want = "optimizer state was not converted" if converted else "convert_checkpoints.py"
    assert want in job.error
    assert manager._running is None
