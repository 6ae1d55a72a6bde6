"""Model checkpoints of the port (counterpart of ``ics_tpu/train/checkpoint.py``).

The reference's interface (``save``, ``latest_step``, ``restore``, ``close``,
``max_to_keep``) over ``torch.save``: one file a step, ``step_<n>.pt`` under
the directory, holding the port's state dict and, when given, the optimizer
state and a metadata dict.

The JAX trainer's orbax checkpoints (a directory per step, named by the
step) are not read here: the port imports no orbax. A directory that holds
them and no ``step_<n>.pt`` raises ``UnconvertedCheckpointError``, which
names ``convert_checkpoints.py`` at the root of the repository: that tool
reads the orbax steps with the JAX package and writes ``step_<n>.pt``
beside them through ``ics_tpu_torch.weights``.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Any, Optional

import torch

_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")
CONVERSION_TOOL = "convert_checkpoints.py"


class UnconvertedCheckpointError(FileNotFoundError):
    """The directory holds orbax steps of the JAX trainer and no checkpoint
    of the port: ``convert_checkpoints.py`` writes them."""

    def __init__(self, directory: Path, steps: list[int]):
        self.directory = directory
        self.steps = steps
        super().__init__(
            f"{directory} holds orbax steps {steps} of the JAX trainer and no step_<n>.pt; "
            f"convert them with `python {CONVERSION_TOOL} {directory}`")


def orbax_steps(directory: str | Path) -> list[int]:
    """The steps of the orbax checkpoints in ``directory`` (a subdirectory
    each, named by the step), oldest first."""
    directory = Path(directory)
    if not directory.is_dir():
        return []
    return sorted(int(p.name) for p in directory.iterdir() if p.is_dir() and p.name.isdigit())


class CheckpointManager:
    def __init__(self, directory: str | Path, max_to_keep: int = 3):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _path(self, step: int) -> Path:
        return self.directory / f"step_{step}.pt"

    def steps(self) -> list[int]:
        """The steps saved, oldest first."""
        return sorted(int(m.group(1)) for m in map(_STEP_FILE.match, os.listdir(self.directory))
                      if m)

    def save(self, step: int, state_dict: dict, opt_state: Any = None,
             metadata: Optional[dict] = None) -> None:
        """Write step ``step`` (tensors moved to the CPU), then drop the
        oldest steps past ``max_to_keep``. The file appears whole or not at
        all: it is written beside its name and renamed."""
        payload: dict = {"state_dict": {k: v.detach().cpu() for k, v in state_dict.items()}}
        if opt_state is not None:
            payload["opt_state"] = opt_state
        if metadata is not None:
            payload["metadata"] = metadata
        path = self._path(step)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        torch.save(payload, tmp)
        os.replace(tmp, path)
        for old in self.steps()[:-self.max_to_keep] if self.max_to_keep else ():
            self._path(old).unlink(missing_ok=True)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None) -> dict:
        """``{"state_dict": ..., ["opt_state": ...], ["metadata": ...]}`` of
        ``step`` (default: the latest), tensors on the CPU. Raises
        ``UnconvertedCheckpointError`` where that step is there only as an
        orbax checkpoint of the JAX trainer."""
        step = step if step is not None else self.latest_step()
        if step is None or not self._path(step).exists():
            orbax = orbax_steps(self.directory)
            if orbax and (step is None or step in orbax):
                raise UnconvertedCheckpointError(self.directory, orbax)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return torch.load(self._path(step), map_location="cpu", weights_only=True)

    def close(self) -> None:
        """Nothing is held open between calls; kept for the reference's interface."""
