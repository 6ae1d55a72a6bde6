#!/usr/bin/env python3
"""Convert the JAX trainer's checkpoints (orbax) into the PyTorch port's.

The port (``ics_tpu_torch``) serves a trained version from ``step_<n>.pt``
files in the version's ``dir_checkpoint``; the JAX package's trainer writes
orbax steps there, which the port does not read (it imports no orbax). This
tool reads each orbax step with the JAX package's ``CheckpointManager``,
maps its variables tree with ``ics_tpu_torch.weights.from_jax_variables``
and writes ``step_<n>.pt`` beside it with the port's ``CheckpointManager``.
The orbax steps stay; a step that has its ``.pt`` already is left as it is.
The optimizer state is not converted: optax's state has no counterpart in
``torch.optim``, and serving needs the weights alone.

Usage, from the root of a checkout (needs both packages' dependencies, JAX
and orbax among them)::

    python convert_checkpoints.py DIR [DIR ...]
    python convert_checkpoints.py --database-url sqlite:///./image_classification.db

With ``--database-url`` (default: the port's ``DATABASE_URL`` setting when
no directory is given), every ``modelos_treinados`` row's ``dir_checkpoint``
is converted. Prints one line per step written; exits 1 when a directory
has neither orbax steps nor the port's checkpoints.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Optional

import numpy as np


def convert_directory(directory: str | Path) -> list[int]:
    """Write ``step_<n>.pt`` for every orbax step of ``directory`` that has
    none; returns the steps written. Raises FileNotFoundError when the
    directory holds neither kind of checkpoint."""
    import jax

    from ics_tpu.train.checkpoint import CheckpointManager as OrbaxManager
    from ics_tpu_torch.train.checkpoint import CheckpointManager, orbax_steps
    from ics_tpu_torch.weights import from_jax_variables

    directory = Path(directory)
    if not directory.is_dir():
        raise FileNotFoundError(f"no such directory: {directory}")
    steps = orbax_steps(directory)
    port = CheckpointManager(directory, max_to_keep=0)   # 0: keep every step
    if not steps and not port.steps():
        raise FileNotFoundError(f"no checkpoints in {directory}")
    todo = [s for s in steps if s not in set(port.steps())]
    if not todo:
        return []
    orbax = OrbaxManager(directory)
    try:
        for step in todo:
            restored = orbax.restore(step)
            variables = jax.tree_util.tree_map(np.asarray, restored["variables"])
            # plain Python values (orbax gives numpy scalars back), which
            # torch.load(weights_only=True) reads
            metadata = jax.tree_util.tree_map(lambda v: np.asarray(v).tolist(),
                                              restored.get("metadata"))
            port.save(step, from_jax_variables(variables), metadata=metadata)
    finally:
        orbax.close()
    return todo


def trained_directories(database_url: str) -> list[str]:
    """``dir_checkpoint`` of every ``modelos_treinados`` row."""
    from ics_tpu_torch.db.engine import Database

    db = Database(database_url)
    with db.session() as s:
        rows = s.fetchall("SELECT dir_checkpoint FROM modelos_treinados ORDER BY id_mod")
    return [r["dir_checkpoint"] for r in rows if r["dir_checkpoint"]]


def main(argv: Optional[list[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("directories", nargs="*", help="checkpoint directories to convert")
    parser.add_argument("--database-url", help="convert every modelos_treinados row of it")
    args = parser.parse_args(argv)
    directories = list(args.directories)
    if args.database_url or not directories:
        from ics_tpu_torch.core.config import settings

        directories += trained_directories(args.database_url or settings.DATABASE_URL)
    failed = 0
    for directory in dict.fromkeys(directories):
        try:
            written = convert_directory(directory)
        except FileNotFoundError as exc:
            print(f"{directory}: {exc}", file=sys.stderr)
            failed += 1
            continue
        for step in written:
            print(f"{directory}: step {step} -> step_{step}.pt")
        if not written:
            print(f"{directory}: nothing to convert")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
