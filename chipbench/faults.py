"""Faults planted under a classify cell's timed path, to show that
``correct`` comes out false when the program serves wrong answers. Each is
an ``on_service`` hook of ``chipbench.run.run_cell``:

- ``half_batch``: each decode step is handed its batch with the second half
  of the rows' coefficients zeroed, so those requests are answered for a
  blank image (half of the batch left out);
- ``answer_altered``: each decode step's answers come back with the first
  class moved to the next class index (an answer altered where it is
  produced).

A one-card classify cell has no step state and no exchange between chips,
so those faults do not apply.
"""

from __future__ import annotations

import numpy as np


def half_batch(service) -> None:
    engine = service.engine
    dispatch = engine.predict_coeff_staged_async

    def broken(staged, mode="420", record=True):
        n = staged["y"].shape[0]
        staged = {k: v.copy() for k, v in staged.items()}
        for key in ("y", "cb", "cr"):
            staged[key][n // 2:] = 0
        return dispatch(staged, mode, record)

    engine.predict_coeff_staged_async = broken


def answer_altered(service) -> None:
    engine = service.engine
    dispatch = engine.predict_coeff_staged_async

    def broken(staged, mode="420", record=True):
        resolve = dispatch(staged, mode, record)

        def altered():
            idx, scores = resolve()
            idx = np.array(idx, copy=True)
            idx[:, 0] = (idx[:, 0] + 1) % engine.num_classes
            return idx, scores
        return altered

    engine.predict_coeff_staged_async = broken


FAULTS = {"half_batch": half_batch, "answer_altered": answer_altered}
