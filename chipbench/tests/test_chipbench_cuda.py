"""On the card, at each cell's own size: the control (the reference in
float8 e4m3, the precision below the configured bf16) fails the cell's
limits on three seeds, and each planted fault makes the run incorrect.
Skips where there is no CUDA card.

    python -m pytest chipbench/tests/test_chipbench_cuda.py -q -p no:cacheprovider
"""

from __future__ import annotations

import pytest

from chipbench import faults, manifest, run

BENCH = manifest.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
SEEDS = (2026101801, 2026101802, 2026101803)
SECONDS = 3.0

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def _run(cell_name, seed, device, hook=None, control=False):
    cell = manifest.cell(cell_name, BENCH)
    return run.run_cell(cell, manifest.config(cell["config"]), manifest.traffic(cell["traffic"]),
                        manifest.limits(cell_name), BENCH, seed, SECONDS, False, device=device,
                        on_service=hook, control=control)


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_limits(cell, card):
    for seed in SEEDS:
        result = _run(cell, seed, card, control=True)
        assert result["correct"], result["checks"]
        assert not result["control"]["correct"], result["control"]["checks"]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_makes_the_run_incorrect(cell, fault, card):
    assert not _run(cell, SEEDS[0], card, hook=faults.FAULTS[fault])["correct"]
