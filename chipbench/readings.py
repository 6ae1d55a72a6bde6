"""The readings that a cell's correctness limits are set from, in one
process: the program's numbers over a dozen seeds or more, the control's
(the reference in float8) on the same images, and each planted fault's
(``chipbench.faults``). Not part of a benchmark run.

    python3 chipbench/readings.py --workload <cell> --seconds 5 --seeds 1 2 3 ... \\
        [--faults-on 3]

Prints one JSON line a run: the cell, the seed, the fault (or null), the
program's verdict and checks, and on the runs without a fault the
control's verdict and checks, judged by the same limits.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from chipbench import faults, manifest, run  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, default=5.0)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--faults-on", type=int, default=3,
                        help="plant each fault on this many of the seeds")
    args = parser.parse_args(argv)
    bench = manifest.benchmark()
    cell = manifest.cell(args.workload, bench)
    config = manifest.config(cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    limits = manifest.limits(cell["name"])
    plans = [(seed, None) for seed in args.seeds]
    plans += [(seed, f) for f in faults.FAULTS for seed in args.seeds[:args.faults_on]]
    for seed, fault in plans:
        hook = faults.FAULTS[fault] if fault else None
        result = run.run_cell(cell, config, traffic, limits, bench, seed, args.seconds, False,
                              on_service=hook, control=fault is None, record=True)
        line = {"cell": cell["name"], "seed": seed, "fault": fault,
                "correct": result["correct"], "metrics": result["metrics"],
                "checks": {k: v["value"] for k, v in result["checks"].items()}}
        if "control" in result:
            line["control_correct"] = result["control"]["correct"]
            line["control"] = {k: v["value"] for k, v in result["control"]["checks"].items()}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
