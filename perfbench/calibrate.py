"""Readings that set a cell's correctness limits, and show them fail what
they must: the cell at a short window on each of many seeds, in one
process, printing per seed the program's numbers, the fp8 control's
(``perfbench/correct.py``) and the harness's verdict on each under the
cell's limits (``correct``, ``control_correct``). With ``--fault`` a
fault of ``perfbench/faults.py`` is planted under the timed path first,
and the control is not read.

    python3 perfbench/calibrate.py --workload <cell> --seconds <s> \
        --seeds 1,2,3 [--fault token_altered|state_unchanged]
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1] / "src"),
                str(Path(__file__).resolve().parents[1])]

from perfbench import run as bench_run  # noqa: E402


def main() -> int:
    bench_run._environment()
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--fault", default=None)
    a = ap.parse_args()
    from perfbench import faults, harness
    if a.fault:
        faults.FAULTS[a.fault](setattr)
    for seed in [int(x) for x in a.seeds.split(",")]:
        res = harness.run_cell(bench_run.ROOT, a.workload, seed, a.seconds,
                               False, control=not a.fault)
        row = {"seed": seed, "fault": a.fault, "correct": res["correct"],
               "control_correct": res.get("control_correct"),
               **res["readings"],
               "metrics": {k: v["value"] for k, v in res["metrics"].items()},
               "attempted": res["attempted"], "failed": res["failed"],
               "memory_peak_bytes": res["device"]["memory_peak_bytes"],
               "pool_high_water_blocks": res["pool_high_water_blocks"]}
        print("CALIB " + json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
