"""The knee sweep of an open-loop cell: the cell at each of a few rates,
each in its own window, reporting its tails and whether the backlog
(requests due and not yet in a slot) grew through the window.

    python3 perfbench/sweep.py --workload <cell> --seed <n> --seconds <s> \
        --rates 4,5,6,7,8,9

The knee is the highest rate whose backlog does not grow: the mean over
the window's last third is no more than one request above that over its
first third.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1] / "src"),
                str(Path(__file__).resolve().parents[1])]

from perfbench import run as bench_run  # noqa: E402


def growth(backlog, seconds):
    a = [n for t, n in backlog if 0 <= t < seconds / 3]
    b = [n for t, n in backlog if 2 * seconds / 3 <= t < seconds]
    return (statistics.mean(a) if a else 0.0), (statistics.mean(b) if b
                                                else 0.0)


def main() -> int:
    bench_run._environment()
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    a = ap.parse_args()
    from perfbench import harness
    for rate in [float(x) for x in a.rates.split(",")]:
        res = harness.run_cell(bench_run.ROOT, a.workload, a.seed, a.seconds,
                               False, overrides={"rate_rps": rate},
                               judge=False)
        first, last = growth(res["backlog"], a.seconds)
        row = {"rate_rps": rate, "backlog_first_third": first,
               "backlog_last_third": last,
               "sustained": last <= first + 1.0,
               "metrics": {k: v["value"] for k, v in res["metrics"].items()},
               "attempted": res["attempted"], "failed": res["failed"],
               "notes": res["notes"]}
        print("SWEEP " + json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
