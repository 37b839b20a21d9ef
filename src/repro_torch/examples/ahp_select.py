"""AHP substrate selection: the paper's Tables 3/4/5 from its published
Table 2 data.

    PYTHONPATH=src python -m repro_torch.examples.ahp_select

The reference's example then re-runs the methodology live against three
in-process executor backends (``benchmarks/bench_framework.py``). That
re-run is a benchmark driver, so it is ported with the benchmark, not
here; this module prints the paper's tables only.
"""
from __future__ import annotations

import argparse

from repro_torch.core.ahp import PAPER_RESULTS, reproduce_paper_tables


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="accepted as every example accepts it; the "
                         "tables are host arithmetic")
    ap.parse_args(argv)
    print("== Paper data -> Tables 3/4/5 ==")
    for scenario, res in reproduce_paper_tables().items():
        paper = {k: f"{v*100:.1f}%"
                 for k, v in PAPER_RESULTS[scenario].items()}
        print(f"\n-- {scenario} (paper: {paper})")
        print(res.table())
        print(f"consistency ratios: "
              f"{ {k: round(v, 4) for k, v in res.consistency.items()} }")


if __name__ == "__main__":
    main()
