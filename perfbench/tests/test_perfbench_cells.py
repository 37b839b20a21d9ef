"""The harness end to end on the CPU, through the program's plain path, at
tiny sizes: cells, configurations, traffic mixes and a per-layer metric
added as new files only; the comparison that decides ``correct`` failing
on the faults a served cell can have and on the fp8 control; a cell on
two ranks under a process group (gloo)."""
import argparse
import json

import pytest
import torch

from perfbench import faults, harness, run
from perfbench.tests import tiny

SEED = 2**31 + 4242



@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these many small CPU ops: beside the other
    test workers, a pool a core wide spends its time waiting on itself."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", ["tiny-dense-open", "tiny-moe-closed"])
def test_a_cell_added_as_files_runs(root, cell):
    res = harness.run_cell(root, cell, SEED, 1.0, False, device="cpu")
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"itl_p95_ms", "setup_s"}
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert res["failed"] == 0
    if cell.endswith("open"):
        # every request due in the window is counted, however fast the
        # host: the mix's rate times the window
        assert res["attempted"] == round(tiny.OPEN["rate_rps"] * 1.0)


def test_a_metric_added_as_a_file_is_read(root):
    res = harness.run_cell(root, "tiny-dense-open", SEED, 1.0, True,
                           device="cpu")
    assert res["correct"]
    assert set(res["metrics"]) == {"tokens_seen"}
    assert res["metrics"]["tokens_seen"]["value"] > 0


# open loop: every request due in the window is followed to its end, so
# the sample holds whole outputs however fast the host runs
@pytest.mark.parametrize("cell", ["tiny-dense-open", "tiny-moe-open"])
@pytest.mark.parametrize("fault", ["token_altered", "state_unchanged"])
def test_faults_of_the_timed_path_are_not_correct(root, monkeypatch, fault,
                                                  cell):
    faults.FAULTS[fault](monkeypatch.setattr)
    res = harness.run_cell(root, cell, SEED, 1.0, False, device="cpu")
    assert not res["correct"]
    assert res["checks"]["served_gap_max"]["value"] > 1e-3


def test_the_fp8_control_fails_where_bf16_passes(tmp_path, monkeypatch):
    """At a tiny bf16 cell comparing 96 served tokens (the CPU's readings
    over seeds 1-8: the program's widest gap at most 0.027 and its
    disagreeing share at most 0.041, the control's at least 0.278 and
    0.144), limits of 0.09 and 0.08 pass the program and fail the control
    on every seed: the harness's own verdict on the control is false."""
    dense = {**tiny.DENSE, "run": {**tiny.DENSE["run"],
                                   "dtype": "bfloat16"}}
    monkeypatch.setattr(tiny, "DENSE", dense)
    monkeypatch.setattr(tiny, "OPEN", {
        **tiny.OPEN, "rate_rps": 10.0,
        "output": {"dist": "uniform", "min": 12, "max": 20},
        "check": {"served_tokens": 96}})
    r = tiny.make(tmp_path)
    (r / "perfbench/checks/tiny-dense-open.json").write_text(
        json.dumps({"served_gap_max": {"limit": 0.09},
                    "served_disagree_share": {"limit": 0.08}}))
    for seed in (1, 2):
        res = harness.run_cell(r, "tiny-dense-open", seed, 1.0, False,
                               device="cpu", control=True)
        assert res["correct"]
        assert res["control_correct"] is False
        assert res["readings"]["control_gap_max"] > 0.09
        assert res["readings"]["control_disagree_share"] > 0.08


def test_a_number_without_a_limit_is_not_compared(tmp_path):
    """A number whose limit is null is read but not compared; a cell that
    compares no number is not correct."""
    r = tiny.make(tmp_path)
    checks = r / "perfbench/checks/tiny-dense-open.json"
    checks.write_text(json.dumps({"served_gap_max": {"limit": None},
                                  "served_disagree_share": {"limit": 0.0}}))
    res = harness.run_cell(r, "tiny-dense-open", SEED, 1.0, False,
                           device="cpu")
    assert res["correct"]
    assert set(res["checks"]) == {"served_disagree_share", "failed"}
    assert "served_gap_max" in res["readings"]
    checks.write_text(json.dumps({"served_gap_max": {"limit": None}}))
    res = harness.run_cell(r, "tiny-dense-open", SEED, 1.0, False,
                           device="cpu")
    assert not res["correct"]


def test_two_ranks_under_a_process_group(tmp_path):
    r = tiny.make(tmp_path, chips=2)
    args = argparse.Namespace(workload="tiny-dense-open", seed=SEED,
                              seconds=1.0, trace=0, root=r,
                              t_start=None)
    res = run.run_ranks(args, 2, "cpu")
    assert res["correct"] and res["device"]["count"] == 2
    assert res["attempted"] > 0 and res["failed"] == 0


def test_no_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "grok1-decode", "--seed", "1",
                     "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_without_the_program_no_result(tmp_path):
    """A checkout holding only BENCHMARK.json and the benchmark's folder
    (no ``src/``): the run fails before it prints a result. The look for
    a card is stubbed to find one, so the failure is the program's
    absence."""
    import os
    import shutil
    import subprocess
    import sys
    shutil.copy(tiny.REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(tiny.REPO / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    stub = ("import runpy, sys, torch; "
            "torch.cuda.is_available = lambda: True; "
            "torch.cuda.device_count = lambda: 1; "
            "sys.argv = ['perfbench/run.py', '--workload', 'grok1-decode', "
            "'--seed', '1', '--seconds', '1']; "
            "runpy.run_path('perfbench/run.py', run_name='__main__')")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", stub], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "repro_torch" in out.stderr
