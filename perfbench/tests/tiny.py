"""A benchmark tree of tiny cells, written to a temporary directory, that
the harness runs on the CPU through the plain path: it holds only new
files (a configuration, a traffic mix, a per-layer metric and the cells'
limits), as a later change adding a cell would."""
from __future__ import annotations

import json
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

DENSE = {
    "name": "tiny-dense", "source": "tests", "published": {},
    "reduced": {}, "arch": "deepseek-7b",
    "run": {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
            "head_dim": 16, "d_ff": 128, "vocab_size": 256,
            "act": "swiglu", "rope": "rope", "rope_theta": 10000.0,
            "norm_eps": 1e-6, "tie_embeddings": False, "dtype": "float32"},
}
MOE = {
    "name": "tiny-moe", "source": "tests", "published": {},
    "reduced": {}, "arch": "grok-1-314b",
    "run": {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
            "head_dim": 16, "d_ff": 96, "moe_d_ff": 96, "n_experts": 4,
            "top_k": 2, "capacity_factor": 2.0, "vocab_size": 256,
            "act": "geglu", "rope": "rope", "rope_theta": 10000.0,
            "norm_eps": 1e-5, "tie_embeddings": False, "dtype": "float32"},
}
OPEN = {
    "loop": "open", "rate_rps": 12.0, "preroll_s": 0.2, "grace_s": 120,
    "prompt": {"dist": "loguniform", "min": 8, "max": 40},
    "output": {"dist": "uniform", "min": 2, "max": 6},
    "engine": {"slots": 4, "max_seq": 64, "block_size": 8,
               "pool_tokens": 512, "prefill_chunk": 0,
               "prefill_budget": 96},
    "check": {"served_tokens": 24},
}
CLOSED = {
    "loop": "closed", "clients": 4, "preroll_s": 0.2,
    "prompt": {"dist": "uniform", "min": 4, "max": 24},
    "output": {"dist": "uniform", "min": 2, "max": 6},
    "engine": {"slots": 4, "max_seq": 48, "block_size": 8,
               "pool_tokens": 384},
    "check": {"served_tokens": 24},
}
# f32 on the CPU: the program and the reference agree to rounding
LIMIT = {"served_gap_max": {"limit": 1e-3},
         "served_disagree_share": {"limit": 0.0}}

READER = '''"""Tokens a slice-free run delivered: a metric added as a file."""


def read(run):
    n = sum(len(r.times) for r in run.records)
    return float(n) if n else None
'''


def make(root: Path, chips: int = 1) -> Path:
    """The tree: the real harness's BENCHMARK.json keys, tiny cells."""
    root = Path(root)
    pb = root / "perfbench"
    for sub in ("configs", "traffic", "metrics", "checks"):
        (pb / sub).mkdir(parents=True, exist_ok=True)
    cells = [("tiny-dense-open", DENSE, "tiny-open"),
             ("tiny-moe-closed", MOE, "tiny-closed"),
             ("tiny-moe-open", MOE, "tiny-open")]
    for conf in (DENSE, MOE):
        (pb / "configs" / f"{conf['name']}.json").write_text(
            json.dumps(conf))
    (pb / "traffic" / "tiny-open.json").write_text(json.dumps(OPEN))
    (pb / "traffic" / "tiny-closed.json").write_text(json.dumps(CLOSED))
    (pb / "metrics" / "tokens_seen.py").write_text(READER)
    for name, _, _ in cells:
        (pb / "checks" / f"{name}.json").write_text(json.dumps(LIMIT))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": c["name"], "source": "tests",
                         "file": f"perfbench/configs/{c['name']}.json",
                         "reduced": [], "why": "tests"}
                        for c in (DENSE, MOE)]
    bench["workloads"] = [{"name": n, "config": c["name"], "traffic": t,
                           "chips": chips, "why": "tests"}
                          for n, c, t in cells]
    for m in bench["end_to_end"]:
        m.pop("workloads", None)
    bench["end_to_end"] = [m for m in bench["end_to_end"]
                           if m["name"] in ("itl_p95_ms", "setup_s")]
    bench["per_layer"] = [{"name": "tokens_seen", "unit": "tokens",
                           "better": "higher", "source": "host_clock",
                           "layer": "tests", "moves": "itl_p95_ms"}]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root

