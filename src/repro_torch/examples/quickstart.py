"""Quickstart — the three layers of the framework in about a minute.

    PYTHONPATH=src python -m repro_torch.examples.quickstart \
        [--arch qwen3-4b] [--device cuda|cpu]

1. AHP substrate selection (the paper's §3.1 / §4.1) on the paper's data.
2. One CV parsed end-to-end through the parallel PaaS pipeline (§4.2).
3. One train loss and one prefill of an architecture (reduced config)
   through the model zoo the serving layer deploys.
"""
from __future__ import annotations

import argparse
import random

import torch

from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.core import cvdata
from repro_torch.core.ahp import reproduce_paper_tables
from repro_torch.core.pipeline import CVParser
from repro_torch.models.model import build_model
from repro_torch.train import tree


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b", choices=ARCH_IDS)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = args.device

    # 1 ---------------------------------------------------------------- AHP
    print("== 1. AHP framework selection (paper Tables 3-5) ==")
    for scenario, res in reproduce_paper_tables().items():
        (best, score), *_ = res.ranking()
        print(f"  {scenario:32s} -> {best} ({score*100:.1f}%)")

    # 2 ----------------------------------------------------------- pipeline
    print("\n== 2. CV-parser pipeline (parallel PaaS fan-out) ==")
    parser = CVParser.create(0, device=device)
    doc = cvdata.make_document(random.Random(42))
    out = parser.parse(doc)
    for svc, fields in out["fields"].items():
        print(f"  {svc:22s} {len(fields):2d} entities "
              f"({out['dispatch'].per_call_s[svc]*1e3:.1f} ms)")
    t = out["timings"]
    print(f"  stages: tika={t['tika']*1e3:.1f}ms "
          f"bert={t['bert']*1e3:.1f}ms sect={t['sectioning']*1e3:.1f}ms "
          f"services={t['parallel_services']*1e3:.1f}ms "
          f"total={t['total']*1e3:.1f}ms")
    parser.dispatcher.shutdown()

    # 3 ------------------------------------------------------------- model
    print(f"\n== 3. Model zoo: {args.arch} (reduced) ==")
    cfg = get_config(args.arch).reduced()
    model = build_model(cfg, device=device)
    params = model.init(1)
    n = sum(x.numel() for x in tree.leaves(params))
    B, S = 2, 32
    gen = torch.Generator(device=device).manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen,
                           device=device)
    batch = {"tokens": tokens}
    if cfg.frontend == "vision":
        batch["patch_embeds"] = torch.zeros((B, cfg.n_patches, cfg.d_model),
                                            dtype=cfg.dtype, device=device)
    if cfg.frontend == "audio":
        batch["frames"] = torch.zeros((B, cfg.n_frames, cfg.d_model),
                                      dtype=cfg.dtype, device=device)
    with torch.no_grad():
        loss, metrics = model.train_loss(params, batch)
        print(f"  {n/1e6:.2f}M params | train loss {float(loss):.3f} | "
              f"metrics: {sorted(metrics)}")
        logits, cache = model.prefill(
            params, {k: (v[:, :-1] if k == "tokens" else v)
                     for k, v in batch.items()})
    print(f"  prefill logits {tuple(logits.shape)} | cache leaves: "
          f"{len(tree.leaves(cache))}")
    print("\nOK — see repro_torch.examples.serve_parallel_pipeline for the "
          "end-to-end serving driver.")


if __name__ == "__main__":
    main()
