"""Train a small LM end-to-end on the synthetic CV corpus, then resume it.

    PYTHONPATH=src python -m repro_torch.examples.train_small \
        [--arch qwen3-4b] [--steps 150] [--d-model 256] [--layers 4] \
        [--batch 8] [--seq 128] [--device cuda|cpu]

Uses the full substrate: config -> model factory -> packed data pipeline
-> AdamW + warmup-cosine + clipping -> train step -> chunked (GridFS-
style) checkpointing -> resume. The model is the architecture's family at
reduced width, f32, random weights from seed 0 (``torch.Generator`` on
the device). On the card attention and the scans train through their
forward and backward kernels. Loss must drop more than 20 % or the
script exits 1.
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile

import torch

from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.models.model import build_model
from repro_torch.train import checkpoint, optimizer as opt_mod, tree
from repro_torch.train.data import DataConfig, PackedLMDataset
from repro_torch.train.train_loop import TrainerConfig, train


def trainer_config(steps: int, ckroot: str) -> TrainerConfig:
    return TrainerConfig(
        n_steps=steps, log_every=max(steps // 10, 1),
        ckpt_every=steps // 2, ckpt_root=ckroot,
        opt=opt_mod.AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=steps,
                                weight_decay=0.01))


def train_and_resume(model, data, tc: TrainerConfig, *, params=None):
    """``train`` for ``tc.n_steps``, then the checkpoint of step
    ``tc.n_steps // 2`` restored onto the run's device and 5 more steps
    from there (a fresh optimizer state, as the reference's resume has).
    The reference's example takes the first checkpoint name in sorted
    order, which at 150 steps is ``run-150``, not ``run-75``; this one
    names the mid-run step. ``params`` default to ``model.init(0)``.
    Returns (first run, resumed run, the checkpoint's name)."""
    res = train(model, data, tc, params=params)
    mid = f"{tc.ckpt_name}-{tc.n_steps // 2}"
    if mid not in checkpoint.list_checkpoints(tc.ckpt_root):
        raise FileNotFoundError(f"no checkpoint {mid} in {tc.ckpt_root}")
    restored = checkpoint.restore(tc.ckpt_root, mid,
                                  like={"params": res.params})
    res2 = train(model, data, dataclasses.replace(tc, n_steps=5,
                                                  log_every=1),
                 params=restored["params"], start_step=tc.n_steps // 2)
    return res, res2, mid


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced()
    cfg = dataclasses.replace(cfg, n_layers=args.layers,
                              d_model=args.d_model,
                              vocab_size=4096, dtype=torch.float32)
    model = build_model(cfg, device=args.device)
    n = sum(t.numel() for t in tree.leaves(model.init(0)))
    print(f"arch={args.arch} ({cfg.family}) {n/1e6:.1f}M params, "
          f"{args.steps} steps @ batch {args.batch} x seq {args.seq}")

    data = PackedLMDataset(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=args.seq,
                                      batch_size=args.batch,
                                      n_documents=2048))
    print(f"packed corpus: {data.n_tokens():,} tokens")

    with tempfile.TemporaryDirectory() as ckroot:
        res, res2, mid = train_and_resume(
            model, data, trainer_config(args.steps, ckroot))
        first, last = res.history[0]["loss"], res.history[-1]["loss"]
        for h in res.history:
            print(f"  step {h['step']:4d} loss {h['loss']:.4f} "
                  f"lr {h.get('lr', 0):.2e} gnorm {h.get('grad_norm', 0):.2f}")
        print(f"{res.steps_per_s:.2f} steps/s | loss {first:.3f} -> "
              f"{last:.3f} ({(1 - last/first)*100:.1f}% drop)")
        print(f"resumed {mid}: 5 more steps, "
              f"loss {res2.history[-1]['loss']:.4f}")

    if not last < 0.8 * first:
        raise SystemExit(f"loss did not drop enough: {first} -> {last}")
    print("OK")


if __name__ == "__main__":
    main()
