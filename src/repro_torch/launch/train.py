"""Training launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \
        [--steps 30] [--batch 8] [--seq 128] [--full] [--lr 1e-3] \
        [--ckpt-root checkpoints] [--device cuda|cpu]

Trains the family-preserving reduced config of the architecture (f32,
vocab 4096) on the packed synthetic CV corpus, from random weights drawn
with seed 0; ``--full`` keeps the full-size config. It runs on the card
unless ``--device cpu`` is given, and exits non-zero on a non-finite
loss. One device only: ``--mesh-shape`` raises until the sharding rules
are ported (ROADMAP Queue 1, item 4).
"""
from __future__ import annotations

import argparse
import dataclasses
import math

import torch

from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.models.model import build_model
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.data import DataConfig, PackedLMDataset
from repro_torch.train.train_loop import TrainerConfig, train


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true",
                    help="full-size config")
    ap.add_argument("--mesh-shape", default="",
                    help="e.g. 4,2 -> (data=4, model=2); not ported yet")
    ap.add_argument("--ckpt-root", default="checkpoints")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args()

    if args.mesh_shape:
        raise NotImplementedError(
            f"--mesh-shape {args.mesh_shape}: meshes need the sharding "
            f"rules (ROADMAP Queue 1, item 4); the port trains on one "
            f"device")
    cfg = get_config(args.arch)
    if not args.full:
        cfg = dataclasses.replace(cfg.reduced(), dtype=torch.float32,
                                  vocab_size=4096)
    model = build_model(cfg, device=args.device)

    print(f"training {args.arch} ({cfg.family}) on 1 device(s); "
          f"mesh=None")

    data = PackedLMDataset(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=args.seq,
                                      batch_size=args.batch,
                                      n_documents=2048))
    tc = TrainerConfig(
        n_steps=args.steps, log_every=max(args.steps // 10, 1),
        ckpt_root=args.ckpt_root, ckpt_name=args.arch,
        opt=opt_mod.AdamWConfig(lr=args.lr, warmup_steps=10,
                                total_steps=args.steps))
    res = train(model, data, tc)
    for h in res.history:
        print(f"  step {h['step']:4d} loss {h['loss']:.4f}")
    losses = [h["loss"] for h in res.history]
    print(f"{res.steps_per_s:.2f} steps/s; loss {losses[0]:.3f} -> "
          f"{losses[-1]:.3f}; checkpoint: {args.ckpt_root}/{args.arch}-final")
    if not math.isfinite(losses[-1]):
        raise SystemExit("non-finite loss")


if __name__ == "__main__":
    main()
