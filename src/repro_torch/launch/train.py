"""Training launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \
        [--steps 30] [--batch 8] [--seq 128] [--full] [--lr 1e-3] \
        [--ckpt-root checkpoints] [--device cuda|cpu] \
        [--mesh-shape 2,2 [--init-method URL]]

Trains the family-preserving reduced config of the architecture (f32,
vocab 4096) on the packed synthetic CV corpus, from random weights drawn
with seed 0; ``--full`` keeps the full-size config. It runs on the card
unless ``--device cpu`` is given, and exits non-zero on a non-finite
loss.

``--mesh-shape`` trains under a ``ParallelPlan`` on a ``DeviceMesh`` of
that shape ((model), (data, model) or (pod, data, model)). Under
``torchrun`` the rank and world come from the environment
(``torchrun --nproc-per-node 4 -m repro_torch.launch.train --mesh-shape
2,2``); without it the launcher is rank 0 of a world of one, which
takes ``--mesh-shape 1,1``. Each rank uses card ``LOCAL_RANK``.
The ranks join over NCCL on the card, over gloo with ``--device cpu``.
Rank 0 prints.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.models.model import build_model
from repro_torch.sharding.rules import ParallelPlan
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.data import DataConfig, PackedLMDataset
from repro_torch.train.train_loop import TrainerConfig, train


def make_mesh(shape_str: str, device: str):
    """The reference's axis names for a mesh shape string, or None."""
    if not shape_str:
        return None
    dims = tuple(int(x) for x in shape_str.split(","))
    names = ("data", "model")[-len(dims):] if len(dims) <= 2 else \
        ("pod", "data", "model")
    return init_device_mesh(device, dims, mesh_dim_names=names)


def _init_ranks(args, backend: str) -> None:
    """Join the default process group: torchrun's environment, or rank 0
    of a world of one."""
    rank = int(os.environ.get("RANK", 0))
    world = int(os.environ.get("WORLD_SIZE", 1))
    init = args.init_method or ("env://" if "MASTER_ADDR" in os.environ
                                else None)
    if init is None:      # a lone process: a store in its own memory
        store = dist.HashStore()
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world)
    else:
        dist.init_process_group(backend, init_method=init, rank=rank,
                                world_size=world)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true",
                    help="full-size config")
    ap.add_argument("--mesh-shape", default="",
                    help="e.g. 4,2 -> (data=4, model=2)")
    ap.add_argument("--init-method", default=None,
                    help="rendezvous URL (default: torchrun's env://)")
    ap.add_argument("--ckpt-root", default="checkpoints")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if not args.full:
        cfg = dataclasses.replace(cfg.reduced(), dtype=torch.float32,
                                  vocab_size=4096)
    device = args.device
    mesh = None
    if args.mesh_shape:
        dev_type = torch.device(device).type
        _init_ranks(args, "nccl" if dev_type == "cuda" else "gloo")
        if dev_type == "cuda":
            device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
            torch.cuda.set_device(device)
        n = math.prod(int(x) for x in args.mesh_shape.split(","))
        world = dist.get_world_size()
        if n != world:
            dist.destroy_process_group()
            raise SystemExit(f"--mesh-shape {args.mesh_shape} needs {n} "
                             f"ranks; this world has {world} (start it "
                             f"under torchrun --nproc-per-node {n})")
        mesh = make_mesh(args.mesh_shape, dev_type)
    try:
        _run(args, cfg, device, mesh)
    finally:
        if mesh is not None:
            dist.destroy_process_group()


def _run(args, cfg, device, mesh) -> None:
    plan = ParallelPlan.make(mesh, cfg, "train")
    model = build_model(cfg, device=device)
    lead = mesh is None or dist.get_rank() == 0
    n_dev = mesh.size() if mesh is not None else 1
    shape = None if mesh is None else \
        dict(zip(mesh.mesh_dim_names, mesh.shape))
    if lead:
        print(f"training {args.arch} ({cfg.family}) on {n_dev} device(s); "
              f"mesh={shape}")

    data = PackedLMDataset(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=args.seq,
                                      batch_size=args.batch,
                                      n_documents=2048))
    tc = TrainerConfig(
        n_steps=args.steps, log_every=max(args.steps // 10, 1),
        ckpt_root=args.ckpt_root, ckpt_name=args.arch,
        opt=opt_mod.AdamWConfig(lr=args.lr, warmup_steps=10,
                                total_steps=args.steps))
    res = train(model, data, tc, plan=plan)
    losses = [h["loss"] for h in res.history]
    if lead:
        for h in res.history:
            print(f"  step {h['step']:4d} loss {h['loss']:.4f}")
        print(f"{res.steps_per_s:.2f} steps/s; loss {losses[0]:.3f} -> "
              f"{losses[-1]:.3f}; checkpoint: "
              f"{args.ckpt_root}/{args.arch}-final")
    if not math.isfinite(losses[-1]):
        raise SystemExit("non-finite loss")


if __name__ == "__main__":
    main()
