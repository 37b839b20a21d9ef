#!/usr/bin/env python3
"""The port's sharded path across cards: NCCL ranks, one a GPU.

    python scripts/torch_multirank_card.py [--ranks 4] [--cpu]

starts ``--ranks`` processes (rank r on card r) on a (data 2, model
ranks / 2) ``DeviceMesh`` and holds each planned call against the same
call without a plan on the same card, the reference being out of reach
there (``tests/test_torch_multirank.py`` holds the gloo ranks to the JAX
package on the CPU):

* ``moe_ffn`` (reduced kimi-k2 in EP, reduced grok-1 with 3 experts in
  TP; capacity 8, so no token is dropped) under a train plan, and
  ``moe_decode_ffn`` under a decode plan with ``weight_fsdp=("data",)``,
  against ``moe_ffn_local`` on the whole batch;
* decode steps with the stripe cache placed by ``cache_spec``: reduced
  qwen3-4b at B 2 and B 1, reduced hymba-1.5b with its window cut to 8,
  reduced rwkv6-1.6b, and full-width qwen3-4b at 2 layers, all f32
  (greedy tokens identical too);
* two AdamW steps of reduced qwen3-4b (remat) under a train plan with
  DTensor params.

Each rank prints one JSON line of its largest differences; the script
then prints the card's name and power limit and one JSON summary, and
exits non-zero if a difference passes its bound. ``--cpu`` runs the same
checks on gloo ranks on the CPU (the full-width model cut to d 256).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BOUNDS = {"moe": 2e-4, "decode": 1e-4, "tokens_differ": 0,
          "train_loss_rel": 1e-5, "train_mu_rel": 1e-5}


def rank_main(rank: int, world: int, store: str, cpu: bool) -> dict:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.base import get_config
    from repro_torch.models import moe
    from repro_torch.models.model import build_model
    from repro_torch.sharding.rules import DTensor, ParallelPlan
    from repro_torch.train import optimizer as opt_mod, tree
    from repro_torch.train.train_loop import make_train_step

    if cpu:
        torch.set_num_threads(1)
        dev = torch.device("cpu")
    else:
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
        dev = torch.device("cuda", rank)
    dist.init_process_group("gloo" if cpu else "nccl",
                            init_method=f"file://{store}", rank=rank,
                            world_size=world)
    mesh = init_device_mesh(dev.type, (2, world // 2),
                            mesh_dim_names=("data", "model"))
    out = {}

    def full(t):
        return (t.full_tensor() if isinstance(t, DTensor) else t).float()

    # ---- MoE bodies
    g = torch.Generator(device=dev).manual_seed(1)
    for key, name, over in (("kimi-ep", "kimi-k2-1t-a32b", {}),
                            ("grok-tp", "grok-1-314b", {"n_experts": 3})):
        cfg = dataclasses.replace(get_config(name).reduced(),
                                  capacity_factor=8.0, **over)
        p = moe.init_moe(torch.Generator(device=dev).manual_seed(0), cfg,
                         dev)
        for kind, shape in (("train", (4, 16, cfg.d_model)),
                            ("decode", (4, 1, cfg.d_model))):
            x = torch.randn(shape, generator=g, device=dev)
            plan = ParallelPlan.make(mesh, cfg, kind)
            out[f"moe/{key}/mode"] = plan.moe_mode
            if kind == "decode":
                plan = dataclasses.replace(plan, weight_fsdp=("data",))
            with torch.no_grad():
                y, _ = moe.moe_ffn(x, p, cfg, plan)
                want, _ = moe.moe_ffn_local(x.reshape(-1, cfg.d_model), p,
                                            cfg)
            out[f"moe/{key}/{kind}"] = float(
                (y - want.reshape(shape)).abs().max())

    # ---- decode with caches placed by cache_spec
    def decode(cfg, B, P, n, T):
        model = build_model(cfg, device=dev)
        params = model.init(0)
        prompts = torch.randint(2, cfg.vocab_size, (B, P),
                                generator=torch.Generator().manual_seed(2))
        prompts = prompts.to(dev)
        res = {}
        for planned in (False, True):
            plan = ParallelPlan.make(mesh, cfg, "decode") if planned \
                else None
            with torch.no_grad():
                logits, pref = model.prefill(params, {"tokens": prompts})
                cache = model.init_cache(B, T)
                for k, leaf in cache.items():
                    leaf[tuple(slice(0, m) for m in pref[k].shape)] = pref[k]
                if planned:
                    cache = plan.input_shardings({"cache": cache})["cache"]
                tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
                lg, toks = [], []
                for j in range(n):
                    nv = torch.full((B,), P + j, dtype=torch.int32,
                                    device=dev)
                    step, _ = model.decode_step(params, tok, cache, nv,
                                                plan=plan)
                    tok = step[:, -1].argmax(-1, keepdim=True).to(
                        torch.int32)
                    lg.append(step[:, -1].float())
                    toks.append(tok[:, 0].tolist())
            res[planned] = torch.stack(lg), toks
        return (float((res[True][0] - res[False][0]).abs().max()),
                res[True][1] == res[False][1])

    for key, name, over, B, P, n in (
            ("qwen-b2", "qwen3-4b", {}, 2, 12, 6),
            ("qwen-b1", "qwen3-4b", {}, 1, 12, 6),
            ("hymba-w8", "hymba-1.5b", {"sliding_window": 8}, 2, 10, 8),
            ("rwkv", "rwkv6-1.6b", {}, 2, 6, 4)):
        cfg = dataclasses.replace(get_config(name).reduced(), **over)
        out[f"decode/{key}"], _ = decode(cfg, B, P, n, 64)
    cfg = dataclasses.replace(get_config("qwen3-4b"), n_layers=2,
                              dtype=torch.float32)
    if cpu:
        cfg = dataclasses.replace(cfg, d_model=256, d_ff=512)
    out["decode/qwen3-4b-full"], same = decode(cfg, 4, 100, 8, 1024)
    out["tokens_differ/qwen3-4b-full"] = int(not same)

    # ---- train steps
    cfg = dataclasses.replace(get_config("qwen3-4b").reduced(), remat=True)
    model = build_model(cfg, device=dev)
    oc = opt_mod.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=2)
    batches = [torch.randint(2, cfg.vocab_size, (4, 33),
                             generator=torch.Generator().manual_seed(3 + i))
               .to(dev) for i in range(2)]
    runs = {}
    for planned in (False, True):
        plan = ParallelPlan.make(mesh if planned else None, cfg, "train")
        params = plan.param_shardings(model.init(0))
        state = opt_mod.init_state(params)
        step = make_train_step(model, oc, plan)
        losses = []
        for b in batches:
            params, state, m = step(params, state,
                                    plan.input_shardings({"tokens": b}))
            losses.append(float(m["loss"]))
        runs[planned] = losses, [full(v) for v in tree.leaves(state["mu"])]
    out["train/loss_rel"] = max(abs(a - b) / abs(a) for a, b in
                                zip(runs[False][0], runs[True][0]))
    out["train/mu_rel"] = max(float((a - b).abs().max()) for a, b in
                              zip(runs[False][1], runs[True][1])) / max(
        float(a.abs().max()) for a in runs[False][1])
    dist.destroy_process_group()
    return out


def check(res: dict) -> list:
    """(key, value, bound) of each difference past its bound, and of an
    MoE call that did not take the mode its name says."""
    bad = []
    for k, v in res.items():
        if k.endswith("/mode"):
            if v != k.split("/")[1].split("-")[1]:
                bad.append((k, v, "mode"))
            continue
        bound = BOUNDS[k.split("/")[0]] if not k.startswith("train/") \
            else BOUNDS[k.replace("train/", "train_")]
        if v > bound:
            bad.append((k, v, bound))
    return bad


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--store", default=None)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.rank is not None:
        print(json.dumps(rank_main(args.rank, args.ranks, args.store,
                                   args.cpu)))
        return 0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        store = f"{tmp}/store"
        procs = [subprocess.Popen([sys.executable, __file__, "--ranks",
                                   str(args.ranks), "--rank", str(r),
                                   "--store", store]
                                  + (["--cpu"] if args.cpu else []),
                                  stdout=subprocess.PIPE, text=True)
                 for r in range(args.ranks)]
        try:
            outs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
    if any(p.returncode for p in procs):
        print("a rank failed:", [p.returncode for p in procs])
        return 1
    results = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    worst = {k: max(r[k] for r in results) if not k.endswith("/mode")
             else results[0][k] for k in results[0]}
    card = "cpu" if args.cpu else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()
    print(f"{args.ranks} ranks, mesh (data 2, model {args.ranks // 2}), "
          f"{time.perf_counter() - t0:.1f} s; cards: {card}")
    print(json.dumps({"largest_over_ranks": worst, "bounds": BOUNDS}))
    bad = check(worst)
    if bad:
        print("over bound:", bad)
        return 1
    print("ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
