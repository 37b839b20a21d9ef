"""One rank of ``tests/test_torch_multirank.py``: gloo ranks on the CPU.

    python tests/_torch_multirank_worker.py SUITE RANK WORLD STORE IN OUT

joins a world of WORLD ranks through the file store STORE, builds the
suite's ``DeviceMesh``, waits for the inputs pickled in IN (numpy trees
and arrays, which the test writes while the ranks start), runs every
check of SUITE on them and saves this rank's
results (numpy arrays and plain values) to OUT. It imports the port
only; the test holds the results against the reference.
"""
from __future__ import annotations

import dataclasses
import datetime
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from torch.distributed.device_mesh import init_device_mesh  # noqa: E402

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serve.service import make_lm_service  # noqa: E402
from repro_torch.sharding.rules import DTensor, ParallelPlan  # noqa: E402
from repro_torch.train import optimizer as opt_mod, tree  # noqa: E402
from repro_torch.train.train_loop import make_train_step  # noqa: E402
from repro_torch.weights import params_from_numpy  # noqa: E402


def _np(t):
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().float().numpy()


def _cfg(spec):
    """(name, overrides) -> the port's reduced config."""
    name, over = spec
    return dataclasses.replace(get_config(name).reduced(), **over)


# ------------------------------------------------------------------ (2, 4)
def moe_checks(mesh, inp) -> dict:
    """moe_ffn's EP / TP bodies under a train plan (the config's capacity
    and capacity 8), and moe_decode_ffn with weight_fsdp=("data",)."""
    out = {}
    for key, case in inp["moe"].items():
        cfg = _cfg(case["cfg"])
        p = {k: torch.from_numpy(v) for k, v in case["params"].items()}
        for cf in (cfg.capacity_factor, 8.0):
            c = dataclasses.replace(cfg, capacity_factor=cf)
            plan = ParallelPlan.make(mesh, c, "train")
            x = torch.from_numpy(inp["x_train"])
            y, aux = moe.moe_ffn(x, p, c, plan)
            tag = "cfg" if cf == cfg.capacity_factor else "cf8"
            out[f"{key}/train/{tag}"] = _np(y)
            out[f"{key}/aux/{tag}"] = float(aux)
            out[f"{key}/mode"] = plan.moe_mode
        c = dataclasses.replace(cfg, capacity_factor=8.0)
        plan = dataclasses.replace(ParallelPlan.make(mesh, c, "decode"),
                                   weight_fsdp=("data",))
        y, _ = moe.moe_ffn(torch.from_numpy(inp["x_decode"]), p, c, plan)
        out[f"{key}/decode"] = _np(y)
    return out


def _stripes(model, params, prompts, capacity):
    """A stripe cache holding each row's prompt, from a plan-free prefill."""
    B, P = prompts.shape
    _, pref = model.prefill(params, {"tokens": torch.from_numpy(prompts)})
    cache = model.init_cache(B, capacity)
    for key, leaf in cache.items():
        row = pref[key]
        leaf[tuple(slice(0, n) for n in row.shape)] = row
    return cache


def decode_checks(mesh, inp) -> dict:
    """Decode steps under a decode plan with the cache placed by
    cache_spec, from prompts prefilled without a plan."""
    out = {}
    for key, case in inp["decode"].items():
        cfg = _cfg(case["cfg"])
        model = build_model(cfg, device="cpu")
        params = params_from_numpy(case["params"], cfg, "cpu")
        plan = ParallelPlan.make(mesh, cfg, "decode")
        prompts, steps = case["prompts"], case["tokens"]
        cache = _stripes(model, params, prompts, case["capacity"])
        placed = plan.input_shardings({"cache": cache})["cache"]
        out[f"{key}/placements"] = {k: str(v.placements)
                                    for k, v in placed.items()}
        logits = []
        with torch.no_grad():
            for j, tok in enumerate(steps):
                n = torch.full((prompts.shape[0],), prompts.shape[1] + j,
                               dtype=torch.int32)
                lg, _ = model.decode_step(params, torch.from_numpy(tok),
                                          placed, n, plan=plan)
                logits.append(_np(lg))
        out[f"{key}/logits"] = np.stack(logits)
    return out


# ------------------------------------------------------------------ (2, 2)
def train_checks(mesh, inp) -> dict:
    """Two AdamW steps under a train plan (DTensor params and state,
    batches placed by batch_spec) against the same steps without one."""
    out = {}
    # the train launcher's optimizer settings
    oc = opt_mod.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=2)
    for key, case in inp["train"].items():
        cfg = _cfg(case["cfg"])
        model = build_model(cfg, device="cpu")
        runs = {}
        # no plan; a plan with the batch placed by batch_spec; a plan with
        # the batch whole on every rank (the MoE body splits the rows)
        for run in ("none", "plan", "whole"):
            plan = ParallelPlan.make(None if run == "none" else mesh, cfg,
                                     "train")
            params = params_from_numpy(case["params"], cfg, "cpu")
            params = plan.param_shardings(params)
            state = opt_mod.init_state(params)
            step = make_train_step(model, oc, plan)
            losses = []
            for b in case["batches"]:
                batch = {"tokens": torch.from_numpy(b)}
                if run == "plan":
                    batch = plan.input_shardings(batch)
                params, state, m = step(params, state, batch)
                losses.append(float(m["loss"]))
            runs[run] = (losses, [_np(p) for p in tree.leaves(params)],
                         [_np(v) for v in tree.leaves(state["mu"])])
        for run in ("plan", "whole"):
            tag = key if run == "plan" else f"{key}/whole"
            out[f"{tag}/losses"] = runs["none"][0], runs[run][0]
            out[f"{tag}/param_err"] = max(
                float(np.abs(a - b).max()) for a, b in zip(runs["none"][1],
                                                           runs[run][1]))
            out[f"{tag}/param_max"] = max(float(np.abs(a).max())
                                          for a in runs["none"][1])
            out[f"{tag}/mu_err"] = max(
                float(np.abs(a - b).max()) for a, b in zip(runs["none"][2],
                                                           runs[run][2]))
            out[f"{tag}/mu_max"] = max(float(np.abs(a).max())
                                       for a in runs["none"][2])
    return out


def service_checks(mesh, inp) -> dict:
    """make_lm_service under a decode plan against one without: the same
    payloads, served in the same order on every rank."""
    case = inp["service"]
    cfg = _cfg(case["cfg"])
    model = build_model(cfg, device="cpu")
    params = params_from_numpy(case["params"], cfg, "cpu")
    out = {}
    for name, plan in (("plain", None),
                       ("plan", ParallelPlan.make(mesh, cfg, "decode"))):
        for paged in (True, False):
            svc = make_lm_service(f"lm-{name}-{paged}", model, params,
                                  batch_size=2, max_seq=48, paged=paged,
                                  plan=plan, device="cpu")
            out[f"{name}/{paged}"] = [
                svc.replicas[0].handler(dict(p))["tokens"]
                for p in case["payloads"]]
    return out


SUITES = {"2x4": ((2, 4), (moe_checks, decode_checks)),
          "2x2": ((2, 2), (train_checks, service_checks))}


def main() -> None:
    suite, rank, world, store, inp, out = sys.argv[1:]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=int(rank), world_size=int(world),
                            timeout=datetime.timedelta(seconds=90))
    try:
        shape, checks = SUITES[suite]
        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))
        deadline = time.monotonic() + 90
        while not Path(inp).exists():     # the test writes it after the
            if time.monotonic() > deadline:   # ranks start
                raise TimeoutError(f"no input {inp}")
            time.sleep(0.05)
        data = torch.load(inp, weights_only=False)
        res = {"rank": int(rank), "coords": [mesh.get_local_rank(a)
                                             for a in ("data", "model")]}
        for check in checks:
            t0 = time.perf_counter()
            res.update(check(mesh, data))
            res[f"seconds/{check.__name__}"] = time.perf_counter() - t0
        torch.save(res, out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
