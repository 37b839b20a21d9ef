"""Training loop: an AdamW step over ``Model.train_loss`` and its
gradient, metric logging, periodic chunked checkpointing, deterministic
resume (port of the reference's ``train/train_loop.py``).

The step runs eagerly on the params' device: on the card, attention goes
through the flash kernel and its backward kernel. Metrics stay on the
device until a log step reads them.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from repro_torch.train import checkpoint, optimizer as opt_mod, tree
from repro_torch.train.data import PackedLMDataset, sharded_batches


@dataclass
class TrainerConfig:
    n_steps: int = 100
    log_every: int = 10
    ckpt_every: int = 0          # 0 = only at the end
    ckpt_root: str = "checkpoints"
    ckpt_name: str = "run"
    opt: opt_mod.AdamWConfig = field(default_factory=opt_mod.AdamWConfig)


def make_train_step(model, oc: opt_mod.AdamWConfig):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss and its gradient over every param leaf
    (``torch.autograd.grad``; a leaf the loss does not reach gets zeros,
    as ``jax.grad`` gives), then :func:`optimizer.apply_updates`, which
    updates params and state in place. Metrics ({"loss", "xent", "aux",
    "grad_norm", "lr"}) are detached device scalars."""
    def train_step(params, opt_state, batch):
        leaves = tree.leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            with torch.enable_grad():
                loss, metrics = model.train_loss(params, batch)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        params, opt_state, om = opt_mod.apply_updates(
            params, tree.unflatten(params, grads), opt_state, oc)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(om)
        metrics["loss"] = loss.detach()
        return params, opt_state, metrics

    return train_step


@dataclass
class TrainResult:
    params: object
    opt_state: object
    history: list
    steps_per_s: float


def train(model, dataset: PackedLMDataset, tc: TrainerConfig, *,
          params=None, opt_state=None, start_step: int = 0,
          seed: int = 0) -> TrainResult:
    """``tc.n_steps`` steps from ``start_step`` on ``model.device``.

    ``params`` default to ``model.init(seed)``; given, they are updated in
    place. ``opt_state`` defaults to a fresh state, as the reference's
    ``train`` always starts one; passing a previous run's state resumes
    it exactly. Returns params and state with ``requires_grad`` off (what
    the engine can serve), the history of the log steps and the steps a
    second, timed up to a device synchronise. Checkpoints ``{"params"}``
    every ``ckpt_every`` steps and at the end, as ``<name>-<step>`` and
    ``<name>-final``."""
    if params is None:
        params = model.init(seed)
    if opt_state is None:
        opt_state = opt_mod.init_state(params)
    step_fn = make_train_step(model, tc.opt)
    device = model.device

    history = []
    t0 = time.perf_counter()
    step = start_step
    for batch in sharded_batches(dataset, None, tc.n_steps, start_step,
                                 device=device):
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        step += 1
        if tc.log_every and (step % tc.log_every == 0
                             or step == start_step + 1):
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            history.append(m)
        if tc.ckpt_every and step % tc.ckpt_every == 0:
            checkpoint.save(tc.ckpt_root, f"{tc.ckpt_name}-{step}",
                            {"params": params}, metadata={"step": step})
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    checkpoint.save(tc.ckpt_root, f"{tc.ckpt_name}-final",
                    {"params": params}, metadata={"step": step})
    return TrainResult(params, opt_state, history,
                       (step - start_step) / max(dt, 1e-9))
