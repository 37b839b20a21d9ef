"""Quick check: every reduced architecture runs train / prefill / decode.

    PYTHONPATH=src python -m repro_torch.examples.smoke_all [arch-id ...] \
        [--device cuda|cpu]

For each architecture (all of them by default) the reduced config, with
random weights from seed 1, runs ``train_loss`` (the forward only),
``prefill`` on B 2 x S 32 tokens (a vision prefix or audio frames where
the family has them), and one ``decode_step`` at position 32 of a fresh
64-slot cache. Losses and logits must be finite and the decode logits
of shape (2, 1, vocab). On the card every attention, scan and decode of
these calls runs its kernel, at the reduced configs' head dim of 32.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.models.model import build_model
from repro_torch.train import tree


def batch_for(cfg, device, B=2, S=32, seed=0):
    """Random tokens (B, S + 1) [+ patch embeds / frames], drawn from a
    ``torch.Generator`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    b = {"tokens": torch.randint(0, cfg.vocab_size, (B, S + 1),
                                 generator=gen, device=device)}
    if cfg.frontend == "vision":
        b["tokens"] = b["tokens"][:, : S - cfg.n_patches + 1]
        b["patch_embeds"] = torch.randn((B, cfg.n_patches, cfg.d_model),
                                        generator=gen, device=device,
                                        dtype=cfg.dtype)
    if cfg.frontend == "audio":
        b["frames"] = torch.randn((B, cfg.n_frames, cfg.d_model),
                                  generator=gen, device=device,
                                  dtype=cfg.dtype)
    return b


@torch.no_grad()
def run_arch(model, params, batch) -> dict:
    """``train_loss``, ``prefill`` of the batch without its last token,
    and ``decode_step`` of token 1 at position 32 of ``init_cache(2,
    64)``; asserts finite results and the decode logits' shape. Returns
    {"loss", "logits", "decode_logits"}."""
    cfg, name = model.cfg, model.cfg.name
    loss, _ = model.train_loss(params, batch)
    assert torch.isfinite(loss), f"{name}: train loss not finite"
    pre = dict(batch)
    pre["tokens"] = pre["tokens"][:, :-1]
    logits, _ = model.prefill(params, pre)
    assert torch.isfinite(logits.float()).all(), f"{name}: prefill logits"
    cache64 = model.init_cache(2, 64)
    tok = torch.ones((2, 1), dtype=torch.int32, device=model.device)
    pos = torch.tensor(32, dtype=torch.int32, device=model.device)
    lg, _ = model.decode_step(params, tok, cache64, pos)
    assert lg.shape == (2, 1, cfg.vocab_size), (name, tuple(lg.shape))
    assert torch.isfinite(lg.float()).all(), f"{name}: decode logits"
    return {"loss": loss, "logits": logits, "decode_logits": lg}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("archs", nargs="*", metavar="arch-id")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    for arch in args.archs or ARCH_IDS:
        t0 = time.time()
        cfg = get_config(arch).reduced()
        m = build_model(cfg, device=args.device)
        params = m.init(1)
        n = sum(t.numel() for t in tree.leaves(params))
        out = run_arch(m, params, batch_for(cfg, args.device))
        print(f"OK {arch:20s} params={n:>9,d} "
              f"loss={float(out['loss']):.3f} ({time.time()-t0:.1f}s)")


if __name__ == "__main__":
    main()
