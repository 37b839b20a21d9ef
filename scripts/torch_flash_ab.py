#!/usr/bin/env python3
"""Time the port's flash forward in two checkouts on one card, in turns.

    python3 scripts/torch_flash_ab.py OTHER_CHECKOUT [--rounds 2]

OTHER_CHECKOUT is another tree of this repository (for instance the
parent commit unpacked with ``git archive``). Each round runs OTHER,
this checkout, this checkout, OTHER, each in its own process that builds
its own kernels, and prints the median CUDA-event time in ms (L2 flushed
and the card kept busy while the host enqueues: ``chip_smoke.time_ms``)
of the bf16 flash forward as serving calls it (no log-sum-exp), on the
model's (B, S, H, hd) views, at whisper-tiny's encoder (B 4, S = T =
1500, 6 / 6 heads of 64, non-causal), qwen2-vl-2b's prefill (B 4, S = T
= 320, 12 / 2 of 128) and qwen3-4b's (B 1, S = T = 300, 32 / 8 of 128),
then the card's name and power limit. It needs one CUDA device; both
checkouts need ``chip_smoke.time_ms`` and ``chip_smoke._frontend_qkv``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (key, B, S, T, (Hq, Hkv, hd), causal)
SHAPES = (("whisper_enc", 4, 1500, 1500, (6, 6, 64), False),
          ("qwen2vl_prefill", 4, 320, 320, (12, 2, 128), True),
          ("qwen3_prefill", 1, 300, 300, (32, 8, 128), True))


def child(root: Path) -> None:
    sys.path[:0] = [str(root), str(root / "src")]
    import torch

    import chip_smoke
    from repro_torch.kernels.flash_attention.ops import attention_bshd
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32,
                        device="cuda")
    out = {}
    for key, B, S, T, heads, causal in SHAPES:
        q, k, v = chip_smoke._frontend_qkv(B, S, T, heads, torch.bfloat16,
                                           seed=31)
        out[key] = chip_smoke.time_ms(
            lambda: attention_bshd(q, k, v, causal=causal), flush, iters=50)
    print(json.dumps({"tree": str(root), **out}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", nargs="?")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(Path(args.child).resolve())
        return 0
    if not args.other:
        ap.error("name the other checkout")
    other = Path(args.other).resolve()
    for _ in range(args.rounds):
        for tree in (other, ROOT, ROOT, other):
            r = subprocess.run([sys.executable, __file__, "--child",
                                str(tree)], capture_output=True, text=True,
                               timeout=900)
            if r.returncode:
                print(r.stdout + r.stderr, file=sys.stderr)
                return r.returncode
            print(r.stdout.strip().splitlines()[-1], flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
