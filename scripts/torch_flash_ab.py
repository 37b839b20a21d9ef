#!/usr/bin/env python3
"""Time the port's flash forward and backward, and the WKV6 and
selective-scan training and serving calls, in two checkouts on one card,
in turns.

    python3 scripts/torch_flash_ab.py OTHER_CHECKOUT [--rounds 2]
        [--only flash|scan]

OTHER_CHECKOUT is another tree of this repository (for instance the
parent commit unpacked with ``git archive``). Each round runs OTHER,
this checkout, this checkout, OTHER, each in its own process that builds
its own kernels, and prints the median CUDA-event time in ms (L2 flushed
and the card kept busy while the host enqueues: ``chip_smoke.time_ms``)
of the bf16 flash forward as serving calls it (no log-sum-exp), on the
model's (B, S, H, hd) views, at whisper-tiny's encoder (B 4, S = T =
1500, 6 / 6 heads of 64, non-causal), qwen2-vl-2b's prefill (B 4, S = T
= 320, 12 / 2 of 128) and qwen3-4b's (B 1, S = T = 300, 32 / 8 of 128),
and the flash backward (``backward.flash_attention_bwd`` on the
forward's out and lse, median of 20) in bf16 at qwen3-4b's train shape
(B 2, S = T = 1024, 32 / 8 heads of 128, causal) and whisper-tiny's
encoder (B 2, S = T = 1500, 6 / 6 of 64, non-causal), in f32 at the
train shape, in bf16 at hd 192 (B 1, S = T = 256, 12 / 4 heads) and at
nemotron-4-340b's attention (B 1, S = T = 4096, 96 / 8 heads of 192,
causal), each with the device time of each of its launches per call
(``torch.profiler``, ``*_launches``); then the scans, f32: the autograd
forward + backward pair (``ops.wkv`` / ``ops.selective_scan`` on inputs
that require grad, then ``torch.autograd.grad`` of the output, median of
20) at rwkv6-1.6b's train shape (B 2, T 1024, 32 heads of 64) and
hymba-1.5b's (B 2, T 1024, d_inner 3200, N 16), with the device time of
each launch of a pair (``*_pair_launches``), and the serving forward
(``kernel.wkv_scan`` / ``kernel.ssm_scan``, median of 50) at a 300-token
prefill (B 1) and at the train shape; then the card's name and power
limit. ``--only`` times one of the two groups. It needs one CUDA device;
both checkouts need ``chip_smoke.time_ms``, ``chip_smoke._frontend_qkv``,
``chip_smoke.bwd_inputs``, ``chip_smoke.wkv_bwd_case`` and
``chip_smoke.ssm_bwd_case``.
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
# (key, (B, Hq, Hkv, S, T, hd, causal), dtype): bf16 at the train shape
# and whisper's encoder, f32 at the train shape, bf16 at hd 192 and at
# nemotron's attention
TRAIN = (2, 32, 8, 1024, 1024, 128, True)
BWD_SHAPES = (("bwd_train", TRAIN, "bfloat16"),
              ("bwd_whisper_enc", (2, 6, 6, 1500, 1500, 64, False),
               "bfloat16"),
              ("bwd_train_f32", TRAIN, "float32"),
              ("bwd_hd192", (1, 12, 4, 256, 256, 192, True), "bfloat16"),
              ("bwd_nemotron", (1, 96, 8, 4096, 4096, 192, True),
               "bfloat16"))
# the scans: (key, shape); the train shapes, then a 300-token prefill
SCAN_TRAIN = (("wkv", (2, 1024, 32, 64)), ("ssm", (2, 1024, 3200, 16)))
SCAN_SERVE = (("wkv_t300", "wkv", (1, 300, 32, 64)),
              ("wkv_train", "wkv", (2, 1024, 32, 64)),
              ("ssm_t300", "ssm", (1, 300, 3200, 16)),
              ("ssm_train", "ssm", (2, 1024, 3200, 16)))


def launch_split(fn, calls=10):
    """Device ms per call of each kernel ``fn`` launches
    (``torch.profiler`` over ``calls`` calls)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            name = e.key.replace("(anonymous namespace)::", "") \
                .removeprefix("void ").split("(")[0]
            split[name] = split.get(name, 0.0) + \
                e.self_device_time_total / 1e3 / calls
    return split


def scans(chip_smoke, flush, out) -> None:
    """The scans' autograd pairs at the train shapes and serving forwards
    into ``out``."""
    import torch
    from repro_torch.kernels.rwkv_scan import kernel as wkv_kernel
    from repro_torch.kernels.rwkv_scan.ops import wkv
    from repro_torch.kernels.ssm_scan import kernel as ssm_kernel
    from repro_torch.kernels.ssm_scan.ops import selective_scan
    ops = {"wkv": (wkv, chip_smoke.wkv_bwd_case, wkv_kernel.wkv_scan),
           "ssm": (selective_scan, chip_smoke.ssm_bwd_case,
                   ssm_kernel.ssm_scan)}
    for key, shape in SCAN_TRAIN:
        op, case, _ = ops[key]
        args, cots = case(*shape, seed=11)
        leaves = [t.clone().requires_grad_(True) for t in args]
        pair = lambda: torch.autograd.grad(op(*leaves)[0], leaves, cots[0])
        out[f"{key}_pair"] = chip_smoke.time_ms(pair, flush, iters=20)
        out[f"{key}_pair_launches"] = launch_split(pair)
        del args, cots, leaves
    for key, which, shape in SCAN_SERVE:
        _, case, fwd = ops[which]
        args, _ = case(*shape, seed=12)
        with torch.no_grad():
            out[key] = chip_smoke.time_ms(lambda: fwd(*args), flush,
                                          iters=50)
        del args
    torch.cuda.empty_cache()


def child(root: Path, only: str | None) -> None:
    sys.path[:0] = [str(root), str(root / "src")]
    import torch

    import chip_smoke
    from repro_torch.kernels.flash_attention import backward, kernel
    from repro_torch.kernels.flash_attention.ops import attention_bshd
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32,
                        device="cuda")
    out = {}
    if only != "flash":
        scans(chip_smoke, flush, out)
    if only == "scan":
        print(json.dumps({"tree": str(root), **out}), flush=True)
        return
    for key, B, S, T, heads, causal in SHAPES:
        q, k, v = chip_smoke._frontend_qkv(B, S, T, heads, torch.bfloat16,
                                           seed=31)
        out[key] = chip_smoke.time_ms(
            lambda: attention_bshd(q, k, v, causal=causal), flush, iters=50)
    for key, (B, Hq, Hkv, S, T, hd, causal), dtype in BWD_SHAPES:
        q, k, v, do = chip_smoke.bwd_inputs(B, Hq, Hkv, S, T, hd,
                                            getattr(torch, dtype), seed=9)
        o, lse = kernel.flash_attention(q, k, v, causal=causal,
                                        with_lse=True)
        out[key] = chip_smoke.time_ms(
            lambda: backward.flash_attention_bwd(q, k, v, o, lse, do,
                                                 causal=causal),
            flush, iters=20)
        out[f"{key}_launches"] = launch_split(
            lambda: backward.flash_attention_bwd(q, k, v, o, lse, do,
                                                 causal=causal))
    print(json.dumps({"tree": str(root), **out}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", nargs="?")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--only", choices=("flash", "scan"))
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(Path(args.child).resolve(), args.only)
        return 0
    if not args.other:
        ap.error("name the other checkout")
    other = Path(args.other).resolve()
    for _ in range(args.rounds):
        for tree in (other, ROOT, ROOT, other):
            r = subprocess.run([sys.executable, __file__, "--child",
                                str(tree), *(["--only", args.only]
                                             if args.only else [])],
                               capture_output=True, text=True, timeout=900)
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
