#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no result line is printed then):

1. Environment: the card's name and power limit, torch / CUDA versions.
   Without a GPU it stops here.
2. Build: every CUDA source of the port, with nvcc, into ``build/``.
3. Kernel vs plain version on the card: ``paged_window_attention`` at
   the full qwen3-4b head shape (Hq 32, Hkv 8, hd 128, bs 16, B 8) for
   S in {1, 4, 64}, ragged base lengths, one sliding window, f32
   (atol = rtol = 1e-4) and bf16 (3e-2); poisoning scratch block 0
   changes no output bit.
4. Serve at full width: qwen3-4b (36 layers, bf16, random weights from a
   seeded generator) behind ``ServingEngine(batch_size=8, max_seq=1024,
   use_kernel=True)``, 8 greedy requests. The kernel must launch once per
   layer per decode / chunk step, and the pool must drain clean. The
   same serve then runs again under ``torch.profiler``: device busy time,
   idle share and the top kernels.
5. Kernel path vs plain path at full width in f32 (4 layers): identical
   token streams, logprobs within 1e-3.

Then the kernel's times (CUDA events, L2 flushed between launches,
median of 30) at the decode shape of phase 4 beside its plain version,
``scaled_dot_product_attention`` on the gathered KV (a yardstick only;
the port never calls it) and the bound from bytes and flops. TF32 is off
for every f32 comparison.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
HQ, HKV, HD, BS, B, MAX_BLOCKS = 32, 8, 128, 16, 8, 64
SEED = 0


def phase(name):
    print(f"\n=== {name}", flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


# ------------------------------------------------------------ kernel cases
def window_case(S, dtype, bases, *, seed=0, device="cuda"):
    """q / pool / table / base for B rows at the given base lengths: each
    row owns distinct random blocks covering base + S tokens; table tails
    point at scratch block 0."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    nb = B * MAX_BLOCKS + 1
    q = torch.randn((B, S, HQ, HD), generator=g).to(device, dtype)
    pk = torch.randn((nb, BS, HKV, HD), generator=g).to(device, dtype)
    pv = torch.randn((nb, BS, HKV, HD), generator=g).to(device, dtype)
    free = (torch.randperm(nb - 1, generator=g) + 1).tolist()
    table = torch.zeros((B, MAX_BLOCKS), dtype=torch.int32)
    for b, base in enumerate(bases):
        for i in range(-(-(base + S) // BS)):
            table[b, i] = free.pop()
    return (q, pk, pv, table.to(device),
            torch.tensor(bases, dtype=torch.int32, device=device))


def ragged_bases(S):
    """Base lengths incl. 0, block boundaries and near-full rows."""
    T = MAX_BLOCKS * BS
    return [0, BS - 1, BS, 2 * BS + 7, 127, 300, T // 2 - 1, T - S]


def check_kernel_vs_plain(window_attn):
    worst = 0.0
    cases = [(S, dt, 0) for S in (1, 4, 64)
             for dt in (torch.float32, torch.bfloat16)]
    cases.append((4, torch.bfloat16, 24))
    for S, dt, win in cases:
        args = window_case(S, dt, ragged_bases(S), seed=S)
        out, lse = window_attn(*args, sliding_window=win)
        ro, rl = window_attn(*args, sliding_window=win, force_ref=True)
        torch.cuda.synchronize()
        err_o = (out.float() - ro.float()).abs().max().item()
        err_l = (lse - rl).abs().max().item()
        print(f"S={S:3d} {str(dt):15s} window={win:3d}: max|out-plain| "
              f"{err_o:.3e}  max|lse-plain| {err_l:.3e}  (tol {TOL[dt]})")
        torch.testing.assert_close(out.float(), ro.float(), atol=TOL[dt],
                                   rtol=TOL[dt])
        torch.testing.assert_close(lse, rl, atol=TOL[dt], rtol=TOL[dt])
        worst = max(worst, err_o, err_l)
    q, pk, pv, table, base = window_case(4, torch.float32, ragged_bases(4),
                                         seed=7)
    out, lse = window_attn(q, pk, pv, table, base)
    pk[0], pv[0] = 1e9, -1e9
    out2, lse2 = window_attn(q, pk, pv, table, base)
    torch.cuda.synchronize()
    if not (torch.equal(out, out2) and torch.equal(lse, lse2)):
        raise AssertionError("poisoning scratch block 0 changed the output")
    print("scratch block 0 poisoned with +-1e9: outputs bitwise unchanged")
    return worst


# ---------------------------------------------------------------- serving
def make_requests(Request, vocab):
    """8 greedy requests: mixed lengths, one ~300-token prompt (chunk
    windows of S = 64 through the kernel), and two sharing a 64-token
    prefix — the shorter one ends inside the longer one's fourth block,
    so its first write copies that shared block (copy-on-write)."""
    g = torch.Generator().manual_seed(SEED + 1)

    def toks(n):
        return torch.randint(2, vocab, (n,), generator=g).tolist()

    prefix = toks(64)
    prompts = [toks(300), prefix + toks(10), list(prefix), toks(5),
               toks(17), toks(33), toks(120), toks(250)]
    return [Request(rid=i, prompt=p, max_new_tokens=16)
            for i, p in enumerate(prompts)]


def serve(cfg, params, model, ServingEngine, Request, use_kernel):
    eng = ServingEngine(model, params, batch_size=8, max_seq=1024,
                        use_kernel=use_kernel)
    reqs = make_requests(Request, cfg.vocab_size)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run(list(reqs))
    torch.cuda.synchronize()
    return eng, reqs, done, time.perf_counter() - t0


def check_outputs(reqs, done, vocab):
    if len(done) != len(reqs):
        raise AssertionError(f"{len(done)} of {len(reqs)} requests finished")
    for r in reqs:
        if len(r.out_tokens) != r.max_new_tokens:
            raise AssertionError(f"request {r.rid}: {len(r.out_tokens)} "
                                 f"tokens")
        if not all(0 <= t < vocab for t in r.out_tokens):
            raise AssertionError(f"request {r.rid}: token out of vocab")
        if not all(math.isfinite(x) and x <= 0 for x in r.out_logprobs):
            raise AssertionError(f"request {r.rid}: bad logprobs "
                                 f"{r.out_logprobs}")


def profile_serve(cfg, params, model, ServingEngine, Request):
    """Where the time of the phase-4 serve goes: the same requests again
    under torch.profiler (its overhead included), device time summed
    over kernels against the wall time, and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng, _, _, wall = serve(cfg, params, model, ServingEngine, Request,
                                use_kernel=True)
    # device-side events only (kernels, copies): the CPU ops that launch
    # them carry the same time again
    rows = sorted(((e.self_device_time_total, e) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda r: -r[0])
    busy_ms = sum(t for t, _ in rows) / 1e3
    steps = eng.metrics["decode_steps"]
    if not rows:
        print("profiler recorded no device time: breakdown not measured")
        return
    print(f"profiled serve: wall {wall * 1e3:.1f} ms over {steps} steps, "
          f"device busy {busy_ms:.1f} ms (idle share "
          f"{1 - busy_ms / (wall * 1e3):.3f}), {len(prof.events())} events")
    for t, e in rows[:8]:
        print(f"  {t / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:90]}")


# ----------------------------------------------------------------- timing
def time_ms(fn, flush, iters=30, warmup=5):
    """Median device time of ``fn`` in ms (CUDA events), with the L2
    cache flushed before every launch as the serving caller finds it."""
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def sdpa_on_gathered(q, pk, pv, table, base):
    """Gather the rows' KV (outside the timed call) and return a closure
    running one SDPA call with the causal-in-window mask."""
    F = torch.nn.functional
    Bq, S = q.shape[:2]
    T = table.shape[1] * BS
    gk = pk[table.long()].reshape(Bq, T, HKV, HD).transpose(1, 2)
    gv = pv[table.long()].reshape(Bq, T, HKV, HD).transpose(1, 2)
    qt = q.transpose(1, 2)
    i = base.long()[:, None] + torch.arange(S, device=q.device)[None]
    mask = torch.arange(T, device=q.device)[None, None] <= i[:, :, None]
    mask = mask[:, None]                                  # (B,1,S,T)
    return lambda: F.scaled_dot_product_attention(qt, gk, gv,
                                                  attn_mask=mask,
                                                  enable_gqa=True)


def bound(q, base, S, dtype):
    """Least time for the work this input needs: the K/V bytes of every
    visible cached token read once, q read once, out / lse written once;
    flops 2 * 2 * hd per (query head, visible key) pair."""
    es = q.element_size()
    vis = [min(int(b) + S, MAX_BLOCKS * BS) for b in base.tolist()]
    kv_bytes = sum(vis) * HKV * HD * 2 * es
    io_bytes = 2 * q.numel() * es + q.numel() // HD * 4 \
        + B * (MAX_BLOCKS + 1) * 4
    pairs = sum(sum(min(b + w + 1, MAX_BLOCKS * BS) for w in range(S))
                for b in base.tolist()) * HQ
    flops = 4 * HD * pairs
    t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    phase("1. environment")
    print("torch", torch.__version__, "cuda", torch.version.cuda,
          "cuda available:", torch.cuda.is_available())
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke needs one GPU", file=sys.stderr)
        return 1
    card = gpu_line()
    print("card:", card, "| devices:", torch.cuda.device_count())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.paged_attention import kernel as pw_kernel
    from repro_torch.kernels.paged_attention.ops import paged_window_attention
    from repro_torch.kernels.paged_attention.ref import (
        paged_window_attention_ref)
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import Request, ServingEngine

    phase("2. build")
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"built {len(libs)} CUDA source(s) in "
          f"{time.perf_counter() - t0:.1f} s")
    for src in libs:
        log = _build.BUILD_DIR / f"{src.stem}.log"
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print("  ptxas:", line.strip())

    phase("3. kernel vs plain version on the card (TF32 off)")
    max_err = check_kernel_vs_plain(paged_window_attention)

    phase("4. serve full-width qwen3-4b, bf16, use_kernel=True")
    cfg = get_config("qwen3-4b")
    model = build_model(cfg, device="cuda")
    t0 = time.perf_counter()
    params = model.init(SEED)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"{n_params / 1e9:.3f} B params, "
          f"{sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9:.2f}"
          f" GB, init {time.perf_counter() - t0:.1f} s")
    pw_kernel.paged_window_attention.launches = 0
    eng, reqs, done, wall = serve(cfg, params, model, ServingEngine, Request,
                                  use_kernel=True)
    launches = pw_kernel.paged_window_attention.launches
    check_outputs(reqs, done, cfg.vocab_size)
    m = eng.metrics
    print("metrics:", json.dumps(m))
    print("pool:", json.dumps(eng.pool_stats()))
    n_tok = sum(len(r.out_tokens) for r in reqs)
    lat = sorted(r.latency_s for r in reqs)
    print(f"{n_tok} tokens in {wall:.3f} s: {n_tok / wall:.1f} tok/s; "
          f"latency p50 {statistics.median(lat):.3f} s, max {lat[-1]:.3f} s")
    print(f"kernel launches {launches} = {cfg.n_layers} layers x "
          f"{m['decode_steps']} decode/chunk steps")
    if launches <= 0 or launches != cfg.n_layers * m["decode_steps"]:
        raise AssertionError(f"launches {launches} != {cfg.n_layers} x "
                             f"{m['decode_steps']}")
    if m["chunk_steps"] == 0 or m["shared_admissions"] == 0 \
            or m["cow_copies"] == 0:
        raise AssertionError("chunk windows, prefix sharing and "
                             "copy-on-write must all have run")
    stats = eng.pool_stats()
    if stats["used"] or stats["available"] != stats["total"] \
            or stats["logical_blocks"]:
        raise AssertionError(f"pool did not drain: {stats}")
    decode_bases = [len(r.prompt) + len(r.out_tokens) - 1 for r in reqs]
    profile_serve(cfg, params, model, ServingEngine, Request)
    del eng, params, model
    torch.cuda.empty_cache()

    phase("5. kernel path vs plain path, full width, f32, 4 layers")
    cfg32 = replace(cfg, n_layers=4, dtype=torch.float32)
    model32 = build_model(cfg32, device="cuda")
    params32 = model32.init(SEED)
    _, rk, dk, wk = serve(cfg32, params32, model32, ServingEngine, Request,
                          use_kernel=True)
    _, rp, dp, wp = serve(cfg32, params32, model32, ServingEngine, Request,
                          use_kernel=False)
    check_outputs(rk, dk, cfg32.vocab_size)
    check_outputs(rp, dp, cfg32.vocab_size)
    lp_err = 0.0
    for a, b in zip(rk, rp):
        if a.out_tokens != b.out_tokens:
            raise AssertionError(f"request {a.rid}: kernel {a.out_tokens} "
                                 f"!= plain {b.out_tokens}")
        lp_err = max(lp_err, max(abs(x - y) for x, y in
                                 zip(a.out_logprobs, b.out_logprobs)))
    print(f"token streams identical; max |logprob diff| {lp_err:.3e} "
          f"(tol 1e-3); kernel run {wk:.3f} s, plain run {wp:.3f} s")
    if lp_err > 1e-3:
        raise AssertionError(f"logprobs differ by {lp_err}")
    del params32, model32
    torch.cuda.empty_cache()

    phase("timing at the decode shape of phase 4 (bf16, S = 1)")
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32,
                        device="cuda")
    timings = {}
    for S, bases in ((1, decode_bases), (64, [0, 64, 128, 192, 64, 0, 0,
                                              128])):
        args = window_case(S, torch.bfloat16, bases, seed=11)
        k_ms = time_ms(lambda: paged_window_attention(*args), flush)
        p_ms = time_ms(lambda: paged_window_attention_ref(*args), flush)
        l_ms = time_ms(sdpa_on_gathered(*args), flush)
        b_ms, b_by = bound(args[0], args[4], S, torch.bfloat16)
        timings[S] = (k_ms, p_ms, l_ms, b_ms, b_by)
        print(f"S={S:2d} bases {bases}: kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms, sdpa on gathered KV {l_ms:.4f} ms, bound "
              f"{b_ms:.5f} ms ({b_by})")
    k_ms, p_ms, l_ms, b_ms, b_by = timings[1]
    print(json.dumps({"kernels": [{
        "name": "paged_window_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/paged_attention/csrc/"
                  "paged_window.cu",
        "replaces": "src/repro/kernels/paged_attention/kernel.py:148",
        "launches": launches, "max_abs_err": max_err, "max_err": max_err,
        "ms": k_ms, "kernel_ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": l_ms}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


if __name__ == "__main__":
    sys.exit(main())
