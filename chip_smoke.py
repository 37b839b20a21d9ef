#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no result line is printed then):

1. Environment: the card's name and power limit, torch / CUDA versions.
   Without a GPU it stops here.
2. Build: every CUDA source of the port, with nvcc, into ``build/``;
   ptxas registers and spills of every kernel instantiation; where
   ``cuobjdump`` exists, whether the bf16 flash kernel's SASS holds
   tensor-core ``HMMA`` and both attention kernels asynchronous copies
   (``LDGSTS`` / ``UTMALDG``).
3. Kernel vs plain version on the card: ``paged_window_attention`` at
   the full qwen3-4b head shape (Hq 32, Hkv 8, hd 128, bs 16, B 8) for
   S in {1, 4, 64}, ragged base lengths, one sliding window, f32
   (atol = rtol = 1e-4) and bf16 (3e-2); poisoning scratch block 0
   changes no output bit; then at the edges of its 64-position KV
   splits (rows seeing 1, 63, 64, 65, 128 and all 512 positions) for bs
   in {8, 16, 64}, S in {1, 4, 64}, f32 and bf16, scratch block 0
   poisoned; then at the head dims 112 (Hq 64, Hkv 8) and 192 (Hq 96,
   Hkv 8) for S 1, 5 and 64 at bs 16, f32 and bf16, and at the verify
   shape (B 8, S 5, Hq 32, Hkv 8, hd 128, ragged bases). Then the two scan kernels, f32, random inputs
   (non-zero bonus u, decays w in (0.45, 0.95), varied dt, A and D, a
   random initial state; k and the WKV state scaled by 1/sqrt(hd) and C
   by 1/sqrt(N) so outputs are of order 1): ``wkv_scan`` at the
   rwkv6-1.6b decode shape (B 8, T 1, H 32, hd 64), a full-width prefill
   (T 300) and a reduced shape (hd 32), then with decays in the model's
   own range (w = exp(-exp(z)): underflowing to 0, 0.9933 to 0.9999,
   and 0.45 to 0.95) at the decode shape, T 300, the 16-step chunk edge
   (T 17) and the serve's co-batched prefill (B 2, T 64); ``ssm_scan``
   at the hymba-1.5b decode shape (B 8, T 1, di 3200, N 16), T 300 and
   di 512. Max abs error of out and final state within 1e-5 at T = 1,
   1e-4 above;
   two halves with the state threaded through equal the whole scan.
   Then ``flash_attention`` and ``decode_attention`` at both served head
   shapes (qwen3-4b: Hq 32, Hkv 8, hd 128; hymba-1.5b: Hq 25, Hkv 5, hd
   64), f32 (1e-4) and bf16 (3e-2): flash at S = T = 300, S = 64 < T =
   364 (q offset), ragged S = 37 and a 128 sliding window, and on the
   model's strided (B,S,H,hd) views (bitwise equal to contiguous ones),
   and at every head dim {64, 112, 128, 192, 256} and group size {1, 4,
   5} over S 65 < T 300, causal and with a 24 sliding window;
   decode at B 8 over a 1024 stripe with ragged per-row lengths (1 and T
   among them) and one window, out and lse, the stripe read through
   strides bitwise equal to the contiguous layout, a scalar length equal
   to the same length per row; the sharded op over 4 shards of the
   stripe, one of them empty, within 1e-4 of the unsharded kernel (f32);
   then at the edges of its 64-position KV splits (lengths 0, 1, 63, 64,
   65, 127, T - 1, T) at both head shapes, f32 and bf16, with the stripe
   tail past each length poisoned with NaN, a 70-position window that
   starts inside a split, and back-to-back calls with other lengths.
   Then the sampler (plain PyTorch, as the reference's is XLA outside any
   Pallas kernel): ``sample``, ``draft_propose`` and
   ``speculative_accept`` on the card and on the CPU on the same f32
   logits (V 151,936) for every (temperature, top-k, seed) of
   ``SAMPLER_GRID``: threefry bits and uniforms bitwise equal, tokens
   identical on every row.
4. Serve at full width: qwen3-4b (36 layers, bf16, random weights from a
   seeded generator) behind ``ServingEngine(batch_size=8, max_seq=1024,
   use_kernel=True)``, 8 greedy requests. The paged kernel must launch
   once per layer per decode / chunk step and the flash kernel once per
   layer per prefill call, and the pool must drain clean. The same serve
   then runs again under ``torch.profiler``: device busy time, idle
   share and the top kernels.
4b. The same model behind ``make_lm_service`` (1 replica, B 8, max_seq
   1024, priority policy, use_kernel, a Tracer), started by the port's
   Supervisor with its serve loop on a thread: phase 4's 8 prompts and 4
   more as payloads (half sampled, two priority tiers, 16 new tokens)
   from 4 client threads with ``on_token`` callbacks (client k starts once
   payload k - 1 streams, so chunk windows, prefix sharing and
   copy-on-write all run), one cancelled on its first token. Every request ends completed or cancelled, the pool
   drains, the paged / flash launches follow phase 4's rule, the
   Prometheus exposition holds the engine, pool, loop, scheduler and
   balancer series, the Chrome trace covers the request, loop and pool
   tracks, the loop's plan window measured time; tokens/s, TTFT, the
   loop's plan / commit-wait split, then the profiler's busy / idle share.
4c. The same 12 requests through an ``AsyncServeLoop`` and a synchronous
   ``Scheduler.drain()``: tokens identical, logprobs within 1e-5.
4d. ``dispatch_step()`` on a decode batch with sampled rows never waits
   for the device: no synchronising call in it at full width (PyTorch's
   sync debug mode), and with depth cut to 2 layers (a 36-layer step
   overflows the launch queue behind a spin) it returns behind a 0.5 s
   spin while the card still spins; its host time beside the step's
   device time, and how long the stream stays busy after it returns.
5. Kernel path vs plain path at full width in f32 (4 layers): identical
   token streams, logprobs within 1e-3.
6. Serve on the stripe layout, bf16, random weights from seed 0,
   ``ServingEngine(batch_size=8, max_seq=1024, paged=False)``: full-width
   qwen3-4b with phase 4's 8 requests, then rwkv6-1.6b (24 layers) and
   hymba-1.5b (32 layers) with 10 greedy requests of 16 new tokens (two
   prompts of one length co-batch, slots are reused). Each serve counts
   its kernels from 0: a scan kernel once per layer per prefill call and
   decode step, the flash kernel once per layer per prefill call, the
   decode kernel once per layer per stripe decode step (chunk windows
   stay plain); every request completes and no slot stays active. Each
   serve runs again under ``torch.profiler``.
7. Recurrent kernel path vs plain path, full width, f32, 2 layers (f32
   leaves perturbed from their constant init): 4 requests through the
   port on the card (the scan, flash and decode kernels) and on the CPU
   (their plain versions), same weights: identical token streams,
   logprobs within 1e-3.
8. ``python -m repro_torch.launch.serve --arch qwen3-4b --stream
   --trace-out`` in a subprocess on the card (reduced width): ends with
   ``OK``.
9. Speculative serve of full-width qwen3-4b (bf16, seed-0 weights, k =
   4, ``use_kernel=True``): the draft is the target's bottom 4 layers
   (block leaves sliced on the layer axis, embedding and head shared);
   phase 4's 8 requests, 4 sampled (temperature 0.7, top-k 0 / 50), one
   opted out (``speculation=0``); paged, then on stripes. Every request
   completes, the cache drains, verify steps and proposals ran, the
   paged / flash / decode kernels launch by ``expected_spec_launches``
   (the target's and the draft's calls), and the serve's second run
   (under the profiler) emits the same streams bit for bit. Printed:
   acceptance, tokens per target step, tok/s, TTFT, blocks rolled back,
   idle share; then a speculative tick's ``dispatch_step()`` at full
   width under the sync debug mode (no synchronising call) and its host
   time.
9b. Speculative vs plain decode on the card, f32, full width, 4 layers:
   greedy, a self-draft and a 2-layer draft, paged and stripes; token
   streams equal the non-speculative engine's, logprobs within 1e-3; the
   self-draft accepts; a speculating ``dispatch_step()`` synchronises
   nothing.
10. MoE: full-width grok-1-314b (d 6144, 48 / 8 heads of 128, 8 experts
   top-2, moe_d_ff 32768, vocab 131,072) at 2 layers, bf16, seed-0
   weights from ``init_params`` on the card, paged, ``use_kernel=True``:
   phase 4's 8 greedy requests, one prefill call per admission, the
   paged and flash (G 6) kernels by phase 4's rule, the pool drains,
   tok/s and idle share; the MoE FFN's device time per decode step
   beside its bound (every expert's weights read once); then 1 layer in
   f32, the kernel path against the plain path: identical token
   streams, logprobs within 1e-3.

Then every kernel's times (CUDA events, L2 flushed between launches,
the card kept busy while the host enqueues, median of 30) at the shape
of its serve beside its plain version and its bound from bytes and flops
(the paged kernel also at the verify window, S 5, and at decode with hd
112 and 192: ``verify_*``, ``hd112_*``, ``hd192_*``; flash also at
grok-1-314b's prefill, 48 / 8 heads: ``grok_*``)
(for the scans also at a 300-token prefill, with the latency floor of
300 dependent steps, and WKV at the rwkv6 serve's co-batched prefill,
B 2, T 64, each WKV shape with its launch plan): paged attention and
the scans at decode, flash at the qwen3-4b prefill (B 1, S = T = 300),
decode attention at the stripe decode of hymba-1.5b and of qwen3-4b
(B 8, 1024 stripe, each
serve's lengths) and with every length 1 (its floor); the paged
kernel's row also carries its S = 64 chunk-window time (``window_*``),
the flash row its time and SDPA's at S = T = 16 and that of one tiny
elementwise kernel (what a launch costs this timing before any work),
the scan rows their prefill numbers (``prefill_*``), the WKV row also
its co-batched prefill numbers (``cobatch_*``), the decode row its
qwen3-4b numbers (``qwen3_*``) and floors (``floor_ms``,
``qwen3_floor_ms``). The sampler's device and host time per sampled and
all-greedy step at B 8, V 151,936 is printed beside them.
``scaled_dot_product_attention`` is the yardstick of the attention
kernels (on the gathered KV, causal, or with a length mask; the port
never calls it); no single PyTorch call computes either recurrence. TF32
is off for every f32 comparison.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from dataclasses import replace
from functools import partial
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
SM_CLOCK_HZ = 1.98e9            # H100 SXM boost clock
FMA_CYCLES = 4                  # latency of one dependent f32 FMA
SPIN_CYCLES = 2_000_000         # ~1 ms at the boost clock: longer than the
#                                 host takes to enqueue any timed call
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
HQ, HKV, HD, BS, B, MAX_BLOCKS = 32, 8, 128, 16, 8, 64
SEED = 0
PREFILL_T = 300                 # scan prefill shape: the longest prompt
# (Hq, Hkv, hd) of the served attention: qwen3-4b, hymba-1.5b
HEAD_SHAPES = ((32, 8, 128), (25, 5, 64))
STRIPE_T = 1024                 # the serves' max_seq
COBATCH_WKV = (2, 64, 32, 64)   # the rwkv6 serve's two 64-token prompts


def phase(name):
    print(f"\n=== {name}", flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ build
def _demangle(names, tool_dir):
    """Readable kernel names (``cu++filt`` where the toolkit has it)."""
    tool = Path(tool_dir) / "cu++filt"
    if tool.is_file():
        out = subprocess.run([str(tool), *names], capture_output=True,
                             text=True).stdout.splitlines()
        if len(out) == len(names):
            return [n.replace("(int)", "").replace("void ", "")
                    .replace("(anonymous namespace)::", "")
                    .replace("<unnamed>::", "").split("(")[0] for n in out]
    return names


def print_ptxas(build_dir, tool_dir):
    """Registers and spills of every compiled kernel, from each source's
    ``-Xptxas -v`` log."""
    for log in sorted(Path(build_dir).glob("*.log")):
        entries, name = [], None
        for line in log.read_text().splitlines():
            if "Compiling entry function" in line:
                name, spill = line.split("'")[1], "spills not reported"
            elif name and "spill stores" in line:
                spill = line.strip()
            elif name and "Used" in line and "registers" in line:
                regs = line.split("Used")[1].split("registers")[0].strip()
                entries.append((name, regs, spill))
                name = None
        for (_, regs, spill), short in zip(
                entries, _demangle([e[0] for e in entries], tool_dir)):
            print(f"  ptxas {log.stem}: {short}: {regs} registers; {spill}")


def print_sass_checks(libs, tool_dir):
    """Which kernels' SASS holds tensor-core MMAs (HMMA) and asynchronous
    copies (LDGSTS, or UTMALDG for TMA), where cuobjdump exists."""
    tool = Path(tool_dir) / "cuobjdump"
    if not tool.is_file():
        print("  sass: cuobjdump not available")
        return
    for src, lib in libs.items():
        if src.stem not in ("flash", "paged_window"):
            continue
        sass = subprocess.run([str(tool), "-sass", str(lib)],
                              capture_output=True, text=True).stdout
        funcs = {}
        for part in sass.split("Function : ")[1:]:
            name, _, body = part.partition("\n")
            funcs[name.strip()] = body
        names = _demangle(list(funcs), tool_dir)
        for short, body in zip(names, funcs.values()):
            print(f"  sass {src.stem}: {short}: HMMA "
                  f"{'yes' if 'HMMA' in body else 'no'}, LDGSTS "
                  f"{'yes' if 'LDGSTS' in body else 'no'}, UTMALDG "
                  f"{'yes' if 'UTMALDG' in body else 'no'}")


# ------------------------------------------------------------ kernel cases
def window_case(S, dtype, bases, *, seed=0, device="cuda", bs=BS,
                max_blocks=MAX_BLOCKS, heads=(HQ, HKV, HD)):
    """q / pool / table / base for one row per base length: each row owns
    distinct random blocks covering base + S tokens; table tails point
    at scratch block 0. ``heads``: (Hq, Hkv, hd)."""
    Hq, Hkv, hd = heads
    g = torch.Generator(device="cpu").manual_seed(seed)
    nb = len(bases) * max_blocks + 1
    q = torch.randn((len(bases), S, Hq, hd), generator=g).to(device, dtype)
    pk = torch.randn((nb, bs, Hkv, hd), generator=g).to(device, dtype)
    pv = torch.randn((nb, bs, Hkv, hd), generator=g).to(device, dtype)
    free = (torch.randperm(nb - 1, generator=g) + 1).tolist()
    table = torch.zeros((len(bases), max_blocks), dtype=torch.int32)
    for b, base in enumerate(bases):
        for i in range(-(-(base + S) // bs)):
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
    return max(worst, check_split_edges(window_attn),
               check_config_head_dims(window_attn))


# (Hq, Hkv, hd) of the configs whose head dim is off the power-of-two
# grid: kimi-k2-1t-a32b (hd 112) and nemotron-4-340b (hd 192)
ODD_HEADS = ((64, 8, 112), (96, 8, 192))
VERIFY_S = 5                    # a verify window at k = 4


def check_config_head_dims(window_attn):
    """The kernel at hd 112 and 192 (run on its 128 / 192 instantiations,
    padded dims zero) for S 1, 5 and 64 at bs 16, f32 and bf16 (bf16 at
    S 64 takes the tensor-core route), ragged bases, scratch block 0
    poisoned; then the verify shape at qwen3-4b's width: B 8, S 5, Hq
    32, Hkv 8, hd 128 (20 packed rows: two CUDA-core row tiles)."""
    worst = 0.0
    cases = [(heads, S) for heads in ODD_HEADS for S in (1, VERIFY_S, 64)]
    cases.append(((HQ, HKV, HD), VERIFY_S))
    for heads, S in cases:
        for dt in (torch.float32, torch.bfloat16):
            args = window_case(S, dt, ragged_bases(S), seed=heads[2] + S,
                               heads=heads)
            args[1][0], args[2][0] = 1e9, -1e9         # scratch block 0
            out, lse = window_attn(*args)
            ro, rl = window_attn(*args, force_ref=True)
            torch.cuda.synchronize()
            name = (f"paged Hq {heads[0]} Hkv {heads[1]} hd {heads[2]} S "
                    f"{S:2d} {str(dt):14s}")
            worst = max(worst, _report(name + " out", out, ro, dt),
                        _report(name + " lse", lse, rl, dt))
    return worst


def check_split_edges(window_attn):
    """Rows whose last window query sees 1, 63, 64, 65, 128 and all T =
    512 positions, the edges of the kernel's 64-position KV splits, at
    block sizes 8, 16 and 64; scratch block 0 poisoned, so a read of it
    would show."""
    worst = 0.0
    for bs in (8, 16, 64):
        mb = 512 // bs
        for S in (1, 4, 64):
            bases = [max(0, n - S) for n in (1, 63, 64, 65, 128, mb * bs)]
            for dt in (torch.float32, torch.bfloat16):
                args = window_case(S, dt, bases, seed=bs + S, bs=bs,
                                   max_blocks=mb)
                args[1][0], args[2][0] = 1e9, -1e9     # scratch block 0
                out, lse = window_attn(*args)
                ro, rl = window_attn(*args, force_ref=True)
                torch.cuda.synchronize()
                name = f"paged split edges bs {bs:2d} S {S:2d} {str(dt):14s}"
                worst = max(worst, _report(name + " out", out, ro, dt),
                            _report(name + " lse", lse, rl, dt))
    return worst


# ------------------------------------------------------- scan kernel cases
def model_decays(shape, g):
    """w = exp(-exp(z)) as the model makes it, each entry from one of
    three ranges: z in (4.7, 6) (w underflows to 0 in f32), z in (-9.2,
    -5) (w from 0.9933, the ``decay_base = -5`` init, to 0.9999), and w
    in (0.45, 0.95)."""
    pick = torch.randint(0, 3, shape, generator=g)
    z = torch.where(pick == 0, 4.7 + 1.3 * torch.rand(shape, generator=g),
                    -9.2 + 4.2 * torch.rand(shape, generator=g))
    mid = 0.45 + 0.5 * torch.rand(shape, generator=g)
    return torch.where(pick == 2, mid, torch.exp(-torch.exp(z)))


def wkv_case(Bq, T, H, hd, *, seed=0, decays="mid"):
    """r, k, v, w, u, state on the card: k and the state scaled by
    1/sqrt(hd), decays in (0.45, 0.95) (``decays="model"``: in the
    model's range, ``model_decays``), a non-zero bonus u."""
    g = torch.Generator().manual_seed(seed)
    r, k, v = (torch.randn((Bq, T, H, hd), generator=g) for _ in range(3))
    w = 0.45 + 0.5 * torch.sigmoid(torch.randn((Bq, T, H, hd), generator=g))
    if decays == "model":
        w = model_decays((Bq, T, H, hd), g)
    u = 0.5 * torch.randn((H, hd), generator=g)
    s0 = torch.randn((Bq, H, hd, hd), generator=g)
    return [t.cuda() for t in (r, k / math.sqrt(hd), v, w, u,
                               s0 / math.sqrt(hd))]


def ssm_case(Bq, T, di, N, *, seed=0):
    """u, dt, Bm, Cm, A, D, state on the card: dt = softplus(z - 1),
    A = -exp(z / 2), D = 1 + 0.3 z, C scaled by 1/sqrt(N)."""
    g = torch.Generator().manual_seed(seed)
    u = torch.randn((Bq, T, di), generator=g)
    dt = torch.nn.functional.softplus(torch.randn((Bq, T, di), generator=g)
                                      - 1.0)
    Bm, Cm = (torch.randn((Bq, T, N), generator=g) for _ in range(2))
    A = -torch.exp(0.5 * torch.randn((di, N), generator=g))
    D = 1.0 + 0.3 * torch.randn(di, generator=g)
    s0 = torch.randn((Bq, di, N), generator=g)
    return [t.cuda() for t in (u, dt, Bm, Cm / math.sqrt(N), A, D, s0)]


def scan_tol(T):
    """One step: 1e-5; longer scans carry a state that accumulates
    rounding: 1e-4."""
    return 1e-5 if T == 1 else 1e-4


def check_scan_vs_plain(name, op, case, shapes):
    """op on the card against op(force_ref=True) at each (shape, T); then
    two halves with the state threaded through against the whole."""
    worst = 0.0
    for shape in shapes:
        T = shape[1]
        args = case(*shape, seed=T)
        out, st = op(*args)
        ro, rs = op(*args, force_ref=True)
        torch.cuda.synchronize()
        err = max((out - ro).abs().max().item(), (st - rs).abs().max().item())
        tol = scan_tol(T)
        print(f"{name} {shape}: max |kernel - plain| {err:.3e} (tol {tol})")
        if not err <= tol:
            raise AssertionError(f"{name} {shape}: error {err} > {tol}")
        worst = max(worst, err)
    args = case(*shapes[1], seed=99)
    T, h = shapes[1][1], shapes[1][1] // 3
    seq, rest = args[:4], args[4:-1]      # 4 time-major inputs, then the
    #                                       per-channel ones, then state
    out, st = op(*args)
    o1, s1 = op(*(t[:, :h].contiguous() for t in seq), *rest, args[-1])
    o2, s2 = op(*(t[:, h:].contiguous() for t in seq), *rest, s1)
    torch.cuda.synchronize()
    err = max((torch.cat([o1, o2], 1) - out).abs().max().item(),
              (s2 - st).abs().max().item())
    print(f"{name}: halves {h} + {T - h} with the state threaded vs the "
          f"whole: max |diff| {err:.3e} (tol {scan_tol(T)})")
    if not err <= scan_tol(T):
        raise AssertionError(f"{name}: state carry differs by {err}")
    return worst


# ------------------------------------------------ flash / decode kernel cases
def _report(name, out, ref, dt):
    err = (out.float() - ref.float()).abs().max().item()
    print(f"{name}: max |kernel - plain| {err:.3e} (tol {TOL[dt]})")
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dt],
                               rtol=TOL[dt])
    return err


def check_flash_vs_plain(flash_attention, attention_bshd):
    """The flash kernel against its plain version at both served head
    shapes; then the model's strided views against contiguous copies."""
    worst = 0.0
    for Hq, Hkv, hd in HEAD_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            for Bq, S, T, win in ((1, 300, 300, 0), (2, 64, 364, 0),
                                  (2, 37, 37, 0), (1, 300, 300, 128)):
                g = torch.Generator().manual_seed(S + T + hd + win)
                q = torch.randn((Bq, Hq, S, hd), generator=g).to("cuda", dt)
                k, v = (torch.randn((Bq, Hkv, T, hd), generator=g)
                        .to("cuda", dt) for _ in range(2))
                out = flash_attention(q, k, v, sliding_window=win)
                ref = flash_attention(q, k, v, sliding_window=win,
                                      force_ref=True)
                torch.cuda.synchronize()
                worst = max(worst, _report(
                    f"flash Hq {Hq} Hkv {Hkv} hd {hd} {str(dt):14s} S {S:3d} "
                    f"T {T:3d} window {win:3d}", out, ref, dt))
    g = torch.Generator().manual_seed(5)
    q = torch.randn((1, 300, HQ, HD), generator=g).to("cuda", torch.bfloat16)
    kv = torch.randn((1, 300, 2, HKV, HD), generator=g).to("cuda",
                                                          torch.bfloat16)
    k, v = kv[:, :, 0], kv[:, :, 1]
    out = attention_bshd(q, k, v)
    dense = attention_bshd(q, k.contiguous(), v.contiguous())
    torch.cuda.synchronize()
    if not torch.equal(out, dense):
        raise AssertionError("flash on strided (B,S,H,hd) views != on "
                             "contiguous copies")
    print("flash on the model's (B,S,H,hd) views: bitwise equal to "
          "contiguous copies")
    for hd in (64, 112, 128, 192, 256):
        for G in (1, 4, 5, 6):
            for dt in (torch.float32, torch.bfloat16):
                g = torch.Generator().manual_seed(hd + G)
                q = torch.randn((1, 2 * G, 65, hd), generator=g).to("cuda",
                                                                   dt)
                k, v = (torch.randn((1, 2, 300, hd), generator=g)
                        .to("cuda", dt) for _ in range(2))
                for win in (0, 24):
                    out = flash_attention(q, k, v, sliding_window=win)
                    ref = flash_attention(q, k, v, sliding_window=win,
                                          force_ref=True)
                    torch.cuda.synchronize()
                    worst = max(worst, _report(
                        f"flash hd {hd:3d} G {G} {str(dt):14s} S 65 T 300 "
                        f"window {win:2d}", out, ref, dt))
    return worst


def stripe_case(Bq, Hq, Hkv, hd, dt, seed):
    """q (B,Hq,hd) and a (B,T,Hkv,hd) K / V stripe pair on the card."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((Bq, Hq, hd), generator=g).to("cuda", dt)
    k, v = (torch.randn((Bq, STRIPE_T, Hkv, hd), generator=g).to("cuda", dt)
            for _ in range(2))
    return q, k, v


def check_decode_vs_plain(decode_attention, sharded_decode_attention):
    """The decode kernel against its plain version at both served head
    shapes, out and lse; the stripe read through strides against the
    contiguous layout; a scalar length; the sharded merge."""
    worst = 0.0
    lens = [1, STRIPE_T, 37, 64, 65, 300, 511, 129]
    n = torch.tensor(lens, dtype=torch.int32, device="cuda")
    for Hq, Hkv, hd in HEAD_SHAPES:
        for dt, win in ((torch.float32, 0), (torch.bfloat16, 0),
                        (torch.bfloat16, 100)):
            q, k_st, v_st = stripe_case(B, Hq, Hkv, hd, dt, seed=hd + win)
            k, v = k_st.transpose(1, 2), v_st.transpose(1, 2)
            out, lse = decode_attention(q, k, v, n, sliding_window=win)
            ro, rl = decode_attention(q, k, v, n, sliding_window=win,
                                      force_ref=True)
            co, cl = decode_attention(q, k.contiguous(), v.contiguous(), n,
                                      sliding_window=win)
            torch.cuda.synchronize()
            name = f"decode Hq {Hq} Hkv {Hkv} hd {hd} {str(dt):14s} " \
                   f"window {win:3d}"
            worst = max(worst, _report(name + " out", out, ro, dt),
                        _report(name + " lse", lse, rl, dt))
            if not (torch.equal(out, co) and torch.equal(lse, cl)):
                raise AssertionError(f"{name}: the strided stripe read != "
                                     f"the contiguous layout")
        o1, l1 = decode_attention(q, k, v, 300)
        o2, l2 = decode_attention(q, k, v, torch.full(
            (B,), 300, dtype=torch.int32, device="cuda"))
        torch.cuda.synchronize()
        if not (torch.equal(o1, o2) and torch.equal(l1, l2)):
            raise AssertionError("a scalar n_valid != the same per row")
    print("stripe read through strides: bitwise equal to the contiguous "
          "layout; scalar n_valid equal to per-row")
    q, k_st, v_st = stripe_case(B, 25, 5, 64, torch.float32, seed=3)
    k, v = k_st.transpose(1, 2), v_st.transpose(1, 2)
    out = sharded_decode_attention(q, k.chunk(4, 2), v.chunk(4, 2), 700)
    whole, _ = decode_attention(q, k, v, 700)
    torch.cuda.synchronize()
    err = (out - whole).abs().max().item()
    print(f"sharded decode, 4 shards of {STRIPE_T // 4}, n_valid 700 (last "
          f"shard empty): max |merged - unsharded| {err:.3e} (tol 1e-4)")
    if not (torch.isfinite(out).all() and err <= 1e-4):
        raise AssertionError(f"sharded decode differs by {err}")
    return max(worst, err)


def check_decode_split_edges(decode_attention):
    """The decode kernel at the edges of its 64-position KV splits (rows
    of length 0, 1, 63, 64, 65, 127, T - 1 and T), with the stripe tail
    past each length poisoned with NaN (the plain version reads the
    clean stripe), at both served head shapes, f32 and bf16; then a
    window whose first position falls inside a split; then back-to-back
    calls with other lengths (the in-kernel merge counters reset)."""
    worst = 0.0
    cases = [(hs, dt, 0, [0, 1, 63, 64, 65, 127, STRIPE_T - 1, STRIPE_T])
             for hs in HEAD_SHAPES for dt in (torch.float32, torch.bfloat16)]
    cases += [(HEAD_SHAPES[1], torch.bfloat16, 70,
               [100, 130, 200, STRIPE_T, 700, 65, 1100, 10]),
              (HEAD_SHAPES[0], torch.bfloat16, 0,
               [1024, 1000, 640, 65, 64, 300, 2, 900])]
    for (Hq, Hkv, hd), dt, win, lens in cases:
        q, k_st, v_st = stripe_case(B, Hq, Hkv, hd, dt, seed=sum(lens) + win)
        n = torch.tensor(lens, dtype=torch.int32, device="cuda")
        ro, rl = decode_attention(q, k_st.transpose(1, 2),
                                  v_st.transpose(1, 2), n,
                                  sliding_window=win, force_ref=True)
        tail = torch.arange(STRIPE_T, device="cuda")[None] >= n[:, None]
        k_st[tail], v_st[tail] = float("nan"), float("nan")
        out, lse = decode_attention(q, k_st.transpose(1, 2),
                                    v_st.transpose(1, 2), n,
                                    sliding_window=win)
        torch.cuda.synchronize()
        name = f"decode split edges Hq {Hq} Hkv {Hkv} hd {hd} " \
               f"{str(dt):14s} window {win:2d} NaN tails"
        worst = max(worst, _report(name + " out", out, ro, dt),
                    _report(name + " lse", lse, rl, dt))
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


def make_recurrent_requests(Request, vocab, lens=(300, 74, 64, 64, 5, 17,
                                                   33, 120, 250, 40),
                            max_new=16):
    """Greedy requests for the stripe serves: 10 prompts by default, two
    of one length (they co-batch), more than the 8 slots (slots are
    reused)."""
    g = torch.Generator().manual_seed(SEED + 2)
    return [Request(rid=i, prompt=torch.randint(2, vocab, (n,), generator=g)
                    .tolist(), max_new_tokens=max_new)
            for i, n in enumerate(lens)]


def run_engine(eng, reqs):
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run(list(reqs))
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    return done, time.perf_counter() - t0


def serve(cfg, params, model, ServingEngine, Request, use_kernel):
    eng = ServingEngine(model, params, batch_size=8, max_seq=1024,
                        use_kernel=use_kernel)
    reqs = make_requests(Request, cfg.vocab_size)
    done, wall = run_engine(eng, reqs)
    return eng, reqs, done, wall


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


def expected_launches(name, L, m):
    """Launches a serve owes a kernel: L layers times the calls of the
    engine's metrics that run it."""
    calls = {
        "paged_window_attention": m["decode_steps"],      # incl. chunks
        "flash_attention": m["prefill_batches"],
        "decode_attention": m["decode_steps"] - m["chunk_steps"],
        "wkv_scan": m["prefill_batches"] + m["decode_steps"],
        "ssm_scan": m["prefill_batches"] + m["decode_steps"],
    }
    return L * calls[name]


def check_launches(fns, launches, cfg, m):
    for fn in fns:
        name = fn.__name__
        expect = expected_launches(name, cfg.n_layers, m)
        print(f"{name} launches {launches[name]} = {expect} ({cfg.n_layers} "
              f"layers; {m['prefill_batches']} prefill calls, "
              f"{m['decode_steps']} steps of which {m['chunk_steps']} chunk "
              f"windows)")
        if launches[name] <= 0 or launches[name] != expect:
            raise AssertionError(f"{name} launches {launches[name]} != "
                                 f"{expect}")


def serve_stripes(arch, fns, make_reqs, get_config, build_model,
                  ServingEngine, Request):
    """Phase 6 for one model: full width, bf16, seed-0 weights, the stripe
    engine; ``fns`` are the kernel wrappers of its path, whose launches
    are counted from 0 over the serve. Returns {name: launches}."""
    cfg = get_config(arch)
    model = build_model(cfg, device="cuda")
    params = model.init(SEED)

    def run():
        eng = ServingEngine(model, params, batch_size=8, max_seq=STRIPE_T,
                            paged=False)
        reqs = make_reqs(Request, cfg.vocab_size)
        done, wall = run_engine(eng, reqs)
        return eng, reqs, done, wall

    for fn in fns:
        fn.launches = 0
    eng, reqs, done, wall = run()
    launches = {fn.__name__: fn.launches for fn in fns}
    check_outputs(reqs, done, cfg.vocab_size)
    m, stats = eng.metrics, eng.pool_stats()
    print("metrics:", json.dumps(m))
    print("pool:", json.dumps(stats))
    n_tok = sum(len(r.out_tokens) for r in reqs)
    lat = sorted(r.latency_s for r in reqs)
    print(f"{n_tok} tokens in {wall:.3f} s: {n_tok / wall:.1f} tok/s; "
          f"latency p50 {statistics.median(lat):.3f} s, max {lat[-1]:.3f} s")
    check_launches(fns, launches, cfg, m)
    if stats["paged"] or stats["active"]:
        raise AssertionError(f"stripe engine did not drain: {stats}")
    if make_reqs is make_recurrent_requests and (
            m["prefill_batches"] >= m["prefills"] or m["slot_reuses"] == 0):
        raise AssertionError("co-batched admission and slot reuse must "
                             "both have run")
    profile_serve(lambda: run()[::3])          # (engine, wall)
    return launches, reqs


def perturb_f32_leaves(params, seed):
    """Seeded noise on the f32 leaves that init to constants (bonus_u,
    decay_base; dt_bias, D, A_log), in place."""
    blocks = params["blocks"]
    g = torch.Generator(device=blocks["ln1"].device).manual_seed(seed)
    if "tmix" in blocks:
        blocks["tmix"]["bonus_u"].normal_(0.0, 0.5, generator=g)
        blocks["tmix"]["decay_base"].uniform_(-3.0, 1.0, generator=g)
    if "ssm" in blocks:
        p = blocks["ssm"]
        p["dt_bias"].normal_(0.0, 0.5, generator=g)
        p["D"].normal_(1.0, 0.3, generator=g)
        p["A_log"].add_(0.3 * torch.randn(p["A_log"].shape, generator=g,
                                          device=p["A_log"].device))


def recurrent_card_vs_cpu(arch, get_config, build_model, ServingEngine,
                          Request):
    """Phase 7 for one model: 2 full-width layers in f32, the same
    weights on the card (scan kernels) and on the CPU (plain scans)."""
    cfg = replace(get_config(arch), n_layers=2, dtype=torch.float32)
    params = build_model(cfg, device="cuda").init(SEED)
    perturb_f32_leaves(params, SEED + 3)
    streams, walls = {}, {}
    for device in ("cuda", "cpu"):
        p = params if device == "cuda" else _to(params, "cpu")
        eng = ServingEngine(build_model(cfg, device=device), p, batch_size=4,
                            max_seq=128, device=device)
        reqs = make_recurrent_requests(Request, cfg.vocab_size,
                                       lens=(96, 40, 40, 7), max_new=8)
        done, walls[device] = run_engine(eng, reqs)
        check_outputs(reqs, done, cfg.vocab_size)
        streams[device] = reqs
    lp_err = 0.0
    for a, b in zip(streams["cuda"], streams["cpu"]):
        if a.out_tokens != b.out_tokens:
            raise AssertionError(f"{arch} request {a.rid}: card "
                                 f"{a.out_tokens} != cpu {b.out_tokens}")
        lp_err = max(lp_err, max(abs(x - y) for x, y in
                                 zip(a.out_logprobs, b.out_logprobs)))
    print(f"{arch}: token streams identical; max |logprob diff| "
          f"{lp_err:.3e} (tol 1e-3); card {walls['cuda']:.3f} s, cpu "
          f"{walls['cpu']:.3f} s")
    if lp_err > 1e-3:
        raise AssertionError(f"{arch}: logprobs differ by {lp_err}")


def profile_serve(run):
    """Where the time of a serve goes: ``run()`` (returning the engine
    and its wall time) again under torch.profiler (its overhead
    included), device time summed over kernels against the wall time,
    the top kernels, and the port's own kernels below them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng, wall = run()
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
    # the port's own kernels (anonymous namespace) below the top 8
    for t, e in rows[8:]:
        if "anonymous namespace" in e.key:
            print(f"  {t / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:90]}")


# ----------------------------------------------------------------- timing
def time_ms(fn, flush, iters=30, warmup=5):
    """Median device time of ``fn`` in ms (CUDA events), with the L2
    cache flushed before every launch as the serving caller finds it. A
    spin kernel after the flush keeps the card busy while the host
    enqueues ``fn``, so the interval holds the device's time and not the
    wrapper's host time (an idle card would wait for the enqueue)."""
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def time_decode(decode_attention, flush, Hq, Hkv, hd, lens):
    """The decode kernel at B 8 over a 1024 stripe read in place (bf16)
    at a serve's lengths: kernel, plain version, SDPA with a length mask
    on the contiguous (B,Hkv,T,hd) copy, the bound; then the kernel with
    every row of length 1 (its floor). Returns (kernel, plain, bound,
    bound by, sdpa, floor)."""
    F = torch.nn.functional
    q, k_st, v_st = stripe_case(B, Hq, Hkv, hd, torch.bfloat16, seed=13)
    k, v = k_st.transpose(1, 2), v_st.transpose(1, 2)   # stripe, in place
    n = torch.tensor(lens, dtype=torch.int32, device="cuda")
    ones = torch.ones_like(n)
    kc, vc = k.contiguous(), v.contiguous()
    mask = (torch.arange(STRIPE_T, device="cuda")[None] < n[:, None].long()
            )[:, None, None, :]                           # (B,1,1,T)
    d_ms = time_ms(lambda: decode_attention(q, k, v, n), flush)
    dp_ms = time_ms(lambda: decode_attention(q, k, v, n, force_ref=True),
                    flush)
    dl_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None], kc, vc, attn_mask=mask, enable_gqa=True), flush)
    df_ms = time_ms(lambda: decode_attention(q, k, v, ones), flush)
    db_ms, db_by = decode_bound(lens, Hq, Hkv, hd, torch.bfloat16)
    print(f"decode B {B} T {STRIPE_T} Hq {Hq} Hkv {Hkv} hd {hd} bf16, "
          f"lengths {lens}: kernel {d_ms:.4f} ms, plain {dp_ms:.4f} ms, "
          f"sdpa (length mask) {dl_ms:.4f} ms, bound {db_ms:.5f} ms "
          f"({db_by}); every length 1: kernel {df_ms:.4f} ms")
    return d_ms, dp_ms, db_ms, db_by, dl_ms, df_ms


def sdpa_on_gathered(q, pk, pv, table, base):
    """Gather the rows' KV (outside the timed call) and return a closure
    running one SDPA call with the causal-in-window mask."""
    F = torch.nn.functional
    Bq, S = q.shape[:2]
    _, bs, Hkv, hd = pk.shape
    T = table.shape[1] * bs
    gk = pk[table.long()].reshape(Bq, T, Hkv, hd).transpose(1, 2)
    gv = pv[table.long()].reshape(Bq, T, Hkv, hd).transpose(1, 2)
    qt = q.transpose(1, 2)
    i = base.long()[:, None] + torch.arange(S, device=q.device)[None]
    mask = torch.arange(T, device=q.device)[None, None] <= i[:, :, None]
    mask = mask[:, None]                                  # (B,1,S,T)
    return lambda: F.scaled_dot_product_attention(qt, gk, gv,
                                                  attn_mask=mask,
                                                  enable_gqa=True)


def flash_bound(Bq, Hq, Hkv, S, T, hd, dtype):
    """q, k, v read once and out written once; causal flops 4 * B * Hq *
    S * T * hd / 2 at the input type's peak."""
    es = torch.finfo(dtype).bits // 8
    nbytes = es * Bq * hd * (2 * S * Hq + 2 * T * Hkv)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 4 * Bq * Hq * S * T * hd / 2 / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def decode_bound(lens, Hq, Hkv, hd, dtype):
    """The valid K/V of every row read once, q and the lengths read once,
    out and lse written once; 4 * hd flops per (query head, valid
    position) at the input type's peak."""
    es = torch.finfo(dtype).bits // 8
    nbytes = (sum(lens) * Hkv * hd * 2 * es + len(lens) * Hq * hd * 2 * es
              + len(lens) * (Hq + 1) * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 4 * hd * Hq * sum(lens) / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound(q, base, S, dtype, Hkv=HKV):
    """Least time for the work this input needs: the K/V bytes of every
    visible cached token read once, q read once, out / lse written once;
    flops 2 * 2 * hd per (query head, visible key) pair."""
    es = q.element_size()
    Hq, hd = q.shape[2], q.shape[3]
    vis = [min(int(b) + S, MAX_BLOCKS * BS) for b in base.tolist()]
    kv_bytes = sum(vis) * Hkv * hd * 2 * es
    io_bytes = 2 * q.numel() * es + q.numel() // hd * 4 \
        + B * (MAX_BLOCKS + 1) * 4
    pairs = sum(sum(min(b + w + 1, MAX_BLOCKS * BS) for w in range(S))
                for b in base.tolist()) * Hq
    flops = 4 * hd * pairs
    t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _f32_bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[torch.float32] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def wkv_bound(Bq, T, H, hd):
    """r, k, v, w and u read once, out written once, the state read and
    written once, f32; 7 flops per state entry per step (k v product,
    bonus, r dot, decay FMA)."""
    nbytes = 4 * (5 * Bq * T * H * hd + H * hd + 2 * Bq * H * hd * hd)
    return _f32_bound(nbytes, 7 * Bq * T * H * hd * hd)


def ssm_bound(Bq, T, di, N):
    """u, dt, B, C, A and D read once, y written once, the state read and
    written once, f32; 7 operations per state entry per step (dt A, exp,
    decay, input FMA, C dot) and 2 per channel (dt u, D u)."""
    nbytes = 4 * (3 * Bq * T * di + 2 * Bq * T * N + di * N + di
                  + 2 * Bq * di * N)
    return _f32_bound(nbytes, 7 * Bq * T * di * N + 2 * Bq * T * di)


def step_floor_ms(T):
    """Latency floor of T dependent steps: one f32 FMA each."""
    return T * FMA_CYCLES / SM_CLOCK_HZ * 1e3


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


# --------------------------------------------------------------- sampling
VOCAB = 151936                  # qwen3-4b's vocabulary
SAMPLER_GRID = [(t, k, s) for t in (0.0, 0.3, 1.0, 1.5) for k in (0, 1, 50)
                for s in (0, 7, -1, 2**31 - 1)]


def _knobs(part):
    return ([np.asarray(c, dt) for c, dt in zip(zip(*part), (
        np.float32, np.int32, np.int32))])


def check_sampler(sampling, prng):
    """``sample``, ``draft_propose`` and ``speculative_accept`` on the card
    against the CPU on identical f32 logits (B 8, V 151,936), every
    (temperature, top-k, seed) of ``SAMPLER_GRID``: the threefry bits and
    uniforms bitwise equal, tokens and ``accepted`` identical on every
    row; logprobs within 2e-5 (a log-sum-exp over 151,936 terms in
    another order), probs within 1e-6. Returns (rows, worst errors)."""
    g = torch.Generator().manual_seed(SEED + 5)
    lp_err = p_err = 0.0
    for b0 in range(0, len(SAMPLER_GRID), B):
        temps, top_ks, seeds = _knobs(SAMPLER_GRID[b0:b0 + B])
        n = len(temps)
        ctrs = np.arange(b0, b0 + n, dtype=np.int32)
        k0, k1 = sampling.stream_keys(seeds, ctrs, sampling.TOKEN_STREAM)
        bits = {d: prng.bits(torch.as_tensor(k0, device=d),
                             torch.as_tensor(k1, device=d), VOCAB)
                for d in ("cuda", "cpu")}
        uni = {d: prng.uniform(b, prng.TINY, 1.0) for d, b in bits.items()}
        if not torch.equal(bits["cuda"].cpu(), bits["cpu"]) or not \
                torch.equal(uni["cuda"].cpu().view(torch.int32),
                            uni["cpu"].view(torch.int32)):
            raise AssertionError(f"sampler rows {b0}..: threefry bits or "
                                 f"uniforms differ between card and CPU")
        lg = torch.randn((n, VOCAB), generator=g) * 3
        tl = torch.randn((n, 4, VOCAB), generator=g) * 2
        dp = torch.softmax(torch.randn((n, 3, VOCAB), generator=g), -1)
        prop = tl[:, :3].argmax(-1)
        prop[::2, 1] = (prop[::2, 1] + 1) % VOCAB
        ns = np.asarray([3, 0, 3, 2, 3, 1, 0, 3][:n], np.int32)
        out = {}
        for d in ("cuda", "cpu"):
            out[d] = [t.cpu() for t in (
                *sampling.sample(lg.to(d), temps, top_ks, seeds, ctrs),
                *sampling.draft_propose(lg.to(d), temps, top_ks, seeds, ctrs,
                                        ctrs % 3),
                *sampling.speculative_accept(tl.to(d), dp.to(d), prop.numpy(),
                                             ns, temps, top_ks, seeds, ctrs))]
        (tok, lp, dtok, probs, acc, atok, alp) = out["cuda"]
        (ctok, clp, cdtok, cprobs, cacc, catok, calp) = out["cpu"]
        for name, a, b in (("sample tokens", tok, ctok),
                           ("draft tokens", dtok, cdtok),
                           ("accepted", acc, cacc),
                           ("accept tokens", atok, catok)):
            if not torch.equal(a, b):
                raise AssertionError(f"sampler rows {b0}..: {name} card "
                                     f"{a.tolist()} != cpu {b.tolist()}")
        lp_err = max(lp_err, (lp - clp).abs().max().item(),
                     (alp - calp).abs().max().item())
        p_err = max(p_err, (probs - cprobs).abs().max().item())
    print(f"sampler: {len(SAMPLER_GRID)} rows (temperatures 0 / 0.3 / 1.0 / "
          f"1.5 x top-k 0 / 1 / 50 x seeds 0 / 7 / -1 / 2^31-1, V {VOCAB}): "
          f"threefry bits and uniforms bitwise equal card vs CPU; sample, "
          f"draft and accept tokens identical; max |logprob diff| "
          f"{lp_err:.3e} (tol 2e-5), max |prob diff| {p_err:.3e} (tol 1e-6)")
    if lp_err > 2e-5 or p_err > 1e-6:
        raise AssertionError(f"sampler: logprobs {lp_err} / probs {p_err}")
    return len(SAMPLER_GRID), lp_err


def time_sampler(sampling):
    """The sampler at B 8, V 151,936 on the card, sampled rows (the first
    8 of ``SAMPLER_GRID`` with temperature > 0) and all-greedy rows:
    device time (CUDA events after a spin that keeps the host ahead),
    host time of staging + enqueue (perf_counter while the card spins),
    medians of 20; and the kernels one sampled call launches (profiler).
    Returns a dict of the numbers."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sampled = [r for r in SAMPLER_GRID if r[0] > 0][:B]
    temps, top_ks, seeds = _knobs(sampled)
    ctrs = np.arange(B, dtype=np.int32)
    g = torch.Generator().manual_seed(SEED + 7)
    lg = (torch.randn((B, VOCAB), generator=g) * 3).cuda()
    out = {}
    for name, t in (("sampled", temps), ("greedy", np.zeros(B, np.float32))):
        dev, host = [], []
        for i in range(25):
            torch.cuda.synchronize()
            torch.cuda._sleep(SPIN_CYCLES * 10)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            sampling.sample_rows(lg, sampling.Rows(t, top_ks, seeds, ctrs,
                                                   "cuda"))
            t1 = time.perf_counter()
            end.record()
            torch.cuda.synchronize()
            if i >= 5:
                dev.append(start.elapsed_time(end))
                host.append((t1 - t0) * 1e3)
        out[f"{name}_device_ms"] = statistics.median(dev)
        out[f"{name}_host_ms"] = statistics.median(host)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sampling.sample_rows(lg, sampling.Rows(temps, top_ks, seeds, ctrs,
                                               "cuda"))
        torch.cuda.synchronize()
    out["sampled_launches"] = sum(
        e.count for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0)
    print(f"sampler B {B} V {VOCAB}: sampled rows device "
          f"{out['sampled_device_ms']:.4f} ms, host "
          f"{out['sampled_host_ms']:.4f} ms, "
          f"{out['sampled_launches']} device ops; all greedy device "
          f"{out['greedy_device_ms']:.4f} ms, host "
          f"{out['greedy_host_ms']:.4f} ms")
    return out


# ------------------------------------------------------- the LM service
def service_payloads(vocab):
    """Phase 4's 8 prompts plus 4 more, as service payloads: 16 new tokens
    each; the odd ones sampled (temperature 0.7, top-k 0 or 50, a seed of
    their own); priority tiers 0 and 1 across both kinds."""
    from repro_torch.serve.engine import Request
    g = torch.Generator().manual_seed(SEED + 4)
    prompts = [r.prompt for r in make_requests(Request, vocab)]
    prompts += [torch.randint(2, vocab, (n,), generator=g).tolist()
                for n in (48, 9, 160, 21)]
    out = []
    for i, p in enumerate(prompts):
        pay = {"prompt": p, "max_new_tokens": 16, "priority": (i // 2) % 2}
        if i % 2:
            pay["sampling"] = {"temperature": 0.7,
                               "top_k": 0 if i % 4 == 1 else 50,
                               "seed": 100 + i}
        out.append(pay)
    return out


CANCEL = 5                      # the payload cancelled after one token
CLIENTS = 4
WAIT_S = 600.0


def run_service(model, params, payloads):
    """Full-width LM service: ``make_lm_service`` (1 replica, B 8, max_seq
    1024, priority policy, use_kernel, a Tracer) started by the port's
    Supervisor, its serve loop on its own thread; ``CLIENTS`` client
    threads send the payloads (client k payloads k, k + 4, ...) with
    ``on_token`` callbacks, through the service's balancer; client k
    starts once payload k - 1 has streamed a token, so payload 2 (the
    64-token prefix) arrives while payload 1 (the prefix + 10) holds its
    blocks and shares them up to a partial tail (copy-on-write); payload
    ``CANCEL`` goes through the replica's ``submit`` and is cancelled on
    its first streamed token. Everything started is stopped before it
    returns.
    Returns (engine, wall s, service, tracer, results, ttft s)."""
    import threading
    from repro_torch.core.supervisor import Supervisor
    from repro_torch.serve.service import make_lm_service
    from repro_torch.serve.telemetry import Tracer
    tracer = Tracer()
    sup = Supervisor()
    svc = make_lm_service("lm", model, params, n_replicas=1, batch_size=B,
                          max_seq=STRIPE_T, policy="priority",
                          use_kernel=True, tracer=tracer, supervisor=sup)
    sup.start_all()
    rep = svc.replicas[0].handler
    results, ttft, errors = {}, {}, []
    streamed = [threading.Event() for _ in payloads]

    def send(i):
        toks, handle, submitted = [], {}, threading.Event()
        t_send = time.perf_counter()

        def on_token(tok, lp):
            if not toks:
                ttft[i] = time.perf_counter() - t_send
                streamed[i].set()
            toks.append(tok)
            if i == CANCEL and len(toks) == 1:
                # the client cancels on its first token (the loop applies
                # it at its next boundary)
                submitted.wait(WAIT_S)
                handle["h"].cancel()
        pay = dict(payloads[i], on_token=on_token)
        if i != CANCEL:
            results[i] = ("completed", svc(pay), toks)
            return
        handle["h"] = h = rep.submit(pay)
        submitted.set()
        if not h._done.wait(WAIT_S):
            raise AssertionError("the cancelled request never resolved")
        results[i] = ("cancelled" if h.cancelled else "not cancelled",
                      h.result(), toks)

    def client(k):
        try:
            if k and not streamed[k - 1].wait(WAIT_S):
                raise AssertionError(f"payload {k - 1} streamed nothing")
            for i in range(k, len(payloads), CLIENTS):
                send(i)
        except Exception as e:          # surfaces in the main thread
            errors.append(e)

    rep.loop.start()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(k,), daemon=True)
                   for k in range(CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT_S)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if any(t.is_alive() for t in threads):
            raise AssertionError("a service client did not finish")
        if errors:
            raise errors[0]
    finally:
        rep.loop.stop()
        sup.stop_all()
    return rep.scheduler.engine, wall, svc, tracer, results, ttft


def check_service(eng, svc, tracer, results, payloads, vocab):
    """Every request completed (16 tokens, streamed == reply) or, for
    ``CANCEL``, cancelled after streaming; the pool drained; the
    Prometheus exposition holds the engine, pool, loop, scheduler and
    balancer series; the Chrome trace parses and covers the request,
    loop and pool tracks."""
    import tempfile
    from repro_torch.serve.service import service_prometheus_text
    from repro_torch.serve.telemetry import PID_LOOP, PID_POOL, PID_REQUESTS
    if sorted(results) != list(range(len(payloads))):
        raise AssertionError(f"replies for {sorted(results)}")
    for i, (status, reply, toks) in results.items():
        want = "cancelled" if i == CANCEL else "completed"
        n = len(reply["tokens"])
        if status != want or reply["tokens"] != toks[:n] or not (
                n == 16 if i != CANCEL else 1 <= n < 16):
            raise AssertionError(f"payload {i}: {status}, {n} tokens")
        if not all(0 <= t < vocab for t in reply["tokens"]) or not all(
                math.isfinite(x) and x <= 0 for x in reply["logprobs"]):
            raise AssertionError(f"payload {i}: bad tokens or logprobs")
    m, stats = eng.metrics, eng.pool_stats()
    if m["completed"] != len(payloads) - 1 or m["cancelled"] != 1:
        raise AssertionError(f"engine completed {m['completed']}, "
                             f"cancelled {m['cancelled']}")
    if stats["used"] or stats["logical_blocks"] \
            or stats["available"] != stats["total"]:
        raise AssertionError(f"pool did not drain: {stats}")
    if m["chunk_steps"] == 0 or m["shared_admissions"] == 0 \
            or m["cow_copies"] == 0:
        raise AssertionError("chunk windows, prefix sharing and "
                             "copy-on-write must all have run")
    text = service_prometheus_text(svc)
    series = [line for line in text.splitlines()
              if line and not line.startswith("#")]
    for prefix in ("engine_", "pool_", "loop_", "scheduler_", "balancer_"):
        if not any(s.startswith(prefix) for s in series):
            raise AssertionError(f"no {prefix}* series in the exposition")
    print(f"prometheus: {len(series)} series, e.g.")
    for s in series:
        if s.split("{")[0] in ("engine_completed", "engine_cancelled",
                               "loop_ticks", "loop_plan_time_s",
                               "loop_commit_wait_s", "balancer_served",
                               "scheduler_completed", "pool_used"):
            print("   ", s)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "service_trace.json"
        n_events = tracer.write_chrome_trace(path)
        events = json.loads(path.read_text())["traceEvents"]
    pids = {e["pid"] for e in events}
    names = {e["name"] for e in events}
    need = {"request", "queued", "first_token", "plan-window", "commit-wait",
            "pool"}
    if not {PID_LOOP, PID_REQUESTS, PID_POOL} <= pids or not need <= names:
        raise AssertionError(f"trace tracks {pids}, events missing "
                             f"{need - names}")
    print(f"chrome trace: {n_events} events over the loop, request and "
          f"pool tracks ({tracer.dropped} dropped)")


def async_vs_sync(model, params, payloads):
    """The same requests submitted to an ``AsyncServeLoop`` before it
    starts (its own thread) and to a fresh engine's ``Scheduler.drain()``,
    both ``ServingEngine(B 8, max_seq 1024, use_kernel=True)`` on the
    card, priority policy: tokens identical, logprobs within 1e-5."""
    from repro_torch.serve.async_loop import AsyncServeLoop
    from repro_torch.serve.engine import Request, ServingEngine
    from repro_torch.serve.sampling import SamplingParams
    from repro_torch.serve.scheduler import Scheduler

    def requests():
        return [Request(rid=i, prompt=list(p["prompt"]), max_new_tokens=16,
                        priority=p["priority"],
                        sampling=SamplingParams(**p.get("sampling", {})))
                for i, p in enumerate(payloads)]

    def engine():
        return ServingEngine(model, params, batch_size=B, max_seq=STRIPE_T,
                             use_kernel=True)

    loop = AsyncServeLoop(Scheduler(engine(), policy="priority"))
    areqs = requests()
    handles = [loop.submit(r) for r in areqs]
    loop.start()
    try:
        for h in handles:
            if not h._done.wait(WAIT_S):
                raise AssertionError(f"async request {h.rid} never resolved")
            h.result()
    finally:
        loop.stop()
    sched = Scheduler(engine(), policy="priority")
    sreqs = requests()
    for r in sreqs:
        sched.submit(r)
    sched.drain()
    err = 0.0
    for a, s in zip(areqs, sreqs):
        if a.out_tokens != s.out_tokens:
            raise AssertionError(f"request {a.rid}: async {a.out_tokens} != "
                                 f"sync {s.out_tokens}")
        err = max(err, max(abs(x - y) for x, y in zip(a.out_logprobs,
                                                      s.out_logprobs)))
    print(f"{len(areqs)} requests: async streams identical to the "
          f"synchronous drain; max |logprob diff| {err:.3e} (tol 1e-5); "
          f"loop {loop.metrics['ticks']} ticks")
    if err > 1e-5:
        raise AssertionError(f"async vs sync logprobs differ by {err}")
    return err


SYNC_WARNING = "called a synchronizing CUDA operation"


def _decode_engine(model, params, vocab):
    """``ServingEngine(B 8, max_seq 1024, use_kernel)`` past admission:
    8 rows decoding, 4 of them sampled (temperature 0.7, top-k 0 / 50)."""
    from repro_torch.serve.engine import Request, ServingEngine
    from repro_torch.serve.sampling import SamplingParams
    eng = ServingEngine(model, params, batch_size=B, max_seq=STRIPE_T,
                        use_kernel=True)
    g = torch.Generator().manual_seed(SEED + 6)
    reqs = [Request(rid=i, prompt=torch.randint(2, vocab, (20 + 7 * i,),
                                                generator=g).tolist(),
                    max_new_tokens=64,
                    sampling=SamplingParams(temperature=0.7,
                                            top_k=50 if i % 4 == 1 else 0,
                                            seed=i) if i % 2
                    else SamplingParams()) for i in range(B)]
    if eng.add_requests(reqs) != B:
        raise AssertionError("the decode batch did not admit")
    for _ in range(3):
        eng.step()
    return eng


def _dispatch_syncs(eng):
    """One ``dispatch_step()`` under PyTorch's sync debug mode: (tick,
    host ms, the synchronising calls it reported)."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            tick = eng.dispatch_step()
            h_ms = (time.perf_counter() - t0) * 1e3
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return tick, h_ms, [str(w.message).splitlines()[0] for w in caught
                        if SYNC_WARNING in str(w.message)]


def check_dispatch(model, params, cfg):
    """``dispatch_step()`` never waits for the device. At full width (36
    layers, B 8, 4 sampled rows): PyTorch's sync debug mode reports no
    synchronising call in it; its host time beside the step's device
    time (profiler: kernel time of one dispatch + commit) and how long
    the stream stays busy after it returns. A step's ~3,400 launches
    overflow the device's launch queue behind any long spin, so the
    spin test runs at full width with depth cut to 2 layers (~400
    launches): behind a 0.5 s spin, dispatch returns while the card
    still spins. Returns (host ms, step device ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.model import build_model
    eng = _decode_engine(model, params, cfg.vocab_size)
    host = []
    for _ in range(3):
        torch.cuda.synchronize()
        tick, h_ms, syncs = _dispatch_syncs(eng)
        t_ret = time.perf_counter()
        while not torch.cuda.current_stream().query():
            pass
        tail_ms = (time.perf_counter() - t_ret) * 1e3
        tick.commit()
        host.append(h_ms)
        print(f"dispatch_step, 36 layers: host {h_ms:.3f} ms; the stream "
              f"stays busy {tail_ms:.3f} ms after it returns; "
              f"synchronising calls {len(syncs)}")
        for s_ in syncs[:3]:
            print("    sync:", s_[:160])
        if syncs:
            raise AssertionError("dispatch_step synchronised the stream")
    def profiled_step():
        """Device ms and device ops (kernels, copies) of one step."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eng.step()
        ops = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
        return (sum(e.self_device_time_total for e in ops) / 1e3,
                sum(e.count for e in ops))

    dev_ms, n_ops = profiled_step()
    print(f"dispatch_step median host {statistics.median(host):.3f} ms "
          f"against {dev_ms:.3f} ms of device time a step, {n_ops} device "
          f"ops (profiler)")
    del eng
    cfg2 = replace(cfg, n_layers=2)
    model2 = build_model(cfg2, device="cuda")
    eng = _decode_engine(model2, model2.init(SEED), cfg.vocab_size)
    print(f"2 layers: {profiled_step()[1]} device ops a step")
    spin_ms = 500.0
    for _ in range(3):
        torch.cuda.synchronize()
        torch.cuda._sleep(int(spin_ms * 1e-3 * SM_CLOCK_HZ))
        tick, h_ms, syncs = _dispatch_syncs(eng)
        spinning = not torch.cuda.current_stream().query()
        tick.commit()
        print(f"dispatch_step, 2 layers, behind a {spin_ms:.0f} ms spin: "
              f"host {h_ms:.3f} ms, returned while the card spun: "
              f"{spinning}; synchronising calls {len(syncs)}")
        if not spinning or h_ms >= spin_ms / 2 or syncs:
            raise AssertionError("dispatch_step waited for the device")
    return statistics.median(host), dev_ms


def run_launcher():
    """``python -m repro_torch.launch.serve --arch qwen3-4b --stream
    --trace-out`` on the card (reduced width) in a subprocess: ends with
    ``OK`` and writes a trace that parses."""
    import os
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        trace = Path(tmp) / "launcher_trace.json"
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                            "--arch", "qwen3-4b", "--stream", "--trace-out",
                            str(trace)], cwd=ROOT, env=env,
                           capture_output=True, text=True, timeout=600)
        lines = r.stdout.strip().splitlines()
        for line in lines[-6:]:
            print("   ", line[:200])
        if r.returncode != 0 or not lines or lines[-1] != "OK":
            print(r.stderr[-2000:], file=sys.stderr)
            raise AssertionError(f"launcher exited {r.returncode}")
        n = len(json.loads(trace.read_text())["traceEvents"])
    print(f"launcher: OK, trace of {n} events")


# ------------------------------------------------- speculative serving
SPEC_K = 4                      # draft tokens a verify window checks
DRAFT_LAYERS = 4                # the draft: the target's bottom layers
OPT_OUT = 4                     # the request that opts out (speculation 0)


def _layers(tree, n):
    """The first ``n`` layers of a tree of L-stacked tensors (views)."""
    return {k: _layers(v, n) if isinstance(v, dict) else v[:n]
            for k, v in tree.items()}


def bottom_layers_draft(cfg, params, n, build_model):
    """A draft cut from the target: its bottom ``n`` layers (block leaves
    sliced on the layer axis), embedding, final norm and head shared."""
    return (build_model(replace(cfg, n_layers=n), device="cuda"),
            dict(params, blocks=_layers(params["blocks"], n)))


def make_spec_requests(Request, SamplingParams, vocab, sampled=True):
    """Phase 4's 8 requests; the odd ones sampled (temperature 0.7,
    top-k 50 or 0), request OPT_OUT opted out of speculation."""
    reqs = make_requests(Request, vocab)
    for i, r in enumerate(reqs):
        if sampled and i % 2:
            r.sampling = SamplingParams(temperature=0.7,
                                        top_k=50 if i % 4 == 1 else 0,
                                        seed=i)
    reqs[OPT_OUT].speculation = 0
    return reqs


def expected_spec_launches(m, draft, L_target, L_draft, paged):
    """Launches a speculating serve owes each attention kernel: the
    target's paged kernel once per layer per step (plain, chunk and
    verify windows alike), its flash kernel once per layer per prefill
    call and (stripes) its decode kernel once per layer per plain decode
    step (chunk and verify windows are plain stripe windows); the
    draft's flash kernel once per layer per admission prefill call and
    its decode kernel once per layer per proposal step (its catch-up
    windows are plain stripe windows)."""
    plain = m["decode_steps"] - m["chunk_steps"] - m["verify_steps"]
    return {
        "paged_window_attention": L_target * m["decode_steps"] if paged
        else 0,
        "flash_attention": L_target * m["prefill_batches"]
        + L_draft * draft.admit_calls,
        "decode_attention": (0 if paged else L_target * plain)
        + L_draft * (draft.steps_run - draft.ingest_steps)}


def serve_spec(model, params, draft, dparams, reqs, paged, ServingEngine):
    eng = ServingEngine(model, params, batch_size=B, max_seq=STRIPE_T,
                        paged=paged, use_kernel=True, draft_model=draft,
                        draft_params=dparams, speculation=SPEC_K)
    done, wall = run_engine(eng, reqs)
    return eng, done, wall


def report_spec(eng, reqs, wall):
    """Acceptance, tokens per target step, tok/s and TTFT of a serve.
    Tokens per target step: every token after each request's first over
    the target's steps (all rows of the batch together); a speculating
    row's own yield is 1 + k x acceptance when no window was cut
    short."""
    m = eng.metrics
    n_tok = sum(len(r.out_tokens) for r in reqs)
    ttft = sorted(r.first_token_s - r.submitted_s for r in reqs)
    acc = m["spec_accepted"] / max(m["spec_proposed"], 1)
    per_step = (n_tok - len(reqs)) / max(m["decode_steps"], 1)
    print(f"{n_tok} tokens in {wall:.3f} s: {n_tok / wall:.1f} tok/s; TTFT "
          f"p50 {statistics.median(ttft):.3f} s, max {ttft[-1]:.3f} s; "
          f"acceptance {m['spec_accepted']}/{m['spec_proposed']} = "
          f"{acc:.3f}; {per_step:.3f} tokens per target step (all rows) "
          f"over {m['decode_steps']} steps ({m['verify_steps']} verify, "
          f"{m['chunk_steps']} chunk), a speculating row's "
          f"{1 + SPEC_K * acc:.3f}; blocks rolled back "
          f"{m['spec_blocks_rolled_back']}; draft calls "
          f"{eng.draft.steps_run} ({eng.draft.ingest_steps} catch-up "
          f"windows, {eng.draft.admit_calls} admission prefills)")


def streams_equal(a, b, what, lp_tol=0.0):
    """Token streams identical, logprobs within ``lp_tol`` (0: equal)."""
    err = 0.0
    for x, y in zip(a, b):
        if x.out_tokens != y.out_tokens:
            raise AssertionError(f"{what}, request {x.rid}: {x.out_tokens} "
                                 f"!= {y.out_tokens}")
        err = max([err] + [abs(p - q) for p, q in
                           zip(x.out_logprobs, y.out_logprobs)])
    if err > lp_tol:
        raise AssertionError(f"{what}: logprobs differ by {err}")
    return err


def check_spec_dispatch(eng, label):
    """``dispatch_step()`` of a speculative tick (draft catch-up, k draws,
    verify, acceptance) under PyTorch's sync debug mode: no synchronising
    call. Returns the median host ms."""
    host = []
    for _ in range(3):
        torch.cuda.synchronize()
        steps = eng.metrics["verify_steps"]
        tick, h_ms, syncs = _dispatch_syncs(eng)
        spec = eng.metrics["verify_steps"] == steps + 1
        tick.commit()
        host.append(h_ms)
        print(f"dispatch_step, {label}, speculative tick {spec}: host "
              f"{h_ms:.3f} ms; synchronising calls {len(syncs)}")
        for s_ in syncs[:3]:
            print("    sync:", s_[:160])
        if syncs or not spec:
            raise AssertionError("a speculative dispatch_step synchronised "
                                 "the stream (or did not speculate)")
    return statistics.median(host)


def spec_decode_engine(model, params, draft, dparams, vocab):
    """A speculating ``ServingEngine(B 8, max_seq 1024, use_kernel, k 4)``
    past admission: 8 rows decoding, 4 sampled (temperature 0.7)."""
    from repro_torch.serve.engine import Request, ServingEngine
    from repro_torch.serve.sampling import SamplingParams
    eng = ServingEngine(model, params, batch_size=B, max_seq=STRIPE_T,
                        use_kernel=True, draft_model=draft,
                        draft_params=dparams, speculation=SPEC_K)
    g = torch.Generator().manual_seed(SEED + 6)
    reqs = [Request(rid=i, prompt=torch.randint(2, vocab, (20 + 7 * i,),
                                                generator=g).tolist(),
                    max_new_tokens=96,
                    sampling=SamplingParams(temperature=0.7,
                                            top_k=50 if i % 4 == 1 else 0,
                                            seed=i) if i % 2
                    else SamplingParams()) for i in range(B)]
    if eng.add_requests(reqs) != B:
        raise AssertionError("the decode batch did not admit")
    eng.step()
    return eng


def moe_bound_ms(cfg):
    """The MoE FFN of one decode step's layer reads every expert's
    weights once (B 8 top-2 tokens reach every expert): bytes over
    HBM bandwidth."""
    nmat = 3 if cfg.act in ("swiglu", "geglu") else 2
    es = torch.finfo(cfg.dtype).bits // 8
    nbytes = cfg.n_experts * nmat * cfg.d_model * cfg.moe_d_ff * es
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes


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
    from repro_torch.kernels.decode_attention import kernel as dec_kernel
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention, sharded_decode_attention)
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.flash_attention.ops import (attention_bshd,
                                                         flash_attention)
    from repro_torch.kernels.paged_attention import kernel as pw_kernel
    from repro_torch.kernels.paged_attention.ops import paged_window_attention
    from repro_torch.kernels.paged_attention.ref import (
        paged_window_attention_ref)
    from repro_torch.kernels.rwkv_scan import kernel as wkv_kernel
    from repro_torch.kernels.rwkv_scan.ops import wkv
    from repro_torch.kernels.ssm_scan import kernel as ssm_kernel
    from repro_torch.kernels.ssm_scan.ops import selective_scan
    from repro_torch.models.model import build_model
    from repro_torch.serve import prng, sampling
    from repro_torch.serve.engine import Request, ServingEngine

    phase("2. build")
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"built {len(libs)} CUDA source(s) in "
          f"{time.perf_counter() - t0:.1f} s")
    tool_dir = Path(_build.nvcc()).parent
    print_ptxas(_build.BUILD_DIR, tool_dir)
    print_sass_checks(libs, tool_dir)

    phase("3. kernels vs plain versions on the card (TF32 off)")
    max_err = check_kernel_vs_plain(paged_window_attention)
    wkv_err = max(
        check_scan_vs_plain("wkv_scan", wkv, wkv_case, [
            (8, 1, 32, 64), (1, PREFILL_T, 32, 64), (4, 64, 4, 32)]),
        check_scan_vs_plain(
            "wkv_scan, model-range decays", wkv,
            partial(wkv_case, decays="model"), [
                (8, 1, 32, 64), (1, PREFILL_T, 32, 64), (2, 17, 32, 64),
                (2, 64, 32, 64)]))
    ssm_err = check_scan_vs_plain("ssm_scan", selective_scan, ssm_case, [
        (8, 1, 3200, 16), (1, PREFILL_T, 3200, 16), (4, 64, 512, 16)])
    flash_err = check_flash_vs_plain(flash_attention, attention_bshd)
    dec_err = max(check_decode_vs_plain(decode_attention,
                                        sharded_decode_attention),
                  check_decode_split_edges(decode_attention))
    check_sampler(sampling, prng)

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
    paged_fns = (pw_kernel.paged_window_attention,
                 flash_kernel.flash_attention)
    for fn in paged_fns:
        fn.launches = 0
    eng, reqs, done, wall = serve(cfg, params, model, ServingEngine, Request,
                                  use_kernel=True)
    paged_launches = {fn.__name__: fn.launches for fn in paged_fns}
    check_outputs(reqs, done, cfg.vocab_size)
    m = eng.metrics
    print("metrics:", json.dumps(m))
    print("pool:", json.dumps(eng.pool_stats()))
    n_tok = sum(len(r.out_tokens) for r in reqs)
    lat = sorted(r.latency_s for r in reqs)
    print(f"{n_tok} tokens in {wall:.3f} s: {n_tok / wall:.1f} tok/s; "
          f"latency p50 {statistics.median(lat):.3f} s, max {lat[-1]:.3f} s")
    check_launches(paged_fns, paged_launches, cfg, m)
    if m["chunk_steps"] == 0 or m["shared_admissions"] == 0 \
            or m["cow_copies"] == 0:
        raise AssertionError("chunk windows, prefix sharing and "
                             "copy-on-write must all have run")
    stats = eng.pool_stats()
    if stats["used"] or stats["available"] != stats["total"] \
            or stats["logical_blocks"]:
        raise AssertionError(f"pool did not drain: {stats}")
    decode_bases = [len(r.prompt) + len(r.out_tokens) - 1 for r in reqs]
    profile_serve(lambda: serve(cfg, params, model, ServingEngine, Request,
                                use_kernel=True)[::3])
    del eng

    phase("4b. serve full-width qwen3-4b through the LM service, bf16, "
          "paged, use_kernel=True")
    payloads = service_payloads(cfg.vocab_size)
    for fn in paged_fns:
        fn.launches = 0
    eng, wall, svc, tracer, results, ttft = run_service(model, params,
                                                        payloads)
    svc_launches = {fn.__name__: fn.launches for fn in paged_fns}
    m = eng.metrics
    print("metrics:", json.dumps(m))
    print("pool:", json.dumps(eng.pool_stats()))
    check_service(eng, svc, tracer, results, payloads, cfg.vocab_size)
    check_launches(paged_fns, svc_launches, cfg, m)
    loop_m = svc.replicas[0].handler.loop.metrics
    n_tok = sum(len(reply["tokens"]) for _, reply, _ in results.values())
    firsts = sorted(ttft.values())
    print(f"{len(payloads)} payloads from {CLIENTS} client threads "
          f"({sum(1 for p in payloads if 'sampling' in p)} sampled, one "
          f"cancelled after its first token): {n_tok} tokens in {wall:.3f} "
          f"s: {n_tok / wall:.1f} tok/s; TTFT p50 "
          f"{statistics.median(firsts):.3f} s, max {firsts[-1]:.3f} s; loop "
          f"{loop_m['ticks']} ticks, {loop_m['planned']} admissions "
          f"planned in flight, plan_time_s {loop_m['plan_time_s']:.4f}, "
          f"commit_wait_s {loop_m['commit_wait_s']:.4f}; copy-on-write "
          f"copies {m['cow_copies']}")
    if not loop_m["plan_time_s"] > 0:
        raise AssertionError("the loop's plan window measured nothing")
    del eng, svc, tracer
    profile_serve(lambda: run_service(model, params, payloads)[:2])

    phase("4c. async loop vs synchronous drain on the card, full width")
    async_vs_sync(model, params, payloads)

    phase("4d. dispatch_step does not wait for the device")
    check_dispatch(model, params, cfg)
    del params, model
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

    phase("6. serve full-width qwen3-4b, rwkv6-1.6b and hymba-1.5b, bf16, "
          "stripes")
    flash_fn, dec_fn = flash_kernel.flash_attention, dec_kernel.decode_attention
    stripe_launches, decode_lens = {}, {}
    for arch, fns, make_reqs in (
            ("qwen3-4b", (flash_fn, dec_fn), make_requests),
            ("rwkv6-1.6b", (wkv_kernel.wkv_scan,), make_recurrent_requests),
            ("hymba-1.5b", (ssm_kernel.ssm_scan, flash_fn, dec_fn),
             make_recurrent_requests)):
        print(f"--- {arch}")
        stripe_launches[arch], served = serve_stripes(
            arch, fns, make_reqs, get_config, build_model, ServingEngine,
            Request)
        # n_valid of each of the first 8 requests at its last decode
        decode_lens[arch] = [len(r.prompt) + len(r.out_tokens) - 1
                             for r in served[:B]]
        torch.cuda.empty_cache()
    # launches on the served paths, each counted from 0 over its serve
    serve_launches = {}
    for counts in (paged_launches, svc_launches,
                   *stripe_launches.values()):
        for name, n in counts.items():
            serve_launches[name] = serve_launches.get(name, 0) + n
    print("launches summed over the serves:", json.dumps(serve_launches))

    phase("7. recurrent kernel path vs plain path, full width, f32, "
          "2 layers, card vs CPU")
    for arch in ("rwkv6-1.6b", "hymba-1.5b"):
        recurrent_card_vs_cpu(arch, get_config, build_model, ServingEngine,
                              Request)
        torch.cuda.empty_cache()

    phase("8. the launcher: python -m repro_torch.launch.serve --arch "
          "qwen3-4b --stream --trace-out, reduced width, on the card")
    run_launcher()

    phase("9. speculative serve of full-width qwen3-4b, bf16, k = 4, a "
          f"{DRAFT_LAYERS}-layer draft, paged and stripes")
    from repro_torch.models import moe
    from repro_torch.serve.sampling import SamplingParams
    model = build_model(cfg, device="cuda")
    params = model.init(SEED)
    draft, dparams = bottom_layers_draft(cfg, params, DRAFT_LAYERS,
                                         build_model)
    spec_fns = (pw_kernel.paged_window_attention,
                flash_kernel.flash_attention, dec_kernel.decode_attention)
    spec_launches = {}
    for paged in (True, False):
        layout = "paged" if paged else "stripes"
        print(f"--- {layout}")
        runs = []

        def run(paged=paged, runs=runs):
            reqs = make_spec_requests(Request, SamplingParams,
                                      cfg.vocab_size)
            eng, done, wall = serve_spec(model, params, draft, dparams, reqs,
                                         paged, ServingEngine)
            check_outputs(reqs, done, cfg.vocab_size)
            runs.append(reqs)
            return eng, done, wall

        for fn in spec_fns:
            fn.launches = 0
        eng, done, wall = run()
        got = {fn.__name__: fn.launches for fn in spec_fns}
        m, stats = eng.metrics, eng.pool_stats()
        print("metrics:", json.dumps(m))
        print("pool:", json.dumps(stats))
        report_spec(eng, runs[0], wall)
        want = expected_spec_launches(m, eng.draft, cfg.n_layers,
                                      DRAFT_LAYERS, paged)
        print(f"launches {json.dumps(got)} = rule {json.dumps(want)} "
              f"(target {cfg.n_layers} layers, draft {DRAFT_LAYERS})")
        ran = [n for n in want if paged or n != "paged_window_attention"]
        if got != want or min(got[n] for n in ran) <= 0:
            raise AssertionError(f"{layout}: launches {got} != {want}")
        if m["verify_steps"] <= 0 or m["spec_proposed"] <= 0:
            raise AssertionError(f"{layout}: no speculation ran")
        if stats["paged"] and (stats["used"] or stats["logical_blocks"]) \
                or not stats["paged"] and stats["active"]:
            raise AssertionError(f"{layout}: the cache did not drain: "
                                 f"{stats}")
        for name, n in got.items():
            spec_launches[name] = spec_launches.get(name, 0) + n
        profile_serve(lambda: run()[::2])            # the second run
        streams_equal(runs[0], runs[1], f"{layout}: two runs")
        print(f"{layout}: two runs identical (tokens and logprobs), "
              f"sampled rows included")
        del eng
    spec_host_ms = check_spec_dispatch(
        spec_decode_engine(model, params, draft, dparams, cfg.vocab_size),
        f"{cfg.n_layers} layers + a {DRAFT_LAYERS}-layer draft")
    print(f"speculative dispatch_step median host {spec_host_ms:.3f} ms")
    del model, params, draft, dparams
    torch.cuda.empty_cache()

    phase("9b. speculative vs plain decode on the card, full width, f32, "
          "4 layers")
    model32 = build_model(cfg32, device="cuda")
    params32 = model32.init(SEED)
    draft2 = bottom_layers_draft(cfg32, params32, 2, build_model)
    for paged in (True, False):
        layout = "paged" if paged else "stripes"
        base = make_requests(Request, cfg32.vocab_size)
        eng = ServingEngine(model32, params32, batch_size=B,
                            max_seq=STRIPE_T, paged=paged, use_kernel=True)
        check_outputs(base, run_engine(eng, base)[0], cfg32.vocab_size)
        for tag, (dm, dp) in (("self-draft", (model32, params32)),
                              ("2-layer draft", draft2)):
            reqs = make_spec_requests(Request, SamplingParams,
                                      cfg32.vocab_size, sampled=False)
            eng, done, wall = serve_spec(model32, params32, dm, dp, reqs,
                                         paged, ServingEngine)
            check_outputs(reqs, done, cfg32.vocab_size)
            err = streams_equal(reqs, base, f"{layout} {tag} vs plain",
                                lp_tol=1e-3)
            m = eng.metrics
            print(f"{layout}, {tag}: token streams equal plain decode's; "
                  f"max |logprob diff| {err:.3e} (tol 1e-3); acceptance "
                  f"{m['spec_accepted']}/{m['spec_proposed']}, "
                  f"{m['verify_steps']} verify steps")
            if tag == "self-draft" and m["spec_accepted"] <= 0:
                raise AssertionError("the self-draft accepted nothing")
    check_spec_dispatch(spec_decode_engine(model32, params32, model32,
                                           params32, cfg32.vocab_size),
                        "4 layers f32, self-draft")
    del model32, params32, draft2, eng
    torch.cuda.empty_cache()

    phase("10. MoE serve of full-width grok-1-314b, 2 layers, bf16, paged, "
          "use_kernel=True")
    gcfg = replace(get_config("grok-1-314b"), n_layers=2)
    gmodel = build_model(gcfg, device="cuda")
    t0 = time.perf_counter()
    gparams = gmodel.init(SEED)
    torch.cuda.synchronize()
    print(f"d {gcfg.d_model}, {gcfg.n_heads} / {gcfg.n_kv_heads} heads of "
          f"{gcfg.hd}, {gcfg.n_experts} experts top-{gcfg.top_k}, moe_d_ff "
          f"{gcfg.moe_d_ff}, vocab {gcfg.vocab_size}: "
          f"{sum(t.numel() for t in _leaves(gparams)) / 1e9:.3f} B params, "
          f"{sum(t.numel() * t.element_size() for t in _leaves(gparams)) / 1e9:.2f}"
          f" GB, init {time.perf_counter() - t0:.1f} s")

    def grok_serve():
        eng = ServingEngine(gmodel, gparams, batch_size=B, max_seq=STRIPE_T,
                            use_kernel=True)
        reqs = make_requests(Request, gcfg.vocab_size)
        done, wall = run_engine(eng, reqs)
        check_outputs(reqs, done, gcfg.vocab_size)
        return eng, reqs, wall

    for fn in paged_fns:
        fn.launches = 0
    eng, reqs, wall = grok_serve()
    moe_launches = {fn.__name__: fn.launches for fn in paged_fns}
    m, stats = eng.metrics, eng.pool_stats()
    print("metrics:", json.dumps(m))
    print("pool:", json.dumps(stats))
    n_tok = sum(len(r.out_tokens) for r in reqs)
    print(f"{n_tok} tokens in {wall:.3f} s: {n_tok / wall:.1f} tok/s")
    check_launches(paged_fns, moe_launches, gcfg, m)
    if not (m["prefill_batches"] == m["prefills"] == len(reqs)) \
            or m["shared_admissions"] or m["chunk_steps"]:
        raise AssertionError("MoE admission must prefill one request a "
                             "call, share nothing and never chunk")
    if stats["used"] or stats["logical_blocks"]:
        raise AssertionError(f"pool did not drain: {stats}")
    profile_serve(lambda: grok_serve()[::2])
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32,
                        device="cuda")
    p0 = {k: v[0] for k, v in gparams["blocks"]["moe"].items()}
    x = torch.randn((B, 1, gcfg.d_model), generator=torch.Generator(
        device="cuda").manual_seed(7), device="cuda").to(gcfg.dtype)
    moe_ms = time_ms(lambda: moe.moe_ffn(x, p0, gcfg), flush, iters=10,
                     warmup=2)
    moe_b_ms, moe_bytes = moe_bound_ms(gcfg)
    print(f"MoE FFN at decode (B {B}, one layer): {moe_ms:.4f} ms device "
          f"time, bound {moe_b_ms:.4f} ms ({moe_bytes / 1e9:.2f} GB of "
          f"expert weights at {HBM_BYTES_PER_S / 1e12:.2f} TB/s); per decode "
          f"step ({gcfg.n_layers} layers) {moe_ms * gcfg.n_layers:.4f} ms, "
          f"bound {moe_b_ms * gcfg.n_layers:.4f} ms")
    del eng, gparams, gmodel, p0, x, flush
    torch.cuda.empty_cache()
    g32 = replace(gcfg, n_layers=1, dtype=torch.float32)
    gmodel32 = build_model(g32, device="cuda")
    gparams32 = gmodel32.init(SEED)
    _, rk, dk, wk = serve(g32, gparams32, gmodel32, ServingEngine, Request,
                          use_kernel=True)
    _, rp, dp, wp = serve(g32, gparams32, gmodel32, ServingEngine, Request,
                          use_kernel=False)
    check_outputs(rk, dk, g32.vocab_size)
    check_outputs(rp, dp, g32.vocab_size)
    err = streams_equal(rk, rp, "grok 1 layer f32 kernel vs plain",
                        lp_tol=1e-3)
    print(f"grok-1-314b, 1 layer, f32: kernel path token streams identical "
          f"to the plain path's; max |logprob diff| {err:.3e} (tol 1e-3); "
          f"kernel run {wk:.3f} s, plain run {wp:.3f} s")
    del gmodel32, gparams32
    torch.cuda.empty_cache()
    for counts in (spec_launches, moe_launches):
        for name, n in counts.items():
            serve_launches[name] = serve_launches.get(name, 0) + n
    print("launches summed over the serves:", json.dumps(serve_launches))

    phase("timing at the shape of each serve")
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
    # the verify window (S 5, qwen3-4b's heads) and decode at the head
    # dims off the power-of-two grid (B 8, each at the decode bases)
    for key, S, heads in (("verify", VERIFY_S, (HQ, HKV, HD)),
                          ("hd112", 1, ODD_HEADS[0]),
                          ("hd192", 1, ODD_HEADS[1])):
        args = window_case(S, torch.bfloat16, decode_bases, seed=11,
                           heads=heads)
        k_ms = time_ms(lambda: paged_window_attention(*args), flush)
        p_ms = time_ms(lambda: paged_window_attention_ref(*args), flush)
        l_ms = time_ms(sdpa_on_gathered(*args), flush)
        b_ms, b_by = bound(args[0], args[4], S, torch.bfloat16,
                           Hkv=heads[1])
        timings[key] = (k_ms, p_ms, l_ms, b_ms, b_by)
        print(f"{key}: S={S} Hq {heads[0]} Hkv {heads[1]} hd {heads[2]} "
              f"bases {decode_bases}: kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms, sdpa on gathered KV {l_ms:.4f} ms, bound "
              f"{b_ms:.5f} ms ({b_by})")
    scans = {}
    for name, op, case, bound_fn, shapes in (
            ("wkv_scan", wkv, wkv_case, wkv_bound,
             ((B, 1, 32, 64), (1, PREFILL_T, 32, 64), COBATCH_WKV)),
            ("ssm_scan", selective_scan, ssm_case, ssm_bound,
             ((B, 1, 3200, 16), (1, PREFILL_T, 3200, 16)))):
        for shape in shapes:
            if name == "wkv_scan":
                print(f"wkv_scan {shape}: {wkv_kernel.plan(*shape)}")
            args = case(*shape, seed=11)
            k_ms = time_ms(lambda: op(*args), flush)
            p_ms = time_ms(lambda: op(*args, force_ref=True), flush)
            b_ms, b_by = bound_fn(*shape)
            scans.setdefault(name, []).append((k_ms, p_ms, b_ms, b_by))
            print(f"{name} {shape}: kernel {k_ms:.4f} ms, plain "
                  f"{p_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}), latency "
                  f"floor of {shape[1]} dependent steps "
                  f"{step_floor_ms(shape[1]):.5f} ms")
    F = torch.nn.functional
    Hq, Hkv, hd = HEAD_SHAPES[0]
    g = torch.Generator().manual_seed(12)
    q = torch.randn((1, PREFILL_T, Hq, hd), generator=g).to("cuda",
                                                            torch.bfloat16)
    kv = torch.randn((1, PREFILL_T, 2, Hkv, hd), generator=g).to(
        "cuda", torch.bfloat16)
    k, v = kv[:, :, 0], kv[:, :, 1]          # the model's prefill views
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    f_ms = time_ms(lambda: attention_bshd(q, k, v), flush)
    fp_ms = time_ms(lambda: attention_bshd(q, k, v, force_ref=True), flush)
    fl_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), flush)
    fb_ms, fb_by = flash_bound(1, Hq, Hkv, PREFILL_T, PREFILL_T, hd,
                               torch.bfloat16)
    print(f"flash B 1 S = T = {PREFILL_T} Hq {Hq} Hkv {Hkv} hd {hd} bf16: "
          f"kernel {f_ms:.4f} ms, plain {fp_ms:.4f} ms, sdpa (causal) "
          f"{fl_ms:.4f} ms, bound {fb_ms:.5f} ms ({fb_by})")
    # the same call at S = T = 16 (one tile), and one tiny elementwise
    # kernel: what a launch costs this timing before any work
    q16, k16, v16 = (t[:, :16] for t in (q, k, v))
    qt16, kt16, vt16 = (t[:, :, :16].contiguous() for t in (qt, kt, vt))
    f16_ms = time_ms(lambda: attention_bshd(q16, k16, v16), flush)
    fl16_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt16, kt16, vt16, is_causal=True, enable_gqa=True), flush)
    tiny = torch.zeros(16, device="cuda")
    tiny_ms = time_ms(lambda: tiny.add_(1), flush)
    print(f"flash at S = T = 16: kernel {f16_ms:.4f} ms, sdpa {fl16_ms:.4f} "
          f"ms; one 16-element add {tiny_ms:.4f} ms")
    # grok-1-314b's prefill: 48 query heads over 8 KV heads (G 6)
    gq = torch.randn((1, PREFILL_T, 48, hd), generator=g).to(
        "cuda", torch.bfloat16)
    gqt = gq.transpose(1, 2).contiguous()
    fg_ms = time_ms(lambda: attention_bshd(gq, k, v), flush)
    fgp_ms = time_ms(lambda: attention_bshd(gq, k, v, force_ref=True), flush)
    fgl_ms = time_ms(lambda: F.scaled_dot_product_attention(
        gqt, kt, vt, is_causal=True, enable_gqa=True), flush)
    fgb_ms, fgb_by = flash_bound(1, 48, Hkv, PREFILL_T, PREFILL_T, hd,
                                 torch.bfloat16)
    print(f"flash B 1 S = T = {PREFILL_T} Hq 48 Hkv {Hkv} hd {hd} (G 6) "
          f"bf16: kernel {fg_ms:.4f} ms, plain {fgp_ms:.4f} ms, sdpa "
          f"(causal) {fgl_ms:.4f} ms, bound {fgb_ms:.5f} ms ({fgb_by})")
    time_sampler(sampling)
    dec_times = {}
    for arch, (Hq, Hkv, hd) in (("hymba-1.5b", HEAD_SHAPES[1]),
                                ("qwen3-4b", HEAD_SHAPES[0])):
        dec_times[arch] = time_decode(decode_attention, flush, Hq, Hkv, hd,
                                      decode_lens[arch])
    k_ms, p_ms, l_ms, b_ms, b_by = timings[1]
    w_ms, wp_ms, wl_ms, wb_ms, wb_by = timings[64]
    rows = [{
        "name": "paged_window_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/paged_attention/csrc/"
                  "paged_window.cu",
        "replaces": "src/repro/kernels/paged_attention/kernel.py:148",
        "launches": serve_launches["paged_window_attention"],
        "max_abs_err": max_err, "max_err": max_err,
        "ms": k_ms, "kernel_ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": l_ms, "window_ms": w_ms,
        "window_plain_ms": wp_ms, "window_library_ms": wl_ms,
        "window_bound_ms": wb_ms, "window_bound_by": wb_by}]
    for key in ("verify", "hd112", "hd192"):
        k_ms, p_ms, l_ms, b_ms, b_by = timings[key]
        rows[0].update({f"{key}_ms": k_ms, f"{key}_plain_ms": p_ms,
                        f"{key}_library_ms": l_ms, f"{key}_bound_ms": b_ms,
                        f"{key}_bound_by": b_by})
    for name, source, replaces, err in (
            ("wkv_scan", "rwkv_scan/csrc/wkv.cu", "rwkv_scan/kernel.py:29",
             wkv_err),
            ("ssm_scan", "ssm_scan/csrc/ssm_scan.cu", "ssm_scan/kernel.py:36",
             ssm_err)):
        (k_ms, p_ms, b_ms, b_by), (pk_ms, pp_ms, pb_ms, pb_by) = \
            scans[name][:2]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/{source}",
            "replaces": f"src/repro/kernels/{replaces}",
            "launches": serve_launches[name], "max_abs_err": err,
            "max_err": err, "ms": k_ms, "kernel_ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "prefill_ms": pk_ms, "prefill_plain_ms": pp_ms,
            "prefill_bound_ms": pb_ms, "prefill_bound_by": pb_by})
    for name, source, replaces, err, times in (
            ("flash_attention", "flash_attention/csrc/flash.cu",
             "flash_attention/kernel.py:24", flash_err,
             (f_ms, fp_ms, fb_ms, fb_by, fl_ms)),
            ("decode_attention", "decode_attention/csrc/decode.cu",
             "decode_attention/kernel.py:29", dec_err,
             dec_times["hymba-1.5b"][:5])):
        k_ms, p_ms, b_ms, b_by, l_ms = times
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/{source}",
            "replaces": f"src/repro/kernels/{replaces}",
            "launches": serve_launches[name], "max_abs_err": err,
            "max_err": err, "ms": k_ms, "kernel_ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": l_ms})
    ck_ms, cp_ms, cb_ms, cb_by = scans["wkv_scan"][2]
    next(r for r in rows if r["name"] == "wkv_scan").update(
        cobatch_ms=ck_ms, cobatch_plain_ms=cp_ms, cobatch_bound_ms=cb_ms,
        cobatch_bound_by=cb_by)
    next(r for r in rows if r["name"] == "flash_attention").update(
        s16_ms=f16_ms, s16_library_ms=fl16_ms, tiny_op_ms=tiny_ms,
        grok_ms=fg_ms, grok_plain_ms=fgp_ms, grok_library_ms=fgl_ms,
        grok_bound_ms=fgb_ms, grok_bound_by=fgb_by)
    q_ms, qp_ms, qb_ms, qb_by, ql_ms, qf_ms = dec_times["qwen3-4b"]
    next(r for r in rows if r["name"] == "decode_attention").update(
        floor_ms=dec_times["hymba-1.5b"][5], qwen3_ms=q_ms,
        qwen3_plain_ms=qp_ms, qwen3_bound_ms=qb_ms, qwen3_bound_by=qb_by,
        qwen3_library_ms=ql_ms, qwen3_floor_ms=qf_ms)
    print(json.dumps({"kernels": rows}))
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
