"""Serving launcher of the port: slot-native continuous-batching engine
for one architecture, behind an SLO-aware scheduler.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \
        [--requests 6] [--batch 4] [--max-new 8] [--policy spf] \
        [--stream] [--trace-out PATH] [--device cuda|cpu]

Serves synthetic token requests (prompts from a seeded
``torch.Generator``) through the mixed-length engine on the reduced
config of the architecture, in f32, with random weights from seed 0. It
runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import statistics
import time

import torch

from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.models.model import build_model
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.serve.scheduler import POLICIES, Scheduler


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b", choices=ARCH_IDS)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--policy", default="fifo", choices=POLICIES)
    ap.add_argument("--slo-ms", type=float, default=0.0,
                    help="per-request deadline; 0 = no SLO")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked-prefill width (default: engine auto; "
                         "0 = monolithic admission)")
    ap.add_argument("--prefill-budget", type=int, default=None,
                    help="per-tick prefill token budget (chunk "
                         "continuation + new admissions)")
    ap.add_argument("--stream", action="store_true",
                    help="serve through the async dispatch/plan-ahead/"
                         "commit loop with per-token streaming (reports "
                         "TTFT and host/device overlap)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="record request lifecycles, tick phases, and "
                         "pool events to a Chrome trace-event JSON "
                         "(open in Perfetto / chrome://tracing)")
    ap.add_argument("--device", default="cuda",
                    help="where the model and the engine run")
    args = ap.parse_args()

    tracer = None
    if args.trace_out:
        from repro_torch.serve.telemetry import Tracer
        tracer = Tracer()

    cfg = get_config(args.arch).reduced()
    model = build_model(cfg, device=args.device)
    params = model.init(0)
    eng = ServingEngine(model, params, batch_size=args.batch,
                        max_seq=args.max_seq,
                        prefill_chunk=args.prefill_chunk,
                        prefill_budget=args.prefill_budget,
                        tracer=tracer, device=args.device)

    sched = Scheduler(eng, policy=args.policy,
                      prefill_budget=args.prefill_budget)

    gen = torch.Generator().manual_seed(1)
    reqs = []
    for i in range(args.requests):
        # mixed prompt lengths exercise per-slot decode
        plen = max(2, args.prompt_len - (i % 4) * 2)
        prompt = torch.randint(2, cfg.vocab_size, (plen,),
                               generator=gen).tolist()
        deadline = (time.perf_counter() + args.slo_ms / 1e3
                    if args.slo_ms else None)
        reqs.append(Request(rid=i, prompt=prompt, deadline_s=deadline,
                            max_new_tokens=args.max_new))

    print(f"serving {args.requests} requests on {args.arch} "
          f"({cfg.family}, reduced, {args.device}) — engine batch "
          f"{args.batch}, "
          f"policy {args.policy}"
          + (" — async streaming loop" if args.stream else ""))
    if args.stream:
        from repro_torch.serve.async_loop import AsyncServeLoop
        loop = AsyncServeLoop(sched, name=f"{args.arch}/0")
        ttft: dict = {}
        handles = []
        for r in reqs:
            def _first(tok, logp, rid=r.rid, t0=time.perf_counter()):
                ttft.setdefault(rid, time.perf_counter() - t0)
            handles.append(loop.submit(r, _first))
        done = []
        for h in handles:
            try:
                loop.wait(h)
                done.append(h.request)
            except Exception as e:  # shed / queue full
                print(f"  req {h.rid}: {e}")
        if ttft:
            print(f"TTFT p50={statistics.median(ttft.values())*1e3:.0f}ms "
                  f"max={max(ttft.values())*1e3:.0f}ms; "
                  f"loop: {loop.metrics['ticks']} ticks, "
                  f"{loop.metrics['planned']} admissions planned in-flight "
                  f"(plan {loop.metrics['plan_time_s']*1e3:.0f}ms hidden "
                  f"behind {loop.metrics['commit_wait_s']*1e3:.0f}ms of "
                  f"device wait)")
    else:
        for r in reqs:
            sched.submit(r)
        done = sched.drain()
    lats = [r.latency_s for r in done]
    toks = sum(len(r.out_tokens) for r in done)
    if lats:
        print(f"completed {len(done)}; {toks} tokens; "
              f"latency p50={statistics.median(lats)*1e3:.0f}ms "
              f"max={max(lats)*1e3:.0f}ms; "
              f"queue wait mean={sched.stats.mean_queue_wait_s()*1e3:.0f}ms")
    else:
        print("completed 0 (all requests shed past their deadline)")
    print(f"engine metrics: {eng.metrics}")
    if args.slo_ms:
        print(f"SLO: hits={sched.stats.slo_hits} "
              f"misses={sched.stats.slo_misses} shed={sched.stats.shed} "
              f"rejected={sched.stats.rejected}")
    for r in done[:3]:
        print(f"  req {r.rid}: out={r.out_tokens}")
    assert len(done) + sched.stats.shed + sched.stats.rejected \
        == args.requests
    if tracer is not None:
        n = tracer.write_chrome_trace(args.trace_out)
        print(f"trace: {n} events -> {args.trace_out}"
              + (f" ({tracer.dropped} dropped)" if tracer.dropped else ""))
    print("OK")


if __name__ == "__main__":
    main()
