"""End-to-end serving driver: the paper's full production deployment
(§3.3 / §4.3) on the port, serving a batch of CV-parse requests.

    PYTHONPATH=src python -m repro_torch.examples.serve_parallel_pipeline \
        [--docs 40] [--replicas 3] [--fail-rate 0.08] [--clients 4] \
        [--lm | --no-lm] [--device cuda|cpu]

What it stands up, in the paper's startup order (supervisord priorities):
    0  tika            text extraction
    1  bert            sentence encoder + sectioning classifier
    2  5x section PaaS each with N replicas (1 backup) behind an
                       NGINX-style round-robin balancer, fault-injected
    3  cv_parser       the front-end that fans out in parallel

Then it serves a corpus with concurrent clients, kills a replica mid-run
to show failover (max_fails / fail_timeout / backup promotion), and
prints Table-6-style stage statistics and the parallel-vs-sequential
comparison. It fails unless every request was served.

With ``--lm`` (default on) a slot-native LM PaaS joins the deployment:
two engine replicas behind a least-loaded balancer, each running the
mixed-length continuous-batching engine (paged, through the paged-window
kernel on the card) with an SLO-aware scheduler — the LM analogue of the
paper's per-section NER services.
"""
from __future__ import annotations

import argparse
import dataclasses
import random
import statistics
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from repro_torch.configs.base import get_config
from repro_torch.core import cvdata, router
from repro_torch.core.balancer import deploy
from repro_torch.core.parallel import ParallelDispatcher
from repro_torch.core.pipeline import CVParser, NERModel
from repro_torch.core.services import Replica, Service
from repro_torch.core.supervisor import Supervisor
from repro_torch.models.model import build_model
from repro_torch.serve.service import make_lm_service


def build_deployment(n_replicas: int, fail_rate: float, *, device="cuda",
                     ners=None):
    """The paper's cluster: every PaaS on ``n_replicas`` machines (last one
    backup), upstreamed behind a balancer, under a supervisor. ``ners``
    ({service: NERModel}) default to random weights drawn in
    ``router.ROUTES`` order from one ``torch.Generator(device)`` seeded
    0; the parser's encoder and classifier come from seed 1."""
    sup = Supervisor()
    sup.add(Service("tika", replicas=[Replica("tika/0", lambda p: p)],
                    priority=0))
    sup.add(Service("bert", replicas=[Replica("bert/0", lambda p: p)],
                    priority=1, depends_on=("tika",)))

    if ners is None:
        gen = torch.Generator(device=device).manual_seed(0)
        ners = {name: NERModel.create(name, gen, device=device)
                for name in router.ROUTES}
    services = {}
    for name in router.ROUTES:
        reps = [Replica(f"{name}/{r}", ners[name],
                        backup=(r == n_replicas - 1 and n_replicas > 1),
                        fail_rate=fail_rate)
                for r in range(n_replicas)]
        svc = Service(name, replicas=reps, priority=2, depends_on=("bert",))
        deploy(svc, max_fails=3, fail_timeout=2.0)
        services[name] = sup.add(svc)

    parser = CVParser.create(
        1, services=services, device=device,
        dispatcher=ParallelDispatcher(mode="thread", max_workers=16,
                                      rng=random.Random(7)))
    sup.add(Service("cv_parser", replicas=[Replica("cv/0", parser.parse)],
                    priority=3, depends_on=tuple(services)))
    return sup, parser, services


def lm_prompts(vocab_size: int) -> list:
    """The LM PaaS's 6 mixed-length prompts (5, 9 or 13 tokens)."""
    rng = random.Random(11)
    return [[rng.randrange(2, vocab_size)
             for _ in range(rng.choice([5, 9, 13]))] for _ in range(6)]


def run_lm_paas(sup: Supervisor, *, device="cuda", cfg=None, params=None):
    """Slot-native LM serving as one more PaaS under the supervisor:
    2 engine replicas, least-loaded upstream, deadline scheduling.
    ``cfg`` defaults to reduced qwen3-4b in f32, ``params`` to random
    weights from seed 9. Returns (the service, its replies in order)."""
    if cfg is None:
        cfg = dataclasses.replace(get_config("qwen3-4b").reduced(),
                                  dtype=torch.float32)
    model = build_model(cfg, device=device)
    if params is None:
        params = model.init(9)
    svc = make_lm_service("lm_summarizer", model, params, n_replicas=2,
                          batch_size=2, max_seq=64, policy="deadline",
                          balancer_policy="least_loaded", with_backup=False,
                          supervisor=sup, priority=2, use_kernel=True,
                          device=device)
    svc.start()

    lat, outs = [], []
    for prompt in lm_prompts(cfg.vocab_size):
        out = svc({"prompt": prompt, "max_new_tokens": 4,
                   "deadline_s": time.perf_counter() + 30.0})
        lat.append(out["latency_s"])
        outs.append(out)
    print(f"\nLM PaaS: served 6 mixed-length prompts, "
          f"p50 {sorted(lat)[3]*1e3:.0f} ms")
    for rep in svc.replicas:
        eng = rep.handler.scheduler.engine
        print(f"  {rep.name}: {eng.metrics}")
    st = sup.status()["lm_summarizer"]
    print(f"  supervisor: {st['state']} healthy={st['healthy_replicas']} "
          f"upstream={st['upstream']}")
    return svc, outs


def serve_corpus(sup, services, docs, clients: int, kill_at: int):
    """``docs`` through the cv_parser service from ``clients`` concurrent
    clients; ``work_experience/0`` goes down at request ``kill_at``.
    Returns (results in order, {stage: [seconds]}, wall seconds)."""
    cv = sup.services["cv_parser"]
    stage_acc: dict = {}

    def request(i_doc):
        i, doc = i_doc
        if i == kill_at:       # outage mid-run: first work_experience primary
            services["work_experience"].replicas[0].set_up(False)
            print(f"  !! killed work_experience/0 at request {i}")
        out = cv(doc)
        for k, v in out["timings"].items():
            stage_acc.setdefault(k, []).append(v)
        return out

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=clients) as pool:
        results = list(pool.map(request, enumerate(docs)))
    return results, stage_acc, time.perf_counter() - t0


def report(results, stage_acc, wall, clients, services, docs: int) -> None:
    """Table 6's stage statistics, the last request's dispatch, the
    balancers' counters; fails if work_experience lost a request."""
    print(f"\nserved {len(results)} CVs in {wall:.2f}s "
          f"({len(results)/wall:.1f} req/s, {clients} clients)")
    print("\nstage timings (ms) — the paper's Table 6 layout:")
    print(f"{'stage':20s} {'mean':>8s} {'p50':>8s} {'p75':>8s} {'max':>8s}")
    for k in ("tika", "sectioning", "bert", "parallel_services", "total"):
        v = sorted(stage_acc[k])
        print(f"{k:20s} {statistics.mean(v)*1e3:8.1f} "
              f"{v[len(v)//2]*1e3:8.1f} {v[3*len(v)//4]*1e3:8.1f} "
              f"{v[-1]*1e3:8.1f}")

    d = results[-1]["dispatch"]
    print(f"\nlast request: parallel dispatch {d.total_s*1e3:.1f} ms vs "
          f"sequential-equivalent {d.sequential_equivalent_s*1e3:.1f} ms "
          f"({d.speedup:.2f}x)")

    print("\nbalancer state after the injected outage:")
    for name, svc in services.items():
        b = svc.balancer
        served = b.stats["served"]
        print(f"  {name:22s} served={served:3d} "
              f"failovers={b.stats['failovers']:2d} "
              f"backup_served={b.stats['backup_served']:2d}")
    we = services["work_experience"]
    assert we.balancer.stats["served"] == docs + 1, "lost requests"
    print("\nOK — zero lost requests through the outage.")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=40)
    ap.add_argument("--replicas", type=int, default=3)
    ap.add_argument("--fail-rate", type=float, default=0.08)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--lm", action=argparse.BooleanOptionalAction,
                    default=True, help="stand up the LM PaaS stage too")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    sup, parser, services = build_deployment(args.replicas, args.fail_rate,
                                             device=args.device)
    order = sup.start_all()
    print("startup order:", " -> ".join(order))

    rng = random.Random(3)
    docs = [cvdata.make_document(rng) for _ in range(args.docs)]
    parser.parse(docs[0])                       # warm the kernels and caches

    results, stage_acc, wall = serve_corpus(sup, services, docs,
                                            args.clients, args.docs // 3)
    report(results, stage_acc, wall, args.clients, services, args.docs)
    parser.dispatcher.shutdown()

    if args.lm:
        run_lm_paas(sup, device=args.device)


if __name__ == "__main__":
    main()
