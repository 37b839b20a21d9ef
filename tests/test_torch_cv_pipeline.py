"""The paper's CV parser on the port (CPU), against the JAX reference.

The host modules (router, synthetic corpus, tokenizer) give the
reference's values document by document. The NER services and the whole
``CVParser.parse`` run the reference's weights (``CVParser.create`` of
the JAX package, carried over through numpy) and give the reference's
fields on ``make_corpus(8, seed=1)``, label for label; section logits
agree within 1e-4 first (an argmax near a tie would show its margin
there). Then each case of ``tests/test_system.py`` on the port (not
``test_trained_ner_beats_chance``: training is a later slice), the
dispatcher's modes and accounting (``tests/test_parallel.py``, with
``jax_async`` ported as ``device_async``), and ``MultiModelServer`` on
lists of CPU devices.
"""
import dataclasses
import random
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cvdata as jcvdata
from repro.core import router as jrouter
from repro.core.multimodel import MultiModelServer as JaxMultiModelServer
from repro.core.pipeline import CVParser as JaxCVParser
from repro.models import bert_encoder as jbert
from repro_torch.core import cvdata, router
from repro_torch.core.balancer import deploy
from repro_torch.core.multimodel import ModelService, MultiModelServer
from repro_torch.core.parallel import (DispatchResult, ParallelDispatcher,
                                       block_until_ready)
from repro_torch.core.pipeline import (MAX_SENT_LEN, CVParser, NERModel,
                                       TextExtractor)
from repro_torch.core.services import LatencyModel, Replica, Service
from repro_torch.core.supervisor import Supervisor
from repro_torch.models import bert_encoder, bilstm_lan
from repro_torch.weights import (classifier_params_from_numpy,
                                 encoder_params_from_numpy,
                                 lan_params_from_numpy)

VOCAB = 4096


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def corpus():
    return cvdata.make_corpus(8, seed=1)


# ------------------------------------------------------------ host modules
def test_corpus_and_tokenizer_equal_reference():
    mine, ref = cvdata.make_corpus(12, seed=3), jcvdata.make_corpus(12, seed=3)
    assert [dataclasses.asdict(d) for d in mine] == \
        [dataclasses.asdict(d) for d in ref]
    tok, jtok = cvdata.HashTokenizer(VOCAB), jcvdata.HashTokenizer(VOCAB)
    for doc, jdoc in zip(mine, ref):
        assert doc.text == jdoc.text
        for s in doc.sentences:
            assert tok.encode(s.tokens) == jtok.encode(s.tokens)
            assert tok.pad(tok.encode(s.tokens), MAX_SENT_LEN) == \
                jtok.pad(jtok.encode(s.tokens), MAX_SENT_LEN)
    assert cvdata.SERVICE_LABELS == jcvdata.SERVICE_LABELS
    assert cvdata.SECTION_LABELS == jcvdata.SECTION_LABELS


def test_route_equals_reference():
    assert router.SECTIONS == jrouter.SECTIONS
    assert router.ROUTES == jrouter.ROUTES
    rng = random.Random(0)
    for _ in range(20):
        sectioned = {s: [[f"{s}{i}"] for i in range(rng.randint(0, 3))]
                     for s in router.SECTIONS if rng.random() < 0.8}
        assert router.route(sectioned) == jrouter.route(sectioned)


# ------------------------------------------------------ models vs reference
@pytest.fixture(scope="module")
def jparser():
    p = JaxCVParser.create(rng=jax.random.key(42))
    yield p
    p.dispatcher.shutdown()


def _port_ner(jner, device="cpu"):
    cfg = bilstm_lan.LANConfig(vocab_size=jner.cfg.vocab_size,
                               n_labels=jner.cfg.n_labels)
    return NERModel(jner.name, cfg,
                    lan_params_from_numpy(_np_tree(jner.params), cfg, device),
                    cvdata.HashTokenizer(cfg.vocab_size))


def port_parser(jp, device="cpu", dispatcher=None):
    """The port's CVParser with the reference parser's weights."""
    cfg = bert_encoder.encoder_config(VOCAB)
    services = {}
    for name, svc in jp.services.items():
        ner = _port_ner(svc.replicas[0].handler, device)
        services[name] = Service(name, replicas=[Replica(f"{name}/0", ner)],
                                 priority=2)
        services[name].start()
    return CVParser(
        TextExtractor(), cfg,
        encoder_params_from_numpy(_np_tree(jp.encoder_params), cfg, device),
        classifier_params_from_numpy(_np_tree(jp.classifier_params), device),
        services, dispatcher or ParallelDispatcher(mode="thread"),
        cvdata.HashTokenizer(VOCAB))


@pytest.fixture(scope="module")
def parser(jparser):
    p = port_parser(jparser)
    yield p
    p.dispatcher.shutdown()


def test_section_logits_match_reference(jparser, parser, corpus):
    """Every document's sentence embeddings (1e-4) and section logits;
    section ids equal, or the failure shows the margin."""
    for doc in corpus:
        sents = [s.tokens for s in doc.sentences]
        ids = np.array([parser.tokenizer.pad(parser.tokenizer.encode(s),
                                             MAX_SENT_LEN) for s in sents],
                       np.int32)
        want_e = jbert.encode_sentences(jparser.encoder_params,
                                        jparser.encoder_cfg,
                                        jnp.asarray(ids),
                                        jnp.asarray(ids != 0))
        want = np.asarray(jbert.classify_sections(jparser.classifier_params,
                                                  want_e))
        t = torch.from_numpy(ids)
        emb = bert_encoder.encode_sentences(parser.encoder_params,
                                            parser.encoder_cfg, t, t != 0)
        np.testing.assert_allclose(emb.numpy(), np.asarray(want_e),
                                   atol=1e-4, rtol=1e-4)
        got = bert_encoder.classify_sections(parser.classifier_params,
                                             emb).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
        if not np.array_equal(got.argmax(-1), want.argmax(-1)):
            top2 = np.sort(want, axis=-1)[:, -2:]
            pytest.fail(f"section ids differ; margins {top2[:, 1] - top2[:, 0]}")


def test_ner_services_match_reference(jparser, parser, corpus):
    sents = [s.tokens for doc in corpus for s in doc.sentences]
    for name, svc in jparser.services.items():
        jner = svc.replicas[0].handler
        ner = parser.services[name].replicas[0].handler
        for chunk in (sents[:3], sents[3:12], sents):
            assert ner(chunk) == jner(chunk), name
        assert ner([]) == []


def test_parse_fields_equal_reference(jparser, parser, corpus):
    for doc in corpus:
        out, jout = parser.parse(doc), jparser.parse(doc)
        assert out["fields"] == jout["fields"]
        assert set(out["timings"]) == set(jout["timings"])
        assert out["dispatch"].mode == "thread"
        assert set(out["dispatch"].outputs) == set(router.ROUTES)


# ------------------------------------- tests/test_system.py on the port
@pytest.fixture(scope="module")
def own_parser():
    p = CVParser.create(42, device="cpu")
    yield p
    p.dispatcher.shutdown()


def test_parse_produces_all_sections_and_timings(own_parser, corpus):
    out = own_parser.parse(corpus[0])
    assert set(out["fields"]) == set(router.ROUTES)
    for key in ("tika", "sectioning", "bert", "parallel_services", "total"):
        assert out["timings"][key] >= 0
    assert out["timings"]["total"] >= out["timings"]["parallel_services"]
    assert bert_encoder.classifier_n_params(
        own_parser.classifier_params) == 154_604


def test_parallel_and_sequential_agree(own_parser, corpus):
    seq = ParallelDispatcher(mode="sequential")
    parser_seq = dataclasses.replace(own_parser, dispatcher=seq)
    for doc in corpus[1:4]:
        assert own_parser.parse(doc)["fields"] == \
            parser_seq.parse(doc)["fields"]


def test_unsupported_mime_rejected(own_parser):
    doc = cvdata.Document(mime="exe")
    with pytest.raises(ValueError, match="unsupported mime"):
        own_parser.parse(doc)


def test_ha_failover_keeps_parsing(corpus):
    """Kill the primary replicas of one PaaS mid-traffic: the backup takes
    over and parsing continues (paper §3.3: zero-downtime deployment)."""
    parser = CVParser.create(7, device="cpu")
    name = "skills"
    ner = parser.services[name].replicas[0].handler
    svc = Service(name, replicas=[
        Replica(f"{name}/a", ner), Replica(f"{name}/b", ner),
        Replica(f"{name}/backup", ner, backup=True)])
    deploy(svc, max_fails=1)
    svc.start()
    parser.services[name] = svc

    out1 = parser.parse(corpus[2])
    svc.replicas[0].set_up(False)
    svc.replicas[1].set_up(False)          # both primaries down
    out2 = parser.parse(corpus[2])
    assert out1["fields"][name] == out2["fields"][name]
    assert svc.balancer.stats["backup_served"] > 0
    parser.dispatcher.shutdown()


def test_full_stack_under_supervisor(own_parser, corpus):
    sup = Supervisor()
    tika = Service("tika", replicas=[Replica("tika/0",
                                             own_parser.extractor.extract)],
                   priority=0)
    bert = Service("bert", replicas=[Replica("bert/0", lambda p: p)],
                   priority=1, depends_on=("tika",))
    sup.add(tika)
    sup.add(bert)
    for name, svc in own_parser.services.items():
        svc.priority = 2
        svc.depends_on = ("bert",)
        svc.started = False
        sup.add(svc)
    cv = Service("cv_parser", replicas=[Replica("cv/0", own_parser.parse)],
                 priority=3, depends_on=tuple(own_parser.services))
    sup.add(cv)
    order = sup.start_all()
    assert order[0] == "tika" and order[-1] == "cv_parser"
    out = cv(corpus[3])
    assert set(out["fields"]) == set(router.ROUTES)


def test_create_draws_from_one_seeded_generator():
    """The same seed gives the same weights; NERModel takes a seed or a
    generator."""
    a = CVParser.create(3, device="cpu", services={})
    b = CVParser.create(3, device="cpu", services={})
    assert torch.equal(a.encoder_params["blocks"]["attn"]["w_q"],
                       b.encoder_params["blocks"]["attn"]["w_q"])
    assert torch.equal(a.classifier_params["dense_2"]["w"],
                       b.classifier_params["dense_2"]["w"])
    n1 = NERModel.create("education", 5, device="cpu")
    n2 = NERModel.create("education", torch.Generator().manual_seed(5),
                         device="cpu")
    assert n1.cfg.n_labels == 4
    assert torch.equal(n1.params["lan_layers"][1]["bwd"]["u"],
                       n2.params["lan_layers"][1]["bwd"]["u"])


def test_entry_points_default_to_cuda_without_fallback():
    """``CVParser.create()`` / ``NERModel.create`` without ``device`` need
    a card: here they raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        CVParser.create()
    with pytest.raises((RuntimeError, AssertionError)):
        NERModel.create("skills", 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        MultiModelServer([ModelService("m", lambda p, b: b, None)])


# --------------------------------- tests/test_parallel.py on the port
def make_services(latency=None, n=5):
    out = {}
    for i in range(n):
        name = f"svc{i}"
        s = Service(name, replicas=[
            Replica(f"{name}/0", lambda p, i=i: [(t, f"L{i}") for t in p],
                    latency=latency)])
        s.start()
        out[name] = s
    return out


def calls_for(services, payload=("tok",)):
    return [(n, s, list(payload)) for n, s in services.items()]


@pytest.mark.parametrize("mode", ["thread", "device_async"])
def test_parallel_equals_sequential_outputs(mode):
    svcs = make_services()
    r1 = ParallelDispatcher(mode="sequential")(calls_for(svcs))
    par = ParallelDispatcher(mode=mode)
    r2 = par(calls_for(svcs))
    assert r1.outputs == r2.outputs
    assert r2.mode == mode and set(r2.per_call_s) == set(svcs)
    par.shutdown()


def test_parallel_speedup_with_latency_model():
    """With remote-like service latencies (the paper's situation), thread
    fan-out overlaps the waits: T_p << T_s == sum(T_i)."""
    lat = LatencyModel(median_s=0.05, p75_s=0.055)
    svcs = make_services(latency=lat)
    seq = ParallelDispatcher(mode="sequential", rng=random.Random(0))
    par = ParallelDispatcher(mode="thread", max_workers=8,
                             rng=random.Random(0))
    t0 = time.perf_counter()
    seq(calls_for(svcs))
    t_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = par(calls_for(svcs))
    t_p = time.perf_counter() - t0
    assert t_p < t_s / 2, (t_p, t_s)   # >=2x with 5 overlapping services
    assert res.speedup > 2.0
    par.shutdown()


def test_dispatch_result_accounting():
    svcs = make_services(n=3)
    par = ParallelDispatcher(mode="thread")
    res = par(calls_for(svcs))
    assert set(res.per_call_s) == set(svcs)
    assert res.sequential_equivalent_s >= 0
    assert res.speedup >= 0
    par.shutdown()
    r = DispatchResult({}, {"a": 0.25, "b": 0.5}, 0.5, "thread")
    assert r.sequential_equivalent_s == 0.75 and r.speedup == 1.5


def test_device_async_mode():
    """Each call is enqueued before any output is waited on; outputs are
    tensors (CPU here, ready at once) or trees of them."""
    order = []

    def heavy(p):
        order.append(p["scale"])
        x = torch.ones((64, 64)) * p["scale"]
        return {"sum": (x @ x).sum(), "rows": [x[0], x[1]]}

    svcs = {}
    for i in range(3):
        s = Service(f"m{i}", replicas=[Replica(f"m{i}/0", heavy)])
        s.start()
        svcs[f"m{i}"] = s
    d = ParallelDispatcher(mode="device_async")
    res = d([(n, s, {"scale": float(i)}) for i, (n, s) in
             enumerate(svcs.items())])
    assert order == [0.0, 1.0, 2.0]
    assert float(res.outputs["m0"]["sum"]) == 0.0
    assert float(res.outputs["m1"]["sum"]) > 0.0
    assert list(res.outputs) == ["m0", "m1", "m2"]
    t = torch.ones(3)
    assert block_until_ready(t) is t
    tree = {"a": [t, (t, 3)], "b": "x"}
    assert block_until_ready(tree) is tree


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="unknown dispatch mode"):
        ParallelDispatcher(mode="jax_async")([])


# ---------------------------------------------------------- multimodel
@pytest.mark.parametrize("n,k", [(8, 4), (8, 3), (4, 4), (2, 5), (1, 3),
                                 (5, 2)])
def test_partition_equals_reference(n, k):
    devices = [f"d{i}" for i in range(n)]
    assert MultiModelServer._partition(devices, k) == \
        JaxMultiModelServer._partition(devices, k)


@pytest.mark.parametrize("n_devices", [4, 2, 8])
def test_multimodel_parallel_equals_sequential(n_devices):
    def mk(i):
        return ModelService(f"m{i}", lambda p, b: b @ p,
                            torch.eye(16) * (i + 1))

    server = MultiModelServer([mk(i) for i in range(4)],
                              devices=["cpu"] * n_devices)
    for svc in server.services.values():
        assert svc.device == torch.device("cpu")
        assert len(svc.devices) == max(1, n_devices // 4)
    batches = {f"m{i}": torch.ones((4, 16)) for i in range(4)}
    par, t_par = server.serve_parallel(batches)
    seq, t_seq = server.serve_sequential(batches)
    assert t_par >= 0 and t_seq >= 0
    for i in range(4):
        assert torch.equal(par[f"m{i}"], seq[f"m{i}"])
        assert torch.equal(par[f"m{i}"], torch.full((4, 16), float(i + 1)))
    assert server.stats == {"parallel_calls": 1, "sequential_calls": 1}
