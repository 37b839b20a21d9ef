"""The CV-Parser pipeline (paper Fig 5; port of the reference's
``core/pipeline.py``): extract -> embed -> section -> parallel
per-section NER PaaS -> join.

Every stage is a real PyTorch model (no stubs except the Tika byte-format
handling, which reduces to reading the synthetic Document's text). Stage
timings are recorded exactly as the paper's Table 6 (tika / sectioning /
bert / parallel-services). Models live on one device, the card unless
the caller passes ``device="cpu"``. The only deliberate waits for the
card are the one before the ``bert`` timing ends and each NER call's
read-back of its labels. A parse and every NER call run under
``torch.no_grad()`` (the services run on the dispatcher's threads, each
with its own grad mode).
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import cvdata, router
from repro_torch.core.cvdata import SERVICE_LABELS, HashTokenizer
from repro_torch.core.parallel import ParallelDispatcher
from repro_torch.core.services import Replica, Service
from repro_torch.models import bert_encoder, bilstm_lan

MAX_SENT_LEN = 24


def _generator(seed_or_generator, device) -> torch.Generator:
    if isinstance(seed_or_generator, torch.Generator):
        return seed_or_generator
    return torch.Generator(device=device).manual_seed(int(seed_or_generator))


def _bucketed_ids(tokenizer, sentences, least: int) -> np.ndarray:
    """(bucket, MAX_SENT_LEN) int32 token ids, the sentence count padded
    with all-zero rows to ``max(least, next power of two)``, so each
    shape recurs (shape bucketing, as the reference's jit needs)."""
    ids = np.array([tokenizer.pad(tokenizer.encode(s), MAX_SENT_LEN)
                    for s in sentences], np.int32)
    n = len(sentences)
    bucket = max(least, 1 << (n - 1).bit_length())
    if n < bucket:
        ids = np.pad(ids, ((0, bucket - n), (0, 0)))
    return ids


# ------------------------------------------------------------- tika (stub)
class TextExtractor:
    """Apache-Tika stand-in: mime detection + text extraction. The paper
    treats Tika as a black-box service; our synthetic documents carry
    their text, so extraction is parsing the Document container."""

    SUPPORTED = set(cvdata.MIMES) | {"txt", "rtf", "odt"}

    def extract(self, document) -> list:
        if document.mime not in self.SUPPORTED:
            raise ValueError(f"unsupported mime {document.mime}")
        return [s.tokens for s in document.sentences]


# ------------------------------------------------------------- NER service
@dataclass
class NERModel:
    name: str
    cfg: bilstm_lan.LANConfig
    params: dict
    tokenizer: HashTokenizer

    @classmethod
    def create(cls, name: str, seed_or_generator, vocab_size=4096,
               device="cuda"):
        """Random weights from a seed or a ``torch.Generator`` on
        ``device``."""
        labels = SERVICE_LABELS[name]
        cfg = bilstm_lan.LANConfig(vocab_size=vocab_size,
                                   n_labels=len(labels))
        params = bilstm_lan.init_params(_generator(seed_or_generator,
                                                   device), cfg, device)
        return cls(name, cfg, params, HashTokenizer(vocab_size))

    @torch.no_grad()
    def __call__(self, sentences: list) -> list:
        """sentences: list of token lists -> list of (token, label) pairs."""
        if not sentences:
            return []
        labels = SERVICE_LABELS[self.name]
        ids = _bucketed_ids(self.tokenizer, sentences, 4)
        tokens = torch.from_numpy(ids).to(self.params["embed"].device)
        pred = bilstm_lan.predict(self.params, self.cfg, tokens).cpu().numpy()
        out = []
        for si, s in enumerate(sentences):
            for ti, tok in enumerate(s[:MAX_SENT_LEN]):
                lab = labels[int(pred[si, ti])]
                if lab != "O":
                    out.append((tok, lab))
        return out


# ------------------------------------------------------------- the parser
@dataclass
class CVParser:
    extractor: TextExtractor
    encoder_cfg: object
    encoder_params: dict
    classifier_params: dict
    services: dict                   # service name -> Service
    dispatcher: ParallelDispatcher
    tokenizer: HashTokenizer

    @classmethod
    def create(cls, seed=0, dispatcher=None, services=None, vocab_size=4096,
               device="cuda"):
        """Random weights from one ``torch.Generator(device)`` seeded with
        ``seed``: the encoder, the classifier, then (unless ``services``
        is given) the five NER services in ``router.ROUTES`` order, each
        behind a started one-replica ``Service``. On the card the flash
        kernel is built here, not in the first parse's thread."""
        gen = _generator(seed, device)
        enc_cfg = bert_encoder.encoder_config(vocab_size)
        enc = bert_encoder.init_encoder(gen, enc_cfg, device)
        clf = bert_encoder.init_classifier(gen, device)
        if services is None:
            services = {}
            for name in router.ROUTES:
                ner = NERModel.create(name, gen, vocab_size, device)
                services[name] = Service(
                    name, replicas=[Replica(f"{name}/0", ner)], priority=2)
                services[name].start()
        if torch.device(device).type == "cuda":
            from repro_torch.kernels.flash_attention import kernel
            kernel.build()
        return cls(TextExtractor(), enc_cfg, enc, clf, services,
                   dispatcher or ParallelDispatcher(mode="thread"),
                   HashTokenizer(vocab_size))

    # ------------------------------------------------------------ stages
    @torch.no_grad()
    def parse(self, document) -> dict:
        """Returns {"fields": ..., "timings": {tika, sectioning, bert,
        parallel_services, total}, "dispatch": DispatchResult}."""
        t_start = time.perf_counter()
        timings = {}

        t0 = time.perf_counter()
        sentences = self.extractor.extract(document)
        timings["tika"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        device = self.encoder_params["embed"].device
        ids = torch.from_numpy(_bucketed_ids(self.tokenizer, sentences,
                                             8)).to(device)
        emb = bert_encoder.encode_sentences(
            self.encoder_params, self.encoder_cfg, ids, ids != 0)
        if emb.is_cuda:
            torch.cuda.synchronize(device)
        emb = emb[:len(sentences)]
        timings["bert"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        logits = bert_encoder.classify_sections(self.classifier_params, emb)
        section_ids = torch.argmax(logits, dim=-1).cpu().numpy()
        timings["sectioning"] = time.perf_counter() - t0

        sectioned: dict = {s: [] for s in router.SECTIONS}
        for s_id, sent in zip(section_ids, sentences):
            sectioned[router.SECTIONS[int(s_id)]].append(sent)

        t0 = time.perf_counter()
        fanout = router.route(sectioned)
        calls = [(name, self.services[name], payload)
                 for name, payload in fanout.items()]
        result = self.dispatcher(calls)
        timings["parallel_services"] = time.perf_counter() - t0
        timings["total"] = time.perf_counter() - t_start

        fields = {name: result.outputs[name] for name, _, _ in calls}
        return {"fields": fields, "timings": timings, "dispatch": result}
