"""Synthetic CV corpus (own copy of the reference's ``core/cvdata.py``).

The paper's 50k-resume dataset is proprietary: a templated generator
emits token-level entity labels per section, per paper Table 1. Nothing
is downloaded."""
from __future__ import annotations

import random
from dataclasses import dataclass, field

from repro_torch.core.router import SECTIONS

FIRST = ["amit", "priya", "rahul", "sneha", "vikram", "anita", "nikhil",
         "krishna", "meera", "arjun"]
LAST = ["verma", "prasad", "sharma", "gupta", "singh", "iyer", "das",
        "kumar", "patel", "rao"]
CITY = ["noida", "delhi", "mumbai", "bangalore", "pune", "chennai"]
DEGREE = ["btech", "mtech", "bsc", "msc", "mba", "phd"]
INSTITUTE = ["iit", "nit", "bits", "du", "amity", "vit"]
EMPLOYER = ["infoedge", "tcs", "infosys", "wipro", "flipkart", "paytm"]
DESIGNATION = ["engineer", "manager", "analyst", "architect", "lead",
               "scientist"]
SKILL = ["python", "java", "sql", "tensorflow", "jax", "kubernetes",
         "docker", "spark"]
ROLE = ["backend", "frontend", "devops", "research", "qa"]
INDUSTRY = ["software", "fintech", "ecommerce", "analytics"]
YEAR = [str(y) for y in range(2005, 2021)]
FILLER = ["the", "a", "with", "in", "at", "of", "and", "seeking", "worked",
          "completed", "from", "skilled", "to", "for", "experienced"]

# Per-section entity label sets (paper Table 1), BIO-less single tags + O.
SECTION_LABELS = {
    "personal_information": ["O", "NAME", "EMAIL", "PHONE", "CITY"],
    "education": ["O", "DEGREE", "INSTITUTE", "YEAR"],
    "work_experience": ["O", "DESIGNATION", "EMPLOYER", "YEAR"],
    "others": ["O", "SKILL", "ROLE", "INDUSTRY"],
}
# services consume merged sections; their label space is the union
SERVICE_LABELS = {
    "personal_information": SECTION_LABELS["personal_information"],
    "education": SECTION_LABELS["education"],
    "work_experience": SECTION_LABELS["work_experience"],
    "skills": ["O", "SKILL"],
    "functional_area": ["O", "ROLE", "INDUSTRY"],
}

MIMES = ["doc", "docx", "pdf"]


@dataclass
class Sentence:
    section: str
    tokens: list
    labels: list            # per-token entity tag names


@dataclass
class Document:
    mime: str
    sentences: list = field(default_factory=list)

    @property
    def text(self) -> str:
        return "\n".join(" ".join(s.tokens) for s in self.sentences)


def _sent(rng, section: str) -> Sentence:
    def pick(lst):
        return rng.choice(lst)

    toks: list = []
    labs: list = []

    def add(words, label="O"):
        for w in (words if isinstance(words, list) else [words]):
            toks.append(w)
            labs.append(label)

    if section == "personal_information":
        add(pick(FILLER))
        add(pick(FIRST), "NAME")
        add(pick(LAST), "NAME")
        add(pick(FILLER))
        add(f"{pick(FIRST)}@{pick(EMPLOYER)}.com", "EMAIL")
        add(str(rng.randint(6_000_000_000, 9_999_999_999)), "PHONE")
        add(pick(FILLER))
        add(pick(CITY), "CITY")
    elif section == "education":
        add([pick(FILLER), "completed"])
        add(pick(DEGREE), "DEGREE")
        add("from")
        add(pick(INSTITUTE), "INSTITUTE")
        add("in")
        add(pick(YEAR), "YEAR")
    elif section == "work_experience":
        add(["worked", "as"])
        add(pick(DESIGNATION), "DESIGNATION")
        add("at")
        add(pick(EMPLOYER), "EMPLOYER")
        add("since")
        add(pick(YEAR), "YEAR")
        if rng.random() < 0.5:
            add(["skilled", "in"])
            add(pick(SKILL), "SKILL")
    else:  # others
        add(["skilled", "in"])
        add(pick(SKILL), "SKILL")
        add("and")
        add(pick(SKILL), "SKILL")
        add(pick(FILLER))
        add(pick(ROLE), "ROLE")
        add(pick(INDUSTRY), "INDUSTRY")
    return Sentence(section, toks, labs)


def make_document(rng: random.Random) -> Document:
    doc = Document(mime=rng.choice(MIMES))
    for section in SECTIONS:
        for _ in range(rng.randint(1, 3)):
            doc.sentences.append(_sent(rng, section))
    rng.shuffle(doc.sentences)
    return doc


def make_corpus(n: int, seed: int = 0) -> list:
    rng = random.Random(seed)
    return [make_document(rng) for _ in range(n)]


# ---------------------------------------------------------------- tokenizer
class HashTokenizer:
    """Deterministic word -> id tokenizer (no external vocab files)."""

    def __init__(self, vocab_size: int = 4096):
        self.vocab_size = vocab_size

    def encode(self, words: list) -> list:
        import hashlib
        out = []
        for w in words:
            h = int(hashlib.md5(w.lower().encode()).hexdigest(), 16)
            out.append(2 + (h % (self.vocab_size - 2)))
        return out

    def pad(self, ids: list, length: int) -> list:
        ids = ids[:length]
        return ids + [0] * (length - len(ids))
