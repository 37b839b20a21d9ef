"""Faults planted under the timed path, to show that the comparison which
decides ``correct`` fails on them: a served token altered where it is
produced, and a decode step that leaves the KV pool unchanged. Each takes
the setter that patches the program (pytest's ``monkeypatch.setattr`` in
the tests, ``setattr`` in ``calibrate.py --fault`` on the card)."""
from __future__ import annotations


def token_altered(set_attr) -> None:
    from repro_torch.serve import sampling
    orig = sampling.sample_rows

    def altered(logits, rows):
        tok, lp = orig(logits, rows)
        return (tok + 1) % logits.shape[-1], lp

    set_attr(sampling, "sample_rows", altered)


def state_unchanged(set_attr) -> None:
    from repro_torch.models import attention
    orig = attention.paged_decode_attention

    def unchanged(q, pool_k, pool_v, *a, **kw):
        out, _, _ = orig(q, pool_k.clone(), pool_v.clone(), *a, **kw)
        return out, pool_k, pool_v

    set_attr(attention, "paged_decode_attention", unchanged)


FAULTS = {"token_altered": token_altered, "state_unchanged": state_unchanged}
