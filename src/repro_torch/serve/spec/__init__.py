"""Speculative multi-token decode: draft-and-verify serving (PyTorch port
of the reference ``serve/spec``).

A small **draft** model proposes ``k`` tokens per slot; the **target**
verifies all of them in ONE multi-token step (``Model.verify_step``,
q_len = k + 1, causal inside the window) and commits the accepted prefix
plus a bonus / correction token, so a target step can emit several
tokens.

* :class:`~repro_torch.serve.spec.draft.DraftRunner` — the draft model's
  per-slot KV stripes, batched prompt prefill, and the catch-up +
  proposal loop, with the proposals kept on the device.
* Acceptance lives in :mod:`repro_torch.serve.sampling`
  (``speculative_accept``): greedy exact match (streams bit-identical to
  non-speculative greedy decode) or acceptance sampling against the
  draft's proposal distributions.
* The paged-KV watermark / rollback protocol lives in the engine.
"""
from repro_torch.serve.spec.draft import DraftRunner

__all__ = ["DraftRunner"]
