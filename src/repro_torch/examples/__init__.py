"""The repo's entry points on the port, each run as
``python -m repro_torch.examples.<name>`` (on the card unless
``--device cpu`` is given; ``ahp_select`` needs no device):

* ``serve_parallel_pipeline`` — the paper's production deployment: the CV
  parser's cluster with injected faults and a replica killed mid-run,
  then an LM PaaS;
* ``multiarch_serving`` — several architectures as PaaS endpoints behind
  one router;
* ``train_small`` — a small LM trained on the packed CV corpus, then
  resumed from its mid-run checkpoint;
* ``quickstart`` — AHP tables, one CV parse, one train loss and prefill;
* ``ahp_select`` — the paper's Tables 3-5 from its Table 2 data;
* ``smoke_all`` — every reduced architecture through ``train_loss``,
  ``prefill`` and ``decode_step``.
"""
