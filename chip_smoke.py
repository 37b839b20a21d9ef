#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no result line is printed then).
Each starts by checking that what earlier work dropped is off the card:
a ``gc.collect()`` there may free at most 64 MiB of device memory, or an
object kept its tensors in a reference cycle (``free_card``).

1. Environment: the card's name and power limit, torch / CUDA versions.
   Without a GPU it stops here.
2. Build: every CUDA source of the port, with nvcc, into ``build/``;
   ptxas registers and spills of every kernel instantiation; where
   ``cuobjdump`` exists, whether the flash, flash backward and paged
   kernels' SASS holds tensor-core ``HMMA`` (mma.sync) or ``HGMMA``
   (wgmma: the bf16 backward) and asynchronous copies (``LDGSTS`` /
   ``UTMALDG``). The flash backward must show ``HGMMA`` in every bf16
   instantiation (hd 64 to 256), ``LDGSTS`` in every f32 one, and no
   spill stores in any; nor may any WKV or selective-scan backward
   instantiation spill, or the scan forwards' checkpoint instantiations;
   the flash backward's and the scan backwards' per-launch device times
   (``bwd_launch_split``, ``scan_bwd_launch_split``, before any other
   trace), printed with the timing rows.
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
   5} over S 65 < T 300, causal and with a 24 sliding window; then
   non-causal (``causal=False``) at the sentence encoder's shapes (B 8
   and 16, 12 / 12 heads of 64, S = T = 24, the model's strided views)
   and at S 37 < T 300, f32 within 3e-5 and bf16 within 3e-2; then at
   the frontends' shapes: non-causal at whisper-tiny's encoder (B 4, 6 /
   6 heads of 64, S = T = 1500, not a multiple of the tiles) and
   cross-attention (S 1 and 16 < T = 1500), f32 within 3e-5, bf16 3e-2;
   causal at qwen2-vl-2b's prefill (B 4, 12 / 2 heads of 128, S = T =
   320), and decode at both frontends' stripes (6 / 6 of 64 over 128, 12
   / 2 of 128 over 512, B 4, ragged lengths), f32 1e-4, bf16 3e-2;
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
11. The paper's CV parser (f32, random weights from seeded generators):
   the cluster of ``examples/serve_parallel_pipeline.py``'s
   ``build_deployment`` on the port — tika, bert, the five Bi-LSTM-LAN
   NER services with 2 replicas each (the second a backup) behind
   balancers, ``cv_parser`` with the thread dispatcher, under the
   Supervisor — parses ``make_corpus(40, seed=1)`` after
   ``MultiModelServer.lower_all`` warms the encoder and the five NER
   models and one warm-up parse: every document returns all 5 fields; the flash kernel
   launches exactly once per encoder layer per parse (4 x 40) and no
   other kernel launches; the fields equal the sequential dispatcher's
   and those of the port on the CPU with the same weights, label for
   label (a difference prints the logit margins). Printed: p50 / p95 of
   every stage's time beside the paper's 700 ms, the dispatch speedup,
   and one parse's device busy time, idle share and top device ops
   under ``torch.profiler``; the first parse of a fresh process (a
   subprocess: ``chip_smoke.py --first-parse cold|lower_all``) without
   and with ``lower_all`` before it.
12. The frontends at full width, bf16, random weights from seed 0:
   whisper-tiny (4 encoder + 4 decoder layers, d 384, 6 heads of 64,
   vocab 51,865, 1500 frames) and qwen2-vl-2b (28 layers, d 1536, 12 / 2
   heads of 128, vocab 151,936, a 256-patch prefix with M-RoPE ids). B 4
   rows of seeded frames or patch embeds with text of 5 / 16 / 33 / 64
   (whisper) or 5 / 17 / 33 / 64 tokens (qwen2-vl) right-padded with
   ``last_idx``; one ``prefill``, its cache moved into ``init_cache(4,
   128)`` or ``init_cache(4, 512)`` stripes, then 16 greedy
   ``decode_step`` calls at per-row lengths. Launches counted from 0 over
   the prefill and over the decode steps, exactly: flash 12 at whisper's
   prefill (encoder, self, cross) and 4 a step (cross-attention), 28 at
   qwen2-vl's; the decode kernel once per layer a step; nothing else.
   Logits finite, tokens inside the unpadded vocabulary. Printed: prefill
   ms, ms a decode step, tokens/s, then the run under ``torch.profiler``.
12b. The frontends in f32 at full width (qwen2-vl-2b cut to 4 layers),
   seed-0 weights: the port on the card against the port on the CPU
   (prefill logits within 1e-3, 8 greedy tokens identical, logprobs
   within 1e-3; the top-2 margins printed on a difference); qwen2-vl's
   paged decode through the paged kernel (block size 16, a hand-built
   block table) against its stripe decode (tokens identical, logprobs
   within 1e-3, 4 paged launches a step); a 4-token ``verify_step``
   window on stripes against 4 ``decode_step`` calls (logits within
   1e-3), both configs.
13a. The flash backward kernel against its plain version
   (``flash_attention_bwd_ref``, the explicit formulas in f32) on the
   same q, k, v, dout and the kernel's own out and lse, f32 and bf16, at
   qwen3-4b's train shape (B 2, S = T = 1024, 32 / 8 heads of 128),
   whisper-tiny's encoder (non-causal, S = T = 1500, 6 / 6 of 64) and
   cross-attention (S 448 against T 1500), qwen2-vl-2b's G 6 (12 / 2 of
   128), a 128 window inside S 512, hd 112 and 192, S 64 < T 300, a
   ragged S 37 against T 101 with a 24 window, S 40 > T 20 (rows
   that see no key), hymba-1.5b's train shape (B 2, S = T = 1024, 25
   / 5 heads of 64, a 2048 window), nemotron-4-340b's attention (B 1, S
   = T = 2048, 96 / 8 heads of 192, causal) and hd 256 (B 2, S 300
   against T 333, 8 / 2 heads): each gradient within 1e-4 (f32) /
   1e-2 (bf16) of
   its largest magnitude, two runs bitwise equal, nothing NaN, dq 0 on
   keyless rows; the forward's lse within 1e-4 / 1e-3 of the plain
   log-sum-exp and -inf exactly where a row sees no key; the autograd
   route (``ops.flash_attention`` on inputs that require grad) bitwise
   equal to the direct kernel calls. Then the scans' training forwards
   (``checkpoints=True``): their checkpoints (the state every 8 steps)
   against the plain states (``wkv_checkpoints_ref``,
   ``ssm_scan_checkpoints_ref``) within the scan tolerance, out and final
   state bitwise the serving forward's; and the WKV and selective-scan
   backward kernels (``wkv_bwd``, ``ssm_scan_bwd``, f32) fed those
   checkpoints, against their plain versions (``wkv_bwd_ref``,
   ``ssm_scan_bwd_ref``, the explicit reverse-time formulas) and against
   autograd of the plain forwards, on the same inputs and non-zero
   cotangents of the output and the final state: WKV at rwkv6-1.6b's
   train shape (B 2, T 1024, 32 heads of 64), B 8 T 1, T 17 (across the
   8-step chunk edges), T 300 and hd 32, with
   decays in the model's range (exact zeros among them); the selective
   scan at hymba-1.5b's train shape (B 2, T 1024, d_inner 3200, N 16),
   B 8 T 1, T 17, T 300 and d_inner 3,204 (a ragged channel tail), with
   hymba's A (-1 .. -16) and steps where exp(dt A) underflows to 0: each
   gradient within 1e-4 of its largest magnitude, two calls bitwise
   equal, nothing NaN. The same checks, and the serving forwards against
   their plain versions, at the shard shapes a plan's tensor-parallel
   bodies give a rank at the train shape: WKV on 2 and 8 heads of 64
   (rwkv6's 32 over a model axis of 16 / 4), the scan on d_inner 200 and
   800 (hymba's 3200 over 16 / 4; 200 has a ragged channel tail). Then
   the paged-window and decode ops (which
   serve only) and the WKV and selective-scan kernels called directly
   raise on an input that requires grad (no plain fallback) and run
   under no_grad, and the WKV and selective-scan ops run under grad
   through their autograd functions.
13b. Training, the slice's main path: full-width qwen3-4b (bf16, seed-0
   weights, remat) cut to 4 layers (1.18 B params), ``train()`` for 5
   AdamW steps of B 2 x 1024 tokens of the packed synthetic CV corpus.
   Every launch count is set to 0 just before and read just after:
   flash forward exactly 2 a layer a step (remat recomputes it), the
   backward kernel 1 a layer a step, no other kernel. Printed: the
   losses (all finite, the last below the first) and grad norms,
   steps/s and tokens/s,
   ``max_memory_allocated``, the final checkpoint restored equal to the
   final params, then one more step under ``torch.profiler`` (device
   busy against wall: the idle share).
13c. Full width in f32 at 2 layers (B 2, S 512): ``train_loss`` and every
   gradient through the flash kernels against the same model with its
   attention on the plain version: loss within 1e-5 relative, each leaf
   within 1e-4 of its largest magnitude, 2 forward and 2 backward
   launches on the kernel route and none on the plain one.
13d. ``python -m repro_torch.launch.train --steps 3`` (reduced qwen3-4b,
   then ``--arch rwkv6-1.6b``, f32) on the card as subprocesses: exit 0.
13e. The recurrent families train, as 13b: full-width rwkv6-1.6b (24
   layers, d 2048, 32 WKV heads of 64, vocab 65,536) and hymba-1.5b (32
   layers, d 1600, 25 / 5 heads of 64 with a 2048 window, d_inner 3200,
   N 16, vocab 32,001), bf16, remat, 5 AdamW steps of B 2 x 1024 tokens,
   every layer. Launches a layer a step exactly:
   rwkv6 WKV forward 2 and WKV backward 1; hymba flash forward 2, flash
   backward 1, scan forward 2, scan backward 1; no other kernel. The
   same prints and checks as 13b.
13f. As 13c for rwkv6-1.6b and hymba-1.5b, f32, 2 layers at full width, B
   2 x S 256: the kernel route against the plain route (attention, WKV
   and the selective scan all on their plain versions), one forward and
   one backward launch of each kernel a layer.
14. The sharded path: a ``ParallelPlan`` (``repro_torch.sharding``) on a
   1 x 1 ``DeviceMesh`` of one NCCL rank (NCCL refuses two ranks on one
   GPU; the multi-rank runs are the CPU tests' and
   ``scripts/torch_multirank_card.py``'s), so every shard body and
   placement runs, each kernel on its whole local shard, and DTensor's
   code runs as on any mesh; a collective over an axis of one rank is
   skipped, as DTensor skips it. One collective on each mesh group
   first sets up its communicator.
   14a full-width qwen3-4b, bf16, 36 layers, DTensor params
   (``param_shardings``), through ``ServingEngine(plan=...)`` with phase
   4's prompts, paged (kernel) and on stripes: greedy streams identical
   to the serve without a plan, launches by phase 4's / 6's rule. 14a
   and 14b serve in turns (no plan, plan, plan, no plan) and time the
   median of each pair.
   14b full-width grok-1-314b, 2 layers, bf16, paged, under a decode plan
   (EP, E_loc 8; every MoE call takes ``moe_decode_ffn``): tokens
   identical to the serve without a plan; at 1 layer, f32, the MoE FFN
   and one decode step's logits within 1e-4 of the largest. 14c
   full-width hymba-1.5b and rwkv6-1.6b decode steps under a decode plan
   with the stripe cache placed by ``cache_spec`` (DTensors: the stripes'
   sequence over model, the SSM state's channels / the WKV state's heads
   over model), greedy, against the same steps without a plan: tokens
   identical, scan and decode launches exactly L a step; then
   full-width whisper-tiny: phase 12's prompts and frames prefilled under
   a prefill plan (DTensor params, the batch placed by ``batch_spec``)
   and 4 greedy decode steps under a decode plan on stripes placed by
   ``cache_spec``, against the same without a plan: tokens identical,
   logits within 1e-2, flash 12 + 4 a step and decode 4 a step. 14d the
   sequence-sharded decode body (``attention.seq_shard_decode``) for 4
   simulated ranks at hymba-1.5b's decode shape (25 / 5 heads of 64, B 8,
   a 4096 stripe, window 2048), lengths straddling each shard edge and
   the window edge, merged: against the unsharded kernel and the plain
   version, f32 (3e-5) and bf16 (3e-2; about one key's weight in a
   merged row at this window, so only f32 catches a window or merge
   error of one key). 14e full-width qwen3-4b, 4
   layers, bf16, remat, 2 AdamW steps of B 2 x 1024 under a train plan
   (DTensor params and state) against ``plan=None``: losses within 1e-5
   relative, flash forward 2 and backward 1 launches a layer a step;
   then the same for full-width rwkv6-1.6b and hymba-1.5b at 4 layers:
   losses within 1e-5 relative, launches a layer a step WKV forward 2
   and backward 1; flash 2 + 1, scan 2 + 1.
   14f ``python -m repro_torch.launch.train --mesh-shape 1,1 --steps 2``:
   the reference's lines. One line of times: serve tok/s with and
   without the plan, the second train step's ms, beside the card's name
   and power limit. The kernel rows carry each kernel's launches in phase 14
   (``plan_launches``).
15. Configurations never run on the card before, bf16, random weights
   from seed 0, each served like phase 4 (paged, use_kernel, the 8
   prompts; launches by ``expected_launches`` counted from 0, the pool
   drained; not profiled) and then freed: 15a deepseek-7b (30 layers)
   and minitron-8b (32, squared-ReLU) at full depth, then at 2 layers in
   f32 kernel path vs plain path (streams identical, logprobs within
   1e-3); 15b nemotron-4-340b at 2 layers (hd 192, squared-ReLU, V
   256,000), the f32 check at 1 layer; 15c kimi-k2-1t-a32b at 1 layer
   (384 experts top-8, hd 112), one request a prefill call, never shared
   or chunked, then ``moe.moe_ffn`` at B 8 against a direct f32 sum over
   each token's top-8 experts from the same weights (within 2e-2 of the
   largest output). 15d, for each of them and for phase 13b's qwen3-4b
   train step: ``launch.dryrun.build_step`` at the card run's own shape
   (a stripe decode step at B 8 over full 1024-slot stripes; the train
   step at B 2 x 1024), analysed on meta (``launch.step_analysis``), and
   the same step on the card: argument bytes equal the real tensors'
   exactly, the measured peak (``max_memory_allocated``) at most 1.10 x
   the predicted one, the roofline bound (``launch.roofline``) at most
   1.05 x the step's device-busy time (the profiler's kernel and copy
   times of one step, summed) and of its time (CUDA events, median of
   10); printed with the model-FLOPs share. Their launches join the serves' sums. Phase 15
   runs right after phase 2, on a card no other phase has used (its
   largest models need nearly all of it).
16. The entry points (``repro_torch.examples``), after phase 14. 16d
   starts first, in a subprocess (``chip_smoke.py --fresh-build DIR``):
   the kernel build pointed at an empty directory, then the first calls
   of the five forward kernels from 3 threads released together (each
   starts on flash, then goes round the other four from its own place),
   at the reduced configs' head dim 32, f32: one ``nvcc`` a source, 3
   launches a kernel, each within 1e-4 of its plain version, the
   threads' outputs bitwise equal, no temporary file left. 16a runs
   meanwhile: every module at its defaults in its own subprocess, all
   started together (``chip_smoke.py --entry-point NAME ARGS`` runs it
   as ``python -m`` does, then prints the kernels' launch counts):
   ``smoke_all`` (the 10 reduced architectures: attention at hd 32,
   reduced MoE, qwen2-vl and whisper), ``serve_parallel_pipeline`` (40
   CVs, 3 replicas, fail rate 0.08, 4 clients, the kill at request 13,
   then the LM PaaS), ``multiarch_serving``, ``train_small`` for
   qwen3-4b, rwkv6-1.6b and hymba-1.5b (150 steps, the 20 % loss-drop
   gate, then 5 steps resumed from the mid-run checkpoint), ``quickstart``
   and ``ahp_select``: each exits 0, ends on the reference's closing
   line and launched the kernels of its path (the backward kernels under
   ``train_small``). 16b, in this process at full width, bf16:
   ``run_lm_paas`` with qwen3-4b (2 replicas, paged, the paged-window
   kernel), launches owed by the replicas' metrics exactly, pools
   drained, every reply's tokens equal to one engine serving the prompt
   alone; then ``multiarch_serving``'s ``LMPaaS`` for qwen3-4b, rwkv6-1.6b
   and hymba-1.5b on one card, each first serving the 4 prompts alone
   (launches exact), then all behind ``deploy_router``'s thread fan-out:
   tokens equal to the runs alone, launches their sum, pools drained.
   16c: ``serve_parallel_pipeline``'s deployment on the card, f32, with
   faults: zero lost requests, failovers above 0, flash 4 a parse and
   nothing else, the fields of every request equal to a fault-free
   sequential run of the same weights; the stage p50 / p95 beside the
   paper's 700 ms. Each kernel row adds its launches under 16a-16c
   (``entry_launches``); every one of the eight must have launched.

Then every kernel's times (CUDA events, L2 flushed between launches,
the card kept busy while the host enqueues, median of 30) at the shape
of its serve beside its plain version and its bound from bytes and flops
(``repro_torch/kernels/costs.py``, the counts ``launch/step_analysis.py``
reads too)
(the paged kernel also at the verify window, S 5, and at decode with hd
112 and 192: ``verify_*``, ``hd112_*``, ``hd192_*``; flash also at
grok-1-314b's prefill, 48 / 8 heads: ``grok_*``; and non-causal at
the sentence encoder's shape, f32, S = T = 24, B 8: ``encoder_*``, B 16:
``encoder_b16_*``; and bf16 at whisper-tiny's encoder, S = T = 1500:
``whisper_enc_*``, its cross-attention decode, S 1 against T 1500, beside
the decode kernel on the same inputs: ``whisper_xattn_decode_*``, and
qwen2-vl-2b's prefill, B 4, S = T = 320: ``qwen2vl_prefill_*``)
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
qwen3-4b numbers (``qwen3_*``), its numbers at the frontends' stripes
(``whisper_*``: B 4 over 128, 6 / 6 heads of 64; ``qwen2vl_*``: B 4 over
512, 12 / 2 heads of 128; phase 12's last lengths) and floors
(``floor_ms``, ``qwen3_floor_ms``). The sampler's device and host time per sampled and
all-greedy step at B 8, V 151,936 is printed beside them.
The flash backward's row (``flash_attention_bwd``) carries its time at
qwen3-4b's train shape in bf16 beside its plain version, its bound (q,
k, v, out, dout and lse read once, dq, dk, dv written once; 10 * hd
flops per visible query-key pair and query head) and SDPA's backward on
the same inputs, with the same numbers in f32 (``train_f32_*``) and at
whisper's encoder (``whisper_enc_*``), and the device time of each of
its launches per call from ``torch.profiler`` at the train shape and
whisper's encoder, bf16 (``launch_split_ms``), and at hd 192 (B 1, S =
T = 256, 12 / 4 heads, bf16: ``hd192_*``) and nemotron-4-340b's
attention at its training length (B 1, S = T = 4096, 96 / 8 heads of
192, causal, bf16: ``nemotron_*``; the plain version there needs about
35 GB and is timed at S = T = 2048 if the card cannot hold it then,
``nemotron_plain_S`` saying which); its launches are 13b's and 13e's
(bf16), and ``train_launches`` adds 13c's and 13f's (f32,
``train_f32_launches``). The WKV and selective-scan backward rows (``wkv_bwd``,
``ssm_scan_bwd``) carry their time at rwkv6-1.6b's and hymba-1.5b's
train shapes beside their plain versions and bounds (library none), their
launches in 13e, the forward's time at the train shape as serving calls
it and with checkpoints beside its bound and its plain version
(``train_fwd_ms``, ``train_fwd_ck_ms``, ``train_fwd_bound_*``,
``train_fwd_plain_ms``), the autograd forward +
backward pair (``train_pair_ms``) and the device time of each of their
launches per call (``launch_split_ms``, profiler); the scan forward rows
add their 13e launches (``train_launches``). The flash row adds its launches in 13b and 13e
(``train_launches``) and the forward's time with and
without the lse write at the train shape and at qwen3-4b's prefill
(``train_fwd_ms`` / ``train_fwd_lse_ms``, ``prefill_fwd_*``) beside the
forward's bound, its plain version with the lse and SDPA's forward,
which returns no lse (``*_fwd_lse_bound_ms``, ``*_fwd_lse_plain_ms``,
``*_fwd_library_ms``).
``scaled_dot_product_attention`` is the yardstick of the attention
kernels (on the gathered KV, causal, or with a length mask; the port
never calls it); no single PyTorch call computes either recurrence. TF32
is off for every f32 comparison.
"""
from __future__ import annotations

import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager
from dataclasses import replace
from functools import partial
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import costs  # noqa: E402
from repro_torch.launch.mesh import (HBM_BW, PEAK_FLOPS_BF16,  # noqa: E402
                                     PEAK_FLOPS_F32)

HBM_BYTES_PER_S = HBM_BW        # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: PEAK_FLOPS_BF16, torch.float32: PEAK_FLOPS_F32}
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
# the CV parser's sentence encoder: 12 heads of 64, MAX_SENT_LEN 24
# positions, sentence batches bucketed to 8 or 16
ENC_H, ENC_HD, ENC_S, ENC_BATCHES = 12, 64, 24, (8, 16)
NON_CAUSAL_TOL = {torch.float32: 3e-5, torch.bfloat16: 3e-2}
CV_DOCS = 40
PAPER_PARSE_MS = 700            # the paper's "less than 700 ms" a CV


_T0 = time.perf_counter()
CYCLE_SLACK = 64 << 20          # device bytes a gc.collect() may free


def phase(name):
    """Start a phase on a card that holds only what main() still refers
    to (``free_card``)."""
    if torch.cuda.is_initialized():
        free_card()
    print(f"\n=== {name} [{time.perf_counter() - _T0:.1f} s]", flush=True)


def free_card():
    """Return the allocator's cached blocks, after checking that nothing
    dropped is left on the card in reference cycles: device memory that
    the cycle collector frees is memory an object (an engine, a service,
    a train run) kept after its user let it go, and the collector runs
    on the count of Python objects made, never when the card runs short.
    Fails if it freed more than CYCLE_SLACK bytes."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    gc.collect()
    freed = held - torch.cuda.memory_allocated()
    if freed > CYCLE_SLACK:
        raise AssertionError(f"the cycle collector freed {freed / 1e9:.3f} "
                             f"GB of device memory: a dropped object kept "
                             f"its tensors in a reference cycle")
    torch.cuda.empty_cache()


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
    ``-Xptxas -v`` log. Raises if a flash backward, WKV backward or
    selective-scan backward instantiation spills, or a scan forward's
    checkpoint instantiation (the training forward: template flag true)
    does (their register plans keep every accumulator in registers)."""
    spilled = []
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
        for (name, regs, spill), short in zip(
                entries, _demangle([e[0] for e in entries], tool_dir)):
            print(f"  ptxas {log.stem}: {short}: {regs} registers; {spill}")
            m = re.search(r"(\d+) bytes spill stores", spill)
            checked = log.stem in ("flash_bwd", "wkv_bwd", "ssm_scan_bwd") \
                or (log.stem in ("wkv", "ssm_scan")
                    and ("true" in short or "Lb1E" in name))
            if checked and (not m or int(m.group(1))):
                spilled.append(f"{log.stem} {short}: {spill}")
    if spilled:
        raise AssertionError("instantiations that must not spill do: "
                             + "; ".join(spilled))


def print_sass_checks(libs, tool_dir):
    """Which attention kernels' SASS holds tensor-core MMAs (HMMA for
    mma.sync, HGMMA for wgmma) and asynchronous copies (LDGSTS, or
    UTMALDG for TMA), where cuobjdump exists. Raises unless every bf16
    flash backward kernel (``*_wg*``, hd 64 to 256) holds HGMMA and
    LDGSTS and every f32 one (``*_f32``) LDGSTS."""
    tool = Path(tool_dir) / "cuobjdump"
    if not tool.is_file():
        print("  sass: cuobjdump not available")
        return
    missing, seen = [], set()
    for src, lib in libs.items():
        if src.stem not in ("flash", "flash_bwd", "paged_window"):
            continue
        sass = subprocess.run([str(tool), "-sass", str(lib)],
                              capture_output=True, text=True).stdout
        funcs = {}
        for part in sass.split("Function : ")[1:]:
            name, _, body = part.partition("\n")
            funcs[name.strip()] = body
        names = _demangle(list(funcs), tool_dir)
        for short, body in zip(names, funcs.values()):
            has = {op: re.search(r"\b" + op + r"\b", body) is not None
                   for op in ("HMMA", "HGMMA", "LDGSTS", "UTMALDG")}
            print(f"  sass {src.stem}: {short}: " + ", ".join(
                f"{op} {'yes' if yes else 'no'}" for op, yes in has.items()))
            if src.stem != "flash_bwd":
                continue
            need = ("HGMMA", "LDGSTS") if "_wg" in short else ("LDGSTS",)
            missing += [f"{short} lacks {op}" for op in need if not has[op]]
            seen.add("wg" if "_wg" in short else "f32")
    if seen != {"wg", "f32"} or missing:
        raise AssertionError(f"flash backward SASS: routes seen {seen}; "
                             + "; ".join(missing))


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
def _report(name, out, ref, dt, tol=TOL):
    err = (out.float() - ref.float()).abs().max().item()
    print(f"{name}: max |kernel - plain| {err:.3e} (tol {tol[dt]})")
    torch.testing.assert_close(out.float(), ref.float(), atol=tol[dt],
                               rtol=tol[dt])
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
    return max(worst, check_flash_non_causal(flash_attention,
                                             attention_bshd))


def encoder_qkv(Bq, S, dt, seed):
    """q, k, v at the sentence encoder's attention (12 / 12 heads of 64)
    as the model hands them over: (B,S,H,hd) views of its projections."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((Bq, S, ENC_H, ENC_HD), generator=g).to("cuda", dt)
    kv = torch.randn((Bq, S, 2, ENC_H, ENC_HD), generator=g).to("cuda", dt)
    return q, kv[:, :, 0], kv[:, :, 1]


def check_flash_non_causal(flash_attention, attention_bshd):
    """The flash kernel with ``causal=False`` against its plain version:
    at the sentence encoder's shapes (B 8 and 16, S = T = 24, one
    part-filled KV tile), on the model's (B,S,H,hd) views, and at a
    ragged S 37 < T 300; f32 within 3e-5, bf16 3e-2."""
    worst = 0.0
    for dt in (torch.float32, torch.bfloat16):
        for Bq in ENC_BATCHES:
            q, k, v = encoder_qkv(Bq, ENC_S, dt, seed=Bq)
            out = attention_bshd(q, k, v, causal=False)
            ref = attention_bshd(q, k, v, causal=False, force_ref=True)
            torch.cuda.synchronize()
            worst = max(worst, _report(
                f"flash non-causal B {Bq:2d} Hq {ENC_H} Hkv {ENC_H} hd "
                f"{ENC_HD} {str(dt):14s} S = T = {ENC_S} (model views)",
                out, ref, dt, NON_CAUSAL_TOL))
        g = torch.Generator().manual_seed(37)
        q = torch.randn((2, ENC_H, 37, ENC_HD), generator=g).to("cuda", dt)
        k, v = (torch.randn((2, ENC_H, 300, ENC_HD), generator=g)
                .to("cuda", dt) for _ in range(2))
        out = flash_attention(q, k, v, causal=False)
        ref = flash_attention(q, k, v, causal=False, force_ref=True)
        torch.cuda.synchronize()
        worst = max(worst, _report(
            f"flash non-causal B 2 Hq {ENC_H} Hkv {ENC_H} hd {ENC_HD} "
            f"{str(dt):14s} S 37 T 300", out, ref, dt, NON_CAUSAL_TOL))
    return worst


def stripe_case(Bq, Hq, Hkv, hd, dt, seed, T=STRIPE_T):
    """q (B,Hq,hd) and a (B,T,Hkv,hd) K / V stripe pair on the card."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((Bq, Hq, hd), generator=g).to("cuda", dt)
    k, v = (torch.randn((Bq, T, Hkv, hd), generator=g).to("cuda", dt)
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


def device_rows(prof):
    """(self device time in us, event) of every device-side event
    (kernels, copies), longest first: the CPU ops that launch them carry
    the same time again."""
    from torch.autograd import DeviceType
    return sorted(((e.self_device_time_total, e)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda r: -r[0])


def profile_serve(run):
    """Where the time of a serve goes: ``run()`` (returning the engine
    and its wall time) again under torch.profiler (its overhead
    included), device time summed over kernels against the wall time,
    the top kernels, and the port's own kernels below them. Only device
    activity is recorded (kernels, copies and the runtime calls that
    launch them): the profiler parses its events in Python at some 70 us
    each, and with every CPU op recorded the serves of phases 6 and 9 at
    full depth spent minutes there."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng, wall = run()
    rows = device_rows(prof)
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


def time_decode(decode_attention, flush, Hq, Hkv, hd, lens, T=STRIPE_T):
    """The decode kernel at B = len(lens) over a T stripe read in place
    (bf16) at a serve's lengths: kernel, plain version, SDPA with a
    length mask on the contiguous (B,Hkv,T,hd) copy, the bound; then the
    kernel with every row of length 1 (its floor). Returns (kernel,
    plain, bound, bound by, sdpa, floor)."""
    F = torch.nn.functional
    q, k_st, v_st = stripe_case(len(lens), Hq, Hkv, hd, torch.bfloat16,
                                seed=13, T=T)
    k, v = k_st.transpose(1, 2), v_st.transpose(1, 2)   # stripe, in place
    n = torch.tensor(lens, dtype=torch.int32, device="cuda")
    ones = torch.ones_like(n)
    kc, vc = k.contiguous(), v.contiguous()
    mask = (torch.arange(T, device="cuda")[None] < n[:, None].long()
            )[:, None, None, :]                           # (B,1,1,T)
    d_ms = time_ms(lambda: decode_attention(q, k, v, n), flush)
    dp_ms = time_ms(lambda: decode_attention(q, k, v, n, force_ref=True),
                    flush)
    dl_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None], kc, vc, attn_mask=mask, enable_gqa=True), flush)
    df_ms = time_ms(lambda: decode_attention(q, k, v, ones), flush)
    db_ms, db_by = decode_bound(lens, Hq, Hkv, hd, torch.bfloat16)
    print(f"decode B {len(lens)} T {T} Hq {Hq} Hkv {Hkv} hd {hd} bf16, "
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


def bound_ms(flops: float, nbytes: float, dtype=torch.float32):
    """(ms, "bytes" | "operations") of a ``kernels.costs`` pair: the
    larger of the bytes over the card's memory rate and the operations
    over its peak for ``dtype``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_bound(Bq, Hq, Hkv, S, T, hd, dtype, causal=True):
    """``kernels.costs.flash`` as (ms, bound by) at the input type's
    peak."""
    return bound_ms(*costs.flash(Bq, Hq, Hkv, S, T, hd, dtype, causal),
                    dtype)


def decode_bound(lens, Hq, Hkv, hd, dtype):
    return bound_ms(*costs.decode(lens, Hq, Hkv, hd, dtype), dtype)


def bound(q, base, S, dtype, Hkv=HKV):
    """``kernels.costs.paged_window`` of the window case's q and bases
    over its (B, MAX_BLOCKS) table of BS-token blocks."""
    return bound_ms(*costs.paged_window(
        base.tolist(), S, q.shape[2], Hkv, q.shape[3], dtype, BS,
        MAX_BLOCKS), dtype)


def wkv_bound(Bq, T, H, hd):
    return bound_ms(*costs.wkv(Bq, T, H, hd))


def ssm_bound(Bq, T, di, N):
    return bound_ms(*costs.ssm(Bq, T, di, N))


def step_floor_ms(T):
    """Latency floor of T dependent steps: one f32 FMA each."""
    return T * FMA_CYCLES / SM_CLOCK_HZ * 1e3


def _to(tree, device):
    """A tree of dicts and lists of tensors, copied to ``device``."""
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


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


# ------------------------------------------------------------ the CV parser
def build_cv_deployment(n_replicas=2):
    """The paper's cluster as ``examples/serve_parallel_pipeline.py``'s
    ``build_deployment`` stands it up, on the port and the card: tika and
    bert, the five NER services with ``n_replicas`` replicas each (the
    last a backup) behind a balancer, and ``cv_parser`` with the thread
    dispatcher, under a Supervisor; no fault injection (a failed parse
    would fail the smoke). Returns (supervisor, parser, the cv_parser
    service, startup order)."""
    import random
    from repro_torch.core import router
    from repro_torch.core.balancer import deploy
    from repro_torch.core.parallel import ParallelDispatcher
    from repro_torch.core.pipeline import CVParser, NERModel
    from repro_torch.core.services import Replica, Service
    from repro_torch.core.supervisor import Supervisor
    sup = Supervisor()
    sup.add(Service("tika", replicas=[Replica("tika/0", lambda p: p)],
                    priority=0))
    sup.add(Service("bert", replicas=[Replica("bert/0", lambda p: p)],
                    priority=1, depends_on=("tika",)))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    services = {}
    for name in router.ROUTES:
        ner = NERModel.create(name, gen, device="cuda")
        reps = [Replica(f"{name}/{r}", ner,
                        backup=(r == n_replicas - 1 and n_replicas > 1))
                for r in range(n_replicas)]
        svc = Service(name, replicas=reps, priority=2, depends_on=("bert",))
        deploy(svc, max_fails=3, fail_timeout=2.0)
        services[name] = sup.add(svc)
    parser = CVParser.create(
        SEED + 1, services=services, device="cuda",
        dispatcher=ParallelDispatcher(mode="thread", max_workers=16,
                                      rng=random.Random(7)))
    cv = sup.add(Service("cv_parser", replicas=[Replica("cv/0",
                                                        parser.parse)],
                         priority=3, depends_on=tuple(services)))
    return sup, parser, cv, sup.start_all()


def cv_parser_on(parser, device, mode):
    """``parser``'s weights copied to ``device``, each NER model behind a
    one-replica service, with a ``mode`` dispatcher."""
    from repro_torch.core.parallel import ParallelDispatcher
    from repro_torch.core.pipeline import NERModel
    from repro_torch.core.services import Replica, Service
    services = {}
    for name, svc in parser.services.items():
        ner = svc.replicas[0].handler
        own = NERModel(ner.name, ner.cfg, _to(ner.params, device),
                       ner.tokenizer)
        services[name] = Service(name, replicas=[Replica(f"{name}/0", own)])
        services[name].start()
    return replace(parser, services=services,
                   encoder_params=_to(parser.encoder_params, device),
                   classifier_params=_to(parser.classifier_params,
                                             device),
                   dispatcher=ParallelDispatcher(mode=mode))


def cv_margins(parser, other, doc):
    """Where two parsers of the same weights part on ``doc``: the largest
    difference of their section logits and of each service's NER logits
    over the document's sentences, beside the smallest top-2 margin."""
    from repro_torch.core.pipeline import MAX_SENT_LEN
    from repro_torch.models import bert_encoder, bilstm_lan
    tok = parser.tokenizer
    ids = np.array([tok.pad(tok.encode(s.tokens), MAX_SENT_LEN)
                    for s in doc.sentences], np.int32)
    out = []

    def part(name, a, b):
        a, b = a.float().cpu(), b.float().cpu()
        top2 = a.topk(2, dim=-1).values
        out.append(f"{name}: max |diff| {(a - b).abs().max().item():.3e}, "
                   f"min margin {(top2[..., 0] - top2[..., 1]).min():.3e}")

    logits = []
    for p in (parser, other):
        t = torch.from_numpy(ids).to(p.encoder_params["embed"].device)
        emb = bert_encoder.encode_sentences(p.encoder_params, p.encoder_cfg,
                                            t, t != 0)
        logits.append(bert_encoder.classify_sections(p.classifier_params,
                                                     emb))
    part("sections", *logits)
    for name in parser.services:
        ners = [p.services[name].replicas[0].handler for p in (parser, other)]
        part(name, *(bilstm_lan.forward(
            n.params, n.cfg,
            torch.from_numpy(ids).to(n.params["embed"].device))
            for n in ners))
    return "; ".join(out)


def check_cv_fields(got, want, docs, parser, other, what):
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            raise AssertionError(
                f"{what}: document {i} fields differ "
                f"({cv_margins(parser, other, docs[i])})")
    print(f"{what}: fields equal on all {len(docs)} documents, label for "
          f"label")


def pct(vals, q):
    """The q-quantile of ``vals`` (nearest rank)."""
    vals = sorted(vals)
    return vals[max(0, math.ceil(q * len(vals)) - 1)]


def cv_model_server(parser):
    """The deployment's models as a ``MultiModelServer`` on the card (the
    parser's own param tensors): the sentence encoder and the five NER
    models, with the specs of their first batches: the encoder at
    ``docs[0]``'s sentence bucket, each NER model at the smallest one."""
    from repro_torch.core.multimodel import ModelService, MultiModelServer
    from repro_torch.core.pipeline import MAX_SENT_LEN
    from repro_torch.models import bert_encoder, bilstm_lan
    enc_cfg = parser.encoder_cfg
    svcs = [ModelService("encoder", lambda p, ids: bert_encoder
                         .encode_sentences(p, enc_cfg, ids, ids != 0),
                         parser.encoder_params)]
    for name, svc in parser.services.items():
        ner = svc.replicas[0].handler
        svcs.append(ModelService(
            name, lambda p, ids, cfg=ner.cfg: bilstm_lan.predict(p, cfg, ids),
            ner.params))
    return MultiModelServer(svcs, devices=["cuda"]), MAX_SENT_LEN


def lower_cv_models(parser, doc):
    """``MultiModelServer.lower_all`` over the deployment's models before
    the first parse. Returns its wall time in s."""
    server, max_len = cv_model_server(parser)
    n = len(doc.sentences)
    bucket = max(8, 1 << (n - 1).bit_length())
    meta = partial(torch.empty, dtype=torch.int32, device="meta")
    specs = {name: meta((bucket if name == "encoder" else 4, max_len))
             for name in server.services}
    t0 = time.perf_counter()
    with torch.no_grad():
        rec = server.lower_all(specs)
    wall = time.perf_counter() - t0
    print(f"lower_all over {len(rec)} models in {wall:.3f} s: "
          + json.dumps({k: round(v["seconds"] * 1e3, 3)
                        for k, v in rec.items()}) + " ms")
    return wall


def first_parse(lower: bool) -> int:
    """``chip_smoke.py --first-parse cold|lower_all``: in a fresh
    process, stand up phase 11's deployment, optionally warm its models
    with ``lower_all``, and time its first parse; prints one JSON line."""
    from repro_torch.core import cvdata
    torch.backends.cuda.matmul.allow_tf32 = False
    sup, parser, cv, _ = build_cv_deployment()
    doc = cvdata.make_corpus(CV_DOCS, seed=1)[0]
    torch.cuda.synchronize()
    low = lower_cv_models(parser, doc) if lower else None
    t0 = time.perf_counter()
    cv(doc)
    torch.cuda.synchronize()
    print(json.dumps({"lower_all_s": low,
                      "first_parse_ms": (time.perf_counter() - t0) * 1e3}))
    parser.dispatcher.shutdown()
    sup.stop_all()
    return 0


def first_parse_before_after():
    """Phase 11: the first parse of a fresh process without and with
    ``lower_all`` before it (each its own subprocess, on this card)."""
    out = {}
    for mode in ("cold", "lower_all"):
        r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                            "--first-parse", mode], cwd=ROOT,
                           capture_output=True, text=True, timeout=300)
        if r.returncode:
            raise AssertionError(f"--first-parse {mode}: {r.stderr[-2000:]}")
        out[mode] = json.loads(r.stdout.strip().splitlines()[-1])
    print(f"first parse of a fresh process: {out['cold']['first_parse_ms']:.1f}"
          f" ms cold; {out['lower_all']['first_parse_ms']:.1f} ms after "
          f"lower_all ({out['lower_all']['lower_all_s']:.3f} s)")
    return out


def profile_parse(parse, doc):
    """One parse under torch.profiler: device busy time against the wall,
    the idle share, the top device ops."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        parse(doc)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof)
    if not rows:
        raise AssertionError("profiler recorded no device time in a parse")
    busy_ms = sum(t for t, _ in rows) / 1e3
    print(f"profiled parse ({len(doc.sentences)} sentences): wall "
          f"{wall_ms:.2f} ms, device busy {busy_ms:.3f} ms (idle share "
          f"{1 - busy_ms / wall_ms:.3f}), {sum(e.count for _, e in rows)} "
          f"device ops")
    for t, e in rows[:10]:
        print(f"  {t / 1e3:9.4f} ms  {e.count:6d}x  {e.key[:90]}")


def moe_bound_ms(cfg):
    """The MoE FFN of one decode step's layer reads every expert's
    weights once (``kernels.costs.moe_decode_bytes``): bytes over HBM
    bandwidth."""
    nbytes = costs.moe_decode_bytes(cfg)
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes


# ------------------------------------------------------------ the frontends
FRONT_B = 4                     # rows of a frontend run
FRONT_STEPS = 16                # greedy decode steps of phase 12
CHECK_STEPS = 8                 # decode steps of phase 12b's comparisons
WINDOW_S = 4                    # phase 12b's verify window
FRONT_BS = 16                   # block size of qwen2-vl's paged pool
# (Hq, Hkv, hd): whisper-tiny's self- and cross-attention, qwen2-vl-2b's
WHISPER_HEADS, QWEN2VL_HEADS = (6, 6, 64), (12, 2, 128)
N_FRAMES, N_PATCHES = 1500, 256
# text prompt lengths (right-padded to the longest) and stripe capacity
FRONT_RUNS = {"whisper-tiny": ((5, 16, 33, 64), 128),
              "qwen2-vl-2b": ((5, 17, 33, 64), 512)}
QWEN2VL_T = N_PATCHES + 64      # qwen2-vl's prefill: patches + text


def _frontend_qkv(Bq, S, T, heads, dt, seed):
    """q (B,S,Hq,hd) and k / v (B,T,Hkv,hd) on the card as the model hands
    them to flash: views of one K / V projection."""
    Hq, Hkv, hd = heads
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((Bq, S, Hq, hd), generator=g).to("cuda", dt)
    kv = torch.randn((Bq, T, 2, Hkv, hd), generator=g).to("cuda", dt)
    return q, kv[:, :, 0], kv[:, :, 1]


def check_frontend_kernels(attention_bshd, decode_attention):
    """The kernels at the frontends' shapes against their plain versions:
    flash non-causal at whisper-tiny's encoder (B 4, S = T = 1500, 6 / 6
    heads of 64) and cross-attention (S 1 and 16 < T = 1500), f32 within
    3e-5, bf16 3e-2; flash causal at qwen2-vl-2b's prefill (B 4, S = T =
    320, 12 / 2 heads of 128, G 6); decode at both frontends' stripes
    (whisper B 4 over 128, qwen2-vl B 4 over 512, ragged lengths with 1
    and T among them), out and lse, f32 1e-4, bf16 3e-2. Returns the
    largest error of flash and of decode."""
    worst = dec_worst = 0.0
    for dt in (torch.float32, torch.bfloat16):
        for S in (N_FRAMES, 1, 16):
            q, k, v = _frontend_qkv(FRONT_B, S, N_FRAMES, WHISPER_HEADS, dt,
                                    seed=S)
            out = attention_bshd(q, k, v, causal=False)
            ref = attention_bshd(q, k, v, causal=False, force_ref=True)
            torch.cuda.synchronize()
            worst = max(worst, _report(
                f"flash non-causal B {FRONT_B} Hq 6 Hkv 6 hd 64 "
                f"{str(dt):14s} S {S:4d} T {N_FRAMES} (whisper-tiny)",
                out, ref, dt, NON_CAUSAL_TOL))
        q, k, v = _frontend_qkv(FRONT_B, QWEN2VL_T, QWEN2VL_T, QWEN2VL_HEADS,
                                dt, seed=7)
        out = attention_bshd(q, k, v)
        ref = attention_bshd(q, k, v, force_ref=True)
        torch.cuda.synchronize()
        worst = max(worst, _report(
            f"flash causal B {FRONT_B} Hq 12 Hkv 2 hd 128 {str(dt):14s} "
            f"S = T = {QWEN2VL_T} (qwen2-vl-2b)", out, ref, dt))
        for heads, T, lens in ((WHISPER_HEADS, 128, [1, 128, 37, 80]),
                               (QWEN2VL_HEADS, 512, [261, 512, 1, 336])):
            Hq, Hkv, hd = heads
            g = torch.Generator().manual_seed(T + hd)
            q = torch.randn((FRONT_B, Hq, hd), generator=g).to("cuda", dt)
            k, v = (torch.randn((FRONT_B, T, Hkv, hd), generator=g)
                    .to("cuda", dt).transpose(1, 2) for _ in range(2))
            n = torch.tensor(lens, dtype=torch.int32, device="cuda")
            out, lse = decode_attention(q, k, v, n)
            ro, rl = decode_attention(q, k, v, n, force_ref=True)
            torch.cuda.synchronize()
            name = f"decode B {FRONT_B} T {T} Hq {Hq} Hkv {Hkv} hd {hd} " \
                   f"{str(dt):14s} lengths {lens}"
            dec_worst = max(dec_worst, _report(name + " out", out, ro, dt),
                            _report(name + " lse", lse, rl, dt))
    return worst, dec_worst


def frontend_inputs(cfg, seed, device="cuda"):
    """FRONT_B rows of seeded text, right-padded (pad id 0) to the longest
    of the config's prompt lengths, each row's last text index, and the
    frontend's seeded frames (B, 1500, d) or patch embeds (B, 256, d), all
    on ``device``; frames / patches in cfg.dtype."""
    lens, _ = FRONT_RUNS[cfg.name]
    g = torch.Generator(device=device).manual_seed(seed)
    S = max(lens)
    toks = torch.randint(2, cfg.vocab_size, (FRONT_B, S), generator=g,
                         device=device, dtype=torch.int32)
    last = torch.tensor(lens, device=device) - 1
    toks = toks * (torch.arange(S, device=device)[None] <= last[:, None])
    batch = {"tokens": toks}
    n, key = (cfg.n_frames, "frames") if cfg.frontend == "audio" \
        else (cfg.n_patches, "patch_embeds")
    batch[key] = torch.randn((FRONT_B, n, cfg.d_model), generator=g,
                             device=device).to(cfg.dtype)
    return batch, last


def frontend_prefill(model, params, batch, last):
    """One prefill of right-padded rows: (logits (B,1,V), fresh cache,
    each row's cached length, seconds)."""
    sync(model.device)
    t0 = time.perf_counter()
    logits, kv = model.prefill(params, batch, last_idx=last)
    sync(model.device)
    prefix = model.cfg.n_patches if model.cfg.frontend == "vision" else 0
    return logits, kv, (last + 1 + prefix).to(torch.int32), \
        time.perf_counter() - t0


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def stripes_from(model, kv, cap):
    """``init_cache(B, cap)`` stripes holding a prefill's cache."""
    cache = model.init_cache(FRONT_B, cap)
    S = kv["k"].shape[2]
    for key, t in kv.items():
        if key in ("k", "v"):
            cache[key][:, :, :S] = t
        else:
            cache[key].copy_(t)
    return cache


def pool_from(model, kv, cap):
    """A paged pool (block size FRONT_BS) holding a prefill's K / V and a
    hand-built block table: row b owns blocks b * cap / bs + 1 onwards,
    in reverse order; block 0 is scratch."""
    per_row = cap // FRONT_BS
    pool = model.init_paged_cache(FRONT_B * per_row + 1, FRONT_BS)
    table = torch.stack([torch.arange(per_row, 0, -1) + b * per_row
                         for b in range(FRONT_B)]).to(model.device,
                                                      torch.int32)
    S = kv["k"].shape[2]
    pos = torch.arange(S, device=model.device)
    for b in range(FRONT_B):
        blocks = table[b].long()[pos // FRONT_BS]
        for key in ("k", "v"):
            pool[key][:, blocks, pos % FRONT_BS] = kv[key][:, b]
    return pool, table


def greedy_decode(model, params, logits, cache, n, steps, **kw):
    """``steps`` greedy decode steps from a prefill's logits at per-row
    lengths ``n``: (tokens (B, steps), their logprobs, every step's
    logits (B, steps, V), the top-2 margin of each choice, seconds)."""
    toks, lps, outs, margins = [], [], [], []
    cur = logits[:, -1]
    sync(model.device)
    t0 = time.perf_counter()
    for _ in range(steps):
        lp = torch.log_softmax(cur.float(), dim=-1)
        top = torch.topk(cur.float(), 2, dim=-1).values
        tok = lp.argmax(dim=-1)
        toks.append(tok)
        lps.append(lp.gather(1, tok[:, None])[:, 0])
        margins.append(top[:, 0] - top[:, 1])
        cur = model.decode_step(params, tok[:, None].to(torch.int32), cache,
                                n, **kw)[0][:, -1]
        outs.append(cur)
        n = n + 1
    sync(model.device)
    return (torch.stack(toks, 1), torch.stack(lps, 1), torch.stack(outs, 1),
            torch.stack(margins, 1), time.perf_counter() - t0)


def check_frontend_tokens(cfg, toks, lps, logits):
    if not torch.isfinite(logits[..., :cfg.vocab_size]).all():
        raise AssertionError(f"{cfg.name}: non-finite logits")
    if logits.shape[-1] != -(-cfg.vocab_size // 128) * 128:
        raise AssertionError(f"{cfg.name}: logits {tuple(logits.shape)}")
    if not (0 <= int(toks.min()) and int(toks.max()) < cfg.vocab_size):
        raise AssertionError(f"{cfg.name}: a token out of the vocabulary")
    if not (torch.isfinite(lps).all() and (lps <= 0).all()):
        raise AssertionError(f"{cfg.name}: bad logprobs")


def frontend_serve(name, get_config, build_model, kernel_fns):
    """Phase 12 for one config: full width, bf16, seed-0 weights; one
    prefill of FRONT_B right-padded rows with the frontend's input, its
    cache moved into ``init_cache(B, cap)`` stripes, FRONT_STEPS greedy
    decode steps at per-row lengths. Kernel launches are counted from 0
    over the prefill and over the decode steps, and must be exactly: flash
    once per attention layer at the prefill (whisper: 4 encoder + 4 self
    + 4 cross) and once per cross-attention layer a decode step, the
    decode kernel once per layer a decode step, the others never. Then
    the same run under torch.profiler. Returns ({name: launches}, the
    rows' valid lengths at the last step, the stripe capacity)."""
    cfg = get_config(name)
    model = build_model(cfg, device="cuda")
    t0 = time.perf_counter()
    params = model.init(SEED)
    torch.cuda.synchronize()
    leaves = list(_leaves(params))
    lens, cap = FRONT_RUNS[name]
    print(f"--- {name}: {cfg.n_layers} layers"
          + (f" + {cfg.encoder_layers} encoder layers, {cfg.n_frames} "
             "frames" if cfg.encoder_layers else
             f", {cfg.n_patches} patches (M-RoPE)")
          + f", d {cfg.d_model}, {cfg.n_heads} / {cfg.n_kv_heads} heads of "
          f"{cfg.hd}, vocab {cfg.vocab_size}: "
          f"{sum(t.numel() for t in leaves) / 1e9:.3f} B params, "
          f"{sum(t.numel() * t.element_size() for t in leaves) / 1e9:.2f} "
          f"GB, init {time.perf_counter() - t0:.1f} s; text {list(lens)}, "
          f"B {FRONT_B}, stripes of {cap}")
    batch, last = frontend_inputs(cfg, SEED, model.device)
    L = cfg.n_layers
    cross = cfg.cross_attention
    want_prefill = {"flash_attention": L + (cfg.encoder_layers + L
                                            if cross else 0)}
    want_step = {"decode_attention": L, "flash_attention": L if cross else 0}

    def run():
        for fn in kernel_fns:
            fn.launches = 0
        logits, kv, n, t_pre = frontend_prefill(model, params, batch, last)
        pre = {fn.__name__: fn.launches for fn in kernel_fns}
        for fn in kernel_fns:
            fn.launches = 0
        out = greedy_decode(model, params, logits, stripes_from(model, kv,
                                                                cap),
                            n, FRONT_STEPS)
        dec = {fn.__name__: fn.launches for fn in kernel_fns}
        return logits, n, out, pre, dec, t_pre

    run()                                            # warm-up
    logits, n, (toks, lps, outs, _, t_dec), pre, dec, t_pre = run()
    check_frontend_tokens(cfg, toks, lps, logits)
    check_frontend_tokens(cfg, toks, lps, outs)
    for what, got, per in (("prefill", pre, want_prefill),
                           ("decode", dec, {k: FRONT_STEPS * v
                                            for k, v in want_step.items()})):
        want = {fn.__name__: per.get(fn.__name__, 0) for fn in kernel_fns}
        print(f"{what} launches {json.dumps(got)}")
        if got != want:
            raise AssertionError(f"{name} {what} launches {got} != {want}")
    n_tok = FRONT_B * FRONT_STEPS
    print(f"prefill {t_pre * 1e3:.2f} ms; {FRONT_STEPS} decode steps "
          f"{t_dec * 1e3:.2f} ms ({t_dec / FRONT_STEPS * 1e3:.3f} ms a step, "
          f"{n_tok / t_dec:.1f} tok/s); first tokens "
          f"{toks[:, :4].tolist()}")

    def profiled():
        t0 = time.perf_counter()
        run()
        return SimpleNamespace(metrics={"decode_steps": FRONT_STEPS}), \
            time.perf_counter() - t0

    profile_serve(profiled)
    launches = {k: pre[k] + dec[k] for k in pre}
    del params, model
    torch.cuda.empty_cache()
    return launches, (n + FRONT_STEPS).tolist(), cap


def frontend_checks(name, get_config, build_model, paged_fn):
    """Phase 12b for one config, f32, full width (qwen2-vl-2b cut to 4
    layers), seed-0 weights: the port on the card against the port on
    the CPU (prefill logits within 1e-3, CHECK_STEPS greedy tokens
    identical, logprobs within 1e-3; the top-2 margins printed on a
    difference); qwen2-vl's paged decode through the paged kernel (a
    hand-built block table) against its stripe decode (tokens identical,
    logprobs within 1e-3, the kernel once per layer a step); a verify
    window of WINDOW_S tokens on stripes against as many decode steps
    (logits within 1e-3)."""
    cfg = replace(get_config(name), dtype=torch.float32)
    if cfg.frontend == "vision":
        cfg = replace(cfg, n_layers=4)
    lens, cap = FRONT_RUNS[name]
    card = build_model(cfg, device="cuda")
    params = card.init(SEED)
    batch, last = frontend_inputs(cfg, SEED + 1, card.device)
    logits, kv, n, _ = frontend_prefill(card, params, batch, last)
    toks, lps, outs, margins, _ = greedy_decode(
        card, params, logits, stripes_from(card, kv, cap), n, CHECK_STEPS)
    host = build_model(cfg, device="cpu")
    hparams = _to(params, "cpu")
    hlogits, hkv, hn, _ = frontend_prefill(host, hparams, _to(batch, "cpu"),
                                           last.cpu())
    htoks, hlps, _, hmargins, _ = greedy_decode(
        host, hparams, hlogits, stripes_from(host, hkv, cap), hn,
        CHECK_STEPS)
    err = (logits.cpu() - hlogits).abs().max().item()
    lp_err = (lps.cpu() - hlps).abs().max().item()
    print(f"{name} ({cfg.n_layers} layers, f32), card vs CPU: prefill "
          f"logits max |diff| {err:.3e} (tol 1e-3); {CHECK_STEPS} greedy "
          f"tokens {'identical' if torch.equal(toks.cpu(), htoks) else 'DIFFER'}"
          f"; logprobs max |diff| {lp_err:.3e} (tol 1e-3)")
    if not torch.equal(toks.cpu(), htoks):
        print(f"top-2 logit margins, card: {margins.tolist()}; CPU: "
              f"{hmargins.tolist()}")
        raise AssertionError(f"{name}: card tokens {toks.tolist()} != CPU "
                             f"{htoks.tolist()}")
    if err > 1e-3 or lp_err > 1e-3:
        raise AssertionError(f"{name}: card vs CPU differ by {err} / "
                             f"{lp_err}")
    del host, hparams, hkv
    if cfg.frontend == "vision":
        pool, table = pool_from(card, kv, cap)
        paged_fn.launches = 0
        ptoks, plps, _, _, _ = greedy_decode(
            card, params, logits, pool, n, CHECK_STEPS, block_table=table,
            paged_kernel=True)
        p_err = (plps - lps).abs().max().item()
        print(f"{name} paged (bs {FRONT_BS}, paged kernel) vs stripes: "
              f"tokens {'identical' if torch.equal(ptoks, toks) else 'DIFFER'}"
              f", logprobs max |diff| {p_err:.3e} (tol 1e-3); paged kernel "
              f"launches {paged_fn.launches} = {cfg.n_layers} x "
              f"{CHECK_STEPS}")
        if not torch.equal(ptoks, toks) or p_err > 1e-3:
            raise AssertionError(f"{name}: paged decode differs from "
                                 f"stripes")
        if paged_fn.launches != cfg.n_layers * CHECK_STEPS:
            raise AssertionError(f"paged kernel launched "
                                 f"{paged_fn.launches} times")
        del pool
    wl, _ = card.verify_step(params, toks[:, :WINDOW_S].to(torch.int32),
                             stripes_from(card, kv, cap), n)
    w_err = (wl - outs[:, :WINDOW_S]).abs().max().item()
    print(f"{name} verify window S {WINDOW_S} vs {WINDOW_S} decode steps: "
          f"logits max |diff| {w_err:.3e} (tol 1e-3)")
    if w_err > 1e-3:
        raise AssertionError(f"{name}: window differs by {w_err}")
    del card, params, kv
    torch.cuda.empty_cache()
    return max(err, lp_err, w_err)


def time_frontends(attention_bshd, decode_attention, flush, front_lens):
    """bf16 timing rows at the frontends' shapes, each beside its plain
    version, one SDPA call and its bound: flash at whisper-tiny's encoder
    (B 4, S = T = 1500, non-causal), at its cross-attention decode (S 1
    against T 1500 in the cache's contiguous layout, beside the decode
    kernel on the same inputs with every length T, which computes the
    same function) and at qwen2-vl-2b's prefill (B 4, S = T = 320,
    causal, G 6); the decode kernel at both frontends' stripes at phase
    12's final lengths. Returns the flash row's and the decode row's
    extra keys."""
    F = torch.nn.functional
    dt = torch.bfloat16
    flash, dec = {}, {}
    for key, S, heads, causal in (
            ("whisper_enc", N_FRAMES, WHISPER_HEADS, False),
            ("whisper_xattn_decode", 1, WHISPER_HEADS, False),
            ("qwen2vl_prefill", QWEN2VL_T, QWEN2VL_HEADS, True)):
        T = QWEN2VL_T if causal else N_FRAMES
        q, k, v = _frontend_qkv(FRONT_B, S, T, heads, dt, seed=31)
        if S == 1:
            k, v = k.contiguous(), v.contiguous()
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        k_ms = time_ms(lambda: attention_bshd(q, k, v, causal=causal), flush)
        p_ms = time_ms(lambda: attention_bshd(q, k, v, causal=causal,
                                              force_ref=True), flush)
        l_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True), flush)
        b_ms, b_by = flash_bound(FRONT_B, heads[0], heads[1], S, T, heads[2],
                                 dt, causal=causal)
        flash.update({f"{key}_ms": k_ms, f"{key}_plain_ms": p_ms,
                      f"{key}_library_ms": l_ms, f"{key}_bound_ms": b_ms,
                      f"{key}_bound_by": b_by})
        line = f"flash {key}: B {FRONT_B} S {S} T {T} Hq {heads[0]} Hkv " \
               f"{heads[1]} hd {heads[2]} bf16 " \
               f"{'causal' if causal else 'non-causal'}: kernel " \
               f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, sdpa {l_ms:.4f} ms, " \
               f"bound {b_ms:.5f} ms ({b_by})"
        if S == 1:
            n = torch.full((FRONT_B,), T, dtype=torch.int32, device="cuda")
            d_ms = time_ms(lambda: decode_attention(
                q[:, 0], k.transpose(1, 2), v.transpose(1, 2), n), flush)
            flash[f"{key}_decode_kernel_ms"] = d_ms
            line += f"; the decode kernel on the same inputs {d_ms:.4f} ms"
        print(line)
    for key, heads, arch in (("whisper", WHISPER_HEADS, "whisper-tiny"),
                             ("qwen2vl", QWEN2VL_HEADS, "qwen2-vl-2b")):
        lens, cap = front_lens[arch]
        times = time_decode(decode_attention, flush, *heads, lens, T=cap)
        dec.update({f"{key}_{name}": val for name, val in zip(
            ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
             "floor_ms"), times)})
    return flash, dec


# ------------------------------------------------------------- training
TRAIN_B, TRAIN_S = 2, 1024      # phase 13b's batch: 2 rows of 1024 tokens
TRAIN_LAYERS, TRAIN_STEPS = 4, 5
GRAD_B, GRAD_S, GRAD_LAYERS = 2, 512, 2     # phase 13c, f32
REC_GRAD_S = 256                # phase 13f's sequence, f32
# 13e: launches a layer a step of each recurrent family's train run, at
# full depth (a forward twice under remat)
RECURRENT_TRAIN = {
    "rwkv6-1.6b": {"wkv_scan": 2, "wkv_bwd": 1},
    "hymba-1.5b": {"flash_attention": 2, "flash_attention_bwd": 1,
                   "ssm_scan": 2, "ssm_scan_bwd": 1},
}
# the backward kernel against its plain version, of each gradient's
# largest |g|: f32 sum-order noise; bf16 one rounding of the output
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
LSE_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3}
# (name, B, Hq, Hkv, S, T, hd, causal, window)
BWD_CASES = (
    ("qwen3-4b train", TRAIN_B, 32, 8, TRAIN_S, TRAIN_S, 128, True, 0),
    ("whisper encoder", 2, 6, 6, 1500, 1500, 64, False, 0),
    ("whisper cross-attention", 2, 6, 6, 448, 1500, 64, False, 0),
    ("qwen2-vl prefill", 2, 12, 2, 320, 320, 128, True, 0),
    ("sliding window 128", 1, 32, 8, 512, 512, 128, True, 128),
    ("hd 112", 1, 16, 8, 256, 256, 112, True, 0),
    ("hd 192", 1, 12, 4, 256, 256, 192, True, 0),
    ("S < T", 2, 32, 8, 64, 300, 128, True, 0),
    ("ragged S, window 24", 1, 25, 5, 37, 101, 64, True, 24),
    ("keyless rows, S > T", 1, 8, 2, 40, 20, 64, True, 0),
    ("hymba train", TRAIN_B, 25, 5, TRAIN_S, TRAIN_S, 64, True, 2048),
    ("nemotron attention", 1, 96, 8, 2048, 2048, 192, True, 0),
    ("hd 256", 2, 8, 2, 300, 333, 256, True, 0),
)
BWD_BY_NAME = {case[0]: case for case in BWD_CASES}
# nemotron-4-340b's attention at its 4,096-token training length: timed
# only (13a checks it at 2048)
NEMOTRON_TRAIN = ("nemotron attention", 1, 96, 8, 4096, 4096, 192, True, 0)


def bwd_inputs(Bq, Hq, Hkv, S, T, hd, dt, seed):
    """q, k, v, dout on the card: (B,Hq,S,hd), (B,Hkv,T,hd) x 2,
    (B,Hq,S,hd)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda").to(dt)
            for shape in ((Bq, Hq, S, hd), (Bq, Hkv, T, hd),
                          (Bq, Hkv, T, hd), (Bq, Hq, S, hd))]


def flash_bwd_bound(Bq, Hq, Hkv, S, T, hd, dtype, causal, window):
    return bound_ms(*costs.flash_bwd(Bq, Hq, Hkv, S, T, hd, dtype,
                                     causal, window), dtype)


def check_flash_backward(fwd_kernel, bwd_kernel, flash_op, ref_fwd,
                         ref_bwd):
    """Phase 13a: at every BWD_CASES shape, f32 and bf16: the forward's
    lse against the plain lse (-inf exactly on rows that see no key),
    then the backward kernel against ``flash_attention_bwd_ref`` on the
    same inputs (the kernel's out and lse), twice bitwise equal, no NaN,
    zero dq on keyless rows; then the autograd route of the op equals
    the direct call bit for bit. Returns the largest absolute error."""
    worst = 0.0
    for name, Bq, Hq, Hkv, S, T, hd, causal, win in BWD_CASES:
        for dt in (torch.float32, torch.bfloat16):
            q, k, v, do = bwd_inputs(Bq, Hq, Hkv, S, T, hd, dt, seed=S + T)
            out, lse = fwd_kernel(q, k, v, causal=causal,
                                  sliding_window=win, with_lse=True)
            _, rlse = ref_fwd(q, k, v, causal=causal, sliding_window=win,
                              return_lse=True)
            live = torch.isfinite(rlse)
            if not torch.equal(torch.isfinite(lse), live):
                raise AssertionError(f"{name} {dt}: lse finite where the "
                                     f"plain lse is not, or the reverse")
            lse_err = float((lse - rlse)[live].abs().max()) \
                if live.any() else 0.0
            got = bwd_kernel(q, k, v, out, lse, do, causal=causal,
                             sliding_window=win)
            again = bwd_kernel(q, k, v, out, lse, do, causal=causal,
                               sliding_window=win)
            want = ref_bwd(q, k, v, out, lse, do, causal=causal,
                           sliding_window=win)
            torch.cuda.synchronize()
            errs = []
            for label, g, g2, w in zip("q k v".split(), got, again, want):
                if not torch.equal(g, g2):
                    raise AssertionError(f"{name} {dt}: d{label} differs "
                                         f"between two runs")
                if not torch.isfinite(g).all():
                    raise AssertionError(f"{name} {dt}: d{label} not finite")
                err = float((g.float() - w.float()).abs().max())
                scale = float(w.float().abs().max())
                if not scale > 0:
                    raise AssertionError(f"{name} {dt}: the plain d{label} "
                                         f"is all zero: nothing is checked")
                errs.append((err, scale))
                worst = max(worst, err)
                if err > BWD_TOL[dt] * scale:
                    raise AssertionError(f"{name} {dt}: d{label} off by "
                                         f"{err} (largest |g| {scale})")
            dead = ~live
            if dead.any() and (got[0][dead] != 0).any():
                raise AssertionError(f"{name} {dt}: a keyless row's dq is "
                                     f"not 0")
            if lse_err > LSE_TOL[dt]:
                raise AssertionError(f"{name} {dt}: lse off by {lse_err}")
            print(f"{name}: B {Bq} Hq {Hq} Hkv {Hkv} S {S} T {T} hd {hd} "
                  f"{'causal' if causal else 'non-causal'} window {win} "
                  f"{str(dt)[6:]}: lse {lse_err:.2e}; dq / dk / dv max abs "
                  + " / ".join(f"{e:.2e}" for e, _ in errs)
                  + " (largest |g| " + " / ".join(f"{m:.3f}" for _, m in errs)
                  + f"; tol {BWD_TOL[dt]} of it); {int(dead.sum())} keyless "
                  f"rows")
    # the autograd route: FlashAttention.apply through the op
    q, k, v, do = bwd_inputs(*BWD_CASES[0][1:7], torch.bfloat16, seed=7)
    direct_out, lse = fwd_kernel(q, k, v, with_lse=True)
    direct = bwd_kernel(q, k, v, direct_out, lse, do)
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = flash_op(qg, kg, vg)
    via = torch.autograd.grad(out, (qg, kg, vg), do)
    if not torch.equal(out.detach(), direct_out) or \
            not all(torch.equal(a, b) for a, b in zip(via, direct)):
        raise AssertionError("the autograd route differs from the direct "
                             "kernel calls")
    print("autograd route (ops.flash_attention on inputs that require "
          "grad) = direct forward + backward kernel calls, bitwise")
    return worst


def check_grad_refusals(ops, scan_ops):
    """The paged-window and decode ops, which serve only, and the WKV and
    selective-scan kernels called directly raise when autograd would
    record them, and run under torch.no_grad(); the WKV and
    selective-scan ops run under grad through their autograd functions,
    with a finite gradient."""
    paged, decode, wkv_direct, ssm_direct = ops
    args = {
        "paged_window_attention": (paged, list(window_case(
            4, torch.float32, [0, 17, 64, 100], seed=3))),
        "decode_attention": (decode, [*(t.transpose(1, 2) if t.dim() == 4
                                        else t for t in stripe_case(
                                            4, 32, 8, 128, torch.float32, 3,
                                            T=256)),
                                      torch.tensor([1, 17, 100, 256],
                                                   dtype=torch.int32,
                                                   device="cuda")]),
        "wkv_scan (kernel called directly)": (wkv_direct,
                                              wkv_case(2, 8, 4, 64, seed=3)),
        "ssm_scan (kernel called directly)": (ssm_direct,
                                              ssm_case(2, 8, 64, 16, seed=3)),
    }
    for name, (op, a) in args.items():
        a = list(a)
        a[0] = a[0].clone().requires_grad_(True)
        try:
            op(*a)
        except RuntimeError as e:
            if "no backward" not in str(e):
                raise
            print(f"{name}: raises under grad ({str(e)[:70]}...)")
        else:
            raise AssertionError(f"{name} ran with an input that requires "
                                 f"grad")
        with torch.no_grad():
            op(*a)
    for name, op, a in (("wkv", scan_ops[0], wkv_case(2, 8, 4, 64, seed=3)),
                        ("selective_scan", scan_ops[1],
                         ssm_case(2, 8, 64, 16, seed=3))):
        a = list(a)
        a[0] = a[0].clone().requires_grad_(True)
        out, _ = op(*a)
        (g,) = torch.autograd.grad(out.sum(), a[0])
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name}: gradient not finite")
        print(f"{name} (op): runs under grad through its autograd function")
    torch.cuda.synchronize()


# the scan backward kernels (13a): rwkv6-1.6b's and hymba-1.5b's train
# shapes, then one step, the 16-step chunk edge, a 300-step prefill, hd
# 32, and hymba's width with a ragged channel tail (d_inner 3,204: 200
# CTAs of 16 channels and one of 4)
WKV_TRAIN = (TRAIN_B, TRAIN_S, 32, 64)          # (B, T, H, hd)
SSM_TRAIN = (TRAIN_B, TRAIN_S, 3200, 16)        # (B, T, d_inner, N)
WKV_BWD_SHAPES = (WKV_TRAIN, (8, 1, 32, 64), (2, 17, 32, 64),
                  (1, PREFILL_T, 32, 64), (4, 64, 4, 32))
SSM_BWD_SHAPES = (SSM_TRAIN, (8, 1, 3200, 16), (2, 17, 3200, 16),
                  (1, PREFILL_T, 3200, 16), (2, 64, 3204, 16))
# 13a also: the shapes a plan's tensor-parallel bodies give each rank at
# the train shape: rwkv6-1.6b's 32 heads over a model axis of 16 / 4,
# hymba-1.5b's d_inner 3,200 over 16 / 4 (200 channels: 12 CTAs of 16 and
# a ragged tail of 8)
WKV_SHARD_SHAPES = ((TRAIN_B, TRAIN_S, 2, 64), (TRAIN_B, TRAIN_S, 8, 64))
SSM_SHARD_SHAPES = ((TRAIN_B, TRAIN_S, 200, 16), (TRAIN_B, TRAIN_S, 800, 16))


def wkv_bwd_case(Bq, T, H, hd, *, seed=0):
    """``wkv_case`` with decays in the model's range (exact zeros among
    them), and the cotangents dout and dstate_out."""
    args = wkv_case(Bq, T, H, hd, seed=seed, decays="model")
    g = torch.Generator().manual_seed(seed + 1)
    cots = [torch.randn(shape, generator=g).cuda()
            for shape in ((Bq, T, H, hd), (Bq, H, hd, hd))]
    return args, cots


def ssm_bwd_case(Bq, T, di, N, *, seed=0):
    """``ssm_case`` with hymba's A (-1 .. -N on every channel, its
    ``A_log`` init) and one step in 16 at dt 8, where exp(dt A)
    underflows to 0, and the cotangents dy and dstate_out."""
    u, dt, Bm, Cm, _, D, s0 = ssm_case(Bq, T, di, N, seed=seed)
    g = torch.Generator().manual_seed(seed + 1)
    A = -torch.arange(1, N + 1, dtype=torch.float32).expand(di, N)
    dt = torch.where(torch.rand(dt.shape, generator=g).cuda() < 1 / 16,
                     8.0, dt)
    cots = [torch.randn(shape, generator=g).cuda()
            for shape in ((Bq, T, di), (Bq, di, N))]
    return [u, dt, Bm, Cm, A.contiguous().cuda(), D, s0], cots


def check_scan_backward(name, fwd, bwd, bwd_ref, fwd_ref, ck_ref, case,
                        shapes, labels):
    """Phase 13a: the training forward ``fwd`` (``checkpoints=True``) at
    each shape, its checkpoints against the plain states ``ck_ref`` (within
    ``scan_tol``) and its out and final state bitwise the serving call's;
    then the backward kernel ``bwd`` fed those checkpoints against its
    plain version ``bwd_ref`` and against autograd of the plain forward
    ``fwd_ref`` on the same inputs and cotangents: each gradient within
    BWD_TOL (f32) of its largest |g|, two calls bitwise equal, nothing
    NaN. Returns the largest absolute error against the plain version."""
    tol = BWD_TOL[torch.float32]
    worst = 0.0
    for shape in shapes:
        args, cots = case(*shape, seed=shape[1] + 7)
        out, st, ck = fwd(*args, checkpoints=True)
        out2, st2 = fwd(*args)
        if not (torch.equal(out, out2) and torch.equal(st, st2)):
            raise AssertionError(f"{name} {shape}: the training forward's "
                                 f"out / state differ from serving's")
        want_ck = ck_ref(*args)
        ck_err = float((ck - want_ck).abs().max()) if ck.numel() else 0.0
        if ck.shape != want_ck.shape or not ck_err <= scan_tol(shape[1]):
            raise AssertionError(f"{name} {shape}: checkpoints {ck.shape} "
                                 f"off by {ck_err}")
        got = bwd(*args, ck, *cots)
        again = bwd(*args, ck, *cots)
        want = bwd_ref(*args, *cots)
        leaves = [t.clone().requires_grad_(True) for t in args]
        auto = torch.autograd.grad(fwd_ref(*leaves), leaves, cots)
        torch.cuda.synchronize()
        errs = []
        for label, g, g2, w, a in zip(labels, got, again, want, auto):
            if not torch.equal(g, g2):
                raise AssertionError(f"{name} {shape}: d{label} differs "
                                     f"between two calls")
            if not torch.isfinite(g).all():
                raise AssertionError(f"{name} {shape}: d{label} not finite")
            scale = float(w.abs().max())
            if not scale > 0:
                raise AssertionError(f"{name} {shape}: the plain d{label} "
                                     f"is all zero: nothing is checked")
            err = float((g - w).abs().max())
            err_auto = float((g - a).abs().max())
            worst = max(worst, err)
            errs.append(max(err, err_auto) / scale)
            if max(err, err_auto) > tol * scale:
                raise AssertionError(f"{name} {shape}: d{label} off by "
                                     f"{err} (plain backward) / {err_auto} "
                                     f"(autograd), largest |g| {scale}")
        n_ck = ck.shape[2 if name == "wkv" else 1]
        print(f"{name} backward {shape}: {n_ck} checkpoints within "
              f"{ck_err:.1e} of the plain states, out and state bitwise "
              f"serving's; of each gradient's largest "
              f"|g|, " + " / ".join(f"d{x}" for x in labels) + " "
              + " / ".join(f"{e:.1e}" for e in errs)
              + f" (against the plain backward and autograd of the plain "
              f"forward; tol {tol}); two calls bitwise equal")
        del got, again, want, auto, leaves, ck, want_ck
    torch.cuda.empty_cache()
    return worst


def wkv_bwd_bound(Bq, T, H, hd):
    return bound_ms(*costs.wkv_bwd(Bq, T, H, hd))


def ssm_bwd_bound(Bq, T, di, N):
    return bound_ms(*costs.ssm_bwd(Bq, T, di, N))


def time_scan_backward(fwds, bwds, refs, fwd_refs, ops, flush):
    """Each scan's training pieces at its train shape: the backward kernel
    fed the forward's checkpoints beside its plain version and its bound
    (no PyTorch call computes either gradient); the serving forward and
    the training forward (with checkpoints) beside the forward's bound and
    its plain version; the autograd pair (the op on inputs that require
    grad, then ``torch.autograd.grad`` of its output). ``fwds``, ``bwds``,
    ``refs``, ``fwd_refs`` and ``ops`` hold (wkv, selective scan). Returns
    {name: (kernel ms, plain ms, bound ms, bound by, forward ms, forward
    with checkpoints ms, forward bound ms, forward bound by, pair ms,
    plain forward ms)}."""
    rows = {}
    for (name, fwd, bwd, ref, fwd_ref, op, case, bound_fn, fbound_fn,
         shape) in (
            ("wkv_bwd", fwds[0], bwds[0], refs[0], fwd_refs[0], ops[0],
             wkv_bwd_case, wkv_bwd_bound, wkv_bound, WKV_TRAIN),
            ("ssm_scan_bwd", fwds[1], bwds[1], refs[1], fwd_refs[1], ops[1],
             ssm_bwd_case, ssm_bwd_bound, ssm_bound, SSM_TRAIN)):
        args, cots = case(*shape, seed=11)
        ck = fwd(*args, checkpoints=True)[2]
        k_ms = time_ms(lambda: bwd(*args, ck, *cots), flush, iters=10,
                       warmup=2)
        p_ms = time_ms(lambda: ref(*args, *cots), flush, iters=3, warmup=1)
        f_ms = time_ms(lambda: fwd(*args), flush)
        fc_ms = time_ms(lambda: fwd(*args, checkpoints=True), flush)
        pf_ms = time_ms(lambda: fwd_ref(*args), flush, iters=3, warmup=1)
        leaves = [t.clone().requires_grad_(True) for t in args]
        pair_ms = time_ms(lambda: torch.autograd.grad(
            op(*leaves)[0], leaves, cots[0]), flush, iters=10, warmup=2)
        b_ms, b_by = bound_fn(*shape)
        fb_ms, fb_by = fbound_fn(*shape)
        rows[name] = (k_ms, p_ms, b_ms, b_by, f_ms, fc_ms, fb_ms, fb_by,
                      pair_ms, pf_ms)
        print(f"{name} {shape} (train shape): kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}), latency floor "
              f"of {shape[1]} dependent steps {step_floor_ms(shape[1]):.5f} "
              f"ms; no library call computes it. Forward: serving "
              f"{f_ms:.4f} ms, with checkpoints {fc_ms:.4f} ms "
              f"({ck.numel() * 4 / 1e6:.1f} MB), bound {fb_ms:.5f} ms "
              f"({fb_by}), plain {pf_ms:.4f} ms; autograd forward + "
              f"backward {pair_ms:.4f} ms")
        del args, cots, ck, leaves
        torch.cuda.empty_cache()
    return rows


def scan_bwd_launch_split(fwds, bwds, calls=10):
    """Device ms per backward call of each kernel the WKV and
    selective-scan backwards launch at their train shapes, from
    ``torch.profiler`` over ``calls`` calls, as ``bwd_launch_split`` does
    for flash (and, like it, before any other trace). Returns {name:
    {kernel: ms}}."""
    from torch.profiler import ProfilerActivity, profile
    split = {}
    for name, fwd, bwd, case, shape in (
            ("wkv_bwd", fwds[0], bwds[0], wkv_bwd_case, WKV_TRAIN),
            ("ssm_scan_bwd", fwds[1], bwds[1], ssm_bwd_case, SSM_TRAIN)):
        args, cots = case(*shape, seed=11)
        ck = fwd(*args, checkpoints=True)[2]
        bwd(*args, ck, *cots)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                bwd(*args, ck, *cots)
            torch.cuda.synchronize()
        rows = {}
        for t, e in device_rows(prof):
            key = e.key.replace("(anonymous namespace)::", "") \
                .removeprefix("void ").split("(")[0]
            rows[key] = rows.get(key, 0.0) + t / 1e3 / calls
        split[name] = rows
        del args, cots, ck
    torch.cuda.empty_cache()
    return split


def _zero(fns):
    for fn in fns:
        fn.launches = 0


def train_full_width(arch, n_layers, get_config, build_model, fns,
                     per_layer):
    """Phases 13b / 13e: ``arch`` at full width, bf16, remat, cut to
    ``n_layers`` layers (all with None), through ``train()`` for
    TRAIN_STEPS steps at B TRAIN_B x S TRAIN_S. Every launch count of
    ``fns`` is set to 0 just before and read just after; ``per_layer``
    gives each kernel's launches a layer a step ({name: n}, any other
    kernel 0). The losses must be finite and the last below the first.
    Returns (launches, metrics)."""
    import tempfile

    from repro_torch.train import checkpoint, optimizer as opt_mod, tree
    from repro_torch.train.data import (DataConfig, PackedLMDataset,
                                        sharded_batches)
    from repro_torch.train.train_loop import (TrainerConfig,
                                              make_train_step, train)
    cfg = replace(get_config(arch), remat=True)
    if n_layers:
        cfg = replace(cfg, n_layers=n_layers)
    L = cfg.n_layers
    model = build_model(cfg, device="cuda")
    params = model.init(SEED)
    n = sum(t.numel() for t in tree.leaves(params))
    print(f"{cfg.name}: {L} of {get_config(arch).n_layers} layers at full "
          f"width (d {cfg.d_model}, {cfg.n_heads} / {cfg.n_kv_heads} heads "
          f"of {cfg.hd}, vocab {cfg.vocab_size}), {cfg.dtype}, remat: "
          f"{n / 1e9:.3f} B params; params + grads + AdamW f32 moments "
          f"{n * (2 + 2 + 8) / 1e9:.2f} GB")
    ds = PackedLMDataset(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=TRAIN_S, batch_size=TRAIN_B))
    oc = opt_mod.AdamWConfig(lr=1e-4, warmup_steps=2,
                             total_steps=TRAIN_STEPS)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as ck:
        tc = TrainerConfig(n_steps=TRAIN_STEPS, log_every=1, ckpt_root=ck,
                           ckpt_name=cfg.name, opt=oc)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()   # params and earlier phases'
        _zero(fns)
        res = train(model, ds, tc, params=params)
        launches = {fn.__name__: fn.launches for fn in fns}
        peak = torch.cuda.max_memory_allocated()
        losses = [h["loss"] for h in res.history]
        print("losses:", " ".join(f"{x:.4f}" for x in losses))
        print("grad norms:", " ".join(f"{h['grad_norm']:.4f}"
                                      for h in res.history))
        if len(losses) != TRAIN_STEPS or \
                not all(math.isfinite(x) for x in losses) or \
                not losses[-1] < losses[0]:
            raise AssertionError(f"losses {losses}: not all finite, or the "
                                 f"last not below the first")
        want = {fn.__name__: per_layer.get(fn.__name__, 0) * L * TRAIN_STEPS
                for fn in fns}
        print("launches:", json.dumps(launches), "(expected a layer a step:",
              json.dumps(per_layer), "- a forward twice, the second the "
              "recompute of remat; no other kernel)")
        if launches != want:
            raise AssertionError(f"launches {launches}, expected {want}")
        tok_s = res.steps_per_s * TRAIN_B * TRAIN_S
        print(f"train(): {res.steps_per_s:.3f} steps/s, {tok_s:.0f} "
              f"tokens/s (the first step, with the card's warm-up, "
              f"included); max_memory_allocated {peak / 1e9:.2f} GB, "
              f"{(peak - held) / 1e9:.2f} GB above the {held / 1e9:.2f} GB "
              f"held before train()")
        t0 = time.perf_counter()
        back = checkpoint.restore(ck, f"{cfg.name}-final",
                                  like={"params": res.params})["params"]
        same = all(torch.equal(a, b) for a, b in
                   zip(tree.leaves(back), tree.leaves(res.params)))
        nbytes = sum(t.numel() * t.element_size()
                     for t in tree.leaves(back))
        print(f"checkpoint {cfg.name}-final: {nbytes / 1e9:.2f} GB restored "
              f"in {time.perf_counter() - t0:.1f} s, equal to the final "
              f"params: {same}")
        if not same:
            raise AssertionError("the checkpoint does not round-trip")
        del back
    # steady state: 3 more steps, synchronised; then one under the
    # profiler: the device's idle share
    from torch.profiler import ProfilerActivity, profile
    step_fn = make_train_step(model, oc)
    params, state = res.params, res.opt_state
    batches = list(sharded_batches(ds, None, 4, TRAIN_STEPS, device="cuda"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in batches[:3]:
        params, state, m = step_fn(params, state, batch)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / 3
    print(f"steady state: {dt * 1e3:.1f} ms a step, {1 / dt:.3f} steps/s, "
          f"{TRAIN_B * TRAIN_S / dt:.0f} tokens/s")
    metrics = {"layers": L, "params": n, "losses": losses,
               "steps_per_s": res.steps_per_s, "tokens_per_s": tok_s,
               "peak_gb": peak / 1e9, "steady_ms": dt * 1e3,
               "steady_tokens_per_s": TRAIN_B * TRAIN_S / dt}
    batch = batches[3]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, state, m = step_fn(params, state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = device_rows(prof)
    busy_ms = sum(t for t, _ in rows) / 1e3
    metrics.update(wall_ms=wall * 1e3, busy_ms=busy_ms if rows else None)
    if rows:
        print(f"profiled train step: wall {wall * 1e3:.1f} ms, device busy "
              f"{busy_ms:.1f} ms (idle share "
              f"{1 - busy_ms / (wall * 1e3):.3f}), loss {float(m['loss']):.4f}")
        for t, e in rows[:10]:
            print(f"  {t / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:90]}")
    else:
        print("profiler recorded no device time: idle share not measured")
    del params, state, res, model, batches, batch
    torch.cuda.empty_cache()
    return launches, metrics


@contextmanager
def plain_routes():
    """Inside the model modules, attention, the WKV scan and the selective
    scan on their plain versions (``force_ref``) on any device."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rwkv_scan import ops as wkv_ops
    from repro_torch.kernels.ssm_scan import ops as ssm_ops
    from repro_torch.models import attention, rwkv6, ssm
    saved = attention.attention_bshd, rwkv6.wkv, ssm._scan
    attention.attention_bshd = partial(flash_ops.attention_bshd,
                                       force_ref=True)
    rwkv6.wkv = partial(wkv_ops.wkv, force_ref=True)
    ssm._scan = partial(ssm_ops.selective_scan, force_ref=True)
    try:
        yield
    finally:
        attention.attention_bshd, rwkv6.wkv, ssm._scan = saved


def train_grads_kernel_vs_plain(arch, Bq, S, get_config, build_model, fns,
                                per_layer):
    """Phases 13c / 13f: ``arch`` at full width, f32, GRAD_LAYERS layers:
    train_loss and its gradient through the kernels against the same
    model with attention and the scans on their plain versions
    (``plain_routes``), at B ``Bq`` x S ``S``. Loss within 1e-5
    relative, each leaf within 1e-4 of its largest |g|; the kernels'
    launches ``per_layer`` a layer on the kernel route, none on the plain
    one. Returns the kernel route's launches ({name: n})."""
    from repro_torch.train import tree
    cfg = replace(get_config(arch), n_layers=GRAD_LAYERS,
                  dtype=torch.float32, remat=False)
    model = build_model(cfg, device="cuda")
    params = model.init(SEED + 1)
    g = torch.Generator(device="cuda").manual_seed(5)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (Bq, S + 1),
                                     generator=g, device="cuda",
                                     dtype=torch.int32)}
    leaves = tree.leaves(params)

    def value_and_grad():
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = model.train_loss(params, batch)
        grads = torch.autograd.grad(loss, leaves)
        for p in leaves:
            p.requires_grad_(False)
        return loss.detach(), grads

    _zero(fns)
    lk, gk = value_and_grad()
    counts = {fn.__name__: fn.launches for fn in fns}
    with plain_routes():
        lp, gp = value_and_grad()
    after = {fn.__name__: fn.launches for fn in fns}
    want = {fn.__name__: per_layer.get(fn.__name__, 0) * GRAD_LAYERS
            for fn in fns}
    if counts != want or after != counts:
        raise AssertionError(f"launches {counts}, then {after}; expected "
                             f"{want}")
    worst = 0.0
    for (key, p), a, b in zip(tree.leaves_with_path(params), gk, gp):
        err = float((a - b).abs().max())
        scale = max(float(b.abs().max()), 1e-30)
        worst = max(worst, err / scale)
        if err > 1e-4 * scale:
            raise AssertionError(f"{key}: kernel-route gradient off by {err}"
                                 f" (largest |g| {scale})")
    rel = abs(float(lk) - float(lp)) / abs(float(lp))
    print(f"{cfg.name}, B {Bq} S {S}: loss {float(lk):.6f} (kernel route) vs "
          f"{float(lp):.6f} (plain), relative {rel:.1e}; {len(leaves)} "
          f"gradient leaves, worst {worst:.1e} of the leaf's largest |g| "
          f"(tol 1e-4); launches on the kernel route "
          f"{json.dumps({k: v for k, v in counts.items() if v})}, none on "
          f"the plain one")
    if rel > 1e-5:
        raise AssertionError(f"losses differ by {rel}")
    del params, gk, gp, model
    torch.cuda.empty_cache()
    return counts


def run_train_launcher(arch="qwen3-4b"):
    """Phase 13d: ``python -m repro_torch.launch.train --arch ARCH --steps
    3`` on the card (the reduced config, f32), as a subprocess that must
    exit 0."""
    import os
    import tempfile
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as ck:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                            "--arch", arch, "--steps", "3", "--ckpt-root",
                            ck], cwd=ROOT,
                           env=env, capture_output=True, text=True,
                           timeout=300)
    print(r.stdout.strip())
    if r.returncode:
        raise AssertionError(f"launcher exit {r.returncode}: "
                             f"{r.stderr[-2000:]}")


def time_flash_backward(fwd_kernel, bwd_kernel, ref_fwd, ref_bwd, flush,
                        split):
    """The backward kernel's time at the qwen3-4b train shape (bf16 and
    f32), whisper's encoder and hd 192 (bf16) beside its plain version, its
    bound and SDPA's backward on the same inputs, and its per-launch
    split (``split``, from ``bwd_launch_split``); the forward's time with
    and without the lse write at the train shape and at qwen3-4b's
    prefill (B 1, S = T = 300) beside its bound, its plain version with
    the lse and SDPA's forward (which returns no lse)."""
    F = torch.nn.functional
    rows = {}
    for key, case, dt in (("train", BWD_CASES[0], torch.bfloat16),
                          ("train_f32", BWD_CASES[0], torch.float32),
                          ("whisper_enc", BWD_CASES[1], torch.bfloat16),
                          ("hd192", BWD_BY_NAME["hd 192"], torch.bfloat16),
                          ("nemotron", NEMOTRON_TRAIN, torch.bfloat16)):
        _, Bq, Hq, Hkv, S, T, hd, causal, win = case
        q, k, v, do = bwd_inputs(Bq, Hq, Hkv, S, T, hd, dt, seed=9)
        out, lse = fwd_kernel(q, k, v, causal=causal, with_lse=True)
        k_ms = time_ms(lambda: bwd_kernel(q, k, v, out, lse, do,
                                          causal=causal), flush, iters=10,
                       warmup=2)
        if key == "nemotron":
            p_ms, plain_S = nemotron_plain_ms(ref_bwd, out, lse, q, k, v, do,
                                              flush)
        else:
            p_ms = time_ms(lambda: ref_bwd(q, k, v, out, lse, do,
                                           causal=causal), flush, iters=5,
                           warmup=1)
        qs, ks, vs = (t.clone().requires_grad_(True) for t in (q, k, v))
        so = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal,
                                            enable_gqa=Hq != Hkv)
        l_ms = time_ms(lambda: torch.autograd.grad(
            so, (qs, ks, vs), do, retain_graph=True), flush, iters=10,
            warmup=2)
        b_ms, b_by = flash_bwd_bound(Bq, Hq, Hkv, S, T, hd, dt, causal, win)
        rows[key] = (k_ms, p_ms, b_ms, b_by, l_ms)
        at = f" at S = T = {plain_S}" if key == "nemotron" else ""
        print(f"flash backward, {case[0]} (B {Bq}, {Hq} / {Hkv} heads of "
              f"{hd}, S {S}, T {T}, {str(dt)[6:]}): kernel {k_ms:.4f} ms, "
              f"plain{at} {p_ms:.4f} ms, sdpa backward {l_ms:.4f} ms, bound "
              f"{b_ms:.5f} ms ({b_by})")
        del so, qs, ks, vs, q, k, v, do, out, lse
        torch.cuda.empty_cache()
    rows["nemotron_plain_S"] = plain_S
    for key, launches in split.items():
        shown = ", ".join(f"{n} {ms:.4f} ms" for n, ms in launches.items())
        print(f"flash backward launches, {key} (bf16, profiler, per call): "
              f"{shown or 'no device time recorded: not measured'}")
    fwd = {}
    for key, shape in (("train", BWD_CASES[0][1:7]),
                       ("prefill", (1, 32, 8, PREFILL_T, PREFILL_T, 128))):
        q, k, v, _ = bwd_inputs(*shape, torch.bfloat16, seed=10)
        plain = time_ms(lambda: fwd_kernel(q, k, v), flush)
        with_lse = time_ms(lambda: fwd_kernel(q, k, v, with_lse=True), flush)
        ref = time_ms(lambda: ref_fwd(q, k, v, return_lse=True), flush,
                      iters=10, warmup=2)
        sdpa = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), flush)
        b_ms, b_by = flash_bound(*shape, torch.bfloat16)
        fwd[key] = (plain, with_lse, b_ms, b_by, sdpa, ref)
        print(f"flash forward at {key} shape {shape}, bf16: {plain:.4f} ms, "
              f"with the lse write {with_lse:.4f} ms, bound {b_ms:.5f} ms "
              f"({b_by}), plain with the lse {ref:.4f} ms, sdpa forward "
              f"{sdpa:.4f} ms (no lse)")
    return rows, fwd


def nemotron_plain_ms(ref_bwd, out, lse, q, k, v, do, flush):
    """The plain backward's time at nemotron's attention: at S = T = 4096
    it needs about 35 GB; where the card cannot hold that beside what the
    script holds then, at S = T = 2048 (the last 2048 queries and keys:
    the same causal band's shape). Returns (ms, the S it ran at)."""
    try:
        return time_ms(lambda: ref_bwd(q, k, v, out, lse, do), flush,
                       iters=3, warmup=1), q.shape[2]
    except torch.cuda.OutOfMemoryError:
        torch.cuda.empty_cache()
    half = [t[:, :, -2048:] for t in (out, lse, q, k, v, do)]
    return time_ms(lambda: ref_bwd(*half[2:5], half[0], half[1], half[5]),
                   flush, iters=3, warmup=1), 2048


def bwd_launch_split(fwd_kernel, bwd_kernel, calls=10):
    """Device ms per backward call of each kernel the call launches, from
    ``torch.profiler`` over ``calls`` calls (bf16) at the qwen3-4b train
    shape and whisper's encoder. Returns {shape key: {kernel: ms}}. Run
    before any other trace of the process: late in a full run of this
    script the profiler has recorded no device time for these launches,
    which it records in a fresh process."""
    from torch.profiler import ProfilerActivity, profile
    split = {}
    for key, case in (("train", BWD_CASES[0]), ("whisper_enc", BWD_CASES[1])):
        _, Bq, Hq, Hkv, S, T, hd, causal, win = case
        q, k, v, do = bwd_inputs(Bq, Hq, Hkv, S, T, hd, torch.bfloat16,
                                 seed=9)
        out, lse = fwd_kernel(q, k, v, causal=causal, with_lse=True)
        bwd_kernel(q, k, v, out, lse, do, causal=causal)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                bwd_kernel(q, k, v, out, lse, do, causal=causal)
            torch.cuda.synchronize()
        rows = {}
        for t, e in device_rows(prof):
            name = e.key.replace("(anonymous namespace)::", "") \
                .removeprefix("void ").split("(")[0]
            rows[name] = rows.get(name, 0.0) + t / 1e3 / calls
        split[key] = rows
    return split


# ------------------------------------------------------------ phase 14
PLAN_STEPS = 8                  # 14c's greedy decode steps
PLAN_B, PLAN_P = 4, 64          # 14c's rows and prompt length
PLAN_WHISPER_STEPS = 4          # 14c's whisper-tiny decode steps
SHARD_T, SHARD_RANKS = 4096, 4  # 14d: hymba's stripe over 4 ranks
# 14d's lengths after the write: each shard edge (1024, 2048, 3072) from
# both sides, the stripe's end, and window (2048) starts on either side
# of an edge (3073 -> 1025, 4096 -> 2048, 3071 -> 1023)
SHARD_LENS = (1, 1023, 1025, 2048, 2049, 3071, 3073, 4096)


def plan_serve(model, params, plan, cfg, fns, ServingEngine, Request,
               **kw):
    """Phase 14a / 14b: phase 4's requests through an engine with
    ``plan``; each kernel count of ``fns`` from 0. Returns (requests,
    wall, launches)."""
    _zero(fns)
    eng = ServingEngine(model, params, batch_size=B, plan=plan, **kw)
    reqs = make_requests(Request, cfg.vocab_size)
    done, wall = run_engine(eng, reqs)
    launches = {fn.__name__: fn.launches for fn in fns}
    check_outputs(reqs, done, cfg.vocab_size)
    check_launches(fns, launches, cfg, eng.metrics)
    return reqs, wall, launches


def _tok_s(reqs, wall):
    return sum(len(r.out_tokens) for r in reqs) / wall


def plan_serves_in_turns(what, model, params, dparams, plan, cfg, fns,
                         ServingEngine, Request, **kw):
    """Phase 14a / 14b: serves without and with ``plan`` in the order
    none, plan, plan, none, so neither side always runs first. Every
    stream equals the first plan-free one's. Returns (tok/s with the plan
    and without, each the median of its two serves; the plan's launches
    summed; the largest logprob difference)."""
    runs = [plan_serve(model, params if pl is None else dparams, pl, cfg,
                       fns, ServingEngine, Request, **kw)
            for pl in (None, plan, plan, None)]
    err = max(streams_equal(r[0], runs[0][0], f"{what} run {i}",
                            lp_tol=1e-3) for i, r in enumerate(runs))
    launches = {}
    for r in runs[1:3]:
        for name, n in r[2].items():
            launches[name] = launches.get(name, 0) + n
    rate = [_tok_s(*r[:2]) for r in runs]
    return (statistics.median(rate[1:3]),
            statistics.median([rate[0], rate[3]]), launches, err)


def plan_decode_steps(model, params, cfg, plan, fns):
    """Phase 14c: a prefill without a plan, then PLAN_STEPS greedy decode
    steps with the stripe cache placed by ``cache_spec`` (``plan``) or
    whole (None). Returns (tokens, logits, launches over the steps)."""
    g = torch.Generator().manual_seed(SEED + 3)
    prompts = torch.randint(2, cfg.vocab_size, (PLAN_B, PLAN_P),
                            generator=g).to("cuda")
    with torch.no_grad():
        logits, pref = model.prefill(params, {"tokens": prompts})
        cache = model.init_cache(PLAN_B, STRIPE_T)
        for key, leaf in cache.items():
            row = pref[key]
            leaf[tuple(slice(0, n) for n in row.shape)] = row
        del pref
        if plan is not None:
            cache = plan.input_shardings({"cache": cache})["cache"]
        tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        toks, outs = [], []
        torch.cuda.synchronize()
        _zero(fns)
        for j in range(PLAN_STEPS):
            n = torch.full((PLAN_B,), PLAN_P + j, dtype=torch.int32,
                           device="cuda")
            logits, _ = model.decode_step(params, tok, cache, n, plan=plan)
            tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
            toks.append(tok[:, 0].tolist())
            outs.append(logits[:, -1].float())
        torch.cuda.synchronize()
    return toks, torch.stack(outs), {fn.__name__: fn.launches for fn in fns}


def plan_whisper_steps(model, params, cfg, mesh, fns):
    """Phase 14c, whisper-tiny: phase 12's prompts and frames prefilled,
    then PLAN_WHISPER_STEPS greedy decode steps on the stripes; with
    ``mesh`` the prefill under a prefill plan (DTensor params, the batch
    placed by ``batch_spec``) and the steps under a decode plan with the
    stripes placed by ``cache_spec``, else plan-free. Returns (tokens,
    the prefill's and every step's logits, launches over prefill and
    steps)."""
    from repro_torch.sharding.rules import DTensor, ParallelPlan
    batch, last = frontend_inputs(cfg, SEED + 5)
    pplan = dplan = None
    if mesh is not None:
        pplan = ParallelPlan.make(mesh, cfg, "prefill")
        dplan = ParallelPlan.make(mesh, cfg, "decode")
        params = pplan.param_shardings(params)
        batch = pplan.input_shardings(batch)
    with torch.no_grad():
        torch.cuda.synchronize()
        _zero(fns)
        logits, kv = model.prefill(params, batch, last_idx=last, plan=pplan)
        kv = {k: v.full_tensor() if isinstance(v, DTensor) else v
              for k, v in kv.items()}
        cache = stripes_from(model, kv, FRONT_RUNS[cfg.name][1])
        del kv
        if dplan is not None:
            cache = dplan.input_shardings({"cache": cache})["cache"]
        toks, _, outs, _, _ = greedy_decode(
            model, params, logits, cache, (last + 1).to(torch.int32),
            PLAN_WHISPER_STEPS, plan=dplan)
        torch.cuda.synchronize()
    return (toks.tolist(), torch.cat([logits[:, -1:].float(), outs.float()],
                                     1),
            {fn.__name__: fn.launches for fn in fns})


def check_seq_shard_body(decode_attention):
    """Phase 14d: ``seq_shard_decode`` for SHARD_RANKS simulated ranks on
    their slices of one stripe (the kernel on each slice; the new token's
    K / V written into the slice that holds it), merged, against the
    unsharded kernel and the plain version on the stripe written whole.
    Returns the largest error."""
    from repro_torch.kernels.decode_attention.ref import merge_partials
    from repro_torch.models.attention import _stripe_write, seq_shard_decode
    Hq, Hkv, hd = HEAD_SHAPES[1]
    win, t_loc = 2048, SHARD_T // SHARD_RANKS
    Bq = len(SHARD_LENS)
    worst = 0.0
    for dt in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 4)

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(dt)

        q = rnd(Bq, 1, Hq, hd)
        k, v = rnd(Bq, SHARD_T, Hkv, hd), rnd(Bq, SHARD_T, Hkv, hd)
        kn, vn = rnd(Bq, 1, Hkv, hd), rnd(Bq, 1, Hkv, hd)
        idx = torch.tensor(SHARD_LENS, dtype=torch.int32, device="cuda") - 1
        ks, vs = k.clone(), v.clone()
        outs, lses = [], []
        for r in range(SHARD_RANKS):
            sl = slice(r * t_loc, (r + 1) * t_loc)
            o, lse = seq_shard_decode(q, ks[:, sl], vs[:, sl], kn, vn, idx,
                                      r * t_loc, sliding_window=win)
            outs.append(o)
            lses.append(lse)
        got = merge_partials(outs, lses)
        _stripe_write(k, kn, idx[:, None].long())
        _stripe_write(v, vn, idx[:, None].long())
        if not (torch.equal(ks, k) and torch.equal(vs, v)):
            raise AssertionError("the slices' writes differ from the whole "
                                 "stripe's")
        args = (q[:, 0], k.transpose(1, 2), v.transpose(1, 2), idx + 1)
        whole, _ = decode_attention(*args, sliding_window=win)
        plain, _ = decode_attention(*args, sliding_window=win,
                                    force_ref=True)
        # bf16's limit is about one key's weight in a row merged at this
        # window: only the f32 check catches an error of one key
        tol = 3e-5 if dt == torch.float32 else 3e-2
        for what, ref in (("the unsharded kernel", whole),
                          ("the plain version", plain)):
            err = float((got.float() - ref.float()).abs().max())
            worst = max(worst, err)
            print(f"14d {dt}: {SHARD_RANKS} slices of {t_loc} merged vs "
                  f"{what}: max |diff| {err:.3e} (tol {tol:.0e})")
            if not err <= tol:
                raise AssertionError(f"sequence-sharded decode {dt} vs "
                                     f"{what}: {err}")
    print(f"14d lengths {list(SHARD_LENS)}, window {win}: every row merged "
          f"from {SHARD_RANKS} slices, those wholly outside a row's window "
          f"weighing nothing")
    return worst


def plan_train(model, cfg, mesh, fns):
    """Phase 14e: two TRAIN-shaped steps of ``cfg`` with ``mesh`` (a 1 x 1
    train plan: DTensor params, state and batches) or without. Returns
    (losses, ms of each step, launches)."""
    from repro_torch.sharding.rules import ParallelPlan
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.data import (DataConfig, PackedLMDataset,
                                        sharded_batches)
    from repro_torch.train.train_loop import make_train_step
    plan = ParallelPlan.make(mesh, cfg, "train")
    params = plan.param_shardings(model.init(SEED))
    state = opt_mod.init_state(params)
    oc = opt_mod.AdamWConfig(lr=1e-4, warmup_steps=2, total_steps=2)
    step = make_train_step(model, oc, plan)
    ds = PackedLMDataset(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=TRAIN_S, batch_size=TRAIN_B))
    batches = list(sharded_batches(ds, plan, 2, device="cuda"))
    torch.cuda.synchronize()
    _zero(fns)
    losses, ms = [], []
    for batch in batches:
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))       # waits for the step
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = {fn.__name__: fn.launches for fn in fns}
    del params, state, batches
    torch.cuda.empty_cache()
    return losses, ms, launches


def run_plan_launcher():
    """Phase 14f: ``python -m repro_torch.launch.train --mesh-shape 1,1
    --steps 2`` on the card (a world of one), the reference's lines."""
    import os
    import tempfile
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as ck:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                            "--mesh-shape", "1,1", "--steps", "2",
                            "--ckpt-root", ck], cwd=ROOT, env=env,
                           capture_output=True, text=True, timeout=300)
    print(r.stdout.strip())
    lines = r.stdout.splitlines()
    if r.returncode or not lines or lines[0] != (
            "training qwen3-4b (dense) on 1 device(s); "
            "mesh={'data': 1, 'model': 1}") or \
            "steps/s; loss" not in lines[-1]:
        raise AssertionError(f"launcher exit {r.returncode}: "
                             f"{r.stderr[-2000:]}")


def phase14_sharded(get_config, build_model, ServingEngine, Request, card,
                    fns):
    """Phase 14 (see the module docstring). ``fns``: {name: kernel
    wrapper}. Returns ({kernel: launches in phase 14}, {timings})."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import moe
    from repro_torch.sharding.rules import DTensor, ParallelPlan
    pw, flash, dec = (fns["paged_window_attention"], fns["flash_attention"],
                      fns["decode_attention"])
    wkv_fn, ssm_fn, bwd = (fns["wkv_scan"], fns["ssm_scan"],
                           fns["flash_attention_bwd"])
    launches, times = {}, {}

    def add(counts):
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n

    (ROOT / "build").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(dir=ROOT / "build")
    dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_local_mesh()
        # a server sets up its communicators before it serves: the first
        # collective on a group builds its NCCL communicator
        t0 = time.perf_counter()
        for axis in mesh.mesh_dim_names:
            dist.all_reduce(torch.zeros(1, device="cuda"),
                            group=mesh.get_group(axis))
        torch.cuda.synchronize()
        print(f"mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} on "
              f"{mesh.device_type}, backend {dist.get_backend()}; the "
              f"groups' first collectives {time.perf_counter() - t0:.3f} s")

        print("--- 14a. qwen3-4b, 36 layers, bf16, decode plan")
        cfg = get_config("qwen3-4b")
        model = build_model(cfg, device="cuda")
        params = model.init(SEED)
        plan = ParallelPlan.make(mesh, cfg, "decode")
        dparams = plan.param_shardings(params)
        w_q = dparams["blocks"]["attn"]["w_q"]
        print(f"plan: kind {plan.kind}, weight_fsdp {plan.weight_fsdp}, "
              f"moe_mode {plan.moe_mode}; w_q a {type(w_q).__name__} "
              f"{tuple(w_q.shape)} {w_q.placements}")
        if not isinstance(w_q, DTensor):
            raise AssertionError("param_shardings left a plain tensor")
        for layout, kw, path in (
                ("paged", dict(max_seq=1024, use_kernel=True), (pw, flash)),
                ("stripes", dict(max_seq=STRIPE_T, paged=False),
                 (flash, dec))):
            rate, plain_rate, counts, err = plan_serves_in_turns(
                f"14a {layout}", model, params, dparams, plan, cfg, path,
                ServingEngine, Request, **kw)
            add(counts)
            times[f"qwen3_{layout}_tok_s"] = rate
            times[f"qwen3_{layout}_plain_tok_s"] = plain_rate
            print(f"14a {layout}: streams identical, max |logprob diff| "
                  f"{err:.3e}; {rate:.1f} tok/s with the plan, "
                  f"{plain_rate:.1f} without (medians of 2, in turns)")
        del dparams, params, model
        torch.cuda.empty_cache()

        print("--- 14b. grok-1-314b, 2 layers, bf16, decode plan")
        gcfg = replace(get_config("grok-1-314b"), n_layers=2)
        gmodel = build_model(gcfg, device="cuda")
        gparams = gmodel.init(SEED)
        gplan = ParallelPlan.make(mesh, gcfg, "decode")
        print(f"plan: moe_mode {gplan.moe_mode}, E_loc "
              f"{gcfg.n_experts // gplan.axis_size('model')}, weight_fsdp "
              f"{gplan.weight_fsdp}")
        kw = dict(max_seq=STRIPE_T, use_kernel=True)
        rate, plain_rate, counts, err = plan_serves_in_turns(
            "14b grok", gmodel, gparams, gplan.param_shardings(gparams),
            gplan, gcfg, (pw, flash), ServingEngine, Request, **kw)
        add(counts)
        times["grok_tok_s"], times["grok_plain_tok_s"] = rate, plain_rate
        print(f"14b: streams identical, max |logprob diff| {err:.3e}; "
              f"{rate:.1f} tok/s with the plan, {plain_rate:.1f} without "
              f"(medians of 2, in turns)")
        del gparams, gmodel
        torch.cuda.empty_cache()
        g32 = replace(gcfg, n_layers=1, dtype=torch.float32)
        gmodel = build_model(g32, device="cuda")
        gparams = gmodel.init(SEED)
        gplan = ParallelPlan.make(mesh, g32, "decode")
        x = torch.randn((B, 1, g32.d_model), generator=torch.Generator(
            device="cuda").manual_seed(7), device="cuda")
        p0 = {k: v[0] for k, v in gparams["blocks"]["moe"].items()}
        with torch.no_grad():
            y_plan, _ = moe.moe_ffn(x, p0, g32, gplan)
            y_none, _ = moe.moe_ffn(x, p0, g32)
            tok = torch.arange(B, dtype=torch.int32, device="cuda")[:, None]
            n = torch.zeros((B,), dtype=torch.int32, device="cuda")
            lg = [gmodel.decode_step(gparams, tok, gmodel.init_cache(B, 64),
                                     n, plan=pl)[0] for pl in (gplan, None)]
        for what, a, b in (("MoE FFN", y_plan, y_none),
                           ("decode-step logits", *lg)):
            err = float((a - b).abs().max())
            scale = float(b.abs().max())
            print(f"14b f32, 1 layer: {what} under the plan vs none: max "
                  f"|diff| {err:.3e} of largest {scale:.3e}")
            if not err <= 1e-4 * scale:
                raise AssertionError(f"14b {what}: {err} > 1e-4 x {scale}")
        del gparams, gmodel, p0, x, y_plan, y_none, lg
        torch.cuda.empty_cache()

        print("--- 14c. hymba-1.5b / rwkv6-1.6b decode, stripes placed by "
              "cache_spec")
        for arch, path in (("hymba-1.5b", (ssm_fn, dec)),
                           ("rwkv6-1.6b", (wkv_fn,))):
            cfg = get_config(arch)
            model = build_model(cfg, device="cuda")
            params = model.init(SEED)
            plan = ParallelPlan.make(mesh, cfg, "decode")
            t_none, l_none, _ = plan_decode_steps(model, params, cfg, None,
                                                  path)
            t_plan, l_plan, counts = plan_decode_steps(model, params, cfg,
                                                       plan, path)
            add(counts)
            want = {fn.__name__: cfg.n_layers * PLAN_STEPS for fn in path}
            err = float((l_plan - l_none).abs().max())
            print(f"14c {arch}: {PLAN_STEPS} steps of B {PLAN_B} from "
                  f"{PLAN_P}-token prompts; tokens identical "
                  f"{t_plan == t_none}; max |logit diff| {err:.3e}; "
                  f"launches {json.dumps(counts)} (expected "
                  f"{json.dumps(want)})")
            if t_plan != t_none or counts != want or not err <= 1e-2:
                raise AssertionError(f"14c {arch}: tokens {t_plan} vs "
                                     f"{t_none}, launches {counts}, logits "
                                     f"{err}")
            del params, model
            torch.cuda.empty_cache()

        cfg = get_config("whisper-tiny")
        model = build_model(cfg, device="cuda")
        params = model.init(SEED)
        t_none, l_none, _ = plan_whisper_steps(model, params, cfg, None,
                                               (flash, dec))
        t_plan, l_plan, counts = plan_whisper_steps(model, params, cfg,
                                                    mesh, (flash, dec))
        add(counts)
        L, S = cfg.n_layers, PLAN_WHISPER_STEPS
        # prefill: the encoder's, the self- and the cross-attention's
        # flash; a step: the cross-attention's flash, the stripe decode
        want = {"flash_attention": cfg.encoder_layers + 2 * L + L * S,
                "decode_attention": L * S}
        err = float((l_plan - l_none).abs().max())
        print(f"14c whisper-tiny: a planned prefill of B {FRONT_B} (frames "
              f"{cfg.n_frames}) and {S} planned decode steps; tokens "
              f"identical {t_plan == t_none}; max |logit diff| {err:.3e}; "
              f"launches {json.dumps(counts)} (expected "
              f"{json.dumps(want)})")
        if t_plan != t_none or counts != want or not err <= 1e-2:
            raise AssertionError(f"14c whisper-tiny: tokens {t_plan} vs "
                                 f"{t_none}, launches {counts}, logits "
                                 f"{err}")
        del params, model
        torch.cuda.empty_cache()

        print("--- 14d. the sequence-sharded decode body, 4 ranks")
        times["shard_err"] = check_seq_shard_body(fns["decode_op"])

        print(f"--- 14e. qwen3-4b, {TRAIN_LAYERS} layers, bf16, remat, "
              f"train plan")
        cfg = replace(get_config("qwen3-4b"), n_layers=TRAIN_LAYERS,
                      remat=True)
        model = build_model(cfg, device="cuda")
        l_none, ms_none, _ = plan_train(model, cfg, None, (flash, bwd))
        l_plan, ms_plan, counts = plan_train(model, cfg, mesh, (flash, bwd))
        add(counts)
        want = {"flash_attention": 2 * TRAIN_LAYERS * 2,
                "flash_attention_bwd": TRAIN_LAYERS * 2}
        print(f"14e losses with the plan {l_plan}, without {l_none}; "
              f"launches {json.dumps(counts)} (expected {json.dumps(want)})")
        if counts != want or not all(abs(a - b) <= 1e-5 * abs(b)
                                     for a, b in zip(l_plan, l_none)):
            raise AssertionError(f"14e: losses {l_plan} vs {l_none}, "
                                 f"launches {counts}")
        times["train_ms"], times["train_plain_ms"] = ms_plan, ms_none
        print(f"14e step ms with the plan {ms_plan[0]:.1f}, "
              f"{ms_plan[1]:.1f}; without {ms_none[0]:.1f}, "
              f"{ms_none[1]:.1f} (the first step with its warm-up)")
        del model
        torch.cuda.empty_cache()
        for arch, per_layer in RECURRENT_TRAIN.items():
            print(f"--- 14e. {arch}, {TRAIN_LAYERS} layers, bf16, remat, "
                  f"train plan")
            cfg = replace(get_config(arch), n_layers=TRAIN_LAYERS,
                          remat=True)
            model = build_model(cfg, device="cuda")
            path = [fns[name] for name in per_layer]
            l_none, ms_none, _ = plan_train(model, cfg, None, path)
            l_plan, ms_plan, counts = plan_train(model, cfg, mesh, path)
            add(counts)
            want = {name: n * TRAIN_LAYERS * 2
                    for name, n in per_layer.items()}
            print(f"14e {arch}: losses with the plan {l_plan}, without "
                  f"{l_none}; launches {json.dumps(counts)} (expected "
                  f"{json.dumps(want)}); step ms with the plan "
                  f"{ms_plan[1]:.1f}, without {ms_none[1]:.1f} (the "
                  f"second of 2)")
            if counts != want or not all(abs(a - b) <= 1e-5 * abs(b)
                                         for a, b in zip(l_plan, l_none)):
                raise AssertionError(f"14e {arch}: losses {l_plan} vs "
                                     f"{l_none}, launches {counts}")
            times[f"{arch}_train_ms"] = ms_plan
            times[f"{arch}_train_plain_ms"] = ms_none
            del model
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)

    print("--- 14f. the train launcher with --mesh-shape 1,1")
    run_plan_launcher()
    print(f"phase 14 times, {card}: qwen3-4b serve paged "
          f"{times['qwen3_paged_tok_s']:.1f} tok/s with the plan / "
          f"{times['qwen3_paged_plain_tok_s']:.1f} without, stripes "
          f"{times['qwen3_stripes_tok_s']:.1f} / "
          f"{times['qwen3_stripes_plain_tok_s']:.1f}; grok-1-314b (2 "
          f"layers) {times['grok_tok_s']:.1f} / "
          f"{times['grok_plain_tok_s']:.1f} tok/s; qwen3-4b train step "
          f"({TRAIN_LAYERS} layers, B {TRAIN_B} x {TRAIN_S}, the second "
          f"of 2) {times['train_ms'][1]:.1f} ms with the plan / "
          f"{times['train_plain_ms'][1]:.1f} ms without")
    print("launches in phase 14:", json.dumps(launches))
    idle = [n for n in ("paged_window_attention", "flash_attention",
                        "decode_attention", "wkv_scan", "ssm_scan",
                        "flash_attention_bwd", "wkv_bwd", "ssm_scan_bwd")
            if not launches.get(n)]
    if idle:
        raise AssertionError(f"phase 14 never launched {idle}")
    return launches, times


# ------------------------------------------------- phase 15: new configs
# (arch, layers or None for full depth) served paged for the first time on
# the card, and the depth of each one's f32 kernel-vs-plain check
NEW_CONFIGS = (("deepseek-7b", None, 2), ("minitron-8b", None, 2),
               ("nemotron-4-340b", 2, 1), ("kimi-k2-1t-a32b", 1, None))
PEAK_SLACK = 1.10               # measured peak <= 1.10 x the dry-run's
SHARE_LIMIT = 1.05              # roofline bound / the step's time <= 1.05
MOE_TOL = 2e-2                  # kimi's MoE FFN vs the direct f32 sum


def _cut(get_config, arch, layers, dtype=None):
    cfg = get_config(arch)
    if layers:
        cfg = replace(cfg, n_layers=layers)
    return replace(cfg, dtype=dtype) if dtype else cfg


def serve_new_config(cfg, model, params, fns, ServingEngine, Request):
    """Phase 4's paged serve of ``cfg`` (8 greedy prompts, use_kernel):
    launches by ``expected_launches`` counted from 0, the pool drained;
    an MoE model prefills one request a call and never shares or
    chunks. Returns {name: launches}."""
    for fn in fns:
        fn.launches = 0
    eng, reqs, done, wall = serve(cfg, params, model, ServingEngine, Request,
                                  use_kernel=True)
    launches = {fn.__name__: fn.launches for fn in fns}
    check_outputs(reqs, done, cfg.vocab_size)
    m, stats = eng.metrics, eng.pool_stats()
    print("metrics:", json.dumps(m))
    print("pool:", json.dumps(stats))
    n_tok = sum(len(r.out_tokens) for r in reqs)
    print(f"{n_tok} tokens in {wall:.3f} s: {n_tok / wall:.1f} tok/s")
    check_launches(fns, launches, cfg, m)
    if cfg.n_experts and (not (m["prefill_batches"] == m["prefills"]
                               == len(reqs)) or m["shared_admissions"]
                          or m["chunk_steps"]):
        raise AssertionError("MoE admission must prefill one request a "
                             "call, share nothing and never chunk")
    if stats["used"] or stats["available"] != stats["total"] \
            or stats["logical_blocks"]:
        raise AssertionError(f"pool did not drain: {stats}")
    return launches


def kernel_vs_plain_f32(cfg, build_model, ServingEngine, Request):
    """Phase 5's check on ``cfg`` (f32): the kernel path's token streams
    equal the plain path's, logprobs within 1e-3."""
    model = build_model(cfg, device="cuda")
    params = model.init(SEED)
    _, rk, dk, wk = serve(cfg, params, model, ServingEngine, Request,
                          use_kernel=True)
    _, rp, dp, wp = serve(cfg, params, model, ServingEngine, Request,
                          use_kernel=False)
    check_outputs(rk, dk, cfg.vocab_size)
    check_outputs(rp, dp, cfg.vocab_size)
    err = streams_equal(rk, rp, f"{cfg.name} {cfg.n_layers} layers f32 "
                        f"kernel vs plain", lp_tol=1e-3)
    print(f"{cfg.name}, {cfg.n_layers} layer(s), f32: kernel path token "
          f"streams identical to the plain path's; max |logprob diff| "
          f"{err:.3e} (tol 1e-3); kernel run {wk:.3f} s, plain run "
          f"{wp:.3f} s")


def moe_vs_direct_sum(cfg, params):
    """kimi's ``moe.moe_ffn`` at B 8 (bf16) against a direct f32 sum over
    each token's top-k experts, from the same weights and the same
    routing (the router's f32 softmax, its top-k renormalised): max
    |difference| within MOE_TOL of the largest output."""
    from repro_torch.models import moe
    p0 = {k: v[0] for k, v in params["blocks"]["moe"].items()}
    x = torch.randn((B, 1, cfg.d_model), generator=torch.Generator(
        device="cuda").manual_seed(7), device="cuda").to(cfg.dtype)
    with torch.no_grad():
        out = moe.moe_ffn(x, p0, cfg)[0].reshape(B, -1).float()
        x2 = x.reshape(B, -1).float()
        probs = torch.softmax(x2 @ p0["router"], dim=-1)
        w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
        w, ids = w[:, :cfg.top_k], ids[:, :cfg.top_k]
        w = w / w.sum(-1, keepdim=True)
        ref = torch.zeros_like(x2)
        for t in range(B):
            for j in range(cfg.top_k):
                e = int(ids[t, j])
                h = torch.nn.functional.silu(
                    x2[t] @ p0["w_gate"][e].float()) \
                    * (x2[t] @ p0["w_in"][e].float())
                ref[t] += w[t, j] * (h @ p0["w_out"][e].float())
    err = float((out - ref).abs().max())
    top = float(ref.abs().max())
    print(f"{cfg.name} MoE FFN, B {B}, one layer, {cfg.n_experts} experts "
          f"top-{cfg.top_k}: max |moe_ffn - direct f32 sum| {err:.3e} of "
          f"the largest output {top:.3e} (tol {MOE_TOL} of it)")
    if not err <= MOE_TOL * top:
        raise AssertionError(f"MoE FFN differs from the direct sum by {err}")


def card_inputs(model, shape):
    """A step's inputs on the card at ``shape``: seeded tokens; for
    decode a zeroed stripe cache whose rows are full but for the new
    token (``cache_len`` = capacity - 1: the decode kernel reads the
    whole stripe, as the dry-run counts it)."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 15)
    V = model.cfg.vocab_size
    B_, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return {"batch": {"tokens": torch.randint(
            0, V, (B_, S + 1), generator=g, device="cuda",
            dtype=torch.int32)}}
    return {"token": torch.randint(0, V, (B_, 1), generator=g,
                                   device="cuda", dtype=torch.int32),
            "cache": model.init_cache(B_, S),
            "cache_len": torch.tensor(S - 1, dtype=torch.int32,
                                      device="cuda")}


def dryrun_vs_card(cfg, shape, build_model):
    """Phase 15d: the dry-run's ``build_step`` at the card run's own shape
    (plan-free, as the card runs it), analysed on meta, against the same
    step on the card: (i) argument bytes equal the real tensors' bytes,
    (ii) the measured peak within PEAK_SLACK of the predicted one, (iii)
    the roofline bound at most SHARE_LIMIT of the step's device-busy
    time (the profiler's kernel and copy times of one step, summed) and
    of its time (CUDA events, median of 10). The eager step leaves the
    card idle between launches, so only the busy time holds the analysis'
    FLOP and byte counts to a limit that an overcount would break.
    Returns the numbers."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import roofline
    from repro_torch.launch.dryrun import build_step
    from repro_torch.launch.step_analysis import analyze
    from repro_torch.launch.mesh import PEAK_FLOPS_BF16
    meta_step = build_step(cfg, shape, device="meta")
    _, stats = analyze(meta_step.fn, *meta_step.args)
    rec = dict(meta_step.meta, mesh="none",
               memory={"peak_bytes_per_device": stats.peak_bytes},
               analysis=stats.as_record())
    rl = roofline.from_record(rec)
    torch.cuda.synchronize()
    free_card()
    base = torch.cuda.memory_allocated()
    model = build_model(cfg, device="cuda")
    step = build_step(cfg, shape, device="cuda", seed=SEED,
                      inputs=card_inputs(model, shape))
    real = sum(t.numel() * t.element_size() for t in _leaves(step.args))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step.fn(*step.args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    times = []
    for _ in range(10):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        step.fn(*step.args)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    ms = statistics.median(times)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step.fn(*step.args)
        torch.cuda.synchronize()
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA) / 1e3
    bound_ms = rl.bound_s * 1e3
    out = {"arch": cfg.name, "layers": cfg.n_layers, "kind": shape.kind,
           "batch": shape.global_batch, "seq_len": shape.seq_len,
           "argument_bytes": stats.argument_bytes, "real_bytes": real,
           "peak_bytes": stats.peak_bytes, "measured_peak_bytes": peak,
           "flops": stats.flops, "hbm_bytes": stats.hbm_bytes,
           "compute_ms": rl.compute_s * 1e3, "memory_ms": rl.memory_s * 1e3,
           "dominant": rl.dominant, "bound_ms": bound_ms, "ms": ms,
           "share": bound_ms / ms, "busy_ms": busy_ms,
           "busy_share": bound_ms / busy_ms,
           "model_flops_share": rl.model_flops / (ms * 1e-3
                                                   * PEAK_FLOPS_BF16),
           "kernel_launches": dict(stats.kernel_launches)}
    print(f"15d {cfg.name}, {cfg.n_layers} layers, {shape.kind} B "
          f"{shape.global_batch} x {shape.seq_len}: argument bytes "
          f"{stats.argument_bytes} predicted, {real} real; peak "
          f"{stats.peak_bytes / 1e9:.3f} GB predicted, {peak / 1e9:.3f} GB "
          f"measured ({peak / stats.peak_bytes:.3f}x); compute "
          f"{out['compute_ms']:.4f} ms, memory {out['memory_ms']:.4f} ms: "
          f"{rl.dominant}-bound at {bound_ms:.4f} ms; step {ms:.4f} ms "
          f"(median of 10): share {out['share']:.3f}; device busy "
          f"{busy_ms:.4f} ms: share {out['busy_share']:.3f}; model-FLOPs "
          f"share {out['model_flops_share']:.4f}; launches "
          f"{json.dumps(out['kernel_launches'])}")
    if stats.argument_bytes != real:
        raise AssertionError(f"argument bytes {stats.argument_bytes} != "
                             f"{real}")
    if peak > PEAK_SLACK * stats.peak_bytes:
        raise AssertionError(f"measured peak {peak} above {PEAK_SLACK} x "
                             f"the predicted {stats.peak_bytes}")
    if max(out["share"], out["busy_share"]) > SHARE_LIMIT:
        raise AssertionError(f"roofline bound {bound_ms} ms is above "
                             f"{SHARE_LIMIT} x the step's {ms} ms or its "
                             f"{busy_ms} ms of device-busy time")
    del step, model
    free_card()
    return out


def phase15(get_config, build_model, ServingEngine, Request, fns):
    """15a-15c: the configurations never served on the card before, each
    served paged at the depth NEW_CONFIGS gives, then its f32 kernel vs
    plain check (kimi: its MoE FFN vs the direct sum); 15d: the dry-run
    against the card for each of them at a B-8 stripe decode step and
    for phase 13b's qwen3-4b train step. Returns (launches summed over
    the serves, 15d's numbers)."""
    from repro_torch.configs.shapes import InputShape
    decode = InputShape("card_decode", "decode", STRIPE_T, B)
    launches, checks = {}, []
    for arch, layers, f32_layers in NEW_CONFIGS:
        cfg = _cut(get_config, arch, layers)
        label = {"deepseek-7b": "15a", "minitron-8b": "15a",
                 "nemotron-4-340b": "15b"}.get(arch, "15c")
        phase(f"{label}. serve {arch} ({cfg.n_layers} layers), bf16, paged, "
              f"use_kernel=True")
        free_card()
        print(f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated "
              f"before the model")
        model = build_model(cfg, device="cuda")
        t0 = time.perf_counter()
        params = model.init(SEED)
        torch.cuda.synchronize()
        print(f"d {cfg.d_model}, {cfg.n_heads} / {cfg.n_kv_heads} heads of "
              f"{cfg.hd}, act {cfg.act}, vocab {cfg.vocab_size}: "
              f"{sum(t.numel() for t in _leaves(params)) / 1e9:.3f} B "
              f"params, {sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9:.2f}"
              f" GB, init {time.perf_counter() - t0:.1f} s")
        for name, n in serve_new_config(cfg, model, params, fns,
                                        ServingEngine, Request).items():
            launches[name] = launches.get(name, 0) + n
        if cfg.n_experts:
            moe_vs_direct_sum(cfg, params)
        del params, model
        free_card()
        if f32_layers:
            kernel_vs_plain_f32(_cut(get_config, arch, f32_layers,
                                     torch.float32), build_model,
                                ServingEngine, Request)
            free_card()
        checks.append(dryrun_vs_card(cfg, decode, build_model))
    phase("15d. the dry-run against the card: qwen3-4b's train step")
    train = InputShape("card_train", "train", TRAIN_S, TRAIN_B)
    checks.append(dryrun_vs_card(_cut(get_config, "qwen3-4b", TRAIN_LAYERS),
                                 train, build_model))
    print("launches of the phase-15 serves:", json.dumps(launches))
    print("dryrun vs card:", json.dumps(checks))
    return launches, checks


# --------------------------------------------- phase 16: the entry points
# (module, arguments, the reference's closing line, kernels it launches)
ENTRY_POINTS = (
    ("smoke_all", (), "OK hymba-1.5b ",
     ("flash_attention", "decode_attention", "wkv_scan", "ssm_scan")),
    ("serve_parallel_pipeline", (), "  supervisor: RUNNING healthy=2 ",
     ("flash_attention", "paged_window_attention")),
    ("multiarch_serving", (), "OK",
     ("paged_window_attention", "flash_attention", "decode_attention",
      "wkv_scan", "ssm_scan")),
    ("train_small", (), "OK", ("flash_attention", "flash_attention_bwd")),
    ("train_small", ("--arch", "rwkv6-1.6b"), "OK", ("wkv_scan", "wkv_bwd")),
    ("train_small", ("--arch", "hymba-1.5b"), "OK",
     ("flash_attention", "flash_attention_bwd", "ssm_scan", "ssm_scan_bwd")),
    ("quickstart", (), "OK — see ", ("flash_attention",)),
    ("ahp_select", (), "consistency ratios: ", ()),
)
ENTRY_TIMEOUT = 600             # s, one entry point's subprocess
ENTRY_DOCS, ENTRY_REPLICAS, ENTRY_FAIL, ENTRY_CLIENTS = 40, 3, 0.08, 4
FRESH_THREADS = 3


def kernel_wrappers():
    """The eight kernel wrappers, whose ``launches`` count their launches:
    the five forward kernels, then the three backward ones."""
    from repro_torch.kernels.decode_attention import kernel as dec
    from repro_torch.kernels.flash_attention import backward as fb
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.paged_attention import kernel as pw
    from repro_torch.kernels.rwkv_scan import backward as wb
    from repro_torch.kernels.rwkv_scan import kernel as wk
    from repro_torch.kernels.ssm_scan import backward as sb
    from repro_torch.kernels.ssm_scan import kernel as sk
    return (pw.paged_window_attention, fk.flash_attention,
            dec.decode_attention, wk.wkv_scan, sk.ssm_scan,
            fb.flash_attention_bwd, wb.wkv_bwd, sb.ssm_scan_bwd)


def entry_point(name, args) -> int:
    """``chip_smoke.py --entry-point NAME ARGS``: run
    ``repro_torch.examples.NAME`` with ARGS as ``python -m`` runs a
    module (``runpy.run_module(..., alter_sys=True)``), then print the
    kernels' launch counts over the run on stderr, as one line
    ``LAUNCHES {json}``."""
    import runpy
    fns = kernel_wrappers()
    module = f"repro_torch.examples.{name}"
    sys.argv = [module, *args]
    runpy.run_module(module, run_name="__main__", alter_sys=True)
    sys.stdout.flush()
    print("LAUNCHES", json.dumps({fn.__name__: fn.launches for fn in fns}),
          file=sys.stderr)
    return 0


def start_entry_points():
    """16a: every entry point in its own subprocess at its defaults, all
    started together. Returns the running processes."""
    import tempfile
    procs = []
    for name, args, last, kernels in ENTRY_POINTS:
        out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
        p = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                              "--entry-point", name, *args], cwd=ROOT,
                             stdout=out, stderr=err, text=True)
        procs.append((name, args, last, kernels, p, out, err))
    return procs


def check_entry_points(procs, t0):
    """16a: each subprocess exits 0, ends on the reference's closing line
    and launched the kernels of its path. Prints each one's output.
    Returns {kernel: launches summed over the runs}."""
    total, failed = {}, []
    for name, args, last, kernels, p, out, err in procs:
        try:
            rc = p.wait(timeout=max(1.0, ENTRY_TIMEOUT
                                    - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            p.kill()
            rc = p.wait()
        out.seek(0)
        err.seek(0)
        lines, errs = out.read().rstrip().splitlines(), err.read()
        label = " ".join((name, *args))
        print(f"--- python -m repro_torch.examples.{label}: exit {rc}")
        for line in lines:
            print("   ", line[:200])
        counts = {}
        for line in errs.splitlines():
            if line.startswith("LAUNCHES "):
                counts = json.loads(line[len("LAUNCHES "):])
        problems = []
        if rc != 0:
            problems.append(f"exit {rc}: {errs[-2000:]}")
        elif not lines or not lines[-1].startswith(last):
            problems.append(f"last line {lines[-1:]} is not {last!r}...")
        if name == "serve_parallel_pipeline" and \
                "OK — zero lost requests through the outage." not in lines:
            problems.append("no 'zero lost requests' line")
        idle = [k for k in kernels if not counts.get(k)]
        if rc == 0 and idle:
            problems.append(f"kernels of its path never launched: {idle}")
        print(f"    launches: {json.dumps(counts)}")
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
        if problems:
            failed.append(f"{label}: {'; '.join(problems)}")
    if failed:
        raise AssertionError("entry points failed:\n" + "\n".join(failed))
    print(f"16a: {len(procs)} entry points ran on the card in "
          f"{time.perf_counter() - t0:.1f} s (all at once)")
    return total


def fresh_build_cases():
    """The five forward kernels at the reduced configs' head dim 32, f32:
    [(kernel name, kernel call, plain call)]."""
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.paged_attention.ops import (
        paged_window_attention)
    from repro_torch.kernels.paged_attention.ref import (
        paged_window_attention_ref)
    from repro_torch.kernels.rwkv_scan.ops import wkv
    from repro_torch.kernels.ssm_scan.ops import selective_scan
    f32 = torch.float32
    g = torch.Generator().manual_seed(16)
    q = torch.randn((2, 4, 33, 32), generator=g).cuda()
    k, v = (torch.randn((2, 2, 33, 32), generator=g).cuda()
            for _ in range(2))
    window = window_case(1, f32, [0, 5, 16, 40], seed=16, max_blocks=4,
                         heads=(4, 2, 32))
    dq, dk, dv = stripe_case(2, 4, 2, 32, f32, seed=16, T=64)
    dk, dv = dk.transpose(1, 2), dv.transpose(1, 2)
    lens = torch.tensor([33, 64], dtype=torch.int32, device="cuda")
    wargs, sargs = wkv_case(2, 17, 4, 32, seed=16), ssm_case(2, 17, 64, 16,
                                                               seed=16)
    return [
        ("flash_attention", lambda: flash_attention(q, k, v),
         lambda: flash_attention(q, k, v, force_ref=True)),
        ("paged_window_attention", lambda: paged_window_attention(*window),
         lambda: paged_window_attention_ref(*window)),
        ("decode_attention", lambda: decode_attention(dq, dk, dv, lens),
         lambda: decode_attention(dq, dk, dv, lens, force_ref=True)),
        ("wkv_scan", lambda: wkv(*wargs),
         lambda: wkv(*wargs, force_ref=True)),
        ("ssm_scan", lambda: selective_scan(*sargs),
         lambda: selective_scan(*sargs, force_ref=True)),
    ]


def fresh_build(build_dir) -> int:
    """``chip_smoke.py --fresh-build DIR``: in a fresh process, point the
    kernel build at the empty DIR and make the first calls of the five
    forward kernels from FRESH_THREADS threads released together, each
    starting on flash and then going round the others from its own
    place. Prints one JSON line: nvcc runs per source, launches per
    kernel, each kernel's largest difference from its plain version and
    whether the threads' outputs are bitwise equal."""
    import threading
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.BUILD_DIR = Path(build_dir)
    fns = kernel_wrappers()
    cases = fresh_build_cases()
    _zero(fns)
    gate = threading.Barrier(FRESH_THREADS)
    outs = [dict() for _ in range(FRESH_THREADS)]
    errors = []

    def run(i):
        rest = cases[1:]
        order = [cases[0], *rest[i:], *rest[:i]]
        gate.wait()
        try:
            for name, kernel, _ in order:
                outs[i][name] = kernel()
            torch.cuda.synchronize()
        except Exception as e:      # noqa: BLE001 — reported, then fails
            errors.append(f"thread {i}: {e!r}")

    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(i,))
               for i in range(FRESH_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    err, equal = {}, {}
    if not errors:
        for name, _, plain in cases:
            want = plain()
            got = [o[name] for o in outs]
            flat = [x if isinstance(x, tuple) else (x,) for x in got]
            ref = want if isinstance(want, tuple) else (want,)
            err[name] = max((a - b).abs().max().item()
                            for a, b in zip(flat[0], ref))
            equal[name] = all(torch.equal(a, b) for f in flat[1:]
                              for a, b in zip(flat[0], f))
    print(json.dumps({"nvcc_runs": _build.nvcc_runs,
                      "launches": {fn.__name__: fn.launches for fn in fns},
                      "max_abs_err": err, "threads_equal": equal,
                      "errors": errors, "seconds": wall}))
    return 0


def start_fresh_build(build_dir):
    """16d in a subprocess (it builds while 16a runs)."""
    import tempfile
    out = tempfile.TemporaryFile("w+")
    p = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                          "--fresh-build", str(build_dir)], cwd=ROOT,
                         stdout=out, stderr=subprocess.STDOUT, text=True)
    return p, out


def check_fresh_build(p, out, build_dir):
    """16d: one nvcc a source, each kernel launched once a thread and
    within 1e-4 of its plain version (the scans at T 17: 1e-4), the
    threads' outputs bitwise equal."""
    rc = p.wait(timeout=ENTRY_TIMEOUT)
    out.seek(0)
    text = out.read()
    if rc:
        raise AssertionError(f"--fresh-build exit {rc}: {text[-3000:]}")
    rec = json.loads(text.strip().splitlines()[-1])
    print(f"16d: first kernel calls from {FRESH_THREADS} threads on an "
          f"empty build directory, {rec['seconds']:.1f} s: nvcc runs "
          f"{json.dumps(rec['nvcc_runs'])}")
    print(f"    launches {json.dumps(rec['launches'])}; max |kernel - "
          f"plain| at hd 32, f32: "
          + json.dumps({k: float(f"{v:.3e}")
                        for k, v in rec["max_abs_err"].items()}))
    stems = {"flash_attention": "flash", "paged_window_attention":
             "paged_window", "decode_attention": "decode",
             "wkv_scan": "wkv", "ssm_scan": "ssm_scan"}
    want_runs = {stem: 1 for stem in stems.values()}
    bad = list(rec["errors"])
    if rec["nvcc_runs"] != want_runs:
        bad.append(f"nvcc runs {rec['nvcc_runs']} != {want_runs}")
    for name in stems:
        if rec["launches"].get(name) != FRESH_THREADS:
            bad.append(f"{name} launches {rec['launches'].get(name)} != "
                       f"{FRESH_THREADS}")
        if not rec["max_abs_err"].get(name, math.inf) <= 1e-4:
            bad.append(f"{name} differs from its plain version by "
                       f"{rec['max_abs_err'].get(name)}")
        if not rec["threads_equal"].get(name):
            bad.append(f"{name}: the threads' outputs differ")
    libs = sorted(f.name for f in Path(build_dir).glob("*.so"))
    if len(libs) != len(stems) or any(".tmp." in n for n in libs):
        bad.append(f"libraries in the build directory: {libs}")
    if bad:
        raise AssertionError("fresh build from threads: " + "; ".join(bad))


def check_drained(eng, what):
    stats = eng.pool_stats()
    if stats["paged"]:
        bad = stats["used"] or stats["logical_blocks"] \
            or stats["available"] != stats["total"]
    else:
        bad = stats["active"]
    if bad:
        raise AssertionError(f"{what}: the engine did not drain: {stats}")


# kernels each architecture's serve launches (its layout on the card)
SERVE_KERNELS = {"qwen3-4b": ("paged_window_attention", "flash_attention"),
                 "rwkv6-1.6b": ("wkv_scan",),
                 "hymba-1.5b": ("flash_attention", "decode_attention",
                                "ssm_scan")}
METRIC_KEYS = ("decode_steps", "prefill_batches", "chunk_steps")


def serve_launches_owed(engines, arch_cfg):
    """{kernel: launches} the engines' metrics owe (``expected_launches``
    over each engine's metrics deltas), zero for kernels off their path.
    ``engines``: [(engine, metrics before, architecture)]."""
    owed = {fn.__name__: 0 for fn in kernel_wrappers()}
    for eng, before, arch in engines:
        m = {k: eng.metrics[k] - before.get(k, 0) for k in METRIC_KEYS}
        for name in SERVE_KERNELS[arch]:
            owed[name] += expected_launches(name, arch_cfg[arch].n_layers, m)
    return owed


def entry_lm_paas(cfg, params, build_model, ServingEngine, Request, fns):
    """16b, first half: ``run_lm_paas`` with full-width qwen3-4b: every
    request served, launches owed by the replicas' metrics exactly, the
    pools drained, tokens equal to one engine serving each prompt
    alone. Returns {kernel: launches}."""
    from repro_torch.core.supervisor import Supervisor
    from repro_torch.examples import serve_parallel_pipeline as spp
    sup = Supervisor()
    _zero(fns)
    t0 = time.perf_counter()
    svc, outs = spp.run_lm_paas(sup, cfg=cfg, params=params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {fn.__name__: fn.launches for fn in fns}
    engines = [(rep.handler.scheduler.engine, {}, "qwen3-4b")
               for rep in svc.replicas]
    owed = serve_launches_owed(engines, {"qwen3-4b": cfg})
    print(f"LM PaaS, 2 replicas of full-width qwen3-4b, bf16, paged, "
          f"use_kernel: 6 prompts in {wall:.3f} s; launches "
          f"{json.dumps(got)}")
    if got != owed:
        raise AssertionError(f"LM PaaS launches {got} != {owed}")
    for eng, _, _ in engines:
        check_drained(eng, "LM PaaS replica")
    model = build_model(cfg, device="cuda")
    eng = ServingEngine(model, params, batch_size=2, max_seq=64,
                        use_kernel=True)
    for i, (prompt, out) in enumerate(zip(spp.lm_prompts(cfg.vocab_size),
                                          outs)):
        req = Request(rid=i, prompt=prompt, max_new_tokens=4)
        eng.run([req])
        if req.out_tokens != out["tokens"]:
            raise AssertionError(f"LM PaaS prompt {i}: {out['tokens']} != "
                                 f"the engine alone: {req.out_tokens}")
    check_drained(eng, "the engine alone")
    print("LM PaaS: every reply's tokens equal one engine serving the "
          "prompt alone; pools drained")
    sup.stop_all()
    return got


def entry_multiarch(cfgs, params, fns):
    """16b, second half: ``multiarch_serving`` with full-width qwen3-4b,
    rwkv6-1.6b and hymba-1.5b on the card, each ``LMPaaS`` first serving
    the prompts alone (launches owed by its engine's metrics exactly),
    then all behind the router's thread fan-out: tokens equal, launches
    the sum of the runs alone, pools drained. Returns {kernel:
    launches} of the fan-out."""
    from repro_torch.examples import multiarch_serving as ma
    archs = list(cfgs)
    t0 = time.perf_counter()
    paases = [ma.LMPaaS(a, i, cfg=cfgs[a], params=params.get(a))
              for i, a in enumerate(archs)]
    torch.cuda.synchronize()
    gb = sum(t.numel() * t.element_size() for p in paases
             for t in _leaves(p.scheduler.engine.params)) / 1e9
    print(f"multiarch: {', '.join(archs)} at full width, bf16, {gb:.2f} GB "
          f"of weights, built in {time.perf_counter() - t0:.3f} s")
    prompts = ma.prompts(4, "cuda")
    alone, solo = {}, {fn.__name__: 0 for fn in fns}
    for paas in paases:
        eng = paas.scheduler.engine
        before = dict(eng.metrics)
        _zero(fns)
        t0 = time.perf_counter()
        alone[paas.arch] = [paas((p, 4))["tokens"] for p in prompts]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {fn.__name__: fn.launches for fn in fns}
        owed = serve_launches_owed([(eng, before, paas.arch)], cfgs)
        print(f"  {paas.arch} alone: 4 requests in {wall:.3f} s, launches "
              f"{json.dumps({k: n for k, n in got.items() if n})}")
        if got != owed:
            raise AssertionError(f"{paas.arch} alone: launches {got} != "
                                 f"{owed}")
        for k, n in got.items():
            solo[k] += n
    sup, router, dispatcher, order = ma.deploy_router(paases)
    _zero(fns)
    lat, res = [], []
    for p in prompts:
        t0 = time.perf_counter()
        res.append(router((p, 4)))
        lat.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    dispatcher.shutdown()
    got = {fn.__name__: fn.launches for fn in fns}
    print(f"  router ({' -> '.join(order)}), thread fan-out: launches "
          f"{json.dumps(got)}; median join latency "
          f"{statistics.median(lat) * 1e3:.1f} ms")
    for a in archs:
        print(f"    {a:12s} first request -> {res[0].outputs[a]['tokens']} "
              f"({res[0].per_call_s[a] * 1e3:.1f} ms)")
    if got != solo:
        raise AssertionError(f"fan-out launches {got} != the runs alone "
                             f"{solo}")
    for a in archs:
        toks = [r.outputs[a]["tokens"] for r in res]
        if toks != alone[a]:
            raise AssertionError(f"{a}: fan-out tokens {toks} != alone "
                                 f"{alone[a]}")
    for paas in paases:
        check_drained(paas.scheduler.engine, paas.arch)
    print("multiarch: tokens under the fan-out equal each engine alone; "
          "launches the sum of the runs alone; pools drained")
    sup.stop_all()
    return got


def entry_deployment_with_faults(fns, card):
    """16c: ``serve_parallel_pipeline``'s deployment on the card, f32: 40
    documents, 3 replicas a NER service (the last a backup), fail rate
    0.08, 4 clients, work_experience/0 set down at request 13. No request
    lost, failovers above 0, flash launched 4 a parse and nothing else,
    fields equal to a fault-free sequential run of the same weights.
    Returns {kernel: launches}."""
    import random
    from repro_torch.core import cvdata
    from repro_torch.examples import serve_parallel_pipeline as spp
    sup, parser, services = spp.build_deployment(ENTRY_REPLICAS, ENTRY_FAIL)
    print("startup order:", " -> ".join(sup.start_all()))
    rng = random.Random(3)
    docs = [cvdata.make_document(rng) for _ in range(ENTRY_DOCS)]
    parser.parse(docs[0])
    torch.cuda.synchronize()
    _zero(fns)
    results, stages, wall = spp.serve_corpus(sup, services, docs,
                                             ENTRY_CLIENTS, ENTRY_DOCS // 3)
    torch.cuda.synchronize()
    got = {fn.__name__: fn.launches for fn in fns}
    spp.report(results, stages, wall, ENTRY_CLIENTS, services, ENTRY_DOCS)
    want = {fn.__name__: 0 for fn in fns}
    want["flash_attention"] = parser.encoder_cfg.n_layers * ENTRY_DOCS
    print(f"launches over the {ENTRY_DOCS} parses: {json.dumps(got)}")
    if got != want:
        raise AssertionError(f"launches {got} != {want}: flash once per "
                             f"encoder layer per parse, nothing else")
    lost = {n: s.balancer.stats["served"] for n, s in services.items()
            if s.balancer.stats["served"] != ENTRY_DOCS + 1}
    if lost:
        raise AssertionError(f"requests lost: served {lost}")
    fails = sum(s.balancer.stats["failovers"] for s in services.values())
    backup = sum(s.balancer.stats["backup_served"]
                 for s in services.values())
    if services["work_experience"].balancer.stats["failovers"] <= 0:
        raise AssertionError("the killed replica caused no failover")
    print(f"zero lost requests; failovers {fails}, backup_served {backup} "
          f"over the five services")
    print(f"stage timings over {ENTRY_DOCS} parses, {ENTRY_CLIENTS} clients, "
          f"faults injected (ms, p50 / p95), {card}:")
    for key in ("tika", "bert", "sectioning", "parallel_services", "total"):
        vals = [v * 1e3 for v in stages[key]]
        print(f"  {key:18s} {pct(vals, 0.5):9.3f} / {pct(vals, 0.95):9.3f}")
    total = [v * 1e3 for v in stages["total"]]
    print(f"  total p50 {pct(total, 0.5):.3f} ms, p95 {pct(total, 0.95):.3f}"
          f" ms beside the paper's < {PAPER_PARSE_MS} ms a CV (a recorded "
          f"comparison, not a gate)")
    clean = cv_parser_on(parser, "cuda", "sequential")
    check_cv_fields([clean.parse(d)["fields"] for d in docs],
                    [r["fields"] for r in results], docs, parser, clean,
                    "faults and 4 clients vs a fault-free sequential run")
    parser.dispatcher.shutdown()
    sup.stop_all()
    return got


def phase16(get_config, build_model, ServingEngine, Request, card):
    """Phase 16, the entry points: 16d's fresh build and 16a's entry
    points start together as subprocesses; then 16b and 16c in this
    process, on a card those have left. Returns {kernel: launches} over
    16a, 16b and 16c."""
    import tempfile
    fns = kernel_wrappers()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as fresh:
        t0 = time.perf_counter()
        build = start_fresh_build(fresh)
        procs = start_entry_points()
        phase("16a. python -m repro_torch.examples.<name> at its defaults, "
              "each in a subprocess, all at once (16d builds meanwhile)")
        launches = check_entry_points(procs, t0)
        phase(f"16d. a fresh build from {FRESH_THREADS} threads (started "
              f"with 16a)")
        check_fresh_build(*build, fresh)
    phase("16b. full width in-process: run_lm_paas (qwen3-4b, 2 replicas) "
          "and multiarch_serving (qwen3-4b, rwkv6-1.6b, hymba-1.5b)")
    cfgs = {a: get_config(a) for a in SERVE_KERNELS}
    qwen = build_model(cfgs["qwen3-4b"], device="cuda")
    params = {"qwen3-4b": qwen.init(SEED)}
    for got in (entry_lm_paas(cfgs["qwen3-4b"], params["qwen3-4b"],
                              build_model, ServingEngine, Request, fns),
                entry_multiarch(cfgs, params, fns)):
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n
    del qwen, params
    phase(f"16c. the paper's deployment with faults: {ENTRY_DOCS} documents, "
          f"{ENTRY_REPLICAS} replicas, fail rate {ENTRY_FAIL}, "
          f"{ENTRY_CLIENTS} clients, work_experience/0 killed at request "
          f"{ENTRY_DOCS // 3}")
    for k, n in entry_deployment_with_faults(fns, card).items():
        launches[k] = launches.get(k, 0) + n
    idle = [fn.__name__ for fn in fns if not launches.get(fn.__name__)]
    if idle:
        raise AssertionError(f"kernels no entry point launched: {idle}")
    print("launches under the entry points (16a + 16b + 16c):",
          json.dumps(launches))
    return launches


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
    from repro_torch.kernels.flash_attention import backward as flash_bwd
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.flash_attention.ops import (attention_bshd,
                                                         flash_attention)
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_ref)
    from repro_torch.kernels.paged_attention import kernel as pw_kernel
    from repro_torch.kernels.paged_attention.ops import paged_window_attention
    from repro_torch.kernels.paged_attention.ref import (
        paged_window_attention_ref)
    from repro_torch.kernels.rwkv_scan import backward as wkv_bwd
    from repro_torch.kernels.rwkv_scan import kernel as wkv_kernel
    from repro_torch.kernels.rwkv_scan.ops import wkv
    from repro_torch.kernels.rwkv_scan.ref import (wkv_bwd_ref,
                                                   wkv_checkpoints_ref,
                                                   wkv_ref)
    from repro_torch.kernels.ssm_scan import backward as ssm_bwd
    from repro_torch.kernels.ssm_scan import kernel as ssm_kernel
    from repro_torch.kernels.ssm_scan.ops import selective_scan
    from repro_torch.kernels.ssm_scan.ref import (ssm_scan_bwd_ref,
                                                  ssm_scan_checkpoints_ref,
                                                  ssm_scan_ref)
    from repro_torch.models.model import build_model
    from repro_torch.serve import prng, sampling
    from repro_torch.serve.engine import Request, ServingEngine

    phase("2. build")
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"built {len(libs)} CUDA source(s) in "
          f"{time.perf_counter() - t0:.1f} s")
    paged_fns = (pw_kernel.paged_window_attention,
                 flash_kernel.flash_attention)
    tool_dir = Path(_build.nvcc()).parent
    print_ptxas(_build.BUILD_DIR, tool_dir)
    print_sass_checks(libs, tool_dir)
    bwd_split = bwd_launch_split(flash_kernel.flash_attention,
                                 flash_bwd.flash_attention_bwd)
    scan_split = scan_bwd_launch_split(
        (wkv_kernel.wkv_scan, ssm_kernel.ssm_scan),
        (wkv_bwd.wkv_bwd, ssm_bwd.ssm_scan_bwd))
    # phase 15 runs on a card no other phase has used: the largest of its
    # models (nemotron-4-340b's 2 layers, 32.8 GB, and their f32 twin at
    # 1 layer, ~52 GB) need nearly all of it, and main() holds earlier
    # phases' models and results until it returns
    new_launches, _ = phase15(get_config, build_model, ServingEngine,
                              Request, paged_fns)

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
    front_flash_err, front_dec_err = check_frontend_kernels(attention_bshd,
                                                            decode_attention)
    flash_err = max(flash_err, front_flash_err)
    dec_err = max(dec_err, front_dec_err)
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

    phase("11. the CV parser on the card, f32: cv_parser -> sentence "
          "encoder (flash, causal=False) -> sections -> 5 NER services x 2 "
          "replicas, thread dispatch")
    from repro_torch.core import cvdata, router
    from repro_torch.core.parallel import ParallelDispatcher
    from repro_torch.models import bert_encoder
    t0 = time.perf_counter()
    sup, parser, cv, order = build_cv_deployment()
    torch.cuda.synchronize()
    n_enc = sum(t.numel() for t in _leaves(parser.encoder_params))
    n_ner = sum(t.numel() for svc in parser.services.values()
                for t in _leaves(svc.replicas[0].handler.params))
    n_clf = bert_encoder.classifier_n_params(parser.classifier_params)
    print(f"startup order: {' -> '.join(order)}; encoder "
          f"{n_enc / 1e6:.2f} M params, classifier {n_clf:,}, 5 NER models "
          f"{n_ner / 1e6:.2f} M, all f32: "
          f"{4 * (n_enc + n_clf + n_ner) / 1e9:.3f} GB; create "
          f"{time.perf_counter() - t0:.2f} s")
    if n_clf != 154_604:
        raise AssertionError(f"classifier has {n_clf} params, not 154,604")
    docs = cvdata.make_corpus(CV_DOCS, seed=1)
    buckets = {}
    for d in docs:
        n = len(d.sentences)
        b = max(8, 1 << (n - 1).bit_length())
        buckets[b] = buckets.get(b, 0) + 1
    print(f"{CV_DOCS} documents, {sum(len(d.sentences) for d in docs)} "
          f"sentences; encoder batches {json.dumps(buckets)}")
    lower_cv_models(parser, docs[0])
    t0 = time.perf_counter()
    cv(docs[0])                                      # warm-up
    torch.cuda.synchronize()
    print(f"warm-up parse {(time.perf_counter() - t0) * 1e3:.1f} ms (after "
          f"lower_all)")
    first_parse_before_after()
    kernel_fns = (pw_kernel.paged_window_attention,
                  flash_kernel.flash_attention, dec_kernel.decode_attention,
                  wkv_kernel.wkv_scan, ssm_kernel.ssm_scan)
    for fn in kernel_fns:
        fn.launches = 0
    t0 = time.perf_counter()
    outs = [cv(d) for d in docs]
    cv_wall = time.perf_counter() - t0
    cv_launches = {fn.__name__: fn.launches for fn in kernel_fns}
    print("launches over the parses:", json.dumps(cv_launches))
    want = {fn.__name__: 0 for fn in kernel_fns}
    want["flash_attention"] = parser.encoder_cfg.n_layers * len(docs)
    if cv_launches != want:
        raise AssertionError(f"launches {cv_launches} != {want}: flash once "
                             f"per encoder layer per parse, nothing else")
    for i, o in enumerate(outs):
        if set(o["fields"]) != set(router.ROUTES):
            raise AssertionError(f"document {i}: fields {sorted(o['fields'])}")
    fields = [o["fields"] for o in outs]
    print(f"{CV_DOCS} parses in {cv_wall:.3f} s "
          f"({CV_DOCS / cv_wall:.1f} CVs/s); entities found: "
          + json.dumps({k: sum(len(f[k]) for f in fields)
                        for k in router.ROUTES}))
    print(f"stage timings over {CV_DOCS} parses (ms, p50 / p95), "
          f"{card}:")
    for key in ("tika", "bert", "sectioning", "parallel_services", "total"):
        vals = [o["timings"][key] * 1e3 for o in outs]
        print(f"  {key:18s} {pct(vals, 0.5):9.3f} / {pct(vals, 0.95):9.3f}")
    speedups = [o["dispatch"].speedup for o in outs]
    print(f"  dispatch speedup (sum of service times / fan-out wall) p50 "
          f"{pct(speedups, 0.5):.3f}, p95 {pct(speedups, 0.95):.3f}")
    total_p50 = pct([o["timings"]["total"] * 1e3 for o in outs], 0.5)
    print(f"  total p50 {total_p50:.3f} ms beside the paper's < "
          f"{PAPER_PARSE_MS} ms a CV (a recorded comparison, not a gate)")
    seq = replace(parser, dispatcher=ParallelDispatcher(mode="sequential"))
    seq_outs = [seq.parse(d) for d in docs]
    check_cv_fields([o["fields"] for o in seq_outs], fields, docs, parser,
                    parser, "sequential vs thread dispatch, card")
    for key in ("parallel_services", "total"):
        vals = [o["timings"][key] * 1e3 for o in seq_outs]
        print(f"  sequential dispatch {key:18s} p50 {pct(vals, 0.5):9.3f} "
              f"/ p95 {pct(vals, 0.95):9.3f} ms")
    cpu = cv_parser_on(parser, "cpu", "sequential")
    check_cv_fields([cpu.parse(d)["fields"] for d in docs], fields, docs,
                    parser, cpu, "card vs the port on the CPU, same weights")
    profile_parse(parser.parse, max(docs, key=lambda d: len(d.sentences)))
    profile_parse(parser.parse, docs[0])
    parser.dispatcher.shutdown()
    sup.stop_all()
    for name, n in cv_launches.items():
        serve_launches[name] = serve_launches.get(name, 0) + n
    del sup, parser, cv, seq, seq_outs, cpu
    torch.cuda.empty_cache()

    phase("12. the frontends at full width, bf16: whisper-tiny (encoder + "
          "cross-attention decoder) and qwen2-vl-2b (M-RoPE vision prefix), "
          f"prefill + {FRONT_STEPS} greedy decode steps on stripes")
    front_lens = {}
    for name in FRONT_RUNS:
        launches, lens, cap = frontend_serve(name, get_config, build_model,
                                             kernel_fns)
        front_lens[name] = (lens, cap)
        for key, n in launches.items():
            serve_launches[key] = serve_launches.get(key, 0) + n
    print("launches summed over the serves:", json.dumps(serve_launches))

    phase("12b. the frontends, f32, full width (qwen2-vl-2b at 4 layers): "
          "card vs CPU, paged vs stripes, window vs decode steps")
    for name in FRONT_RUNS:
        frontend_checks(name, get_config, build_model,
                        pw_kernel.paged_window_attention)

    phase("13a. the backward kernels vs their plain versions at the "
          "training shapes: flash (f32 and bf16), WKV and the selective "
          "scan (f32), the scans also at the plan's shard shapes")
    bwd_err = check_flash_backward(flash_kernel.flash_attention,
                                   flash_bwd.flash_attention_bwd,
                                   flash_attention, flash_attention_ref,
                                   flash_attention_bwd_ref)
    wkv_err = max(wkv_err, check_scan_vs_plain(
        "wkv_scan, shard shapes", wkv, partial(wkv_case, decays="model"),
        WKV_SHARD_SHAPES))
    ssm_err = max(ssm_err, check_scan_vs_plain(
        "ssm_scan, shard shapes", selective_scan, ssm_case,
        SSM_SHARD_SHAPES))
    wkv_bwd_err = check_scan_backward(
        "wkv", wkv_kernel.wkv_scan, wkv_bwd.wkv_bwd, wkv_bwd_ref, wkv_ref,
        lambda r, k, v, w, u, s: wkv_checkpoints_ref(r, k, v, w, s),
        wkv_bwd_case, WKV_BWD_SHAPES + WKV_SHARD_SHAPES,
        ("r", "k", "v", "w", "u", "state"))
    ssm_bwd_err = check_scan_backward(
        "selective_scan", ssm_kernel.ssm_scan, ssm_bwd.ssm_scan_bwd,
        ssm_scan_bwd_ref, ssm_scan_ref,
        lambda u, dt, Bm, Cm, A, D, s: ssm_scan_checkpoints_ref(u, dt, Bm,
                                                                A, s),
        ssm_bwd_case, SSM_BWD_SHAPES + SSM_SHARD_SHAPES,
        ("u", "dt", "B", "C", "A", "D", "state"))
    check_grad_refusals((paged_window_attention, decode_attention,
                         wkv_kernel.wkv_scan, ssm_kernel.ssm_scan),
                        (wkv, selective_scan))
    train_fns = (*kernel_fns, flash_bwd.flash_attention_bwd,
                 wkv_bwd.wkv_bwd, ssm_bwd.ssm_scan_bwd)
    train_launches, train_metrics = {}, {}
    grad_launches = {}   # 13c / 13f, f32

    phase(f"13b. train full-width qwen3-4b, bf16, remat, {TRAIN_LAYERS} "
          f"layers, {TRAIN_STEPS} steps of B {TRAIN_B} x S {TRAIN_S}")
    train_launches["qwen3-4b"], train_metrics["qwen3-4b"] = \
        train_full_width("qwen3-4b", TRAIN_LAYERS, get_config, build_model,
                         train_fns, {"flash_attention": 2,
                                     "flash_attention_bwd": 1})

    phase(f"13c. train_loss gradients, kernel route vs plain route, f32, "
          f"full width, {GRAD_LAYERS} layers")
    grad_launches["qwen3-4b"] = train_grads_kernel_vs_plain(
        "qwen3-4b", GRAD_B, GRAD_S, get_config, build_model, train_fns,
        {"flash_attention": 1, "flash_attention_bwd": 1})

    phase("13d. the launcher: python -m repro_torch.launch.train --steps 3 "
          "(reduced qwen3-4b and rwkv6-1.6b, f32) on the card")
    run_train_launcher("qwen3-4b")
    run_train_launcher("rwkv6-1.6b")

    for arch, per_layer in RECURRENT_TRAIN.items():
        phase(f"13e. train full-width {arch}, bf16, remat, all layers, "
              f"{TRAIN_STEPS} steps of B {TRAIN_B} x S {TRAIN_S}")
        train_launches[arch], train_metrics[arch] = train_full_width(
            arch, None, get_config, build_model, train_fns, per_layer)

    phase(f"13f. train_loss gradients of the recurrent families, kernel "
          f"route vs plain route, f32, full width, {GRAD_LAYERS} layers, "
          f"B 2 x S {REC_GRAD_S}")
    for arch, per_layer in RECURRENT_TRAIN.items():
        grad_launches[arch] = train_grads_kernel_vs_plain(
            arch, 2, REC_GRAD_S, get_config, build_model, train_fns,
            {k: 1 for k in per_layer})
    print("train runs:", json.dumps(train_metrics))

    phase("14. the sharded path: ParallelPlan on a 1 x 1 DeviceMesh (one "
          "NCCL rank): serve, MoE, recurrent decode, the sequence-sharded "
          "body, train, launcher")
    plan_launches, plan_times = phase14_sharded(
        get_config, build_model, ServingEngine, Request, card,
        {fn.__name__: fn for fn in train_fns} | {"decode_op":
                                                 decode_attention})

    for name, n in new_launches.items():
        serve_launches[name] = serve_launches.get(name, 0) + n
    print("launches summed over the serves:", json.dumps(serve_launches))

    entry_launches = phase16(get_config, build_model, ServingEngine, Request,
                             card)

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
    # the sentence encoder's attention: non-causal, f32, S = T = 24, at
    # both sentence-batch buckets, on the model's (B,S,H,hd) views
    enc_times = {}
    for Bq in ENC_BATCHES:
        q, k, v = encoder_qkv(Bq, ENC_S, torch.float32, seed=21)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        e_ms = time_ms(lambda: attention_bshd(q, k, v, causal=False), flush)
        ep_ms = time_ms(lambda: attention_bshd(q, k, v, causal=False,
                                               force_ref=True), flush)
        el_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt),
                        flush)
        eb_ms, eb_by = flash_bound(Bq, ENC_H, ENC_H, ENC_S, ENC_S, ENC_HD,
                                   torch.float32, causal=False)
        enc_times[Bq] = (e_ms, ep_ms, eb_ms, eb_by, el_ms)
        print(f"flash non-causal B {Bq} S = T = {ENC_S} Hq = Hkv = {ENC_H} "
              f"hd {ENC_HD} f32: kernel {e_ms:.4f} ms, plain {ep_ms:.4f} "
              f"ms, sdpa {el_ms:.4f} ms, bound {eb_ms:.5f} ms ({eb_by})")
    front_flash, front_dec = time_frontends(attention_bshd, decode_attention,
                                            flush, front_lens)
    time_sampler(sampling)
    bwd_times, fwd_lse_times = time_flash_backward(
        flash_kernel.flash_attention, flash_bwd.flash_attention_bwd,
        flash_attention_ref, flash_attention_bwd_ref, flush, bwd_split)
    scan_bwd_times = time_scan_backward(
        (wkv_kernel.wkv_scan, ssm_kernel.ssm_scan),
        (wkv_bwd.wkv_bwd, ssm_bwd.ssm_scan_bwd),
        (wkv_bwd_ref, ssm_scan_bwd_ref), (wkv_ref, ssm_scan_ref),
        (wkv, selective_scan), flush)
    for name, launches in scan_split.items():
        shown = ", ".join(f"{n} {ms:.4f} ms" for n, ms in launches.items())
        print(f"{name} launches at the train shape (profiler, per call): "
              f"{shown or 'no device time recorded: not measured'}")
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
        grok_bound_ms=fgb_ms, grok_bound_by=fgb_by,
        **{f"encoder{tag}_{key}": val
           for tag, Bq in (("", 8), ("_b16", 16))
           for key, val in zip(("ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms"), enc_times[Bq])}, **front_flash)
    q_ms, qp_ms, qb_ms, qb_by, ql_ms, qf_ms = dec_times["qwen3-4b"]
    next(r for r in rows if r["name"] == "decode_attention").update(
        floor_ms=dec_times["hymba-1.5b"][5], qwen3_ms=q_ms,
        qwen3_plain_ms=qp_ms, qwen3_bound_ms=qb_ms, qwen3_bound_by=qb_by,
        qwen3_library_ms=ql_ms, qwen3_floor_ms=qf_ms, **front_dec)
    k_ms, p_ms, b_ms, b_by, l_ms = bwd_times["train"]
    rows.append({
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:24",
        "replaces_note": "the gradient of _flash_kernel's function, which "
                         "the reference takes through XLA "
                         "(src/repro/models/attention.py:106)",
        "launches": sum(n["flash_attention_bwd"]
                        for n in train_launches.values()),
        "train_launches": sum(n["flash_attention_bwd"] for n in (
            *train_launches.values(), *grad_launches.values())),
        "train_f32_launches": sum(n["flash_attention_bwd"]
                                  for n in grad_launches.values()),
        "max_abs_err": bwd_err, "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": l_ms,
        **{f"{key}_{name}": val
           for key in ("train_f32", "whisper_enc", "hd192", "nemotron")
           for name, val in zip(("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms"), bwd_times[key])},
        "nemotron_plain_S": bwd_times["nemotron_plain_S"],
        "launch_split_ms": bwd_split})
    for name, source, replaces, note, err in (
            ("wkv_bwd", "rwkv_scan/csrc/wkv_bwd.cu", "rwkv_scan/kernel.py:29",
             "_wkv_kernel's function, which the reference takes through "
             "XLA's lax.scan (src/repro/models/rwkv6.py:80)", wkv_bwd_err),
            ("ssm_scan_bwd", "ssm_scan/csrc/ssm_scan_bwd.cu",
             "ssm_scan/kernel.py:36", "_ssm_kernel's function, which the "
             "reference takes through XLA's lax.scan "
             "(src/repro/models/ssm.py:34)", ssm_bwd_err)):
        (k_ms, p_ms, b_ms, b_by, f_ms, fc_ms, fb_ms, fb_by, pair_ms,
         pf_ms) = scan_bwd_times[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/{source}",
            "replaces": f"src/repro/kernels/{replaces}",
            "replaces_note": f"the gradient of {note}",
            "launches": sum(n[name] for n in train_launches.values()),
            "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "train_fwd_ms": f_ms, "train_fwd_ck_ms": fc_ms,
            "train_fwd_bound_ms": fb_ms, "train_fwd_bound_by": fb_by,
            "train_fwd_plain_ms": pf_ms,
            "train_pair_ms": pair_ms, "launch_split_ms": scan_split[name]})
    for name in ("wkv_scan", "ssm_scan"):
        next(r for r in rows if r["name"] == name).update(
            train_launches=sum(n[name] for n in train_launches.values()))
    next(r for r in rows if r["name"] == "flash_attention").update(
        train_launches=sum(n["flash_attention"]
                           for n in train_launches.values()),
        **{f"{key}_{name}": val for key, vals in fwd_lse_times.items()
           for name, val in zip(("fwd_ms", "fwd_lse_ms", "fwd_lse_bound_ms",
                                 "fwd_lse_bound_by", "fwd_library_ms",
                                 "fwd_lse_plain_ms"), vals)})
    for row in rows:
        row["plan_launches"] = plan_launches.get(row["name"], 0)
        row["entry_launches"] = entry_launches.get(row["name"], 0)
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _leaves(tree):
    for v in (tree.values() if isinstance(tree, dict) else tree):
        if isinstance(v, (dict, list)):
            yield from _leaves(v)
        else:
            yield v


if __name__ == "__main__":
    if sys.argv[1:2] == ["--first-parse"]:
        sys.exit(first_parse(sys.argv[2] == "lower_all"))
    if sys.argv[1:2] == ["--entry-point"]:
        sys.exit(entry_point(sys.argv[2], sys.argv[3:]))
    if sys.argv[1:2] == ["--fresh-build"]:
        sys.exit(fresh_build(sys.argv[2]))
    sys.exit(main())
