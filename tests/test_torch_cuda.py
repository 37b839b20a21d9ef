"""Card-only tests of the port's CUDA kernel (marker ``cuda``; they skip
where no CUDA device is present). Run them on a GPU machine with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The CUDA paged-window kernel is held against its plain PyTorch version
on the same inputs (f32: atol = rtol = 1e-4, the sum order differs;
bf16: 3e-2, the reference grid's bf16 tolerance), with TF32 off.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.kernels.paged_attention import kernel as pw_kernel
from repro_torch.kernels.paged_attention.ops import (paged_decode_attention,
                                                     paged_window_attention)
from repro_torch.models.model import build_model
from repro_torch.serve.engine import Request, ServingEngine

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(B, S, Hq, Hkv, hd, bs, max_blocks, dtype, *, seed=0):
    """Random q / pool at ragged base lengths (incl. 0 and block
    boundaries); each row owns distinct blocks covering base + S tokens,
    table tails point at scratch block 0."""
    g = torch.Generator().manual_seed(seed)
    nb = B * max_blocks + 1
    q = torch.randn((B, S, Hq, hd), generator=g)
    pk = torch.randn((nb, bs, Hkv, hd), generator=g)
    pv = torch.randn((nb, bs, Hkv, hd), generator=g)
    T = max_blocks * bs
    edges = [0, bs - 1, bs, 2 * bs + 3, T - S]
    free = (torch.randperm(nb - 1, generator=g) + 1).tolist()
    base = torch.zeros(B, dtype=torch.int32)
    table = torch.zeros((B, max_blocks), dtype=torch.int32)
    for b in range(B):
        base[b] = edges[b] if b < len(edges) else \
            int(torch.randint(0, T - S + 1, (), generator=g))
        for i in range(-(-(int(base[b]) + S) // bs)):
            table[b, i] = free.pop()
    return [t.to("cuda", dtype) for t in (q, pk, pv)] + \
        [table.cuda(), base.cuda()]


# S x heads x head_dim x block_size x window x dtype
GRID = [
    (1, 32, 8, 128, 16, 0, torch.float32),    # qwen3-4b decode
    (4, 32, 8, 128, 16, 0, torch.float32),
    (64, 32, 8, 128, 16, 0, torch.float32),   # one chunk window
    (1, 32, 8, 128, 16, 0, torch.bfloat16),
    (64, 32, 8, 128, 16, 0, torch.bfloat16),
    (4, 32, 8, 128, 16, 24, torch.bfloat16),  # sliding window
    (3, 4, 4, 32, 8, 0, torch.float32),       # MHA, small blocks
    (2, 8, 1, 64, 4, 12, torch.float32),      # MQA + window
    (5, 8, 2, 256, 16, 0, torch.bfloat16),    # wide heads
    (2, 4, 2, 64, 64, 0, torch.float32),      # blocks wider than a warp
]


@pytest.mark.parametrize("S,Hq,Hkv,hd,bs,win,dt", GRID)
def test_kernel_matches_plain_version(cuda, S, Hq, Hkv, hd, bs, win, dt):
    max_blocks = -(-512 // bs)
    args = _case(8, S, Hq, Hkv, hd, bs, max_blocks, dt, seed=S * 7 + hd)
    before = pw_kernel.paged_window_attention.launches
    out, lse = paged_window_attention(*args, sliding_window=win)
    assert pw_kernel.paged_window_attention.launches == before + 1
    ro, rl = paged_window_attention(*args, sliding_window=win,
                                    force_ref=True)
    torch.cuda.synchronize()
    assert out.dtype == dt and lse.dtype == torch.float32
    torch.testing.assert_close(out.float(), ro.float(), atol=TOL[dt],
                               rtol=TOL[dt])
    torch.testing.assert_close(lse, rl, atol=TOL[dt], rtol=TOL[dt])


def test_decode_wrapper_is_window_at_s1(cuda):
    q, pk, pv, table, base = _case(8, 1, 32, 8, 128, 16, 32, torch.float32)
    od, ld = paged_decode_attention(q[:, 0], pk, pv, table, base + 1)
    ow, lw = paged_window_attention(q, pk, pv, table, base)
    torch.cuda.synchronize()
    assert torch.equal(od, ow[:, 0]) and torch.equal(ld, lw[:, 0])


def test_kernel_ignores_scratch_poison(cuda):
    q, pk, pv, table, base = _case(8, 4, 32, 8, 128, 16, 32, torch.float32)
    out, lse = paged_window_attention(q, pk, pv, table, base)
    pk[0], pv[0] = 1e9, -1e9
    out2, lse2 = paged_window_attention(q, pk, pv, table, base)
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and torch.equal(lse, lse2)


def test_kernel_rejects_what_it_cannot_run(cuda):
    q, pk, pv, table, base = _case(2, 2, 8, 2, 64, 16, 4, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        pw_kernel.paged_window_attention(q.transpose(0, 1), pk, pv, table,
                                         base)
    with pytest.raises(ValueError, match="dtype"):
        pw_kernel.paged_window_attention(q, pk.bfloat16(), pv.bfloat16(),
                                         table, base)
    with pytest.raises(ValueError, match="int32"):
        pw_kernel.paged_window_attention(q, pk, pv, table.long(), base)
    with pytest.raises(ValueError, match="head dim"):
        pw_kernel.paged_window_attention(q[..., :48].contiguous(),
                                         pk[..., :48].contiguous(),
                                         pv[..., :48].contiguous(), table,
                                         base)


def test_engine_kernel_vs_gather_on_card(cuda):
    """Reduced GQA qwen3-4b on the card: the kernel engine emits the
    gather engine's greedy streams, launching once per layer per step."""
    cfg = dataclasses.replace(get_config("qwen3-4b").reduced(),
                              n_kv_heads=2)
    model = build_model(cfg, device="cuda")
    params = model.init(0)
    g = torch.Generator().manual_seed(3)
    prompts = [torch.randint(2, cfg.vocab_size, (n,), generator=g).tolist()
               for n in (40, 7, 23, 90)]
    streams = {}
    for use_kernel in (True, False):
        before = pw_kernel.paged_window_attention.launches
        eng = ServingEngine(model, params, batch_size=4, max_seq=128,
                            block_size=16, prefill_chunk=16,
                            use_kernel=use_kernel)
        reqs = [Request(rid=i, prompt=list(p), max_new_tokens=6)
                for i, p in enumerate(prompts)]
        assert len(eng.run(list(reqs))) == 4
        launched = pw_kernel.paged_window_attention.launches - before
        expect = cfg.n_layers * eng.metrics["decode_steps"]
        assert launched == (expect if use_kernel else 0)
        assert eng.metrics["chunk_steps"] > 0
        streams[use_kernel] = reqs
    for a, b in zip(streams[True], streams[False]):
        assert a.out_tokens == b.out_tokens, a.rid
        torch.testing.assert_close(torch.tensor(a.out_logprobs),
                                   torch.tensor(b.out_logprobs),
                                   atol=1e-4, rtol=1e-4)
