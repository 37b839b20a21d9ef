"""The plain reference against independent computations: the port's own
CPU forward (plain torch, f32) on tiny dense and MoE configurations, and
a per-query loop for its attention; and its fp8 rounding."""
import math

import pytest
import torch

from perfbench import harness, weights
from perfbench.reference import decoder
from perfbench.tests import tiny
from repro_torch.models.model import build_model



@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these many small CPU ops: beside the other
    test workers, a pool a core wide spends its time waiting on itself."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.mark.parametrize("conf", [tiny.DENSE, tiny.MOE], ids=["dense", "moe"])
def test_logits_match_the_programs_cpu_forward(conf):
    cfg, c = harness.arch_config(conf)
    params = weights.make(c, 2**31 + 5, "cpu")
    model = build_model(cfg, "cpu")
    harness.check_layout(model, params)
    S = 13
    toks = torch.randint(0, c["vocab_size"], (S,),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[None].expand(S, S).to(torch.int32).contiguous()}
    with torch.no_grad():
        got, _ = model.prefill(params, batch,
                               last_idx=torch.arange(S, dtype=torch.int32))
    ref = decoder.logits(params, c, [toks.tolist()], [list(range(S))])[0]
    got = got[:, 0, : c["vocab_size"]]
    assert torch.allclose(got, ref, atol=2e-5, rtol=1e-5), \
        (got - ref).abs().max()


def test_attention_matches_a_loop_over_queries():
    g = torch.Generator().manual_seed(3)
    q = torch.randn(7, 4, 8, generator=g)
    k = torch.randn(7, 2, 8, generator=g)
    v = torch.randn(7, 2, 8, generator=g)
    out = decoder.attention(q, k, v, q_rows=3)
    for i in range(7):
        for h in range(4):
            s = torch.stack([q[i, h] @ k[j, h // 2] for j in range(i + 1)])
            w = torch.softmax(s / math.sqrt(8), 0)
            want = sum(w[j] * v[j, h // 2] for j in range(i + 1))
            assert torch.allclose(out[i, h], want, atol=1e-6)


def test_fp8_rounds_to_three_mantissa_bits():
    t = torch.tensor([[1.0, 1.06, 448.0, -300.0]])
    r = decoder.fp8(t, (-1,))
    assert r[0, 2] == 448.0 and r[0, 0] == 1.0
    assert r[0, 1] in (1.0, 1.125)
    rel = ((r - t).abs() / t.abs()).max()
    assert 0 < rel <= 2 ** -4


def test_full_f32_turns_tf32_off_and_back():
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with decoder.full_f32():
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
