"""The frozen yardstick: the kernel costs and peaks equal the program's
today, and the model FLOPs match hand counts for one layer of each
configuration."""
import json
from pathlib import Path

import pytest
import torch

from perfbench import yardstick as ys
from repro_torch.kernels import costs
from repro_torch.launch import mesh

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def conf(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())["run"]


def test_peaks_are_the_data_sheets():
    assert ys.PEAK_FLOPS_BF16 == mesh.PEAK_FLOPS_BF16 == 989e12
    assert ys.HBM_BW == mesh.HBM_BW == 3.35e12


@pytest.mark.parametrize("shape", [(1, 32, 32, 1024, 1024, 128),
                                   (3, 48, 8, 2048, 2048, 128),
                                   (2, 4, 2, 17, 17, 16)])
def test_flash_cost_is_the_programs(shape):
    assert ys.flash(*shape) == costs.flash(*shape, torch.bfloat16)


@pytest.mark.parametrize("bases", [[0], [5, 100, 1535], [4095] * 32])
def test_paged_cost_is_the_programs(bases):
    args = (1, 48, 8, 128, 16, 256)
    want = costs.paged_window(bases, args[0], args[1], args[2], args[3],
                              torch.bfloat16, args[4], args[5])
    assert ys.paged_window(bases, *args) == want


def test_bound_takes_the_slower_of_compute_and_memory():
    assert ys.bound_s(989e12, 0) == pytest.approx(1.0)
    assert ys.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert ys.bound_s(989e9, 3.35e12) == pytest.approx(1.0)


def test_deepseek_layer_by_hand():
    c = conf("deepseek-7b")
    attn = 4 * 4096 * 4096            # q, k, v, o: MHA, 32 x 128 = 4096
    ffn = 3 * 4096 * 11008
    assert ys.layer_params(c) == attn + ffn
    one = {**c, "n_layers": 1}
    # a token seeing 100 keys, no head: 2 x params + 4 x 128 x 32 x 100
    assert ys.token_flops(one, 100, head=False) == \
        2 * (attn + ffn) + 4 * 128 * 32 * 100
    assert ys.token_flops(one, 1, head=True) - \
        ys.token_flops(one, 1, head=False) == 2 * 4096 * 102400


def test_grok_layer_by_hand():
    c = conf("grok-1-314b-4l")
    attn = 6144 * 48 * 128 * 2 + 6144 * 2 * 8 * 128
    experts = 2 * 3 * 6144 * 32768    # top-2, not the capacity slots
    router = 6144 * 8
    assert ys.layer_params(c) == attn + experts + router
    P = 300
    one = {**c, "n_layers": 1}
    want = 2 * (attn + experts + router) * P \
        + 4 * 128 * 48 * P * (P + 1) // 2 + 2 * 6144 * 131072
    assert ys.prefill_flops(one, P) == want
    # the decode token fed at a row of 300 sees 301 keys
    assert ys.decode_flops(one, 300) == ys.token_flops(one, 301, True)


def test_whole_model_weights_match_the_configs_memory_note():
    c = conf("deepseek-7b")
    n = c["n_layers"] * ys.layer_params(c) + 2 * c["vocab_size"] * 4096
    assert abs(2 * n / 13.82e9 - 1) < 0.01
