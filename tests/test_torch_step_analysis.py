"""The port's step analysis (``repro_torch.launch.step_analysis``)
against the reference's HLO analysis (``repro.launch.hlo_analysis``),
and its collectives on a fake-backend mesh.

FLOPs. Reduced qwen3-4b (2 layers, d 256, 4 / 4 heads of 32, d_ff 512,
V 512, f32), the reference's weights carried over, B 2: the reference
jits its prefill of 64 tokens, a decode step against a 64-slot cache and
a remat train step (loss, gradient, AdamW) and counts the compiled HLO's
dot FLOPs, loop trip counts applied; the port runs the same step once on
CPU tensors (every kernel's plain version) under ``analyze``, which
counts ``torch.utils.flop_counter``'s formulas. Both count each product
as 2 * M * N * K; the attention of both is the dense masked path
(scores over every key, the mask applied after), and the remat train
step recomputes each layer's forward in the backward on both sides.
No op differs: at this size the three counts agree exactly.

Collectives. On a (data 2, model 2) mesh, as rank 0: a decode step
within ``DECODE_TP_WEIGHT_BUDGET`` moves what
``test_decode_plan_gathers_no_weight`` states, and a train step's
collectives are pinned by kind, count, bytes and mesh axis, each derived
in :func:`test_train_step_collectives_are_pinned` from the plan's bodies.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.configs.base import get_config as jax_config
from repro.launch import hlo_analysis
from repro.models.model import build_model as jax_build
from repro.train import optimizer as jax_opt
from repro_torch.configs.base import get_config
from repro_torch.configs.shapes import InputShape
from repro_torch.launch.dryrun import build_step
from repro_torch.launch.step_analysis import analyze, argument_bytes
from repro_torch.models.model import build_model
from repro_torch.sharding.rules import ParallelPlan
from repro_torch.train import optimizer as opt
from repro_torch.train.train_loop import make_train_step
from repro_torch.weights import params_from_numpy

B, S = 2, 64


def _configs(remat: bool):
    over = {"remat": remat}
    return (dataclasses.replace(jax_config("qwen3-4b").reduced(), **over),
            dataclasses.replace(get_config("qwen3-4b").reduced(), **over))


def _hlo_flops(fn, *args) -> float:
    txt = jax.jit(fn).lower(*args).compile().as_text()
    return hlo_analysis.analyze(txt).flops


@pytest.fixture(scope="module")
def tokens():
    rng = np.random.default_rng(0)
    return rng.integers(2, 512, (B, S + 1)).astype(np.int32)


@pytest.mark.parametrize("kind,tol", [("prefill", 0.01), ("decode", 0.01),
                                      ("train", 0.02)])
def test_flops_match_the_reference(kind, tol, tokens):
    jcfg, cfg = _configs(remat=kind == "train")
    jmodel, model = jax_build(jcfg), build_model(cfg, device="cpu")
    jparams = jmodel.init(jax.random.key(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    if kind == "prefill":
        want = _hlo_flops(lambda p, t: jmodel.prefill(p, {"tokens": t}),
                          jparams, jnp.asarray(tokens[:, :S]))
        with torch.no_grad():
            _, got = analyze(model.prefill, params,
                             {"tokens": torch.from_numpy(tokens[:, :S])})
    elif kind == "decode":
        want = _hlo_flops(
            lambda p, t, c: jmodel.decode_step(p, t, c, jnp.int32(S - 1)),
            jparams, jnp.asarray(tokens[:, :1]), jmodel.init_cache(B, S))
        with torch.no_grad():
            _, got = analyze(model.decode_step, params,
                             torch.from_numpy(tokens[:, :1]),
                             model.init_cache(B, S),
                             torch.tensor(S - 1, dtype=torch.int32))
    else:
        oc = jax_opt.AdamWConfig()

        def step(p, s, t):
            (_, _), g = jax.value_and_grad(
                lambda q: jmodel.train_loss(q, {"tokens": t}),
                has_aux=True)(p)
            return jax_opt.apply_updates(p, g, s, oc)[:2]
        want = _hlo_flops(step, jparams, jax_opt.init_state(jparams),
                          jnp.asarray(tokens))
        _, got = analyze(make_train_step(model, opt.AdamWConfig()), params,
                         opt.init_state(params),
                         {"tokens": torch.from_numpy(tokens)})
    assert got.flops == pytest.approx(want, rel=tol), (got.flops, want)
    assert got.collective_counts == {} and got.kernel_launches == {}


def test_kernel_ops_are_one_op_at_their_cost():
    """On meta tensors attention takes the kernels' route: each launch is
    one op whose FLOPs and bytes are its cost function's, and none of its
    plain version's ops run."""
    cfg = get_config("qwen3-4b").reduced()
    step = build_step(cfg, InputShape("t", "prefill", S, B))
    _, stats = analyze(step.fn, *step.args)
    assert stats.kernel_launches == {"flash_attention": cfg.n_layers}
    assert stats.argument_bytes == argument_bytes(step.args)
    assert stats.peak_bytes >= stats.argument_bytes
    with torch.no_grad():
        cpu = build_model(cfg, device="cpu")
        _, plain = analyze(cpu.prefill, cpu.init(0),
                           {"tokens": torch.zeros((B, S), dtype=torch.int32)})
    # the plain route's scores and PV products (4 * S * S * hd per head,
    # dense) against the kernel's causal half (S * S / 2 pairs)
    attn = 4 * B * cfg.n_heads * S * S * cfg.hd * cfg.n_layers
    assert plain.flops - stats.flops == pytest.approx(attn / 2, rel=1e-9)


def _ffn_step(ids, emb, w1, w3, w2, cache):
    x = torch.nn.functional.embedding(ids, emb)
    h = torch.nn.functional.silu(x @ w1) * (x @ w3)
    y = h @ w2
    cache[ids] = y
    return y.sum()


def test_hbm_bytes_of_a_small_step_are_pinned():
    """A SwiGLU FFN step on CPU tensors (T 6 token ids into a V 10 x d 8
    table, d_ff 16, f32: 4 bytes an element, ids 8), its HBM bytes,
    FLOPs and peak derived by hand from the module's rules:

    ======================  ======================================  =====
    op                      bytes                                   total
    ======================  ======================================  =====
    embedding (T x d)       twice its result + the ids: 2*192 + 48    432
    mm x @ w1 (T x f)       x 192 + w1 512 + out 384                 1088
    silu                    in 384 + out 384                          768
    mm x @ w3               as x @ w1                                1088
    mul                     two inputs and the output, 3 * 384       1152
    mm h @ w2 (T x d)       h 384 + w2 512 + out 192                 1088
    index_put_ cache[ids]   the values twice, 2 * 192, + the ids 48   432
    sum                     in 192 + the 0-d out 4                    196
    ======================  ======================================  =====

    6,244 bytes; views and metadata ops move none. FLOPs: three
    products of 2 * T * d * f = 1,536 each. Peak: the arguments (ids 48,
    emb 320, three weights of 512, cache 320: 2,224) live throughout, +
    x 192, silu's input 384 (freed once silu returns), its output 384,
    x @ w3 384 and the product 384 live together: 2,224 + 192 + 3 * 384
    = 3,568."""
    g = torch.Generator().manual_seed(0)
    T, V, d, f = 6, 10, 8, 16
    ids = torch.randperm(V, generator=g)[:T]
    args = (ids, *(torch.randn(shape, generator=g) for shape in
                   ((V, d), (d, f), (d, f), (f, d), (V, d))))
    _, stats = analyze(_ffn_step, *args)
    assert stats.hbm_bytes == 6244
    assert stats.flops == 3 * 2 * T * d * f
    assert stats.argument_bytes == 2224
    assert stats.peak_bytes == 3568
    assert stats.n_ops == 8


@pytest.fixture
def mesh():
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield init_device_mesh("cpu", (2, 2), mesh_dim_names=("data",
                                                              "model"))
    finally:
        dist.destroy_process_group()


def test_decode_step_collectives_follow_the_rule(mesh):
    """A decode step of reduced qwen3-4b (L 2, d 256, q columns Hq * hd =
    128, kv columns 2 * Hkv * hd = 256, padded vocab V 512, f32) under a
    decode plan, the cache and token whole on every rank, B 2: per layer
    the q and kv columns are all-gathered (outputs (B, 1, 128) and (B,
    1, 256)) and the w_o and w_out products all-reduced ((B, 1, d)
    each); then the embedding's lookups are all-reduced (B, 1, d) and
    the logits all-gathered (B, 1, V): 2L + 1 of each kind, all over
    ``model``. An all-gather moves its output once, an all-reduce twice
    its buffer."""
    cfg = get_config("qwen3-4b").reduced()
    model = build_model(cfg, device="meta")
    plan = ParallelPlan.make(mesh, cfg, "decode")
    params = plan.param_shardings(model.init(0))
    L, d, f = cfg.n_layers, cfg.d_model, 4
    q_cols, kv_cols = cfg.n_heads * cfg.hd, 2 * cfg.n_kv_heads * cfg.hd
    V = 512
    with torch.no_grad():
        _, st = analyze(model.decode_step, params,
                        torch.zeros((B, 1), dtype=torch.int32,
                                    device="meta"),
                        model.init_cache(B, S),
                        torch.full((B,), 3, dtype=torch.int32,
                                   device="meta"), plan=plan, mesh=mesh)
    assert st.collective_counts == {"all-gather": 2 * L + 1,
                                    "all-reduce": 2 * L + 1}
    gathered = f * B * (L * (q_cols + kv_cols) + V)
    reduced = 2 * f * B * d * (2 * L + 1)
    assert st.collective_bytes == {"all-gather": gathered,
                                   "all-reduce": reduced}
    assert st.collective_bytes_by_axis == {"model": gathered + reduced}


def test_train_step_collectives_are_pinned(mesh):
    """A train step (loss, gradient, AdamW) of reduced qwen3-4b (L 2, d
    256, 4 / 4 heads of hd 32, d_ff 512, V 512, f32; 4 bytes an element)
    under a train plan on (data 2, model 2), the batch (4, 17) placed by
    ``batch_spec`` (b = 2 rows a rank, S = 16), params by
    ``param_shardings`` (weight rows over ``data``, columns over
    ``model``; w_o / w_out rows over ``model``). What each body issues:

    all-gathers (21):
      * FSDP gathers over ``data`` (``local_block`` of a weight, its rows
        gathered, whole over ``data``, this rank's ``model`` block), each
        moving that block: per layer w_q (d, 128 / 2), w_kv (d, 256 / 2),
        w_o (128 / 2, d), w_in and w_gate (d, 512 / 2), w_out (512 / 2,
        d); once the embedding (V / 2, d) and the head (d, V / 2): 14;
      * over ``model``: per layer the kv columns (``col_linear``'s
        gather, output (b, S, 256)) and the residual read whole at block
        entry (``act_local``, (b, S, d)), in the backward the gradient of
        each ``constrain_residual`` ((b, S, d)); once the logits (b, S,
        V): 7.
    all-reduces (32), each moving twice its buffer:
      * over ``model``: ``psum`` of the w_o and w_out products per layer
        and of the embedding's lookups ((b, S, d), 5); ``psum_grad``'s
        backward for x entering the q, kv, w_in and w_gate products per
        layer and the head ((b, S, d), 9); the backward of ``_my_kv_heads``
        for k and v per layer ((b, S, Hkv, hd), 4); q_norm's gradient,
        partial over ``model`` (the rank's heads) per layer ((hd,), 2);
        the global norm's sum over the grads ((), 1);
      * over ``data``: the gradients of the params every row reads whole
        (attn / mlp norms per layer and the final norm (d,), 5; q_norm
        and k_norm per layer (hd,), 4); the loss's ``pmean`` and the
        global norm's sum ((), 2).
    reduce-scatters over ``data`` (14), each moving its input: the
    gradient of every FSDP-gathered weight back to its rows' shard, the
    14 blocks the gathers moved."""
    cfg = get_config("qwen3-4b").reduced()
    step = build_step(cfg, InputShape("t", "train", 16, 4), mesh)
    _, st = analyze(step.fn, *step.args, mesh=mesh)
    L, d, V, hd, Hkv, f = cfg.n_layers, cfg.d_model, 512, cfg.hd, \
        cfg.n_kv_heads, 4
    b, S_, q, kv, ff = 2, 16, cfg.n_heads * hd, 2 * Hkv * hd, cfg.d_ff
    fsdp = f * (L * (d * q // 2 + d * kv // 2 + q // 2 * d
                     + 2 * d * ff // 2 + ff // 2 * d) + V // 2 * d
                + d * V // 2)
    act = f * b * S_
    model_gathers = act * (L * (kv + d + d) + V)
    model_reduces = 2 * f * (b * S_ * d * (5 + 9) + b * S_ * Hkv * hd * 2 * L
                             + hd * L + 1)
    data_reduces = 2 * f * (d * (2 * L + 1) + hd * 2 * L + 2)
    assert st.collective_counts == {"all-gather": 21, "all-reduce": 32,
                                    "reduce-scatter": 14}
    assert st.collective_bytes == {"all-gather": fsdp + model_gathers,
                                   "all-reduce": model_reduces
                                   + data_reduces,
                                   "reduce-scatter": fsdp}
    assert st.collective_bytes_by_axis == {
        "data": 2 * fsdp + data_reduces,
        "model": model_gathers + model_reduces}
