"""The per-device work of the recurrent mixers' and cross-attention's
tensor-parallel bodies, against the reference's partitioned program.

FLOPs. Reduced rwkv6-1.6b, hymba-1.5b and whisper-tiny (f32, B 4, S 64;
decode: one token against a 64-slot cache), with qwen3-4b as the dense
control, at prefill, decode and a remat train step (loss, gradient,
AdamW) on (data 1, model 4), and the train step on (data 2, model 2).
The reference jits each step with its ``param_shardings`` /
``input_shardings`` on 4 forced XLA CPU devices and counts the compiled
(per-device) HLO's FLOPs with ``hlo_analysis``: that is GSPMD's division
of the work by the placements. The port runs the same step once on a
fake-backend ``DeviceMesh`` under ``step_analysis.analyze`` (meta
tensors, the kernels at their cost formulas). Its FLOPs per device are
at most 1.10x the reference's: each rank computes only its own heads
and channels. ``XLA_FLAGS`` must be set before ``jax`` is imported, so
the reference counts in one subprocess for the whole module.

Collectives. A decode step of each of the three on (data 2, model 2),
pinned by kind, count, bytes and axis in
:func:`test_decode_step_collectives_are_pinned`: no projection weight
of a mixer or of cross-attention is gathered.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro_torch.configs.base import get_config
from repro_torch.configs.shapes import InputShape
from repro_torch.launch.dryrun import build_step
from repro_torch.launch.step_analysis import analyze

ROOT = Path(__file__).resolve().parents[1]
B, S = 4, 64
ARCHS = ("rwkv6-1.6b", "hymba-1.5b", "whisper-tiny", "qwen3-4b")
# (kind, mesh shape): every kind on (1, 4), the train step also on (2, 2)
STEPS = (("prefill", (1, 4)), ("decode", (1, 4)), ("train", (1, 4)),
         ("train", (2, 2)))
CASES = [(a, k, m) for a in ARCHS for k, m in STEPS]
SLACK = 1.10

_REFERENCE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses, json, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, PartitionSpec
    from repro.configs.base import get_config
    from repro.configs.shapes import InputShape
    from repro.launch import hlo_analysis
    from repro.models.model import build_model
    from repro.sharding.rules import ParallelPlan
    from repro.train import optimizer as opt

    def flops(arch, kind, mesh_shape):
        cfg = get_config(arch).reduced()
        if kind == "train":
            cfg = dataclasses.replace(cfg, remat=True)
        model = build_model(cfg)
        mesh = Mesh(np.array(jax.devices()).reshape(mesh_shape),
                    ("data", "model"))
        plan = ParallelPlan.make(mesh, cfg, kind)
        params = jax.eval_shape(model.init, jax.random.key(0))
        p_sh = plan.param_shardings(params)
        specs = model.input_specs(InputShape("t", kind, {S}, {B}))
        in_sh = plan.input_shardings(specs)
        if kind == "train":
            oc = opt.AdamWConfig()
            state = jax.eval_shape(opt.init_state, params)

            def step(p, s, batch):
                (_, _), g = jax.value_and_grad(
                    lambda q: model.train_loss(q, batch, plan),
                    has_aux=True)(p)
                return opt.apply_updates(p, g, s, oc)[:2]
            o_sh = plan.param_shardings(state)
            fn = jax.jit(step, in_shardings=(p_sh, o_sh, in_sh["batch"]),
                         out_shardings=(p_sh, o_sh))
            args = (params, state, specs["batch"])
        elif kind == "prefill":
            fn = jax.jit(lambda p, b: model.prefill(p, b, plan),
                         in_shardings=(p_sh, in_sh["batch"]))
            args = (params, specs["batch"])
        else:
            fn = jax.jit(
                lambda p, t, c, n: model.decode_step(p, t, c, n, plan),
                in_shardings=(p_sh, in_sh["token"], in_sh["cache"],
                              plan.ns(PartitionSpec())),
                out_shardings=(None, in_sh["cache"]))
            args = (params, specs["token"], specs["cache"],
                    jax.ShapeDtypeStruct((), jnp.int32))
        txt = fn.lower(*args).compile().as_text()
        return hlo_analysis.analyze(txt).flops

    cases = json.loads(sys.argv[1])
    print(json.dumps([flops(a, k, tuple(m)) for a, k, m in cases]))
""").replace("{S}", str(S)).replace("{B}", str(B))


@pytest.fixture(scope="module")
def reference_flops():
    """{(arch, kind, mesh shape): the reference's compiled FLOPs per
    device}, counted in one subprocess."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    done = subprocess.run([sys.executable, "-c", _REFERENCE,
                           json.dumps(CASES)], env=env, capture_output=True,
                          text=True, timeout=400)
    assert done.returncode == 0, done.stderr[-3000:]
    counts = json.loads(done.stdout.strip().splitlines()[-1])
    return dict(zip(CASES, counts))


@pytest.fixture
def fake_world():
    """A world of 4 fake ranks, as rank 0; yields a mesh maker."""
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield lambda shape: init_device_mesh(
            "cpu", shape, mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def _step_stats(arch, kind, mesh):
    cfg = get_config(arch).reduced()
    if kind == "train":
        cfg = dataclasses.replace(cfg, remat=True)
    step = build_step(cfg, InputShape("t", kind, S, B), mesh)
    return analyze(step.fn, *step.args, mesh=mesh)[1]


@pytest.mark.parametrize("arch,kind,mesh_shape", CASES,
                         ids=[f"{a}-{k}-{m[0]}x{m[1]}" for a, k, m in CASES])
def test_flops_per_device_follow_the_references(arch, kind, mesh_shape,
                                                reference_flops, fake_world):
    got = _step_stats(arch, kind, fake_world(mesh_shape)).flops
    want = reference_flops[(arch, kind, mesh_shape)]
    assert got <= SLACK * want, (got, want, got / want)


def _decode_collectives(arch, cfg):
    """{kind: (count, bytes)} over ``model`` of a reduced decode step on
    (2, 2) with b = 2 rows a rank, f = 4 bytes an element (see
    :func:`test_decode_step_collectives_are_pinned`)."""
    L, d, f, b = cfg.n_layers, cfg.d_model, 4, B // 2
    hd, H, V = cfg.hd, cfg.n_heads, 512
    psum = 2 * f * b * d                 # an all-reduce of (b, 1, d)
    if arch == "rwkv6-1.6b":
        lora = 64
        gathers = (5 * d + b * lora + H * hd + 2 * d + b * d) * f
        return {"all-gather": (5 * L + 1, L * gathers + f * b * V),
                "all-reduce": (2 * L + 1, L * (2 * f * b + psum) + psum),
                "reduce-scatter": (2 * L, L * f * b * (H * hd + d))}
    # the self-attention: q and kv columns gathered, then the sequence
    # slices' (out, LSE) partials over the two model ranks
    attn = f * b * (H * hd + 2 * cfg.n_kv_heads * hd) \
        + f * 2 * b * H * (hd + 1)
    per_layer, n_ag, n_ar = attn, 4, 3
    if arch == "hymba-1.5b":
        # B and C's columns gathered; A_log (d_inner, N) whole (DTensor
        # redistributes its N-split to a d_inner-split as an all-gather
        # and a chunk on a CPU mesh, an all-to-all on the card)
        per_layer += f * (b * 2 * cfg.ssm_state
                          + cfg.dinner * cfg.ssm_state)
        n_ag += 2
    return {"all-gather": (n_ag * L + 1, L * per_layer + f * b * V),
            "all-reduce": (n_ar * L + 1, n_ar * L * psum + psum)}


@pytest.mark.parametrize("arch", ARCHS[:3])
def test_decode_step_collectives_are_pinned(arch, fake_world):
    """A decode step of reduced rwkv6-1.6b / hymba-1.5b / whisper-tiny (L
    2, d 256, 4 heads (kv 4) of hd 32, d_ff 512, padded vocab V 512, f32:
    4 bytes an element) under a decode plan on (data 2, model 2), B 4
    placed by ``batch_spec`` (b = 2 rows a rank), the 64-slot cache by
    ``cache_spec`` (stripes' T, the WKV state's heads and the SSM state's
    channels over ``model``; whisper's cross K / V whole over it). No
    weight is sharded over ``data`` (``DECODE_TP_WEIGHT_BUDGET``). An
    all-gather moves its output once, an all-reduce twice its buffer, a
    reduce-scatter its input.

    Over ``data``: the logits' rows (B, 1, V), one all-gather. Over
    ``model``, once a step: the embedding's lookups all-reduced (b, 1, d)
    and the logits' columns all-gathered (b, 1, V). Per layer:

    * rwkv6 time-mix: ``mu`` (5, d), split over ``model`` along d,
      gathered whole; ``v`` reduce-scattered from this rank's rows of
      ``w_v`` (input (b, 1, H hd)); the decay LoRA's hidden state
      gathered (b, 1, 64); ``bonus_u`` (H, hd), split along hd, gathered
      (DTensor's CPU stand-in for the all-to-all to a split over H); the
      output norm's mean of squares all-reduced (b, 1, 1); ``w_o``'s
      product all-reduced (b, 1, d). Channel-mix: ``mu`` (2, d) gathered,
      ``w_v``'s partial sums reduce-scattered (input (b, 1, d)) and the
      product with the receptance gathered (b, 1, d). All-gathers 5,
      all-reduces 2, reduce-scatters 2.
    * hymba and whisper self-attention: the q and kv columns gathered
      ((b, 1, H hd), (b, 1, 2 Hkv hd)), the two sequence slices' outputs
      (2, b, H, hd) and LSEs (2, b, H) gathered, ``w_o`` all-reduced;
      the MLP's ``w_out`` all-reduced.
    * hymba's SSM: B and C gathered (b, 1, 2N), ``A_log`` (d_inner, N),
      split along N, gathered (as ``bonus_u``), ``w_out`` all-reduced.
    * whisper's cross-attention: this rank's query heads against its kv
      heads of the cross K / V, read in place; ``w_o`` all-reduced.

    No projection weight (``w_r`` / ``w_k`` / ``w_v`` / ``w_g`` /
    ``w_o``, the LoRA, ``w_in`` / ``w_gate`` / ``w_dt`` / ``w_bc`` /
    ``w_out``, cross ``w_q`` / ``w_kv`` / ``w_o``) is gathered."""
    cfg = get_config(arch).reduced()
    st = _step_stats(arch, "decode", fake_world((2, 2)))
    want = _decode_collectives(arch, cfg)
    data = 4 * B * 512
    assert st.collective_counts == {
        k: n + (k == "all-gather") for k, (n, _) in want.items()}
    assert st.collective_bytes == {
        k: nb + data * (k == "all-gather") for k, (_, nb) in want.items()}
    assert st.collective_bytes_by_axis == {
        "data": data, "model": sum(nb for _, nb in want.values())}
