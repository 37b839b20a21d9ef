"""The port's sharding rules against the reference's, in process.

``repro_torch.sharding.rules.ParallelPlan`` runs on a torch
``DeviceMesh`` of the production sizes — (data 16, model 16) and (pod 2,
data 16, model 16) — built over the fake process-group backend (one
process stands for rank 0 of 256 / 512). The reference's plan runs on
its own fake mesh (``tests/test_sharding.py``'s construction). For every
config, every param leaf, both meshes and the train / prefill / decode
kinds, ``param_spec`` is the reference's; so are ``moe_mode``,
``batch_axes``, the decode ``weight_fsdp``, ``cache_spec`` of every
cache leaf and ``batch_spec``. The reference's own properties hold on
the port: specs divide, non-divisible vocabularies replicate, batch-1
long context shards T over every axis, multi-pod FSDP axes. Placements
and ``local_block`` agree with the spec on a real one-rank gloo mesh.
"""
import contextlib
import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # deterministic local shim, see requirements-dev
    from _hypothesis_fallback import given, settings, strategies as st

from repro.configs.base import get_config as jax_config
from repro.models.model import build_model as jax_build
from repro.sharding.rules import ParallelPlan as JaxPlan
from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.models.model import build_model, init_params
from repro_torch.sharding.rules import P, ParallelPlan
from repro_torch.train import tree

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
KINDS = ("train", "prefill", "decode")


def jax_fake_mesh(shape, axes):
    """An abstract mesh over fake devices just for spec computation."""
    devs = np.array(jax.devices() * int(np.prod(shape)))[:int(np.prod(shape))]
    return Mesh(devs.reshape(shape), axes)


@contextlib.contextmanager
def torch_fake_mesh(shape, axes):
    """A DeviceMesh of prod(shape) ranks on the fake backend, as rank 0."""
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=int(np.prod(shape)))
    try:
        yield init_device_mesh("cpu", shape, mesh_dim_names=axes)
    finally:
        dist.destroy_process_group()


def _jax_leaves(tree_):
    return {tuple(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree_)[0]}


def _port_leaves(tree_):
    return {tuple(path.split("/")): leaf
            for path, leaf in tree.leaves_with_path(tree_)}


def spec_divides(spec, shape, sizes) -> bool:
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        if entry is None:
            continue
        names = (entry,) if isinstance(entry, str) else entry
        if dim % int(np.prod([sizes[a] for a in names])):
            return False
    return True


@pytest.fixture(scope="module")
def jax_shapes():
    """{arch: the reference's param leaves and decode-cache leaves}."""
    out = {}
    for arch in ARCH_IDS:
        m = jax_build(jax_config(arch))
        params = jax.eval_shape(m.init, jax.random.key(0))
        cache = jax.eval_shape(lambda: m.init_cache(128, 32768)) \
            if not jax_config(arch).encoder_layers else None
        out[arch] = (_jax_leaves(params),
                     None if cache is None else _jax_leaves(cache))
    return out


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_the_references(arch, mesh_name, kind, jax_shapes):
    shape, axes = MESHES[mesh_name]
    jplan = JaxPlan.make(jax_fake_mesh(shape, axes), jax_config(arch), kind)
    jparams, jcache = jax_shapes[arch]
    cfg = get_config(arch)
    params = _port_leaves(init_params(cfg, device="meta"))
    assert set(params) == set(jparams)
    with torch_fake_mesh(shape, axes) as mesh:
        plan = ParallelPlan.make(mesh, cfg, kind)
        assert plan.moe_mode == jplan.moe_mode
        assert plan.batch_axes == jplan.batch_axes
        assert plan.weight_fsdp == jplan.weight_fsdp
        assert plan.kind == kind
        for path, leaf in params.items():
            assert tuple(leaf.shape) == tuple(jparams[path].shape), path
            got = plan.param_spec(path, tuple(leaf.shape))
            want = jplan.param_spec(path, jparams[path].shape)
            assert tuple(got) == tuple(want), (path, got, want)
        if jcache is not None:
            cache = build_model(cfg, device="meta").init_cache(128, 32768)
            for key, leaf in cache.items():
                got = plan.cache_spec(("cache", key), tuple(leaf.shape))
                want = jplan.cache_spec(("cache", key), jcache[(key,)].shape)
                assert tuple(got) == tuple(want), (key, got, want)
        for name, s in SHAPES.items():
            shp = (s.global_batch, s.seq_len + 1)
            assert tuple(plan.batch_spec(("tokens",), shp)) == \
                tuple(jplan.batch_spec(("tokens",), shp)), name
            k = (36, s.global_batch, s.seq_len, 8, 128)
            assert tuple(plan.cache_spec(("cache", "k"), k)) == \
                tuple(jplan.cache_spec(("cache", "k"), k)), name


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_param_specs_always_divide(mesh_name):
    shape, axes = MESHES[mesh_name]
    with torch_fake_mesh(shape, axes) as mesh:
        sizes = dict(zip(axes, shape))
        for arch in ARCH_IDS:
            cfg = get_config(arch)
            for kind in KINDS:
                plan = ParallelPlan.make(mesh, cfg, kind)
                for path, leaf in _port_leaves(
                        init_params(cfg, device="meta")).items():
                    spec = plan.param_spec(path, tuple(leaf.shape))
                    assert spec_divides(spec, leaf.shape, sizes), \
                        (arch, path, leaf.shape, spec)


def test_non_divisible_vocab_replicates():
    with torch_fake_mesh(*MESHES["16x16"]) as mesh:
        for arch in ("whisper-tiny", "hymba-1.5b"):
            cfg = get_config(arch)
            plan = ParallelPlan.make(mesh, cfg, "train")
            spec = plan.param_spec(("embed",), (cfg.vocab_size, cfg.d_model))
            assert spec[0] is None, arch


def test_moe_mode_and_decode_weight_budget():
    with torch_fake_mesh(*MESHES["16x16"]) as mesh:
        assert ParallelPlan.make(mesh, get_config("kimi-k2-1t-a32b"),
                                 "train").moe_mode == "ep"   # 384 % 16 == 0
        assert ParallelPlan.make(mesh, get_config("grok-1-314b"),
                                 "train").moe_mode == "tp"   # 8 < 16
        # small models decode gather-free, the large keep 2-D sharding
        assert ParallelPlan.make(mesh, get_config("qwen3-4b"),
                                 "decode").weight_fsdp == ()
        assert ParallelPlan.make(mesh, get_config("grok-1-314b"),
                                 "decode").weight_fsdp == ("data",)
        assert ParallelPlan.make(mesh, get_config("qwen3-4b"),
                                 "train").weight_fsdp == ("data",)


def test_batch1_long_context_shards_sequence():
    with torch_fake_mesh(*MESHES["16x16"]) as mesh:
        plan = ParallelPlan.make(mesh, get_config("qwen3-4b"), "decode")
        spec = plan.cache_spec(("cache", "k"), (36, 1, 524288, 8, 128))
        assert spec[1] is None
        assert spec[2] == ("data", "model")
        spec2 = plan.cache_spec(("cache", "k"), (36, 128, 32768, 8, 128))
        assert spec2[1] == "data" and spec2[2] == "model"


@settings(max_examples=50, deadline=None)
@given(st.integers(min_value=1, max_value=8192),
       st.integers(min_value=1, max_value=8192))
def test_any_matrix_gets_valid_spec(d1, d2):
    with torch_fake_mesh(*MESHES["16x16"]) as mesh:
        plan = ParallelPlan.make(mesh, get_config("qwen3-4b"), "train")
        spec = plan.param_spec(("blocks", "attn", "w_q"), (36, d1, d2))
        assert spec_divides(spec, (36, d1, d2), {"data": 16, "model": 16})


def test_multipod_fsdp_axes():
    with torch_fake_mesh(*MESHES["2x16x16"]) as mesh:
        plan = ParallelPlan.make(mesh, get_config("qwen3-4b"), "train")
        assert plan.batch_axes == ("pod", "data")
        spec = plan.param_spec(("blocks", "ffn", "w_in"), (36, 2560, 9728))
        assert spec == P(None, ("pod", "data"), "model")
        assert plan.placements(spec) == (Shard(1), Shard(1), Shard(2))


def test_placements_and_local_block_on_a_real_mesh(tmp_path):
    """On a one-rank gloo mesh: placements follow the spec, local_block of
    a plain tensor is the whole tensor, param_shardings keeps values."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        cfg = get_config("qwen3-4b").reduced()
        plan = ParallelPlan.make(mesh, cfg, "train")
        assert plan.placements(P(None, "data", "model")) == \
            (Shard(1), Shard(2))
        assert plan.placements(P()) == (Replicate(), Replicate())
        t = torch.arange(24.0).reshape(2, 3, 4)
        assert torch.equal(plan.local_block(t, P("data", None, "model")), t)
        params = init_params(cfg, device="cpu")
        dparams = plan.param_shardings(params)
        for (path, a), (_, b) in zip(tree.leaves_with_path(params),
                                     tree.leaves_with_path(dparams)):
            assert torch.equal(a, b.full_tensor()), path
        # a weight split over both one-rank axes, read as its model block:
        # outside autograd the local tensor as it is, inside through
        # DTensor's redistribution; the same values either way
        w = dparams["blocks"]["ffn"]["w_in"]
        assert w.placements == (Shard(1), Shard(2))
        with torch.no_grad():
            got = plan.local_block(w, P(None, None, "model"))
        assert got.data_ptr() == w.to_local().data_ptr()
        w.requires_grad_(True)
        assert torch.equal(plan.local_block(w, P(None, None, "model")), got)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("multi_pod,shape", [(False, (16, 16)),
                                             (True, (2, 16, 16))])
def test_production_mesh_on_the_fake_backend(multi_pod, shape):
    """make_production_mesh builds the reference's mesh over the default
    group: its shape and axis names, and plans made on it."""
    from repro_torch.launch.mesh import make_production_mesh
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=int(np.prod(shape)))
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        axes = ("pod", "data", "model") if multi_pod else ("data", "model")
        assert tuple(mesh.shape) == shape
        assert mesh.mesh_dim_names == axes
        plan = ParallelPlan.make(mesh, get_config("qwen3-4b"), "train")
        assert plan.batch_axes == axes[:-1]
    finally:
        dist.destroy_process_group()


class _Collectives(torch.utils._python_dispatch.TorchDispatchMode):
    """Records (op, elements) of every collective dispatched inside."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace in ("c10d", "_c10d_functional"):
            n = max((a.numel() for a in torch.utils._pytree.tree_leaves(
                (args, kwargs)) if isinstance(a, torch.Tensor)), default=0)
            self.seen.append((func.name(), n))
        return func(*args, **(kwargs or {}))


def test_decode_plan_gathers_no_weight():
    """A decode step under a decode plan within DECODE_TP_WEIGHT_BUDGET
    (weights not split over the FSDP axes) moves only activations: per
    layer the q / kv columns are gathered and the w_o / w_out products
    summed over model, plus the embedding and the logits. With the
    weights split over ``data`` (a model over the budget) the step
    gathers them. A mesh of one rank takes no collective. Rank 0 of a
    (2, 2) mesh on the fake backend: the collectives are counted, their
    values are not used."""
    cfg = get_config("qwen3-4b").reduced()
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    smallest = min(v.numel() // cfg.n_layers for _, v in
                   tree.leaves_with_path(params["blocks"]) if v.ndim == 3)
    tok = torch.ones((2, 1), dtype=torch.int32)
    n = torch.full((2,), 3, dtype=torch.int32)
    moved = {}
    with torch_fake_mesh((2, 2), ("data", "model")) as mesh:
        for fsdp in ((), ("data",)):
            plan = ParallelPlan.make(mesh, cfg, "decode")
            assert plan.weight_fsdp == ()
            plan = dataclasses.replace(plan, weight_fsdp=fsdp)
            dparams = plan.param_shardings(params)
            with torch.no_grad(), _Collectives() as rec:
                model.decode_step(dparams, tok, model.init_cache(2, 16), n,
                                  plan=plan)
            moved[fsdp] = rec.seen
    with torch_fake_mesh((1, 1), ("data", "model")) as mesh:
        plan = ParallelPlan.make(mesh, cfg, "decode")
        dparams = plan.param_shardings(params)
        with torch.no_grad(), _Collectives() as rec:
            model.decode_step(dparams, tok, model.init_cache(2, 16), n,
                              plan=plan)
        assert rec.seen == []
    ops = [op for op, _ in moved[()]]
    L = cfg.n_layers
    assert sum("allgather" in op for op in ops) == 2 * L + 1, ops
    assert sum("allreduce" in op for op in ops) == 2 * L + 1, ops
    assert max(n for _, n in moved[()]) < smallest, moved[()]
    assert max(n for _, n in moved[("data",)]) >= smallest
