"""The port's sharded path across real ranks: gloo processes on the CPU.

Each suite is one spawn of ``tests/_torch_multirank_worker.py`` ranks
over a ``DeviceMesh`` — (data 2, model 4) and (data 2, model 2) — that
runs all its checks and returns a dict per rank; the launcher spawn runs
``repro_torch.launch.train --mesh-shape 2,2`` on four ranks. Every spawn
has a join timeout, rendezvous goes through a file store, and each rank
destroys its group. The results are held against the reference's
single-device JAX functions on the same seeded numpy inputs and weights:

* EP MoE (reduced kimi-k2, 4 experts) and TP MoE (reduced grok-1 with 6
  experts) under a train plan: each rank's output is JAX
  ``moe_ffn_local`` on its batch rows and expert / d_ff slice, summed
  over the model ranks (the capacity of the local token count); at
  capacity 8 it is ``moe_ffn_local`` of the whole batch within 2e-4;
* ``moe_decode_ffn`` in EP and TP with ``weight_fsdp=("data",)``;
* decode with the cache placed by ``cache_spec``: reduced qwen3-4b at B
  2 (T over model) and B 1 (T over every axis), reduced hymba-1.5b with
  its window cut to 8 across shard edges (SSM state over model),
  reduced rwkv6-1.6b (state heads over model), logits within 1e-4 of
  JAX ``decode_step``;
* two AdamW steps under a (2, 2) train plan against ``plan=None``
  (reduced qwen3-4b with remat, and reduced kimi-k2 at capacity 8):
  loss within 1e-5 relative, params within 1e-4 of the largest, the
  first moments within 1e-5 of the largest; with the batch placed by
  ``batch_spec`` and with it whole on every rank;
* ``make_lm_service`` under a decode plan: streams identical to none.

The slow twin holds the (2, 4) MoE outputs against the reference's own
8-device ``shard_map`` run, in a subprocess as ``tests/test_multidevice``
runs it.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.models import moe as jax_moe
from repro.models.model import build_model as jax_build

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "_torch_multirank_worker.py"
JOIN_S = 100          # a hung collective fails its suite, not the run


def _tree_np(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def _jcfg(spec):
    name, over = spec
    return dataclasses.replace(jax_config(name).reduced(), **over)


class Spawn:
    """``world`` ranks started at once; :meth:`wait` joins them (killing
    every rank past the join timeout) and returns their (stdout, stderr)."""

    def __init__(self, argv_of_rank, world: int, tmp: Path, env=None):
        self.procs = []
        for r in range(world):
            e = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                     OMP_NUM_THREADS="1", **(env(r) if env else {}))
            e.pop("JAX_PLATFORMS", None)
            self.procs.append(subprocess.Popen(
                argv_of_rank(r), env=e, cwd=tmp, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        self.outs = None

    def wait(self) -> list:
        if self.outs is None:
            outs = []
            try:
                for p in self.procs:
                    outs.append(p.communicate(timeout=JOIN_S))
            finally:
                for p in self.procs:
                    if p.poll() is None:
                        p.kill()
                        p.communicate()
            self.outs = outs
        for p, (_, se) in zip(self.procs, self.outs):
            assert p.returncode == 0, se[-4000:]
        return self.outs


def start_suite(name: str, world: int, tmp: Path):
    """Start a suite's ranks, which wait for their inputs; returns (a
    function that writes the inputs, a function that waits for the ranks
    and loads each rank's results)."""
    inp = tmp / f"{name}.in.pt"

    def give(inputs: dict) -> None:
        torch.save(inputs, tmp / f"{name}.part")
        os.replace(tmp / f"{name}.part", inp)       # appears whole

    run = Spawn(lambda r: [sys.executable, str(WORKER), name, str(r),
                           str(world), str(tmp / f"{name}.store"), str(inp),
                           str(tmp / f"{name}.{r}.pt")], world, tmp)

    def results() -> list:
        run.wait()
        return [torch.load(tmp / f"{name}.{r}.pt", weights_only=False)
                for r in range(world)]
    return give, results


# ------------------------------------------------------------------ inputs
MOE = {"kimi-ep": ("kimi-k2-1t-a32b", {}),
       "grok-tp": ("grok-1-314b", {"n_experts": 6})}
DECODE = {"qwen-b2": (("qwen3-4b", {}), 2, 12, 64, 6),
          "qwen-b1": (("qwen3-4b", {}), 1, 12, 64, 6),
          "hymba-w8": (("hymba-1.5b", {"sliding_window": 8}), 2, 10, 64, 8),
          "rwkv": (("rwkv6-1.6b", {}), 2, 6, 64, 4)}
# kimi: no capacity drops, and no load-balance term: the sharded body's
# aux is the mean of each rank's product of means (the reference's
# pmean), which is not the whole batch's product; the z-loss is a mean
# over tokens and stays
TRAIN = {"qwen-remat": ("qwen3-4b", {"remat": True}),
         "kimi-cf8": ("kimi-k2-1t-a32b", {"capacity_factor": 8.0,
                                          "router_aux_weight": 0.0})}


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("multirank")


@pytest.fixture(scope="module")
def inputs_2x4():
    rng = np.random.default_rng(0)
    moe_in = {}
    for i, (key, spec) in enumerate(MOE.items()):
        p = jax.jit(jax_moe.init_moe, static_argnums=1)(
            jax.random.PRNGKey(i), _jcfg(spec))
        moe_in[key] = {"cfg": spec, "params": _tree_np(p)}
    d = _jcfg(MOE["kimi-ep"]).d_model
    dec = {}
    for i, (key, (spec, B, P, cap, n)) in enumerate(DECODE.items()):
        m = jax_build(_jcfg(spec))
        dec[key] = {"cfg": spec, "capacity": cap,
                    "params": _tree_np(jax.jit(m.init)(
                        jax.random.PRNGKey(10 + i))),
                    "prompts": rng.integers(2, 500, (B, P)).astype(np.int32),
                    "tokens": rng.integers(2, 500, (n, B, 1)).astype(
                        np.int32)}
    return {"moe": moe_in, "decode": dec,
            "x_train": rng.standard_normal((4, 16, d)).astype(np.float32),
            "x_decode": rng.standard_normal((4, 1, d)).astype(np.float32)}


@pytest.fixture(scope="module")
def inputs_2x2():
    rng = np.random.default_rng(1)
    train = {}
    for i, (key, spec) in enumerate(TRAIN.items()):
        m = jax_build(_jcfg(spec))
        train[key] = {"cfg": spec,
                      "params": _tree_np(jax.jit(m.init)(
                          jax.random.PRNGKey(20 + i))),
                      "batches": [rng.integers(2, 500, (4, 17)).astype(
                          np.int32) for _ in range(2)]}
    m = jax_build(_jcfg(("qwen3-4b", {})))
    service = {"cfg": ("qwen3-4b", {}),
               "params": _tree_np(jax.jit(m.init)(jax.random.PRNGKey(30))),
               "payloads": [{"prompt": [5, 6, 7, 8, 9], "max_new_tokens": 6},
                            {"prompt": list(range(3, 20)),
                             "max_new_tokens": 5},
                            {"prompt": [11, 12], "max_new_tokens": 7}]}
    return {"train": train, "service": service}


@pytest.fixture(scope="module")
def launched(request, tmp):
    """Every spawn of the file, started first and together: the ranks
    start while the test makes their inputs, and run while it computes
    the reference's side."""
    store = tmp / "launch.store"
    launcher = Spawn(
        lambda r: [sys.executable, "-m", "repro_torch.launch.train",
                   "--device", "cpu", "--mesh-shape", "2,2", "--steps", "2", "--batch", "4", "--seq", "16",
                   "--init-method", f"file://{store}", "--ckpt-root",
                   str(tmp / "ck")],
        4, tmp, env=lambda r: {"RANK": str(r), "WORLD_SIZE": "4",
                               "LOCAL_RANK": str(r)})
    suites = {"2x4": start_suite("2x4", 8, tmp),
              "2x2": start_suite("2x2", 4, tmp)}
    for name, (give, _) in suites.items():
        give(request.getfixturevalue(f"inputs_{name}"))
    return {"2x4": suites["2x4"][1], "2x2": suites["2x2"][1],
            "launcher": launcher}


_moe_local = jax.jit(jax_moe.moe_ffn_local,
                     static_argnames=("cfg", "e0", "E_loc", "expert_slice"))


def _d_ff_cut(m: int, f: int):
    """Model rank m's d_ff slice of the expert weights (cached, so the
    jitted call keeps its compilation)."""
    key = (m, f)
    if key not in _CUTS:
        sl = slice(m * f, (m + 1) * f)
        _CUTS[key] = lambda pe: {k: (v[:, sl, :] if k == "w_out"
                                     else v[:, :, sl])
                                 for k, v in pe.items()}
    return _CUTS[key]


_CUTS: dict = {}


def _jax_rank_moe(x_rows, p, cfg, mode: str, n_model: int = 4):
    """Sum over the model ranks of JAX moe_ffn_local on one rank's rows:
    its expert slice (EP) or its d_ff slice (TP)."""
    x2d = jnp.asarray(x_rows.reshape(-1, x_rows.shape[-1]))
    total = 0
    for m in range(n_model):
        if mode == "ep":
            E_loc = cfg.n_experts // n_model
            y, _ = _moe_local(x2d, p, cfg=cfg, e0=m * E_loc, E_loc=E_loc)
        else:
            y, _ = _moe_local(x2d, p, cfg=cfg, expert_slice=_d_ff_cut(
                m, cfg.moe_d_ff // n_model))
        total = total + np.asarray(y)
    return total.reshape(x_rows.shape)


def _jax_decode_chain(case, spec):
    cfg = _jcfg(spec)
    m = jax_build(cfg)
    params = jax.tree.map(jnp.asarray, case["params"])
    prompts = jnp.asarray(case["prompts"])
    B, P = prompts.shape
    _, pref = jax.jit(m.prefill)(params, {"tokens": prompts})
    cache = m.init_cache(B, case["capacity"])
    cache = {k: v.at[tuple(slice(0, n) for n in pref[k].shape)].set(pref[k])
             for k, v in cache.items()}
    step = jax.jit(m.decode_step)
    out = []
    for j, tok in enumerate(case["tokens"]):
        lg, cache = step(params, jnp.asarray(tok), cache,
                         jnp.full((B,), P + j, jnp.int32))
        out.append(np.asarray(lg, np.float32))
    return np.stack(out)


@pytest.fixture(scope="module")
def jax_refs(launched, inputs_2x4):
    """The reference's single-device results, computed while the ranks
    run: per-rank MoE sums, whole-batch MoE at capacity 8, decode
    chains."""
    x_tr, x_dec = inputs_2x4["x_train"], inputs_2x4["x_decode"]
    refs = {}
    for key, spec in MOE.items():
        cfg = _jcfg(spec)
        p = jax.tree.map(jnp.asarray, inputs_2x4["moe"][key]["params"])
        refs[f"{key}/train/cfg"] = np.concatenate([
            _jax_rank_moe(x_tr[2 * d:2 * d + 2], p, cfg, key.split("-")[1])
            for d in range(2)])
        c8 = dataclasses.replace(cfg, capacity_factor=8.0)
        for tag, x in (("train/cf8", x_tr), ("decode", x_dec)):
            y, _ = _moe_local(jnp.asarray(x.reshape(-1, x.shape[-1])), p,
                              cfg=c8)
            refs[f"{key}/{tag}"] = np.asarray(y).reshape(x.shape)
    for key, (spec, *_) in DECODE.items():
        refs[f"{key}/logits"] = _jax_decode_chain(inputs_2x4["decode"][key],
                                                  spec)
    return refs


@pytest.fixture(scope="module")
def suite_2x4(launched):
    return launched["2x4"]()


@pytest.fixture(scope="module")
def suite_2x2(launched):
    return launched["2x2"]()


# -------------------------------------------------------------------- MoE
@pytest.mark.parametrize("key", list(MOE))
def test_moe_bodies_equal_the_references_per_rank(key, jax_refs, suite_2x4):
    for res in suite_2x4:
        assert res[f"{key}/mode"] == key.split("-")[1]
        np.testing.assert_allclose(res[f"{key}/train/cfg"],
                                   jax_refs[f"{key}/train/cfg"], atol=2e-5,
                                   rtol=0)


@pytest.mark.parametrize("key", list(MOE))
def test_moe_at_high_capacity_equals_the_whole_batch(key, jax_refs,
                                                     suite_2x4):
    for tag in ("train/cf8", "decode"):
        for res in suite_2x4:
            err = np.abs(res[f"{key}/{tag}"] - jax_refs[f"{key}/{tag}"]).max()
            assert err < 2e-4, (key, tag, res["rank"], err)


# ----------------------------------------------------------------- decode
@pytest.mark.parametrize("key", list(DECODE))
def test_planned_decode_equals_the_reference(key, jax_refs, suite_2x4):
    for res in suite_2x4:
        err = np.abs(res[f"{key}/logits"] - jax_refs[f"{key}/logits"]).max()
        assert err < 1e-4, (key, res["rank"], err)


def test_caches_are_placed_by_cache_spec(suite_2x4):
    pl = suite_2x4[0]
    # B 2: rows over data, T over model; B 1: T over every axis
    assert pl["qwen-b2/placements"]["k"] == \
        "(Shard(dim=1), Shard(dim=2))"
    assert pl["qwen-b1/placements"]["k"] == \
        "(Shard(dim=2), Shard(dim=2))"
    assert pl["hymba-w8/placements"]["ssm_state"] == \
        "(Shard(dim=1), Shard(dim=2))"
    assert pl["rwkv/placements"]["state"] == \
        "(Shard(dim=1), Shard(dim=2))"


# ------------------------------------------------------------ train, serve
@pytest.mark.parametrize("key", [*TRAIN, *(f"{k}/whole" for k in TRAIN)])
def test_planned_train_steps_equal_plan_none(key, suite_2x2):
    for res in suite_2x2:
        plain, planned = res[f"{key}/losses"]
        assert len(plain) == 2
        for a, b in zip(plain, planned):
            assert abs(a - b) <= 1e-5 * abs(a), (key, plain, planned)
        assert res[f"{key}/param_err"] <= 1e-4 * res[f"{key}/param_max"], \
            (key, res[f"{key}/param_err"])
        # the first moments hold the gradients: equal to f32 rounding
        assert res[f"{key}/mu_err"] <= 1e-5 * res[f"{key}/mu_max"], \
            (key, res[f"{key}/mu_err"])


def test_planned_service_streams_equal_no_plan(suite_2x2):
    for res in suite_2x2:
        for paged in (True, False):
            assert res[f"plan/{paged}"] == res[f"plain/{paged}"]
            assert all(len(s) > 0 for s in res[f"plan/{paged}"])


def test_train_launcher_on_a_2x2_mesh(launched, tmp):
    outs = launched["launcher"].wait()
    lines = outs[0][0].splitlines()
    assert lines[0] == ("training qwen3-4b (dense) on 4 device(s); "
                        "mesh={'data': 2, 'model': 2}")
    assert [ln.split()[1] for ln in lines[1:3]] == ["1", "2"]
    assert "steps/s; loss" in lines[3]
    assert all(o[0] == "" for o in outs[1:])      # rank 0 prints
    assert (tmp / "ck" / "qwen3-4b-final").is_dir()


# -------------------------------------------------------------- slow twin
@pytest.mark.slow
def test_moe_matches_the_references_8_device_run(suite_2x4, inputs_2x4,
                                                 tmp):
    """The reference's own shard_map bodies on 8 host devices, (2, 4)."""
    np.savez(tmp / "moe_in.npz", x_train=inputs_2x4["x_train"],
             **{f"{k}/{n}": v for k, c in inputs_2x4["moe"].items()
                for n, v in c["params"].items()})
    code = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        import dataclasses
        import jax, jax.numpy as jnp, numpy as np
        from repro.configs.base import get_config
        from repro.models import moe
        from repro.sharding.rules import ParallelPlan
        z = np.load({str(tmp / "moe_in.npz")!r})
        mesh = jax.make_mesh((2, 4), ("data", "model"))
        for key, (name, over) in {MOE!r}.items():
            cfg = dataclasses.replace(get_config(name).reduced(), **over)
            p = {{n: jnp.asarray(z[f"{{key}}/{{n}}"])
                  for n in ("router", "w_in", "w_out", "w_gate")
                  if f"{{key}}/{{n}}" in z}}
            plan = ParallelPlan.make(mesh, cfg, "train")
            y, _ = jax.jit(lambda x, p: moe.moe_ffn(x, p, cfg, plan))(
                jnp.asarray(z["x_train"]), p)
            np.save({str(tmp)!r} + f"/{{key}}.npy", np.asarray(y))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("JAX_PLATFORMS", None)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=420)
    assert r.returncode == 0, r.stderr[-3000:]
    for key in MOE:
        want = np.load(tmp / f"{key}.npy")
        for res in suite_2x4:
            np.testing.assert_allclose(res[f"{key}/train/cfg"], want,
                                       atol=2e-5, rtol=0)
