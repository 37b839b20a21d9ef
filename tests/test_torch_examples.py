"""The port's entry points (``repro_torch.examples``) against the
reference's examples on the CPU, and the kernel build and launch counts
under threads.

Each example runs the reference's weights, carried over through numpy
(``repro_torch.weights``), on the same inputs:

* ``serve_parallel_pipeline``: the reference's ``build_deployment`` and
  the port's, 8 documents, 3 replicas, fail rate 0.08, work_experience/0
  set down at request 2; one client and a sequential dispatcher on both
  sides (the fault draws come in one order) and one step clock per side
  in the balancers (benching is a function of the calls, not of the
  host's speed): every balancer's ``served`` / ``failovers`` /
  ``backup_served`` equal, the fields equal label for label;
* ``multiarch_serving``: first-request tokens of reduced qwen3-4b,
  rwkv6-1.6b and hymba-1.5b through the router equal the reference
  ``LMPaaS``'s;
* ``train_small`` at d 64, 2 layers, 6 steps: the losses, and those of
  the run resumed from the step-3 checkpoint, within 1e-5 relative of
  the reference's ``train``;
* ``smoke_all`` over the 10 reduced architectures (f32): the loss, the
  prefill and the decode logits within 1e-4;
* ``ahp_select``: the printed tables are the reference's
  ``reproduce_paper_tables()``;

then every module's ``main()`` with ``--device cpu`` at a small size,
ending as the reference's does. ``kernels._build.load`` from 8 threads
builds a source once (a stand-in ``nvcc``), and each kernel's launch
count stays exact under 8 threads.
"""
import dataclasses
import importlib.util
import itertools
import random
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ARCH_IDS as JAX_ARCH_IDS
from repro.configs.base import get_config as jax_config
from repro.core import ahp as jahp
from repro.core.parallel import ParallelDispatcher as JaxDispatcher
from repro.models.model import build_model as jax_build
from repro.train import checkpoint as jax_checkpoint
from repro.train import optimizer as jax_opt
from repro.train.data import DataConfig as JaxDataConfig
from repro.train.data import PackedLMDataset as JaxDataset
from repro.train.train_loop import TrainerConfig as JaxTrainerConfig
from repro.train.train_loop import train as jax_train
from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.core import cvdata
from repro_torch.core.parallel import ParallelDispatcher
from repro_torch.core.pipeline import NERModel
from repro_torch.examples import (ahp_select, multiarch_serving, quickstart,
                                  serve_parallel_pipeline, smoke_all,
                                  train_small)
from repro_torch.kernels import _build, count_launch
from repro_torch.kernels.decode_attention import kernel as decode_kernel
from repro_torch.kernels.flash_attention import backward as flash_bwd
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.paged_attention import kernel as pw_kernel
from repro_torch.kernels.rwkv_scan import backward as wkv_bwd
from repro_torch.kernels.rwkv_scan import kernel as wkv_kernel
from repro_torch.kernels.ssm_scan import backward as ssm_bwd
from repro_torch.kernels.ssm_scan import kernel as ssm_kernel
from repro_torch.models import bert_encoder, bilstm_lan
from repro_torch.models.model import build_model
from repro_torch.train.data import DataConfig, PackedLMDataset
from repro_torch.weights import (classifier_params_from_numpy,
                                 encoder_params_from_numpy,
                                 lan_params_from_numpy, params_from_numpy)

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_example(name):
    """The reference's ``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _step_clock(step=0.05):
    """A clock that moves ``step`` seconds at every reading."""
    ticks = itertools.count()
    return lambda: next(ticks) * step


# ------------------------------------------------ serve_parallel_pipeline
def _sequential(parser, dispatcher_cls, services):
    parser.dispatcher = dispatcher_cls(mode="sequential",
                                       rng=random.Random(7))
    for svc in services.values():
        svc.balancer.clock = _step_clock()


def test_pipeline_faults_and_fields_equal_reference():
    ref = _reference_example("serve_parallel_pipeline")
    jsup, jparser, jservices = ref.build_deployment(3, 0.08)
    enc_cfg = bert_encoder.encoder_config(4096)
    ners = {}
    for name, svc in jservices.items():
        jner = svc.replicas[0].handler
        cfg = bilstm_lan.LANConfig(vocab_size=jner.cfg.vocab_size,
                                   n_labels=jner.cfg.n_labels)
        ners[name] = NERModel(name, cfg, lan_params_from_numpy(
            _np(jner.params), cfg, "cpu"), cvdata.HashTokenizer(4096))
    sup, parser, services = serve_parallel_pipeline.build_deployment(
        3, 0.08, device="cpu", ners=ners)
    parser.encoder_params = encoder_params_from_numpy(
        _np(jparser.encoder_params), enc_cfg, "cpu")
    parser.classifier_params = classifier_params_from_numpy(
        _np(jparser.classifier_params), "cpu")
    jparser.dispatcher.shutdown()
    parser.dispatcher.shutdown()
    _sequential(jparser, JaxDispatcher, jservices)
    _sequential(parser, ParallelDispatcher, services)
    assert jsup.start_all() == sup.start_all()

    rng = random.Random(3)
    docs = [cvdata.make_document(rng) for _ in range(8)]
    jparser.parse(docs[0])
    parser.parse(docs[0])
    jcv = jsup.services["cv_parser"]
    want = []
    for i, doc in enumerate(docs):
        if i == 2:
            jservices["work_experience"].replicas[0].set_up(False)
        want.append(jcv(doc)["fields"])
    results, stages, _ = serve_parallel_pipeline.serve_corpus(
        sup, services, docs, clients=1, kill_at=2)
    assert [r["fields"] for r in results] == want
    assert set(stages) == {"tika", "sectioning", "bert",
                           "parallel_services", "total"}
    for name, svc in services.items():
        assert svc.balancer.stats == jservices[name].balancer.stats, name
        assert svc.balancer.stats["served"] == len(docs) + 1, name
    assert services["work_experience"].balancer.stats["failovers"] > 0


# ------------------------------------------------------ multiarch_serving
def test_multiarch_first_tokens_equal_reference():
    ref = _reference_example("multiarch_serving")
    archs = ["qwen3-4b", "rwkv6-1.6b", "hymba-1.5b"]
    prompt = multiarch_serving.prompts(1, "cpu")[0]
    paases, want = [], {}
    for i, arch in enumerate(archs):
        jpaas = ref.LMPaaS(arch, seed=i)
        want[arch] = jpaas((prompt, 4))["tokens"]
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  dtype=torch.float32)
        params = params_from_numpy(_np(jpaas.scheduler.engine.params), cfg,
                                   "cpu")
        paases.append(multiarch_serving.LMPaaS(arch, i, device="cpu",
                                               cfg=cfg, params=params))
    sup, router, dispatcher, order = multiarch_serving.deploy_router(paases)
    assert order == [*archs, "router"]
    res = router((prompt, 4))
    dispatcher.shutdown()
    assert res.mode == "thread"
    assert {a: res.outputs[a]["tokens"] for a in archs} == want


# ------------------------------------------------------------ train_small
def _tiny(cfg):
    return dataclasses.replace(cfg.reduced(), n_layers=2, d_model=64,
                               vocab_size=4096)


def test_train_small_losses_and_resume_equal_reference(tmp_path):
    jmodel = jax_build(_tiny(jax_config("qwen3-4b")))
    jparams = jmodel.init(jax.random.key(0))
    cfg = _tiny(get_config("qwen3-4b"))
    params = params_from_numpy(_np(jparams), cfg, "cpu")
    dc = dict(vocab_size=4096, seq_len=32, batch_size=2, n_documents=64)
    jtc = JaxTrainerConfig(
        n_steps=6, log_every=1, ckpt_every=3, ckpt_root=str(tmp_path / "r"),
        opt=jax_opt.AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=6,
                                weight_decay=0.01))
    jdata = JaxDataset(JaxDataConfig(**dc))
    jres = jax_train(jmodel, jdata, jtc,
                     params=jax.tree.map(jnp.array, jparams))
    jtree = jax_checkpoint.restore(jtc.ckpt_root, "run-3",
                                   like={"params": jres.params})
    jres2 = jax_train(jmodel, jdata, dataclasses.replace(jtc, n_steps=5,
                                                         log_every=1),
                      params=jtree["params"], start_step=3)

    tc = train_small.trainer_config(6, str(tmp_path / "p"))
    assert (tc.log_every, tc.ckpt_every) == (jtc.log_every, jtc.ckpt_every)
    assert dataclasses.asdict(tc.opt) == dataclasses.asdict(jtc.opt)
    res, res2, mid = train_small.train_and_resume(
        build_model(cfg, device="cpu"), PackedLMDataset(DataConfig(**dc)),
        tc, params=params)
    assert mid == "run-3"
    for got, want in ((res, jres), (res2, jres2)):
        assert [h["step"] for h in got.history] == \
            [h["step"] for h in want.history]
        for h, jh in zip(got.history, want.history):
            assert h["loss"] == pytest.approx(jh["loss"], rel=1e-5)
    assert [h["step"] for h in res2.history] == [4, 5, 6, 7, 8]


# -------------------------------------------------------------- smoke_all
def _numpy_batch(cfg, seed=0, B=2, S=32):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S + 1))
         .astype(np.int32)}
    if cfg.frontend == "vision":
        b["tokens"] = b["tokens"][:, : S - cfg.n_patches + 1]
        b["patch_embeds"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model), np.float32)
    if cfg.frontend == "audio":
        b["frames"] = rng.standard_normal((B, cfg.n_frames, cfg.d_model),
                                          np.float32)
    return b


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_all_equals_reference(arch):
    assert ARCH_IDS == JAX_ARCH_IDS
    jcfg = dataclasses.replace(jax_config(arch).reduced(), dtype=jnp.float32)
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=torch.float32)
    jm = jax_build(jcfg)
    jparams = jm.init(jax.random.PRNGKey(1))
    batch = _numpy_batch(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, _ = jax.jit(jm.train_loss)(jparams, jbatch)
    pre = dict(jbatch, tokens=jbatch["tokens"][:, :-1])
    jlogits, _ = jax.jit(jm.prefill)(jparams, pre)
    jlg, _ = jax.jit(jm.decode_step)(jparams, jnp.ones((2, 1), jnp.int32),
                                     jm.init_cache(2, 64), jnp.int32(32))

    model = build_model(cfg, device="cpu")
    out = smoke_all.run_arch(model, params_from_numpy(_np(jparams), cfg,
                                                      "cpu"),
                             {k: torch.from_numpy(v) for k, v in
                              batch.items()})
    np.testing.assert_allclose(float(out["loss"]), float(jloss), **TOL)
    np.testing.assert_allclose(out["logits"].numpy(), np.asarray(jlogits),
                               **TOL)
    np.testing.assert_allclose(out["decode_logits"].numpy(),
                               np.asarray(jlg), **TOL)


# ------------------------------------------------------------- ahp_select
def test_ahp_select_prints_the_reference_tables(capsys):
    ahp_select.main(["--device", "cpu"])
    got = capsys.readouterr().out
    for scenario, res in jahp.reproduce_paper_tables().items():
        assert f"\n-- {scenario} (paper: " in got
        assert res.table() in got
        assert (f"consistency ratios: "
                f"{ {k: round(v, 4) for k, v in res.consistency.items()} }"
                in got)
    assert got.rstrip().splitlines()[-1].startswith("consistency ratios:")


# ------------------------------------------------------- main() on the CPU
MAINS = {
    "ahp_select": (ahp_select, [], "consistency ratios: "),
    "smoke_all": (smoke_all, ["qwen3-4b", "hymba-1.5b"], "OK hymba-1.5b "),
    "serve_parallel_pipeline": (
        serve_parallel_pipeline, ["--docs", "4", "--clients", "2"],
        "  supervisor: RUNNING healthy=2 "),
    "multiarch_serving": (
        multiarch_serving, ["--archs", "qwen3-4b,rwkv6-1.6b", "--requests",
                            "2", "--max-new", "2"], "OK"),
    "train_small": (
        train_small, ["--steps", "30", "--d-model", "64", "--layers", "1",
                      "--batch", "4", "--seq", "32"], "OK"),
    "quickstart": (quickstart, [], "OK — see "),
}


@pytest.mark.parametrize("name", list(MAINS))
def test_main_runs_on_cpu_and_ends_as_the_reference(name, capsys):
    module, argv, last = MAINS[name]
    module.main([*argv, "--device", "cpu"])
    lines = capsys.readouterr().out.rstrip().splitlines()
    assert lines[-1].startswith(last), lines[-3:]
    if name == "serve_parallel_pipeline":
        assert "OK — zero lost requests through the outage." in lines
        assert "  !! killed work_experience/0 at request 1" in lines


# ------------------------------------------------- the build under threads
FAKE_NVCC = """#!{python}
import sys, time
out = sys.argv[sys.argv.index("-o") + 1]
with open({log!r}, "a") as f:
    f.write(out + "\\n")
if {fail}:
    sys.exit(1)
time.sleep(0.3)
open(out, "w").write("library")
"""


def _fake_toolchain(tmp_path, monkeypatch, fail=False):
    """A source, an empty build directory and a stand-in ``nvcc`` that
    logs its output path, then fails, or sleeps 0.3 s and writes a
    file."""
    log = tmp_path / "nvcc.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, log=str(log),
                                     fail=fail))
    nvcc.chmod(0o755)
    src = tmp_path / "k.cu"
    src.write_text("// a kernel")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "_open", lambda lib: object())
    monkeypatch.setattr(_build, "nvcc_runs", {})
    return src, log


def _from_threads(fn, n=8):
    """``fn()`` from ``n`` threads released together: results (or the
    exceptions raised) in thread order."""
    gate = threading.Barrier(n)
    out = [None] * n

    def run(i):
        gate.wait()
        try:
            out[i] = fn()
        except Exception as e:          # noqa: BLE001 — returned to check
            out[i] = e

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def test_load_builds_a_source_once_from_threads(tmp_path, monkeypatch):
    src, log = _fake_toolchain(tmp_path, monkeypatch)
    libs = _from_threads(lambda: _build.load(src))
    assert all(lib is libs[0] for lib in libs)
    assert _build.nvcc_runs == {"k": 1}
    assert len(log.read_text().splitlines()) == 1
    assert _build.library_path(src).read_text() == "library"
    assert not list((tmp_path / "build").glob("*.tmp.so"))
    # a second load neither builds nor opens anew
    assert _build.load(src) is libs[0]
    assert _build.nvcc_runs == {"k": 1}


def test_temporary_names_differ_per_thread():
    lib = _build.library_path(_build.sources()[0])
    names = _from_threads(lambda: _build.temp_path(lib))
    assert len(set(names)) == len(names)
    assert all(n.parent == lib.parent and n.name.endswith(".tmp.so")
               for n in names)


def test_a_failed_build_raises_in_every_thread(tmp_path, monkeypatch):
    src, log = _fake_toolchain(tmp_path, monkeypatch, fail=True)
    errs = _from_threads(lambda: _build.load(src))
    assert all(isinstance(e, RuntimeError) and "CUDA build failed" in str(e)
               for e in errs)
    assert not _build.library_path(src).exists()


def test_slow_build_is_waited_for_not_repeated(tmp_path, monkeypatch):
    """``load`` calls ``build_all`` once however many threads wait on it."""
    src, _ = _fake_toolchain(tmp_path, monkeypatch)
    calls = []

    def slow_build(srcs):
        calls.append(threading.get_ident())
        time.sleep(0.2)
        return {}

    monkeypatch.setattr(_build, "build_all", slow_build)
    libs = _from_threads(lambda: _build.load(src))
    assert len(calls) == 1
    assert all(lib is libs[0] for lib in libs)


WRAPPERS = [pw_kernel.paged_window_attention, flash_kernel.flash_attention,
            decode_kernel.decode_attention, wkv_kernel.wkv_scan,
            ssm_kernel.ssm_scan, flash_bwd.flash_attention_bwd,
            wkv_bwd.wkv_bwd, ssm_bwd.ssm_scan_bwd]


@pytest.mark.parametrize("fn", WRAPPERS, ids=lambda f: f.__name__)
def test_launch_count_is_exact_under_threads(fn):
    before = fn.launches

    def bump():
        for _ in range(10_000):
            count_launch(fn)

    try:
        _from_threads(bump)
        assert fn.launches == before + 80_000
    finally:
        fn.launches = before
