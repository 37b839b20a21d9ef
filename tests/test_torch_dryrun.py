"""The port's dry-run (``repro_torch.launch.dryrun``) against the
reference's.

* Per-device bytes, every arch x shape x mesh at full width (80 pairs):
  the dry-run's step arguments (params, AdamW state, batch, decode token
  and cache) hold on rank 0 exactly the bytes of the reference's
  placements: the sum over leaves of
  ``NamedSharding(mesh, spec).shard_shape(shape)`` bytes, the specs from
  the reference's ``ParallelPlan.make`` on an abstract mesh of fake
  devices, the shapes from ``jax.eval_shape`` of its ``init``,
  ``init_state`` and ``input_specs``. Nothing is compiled.
* ``config_for`` and ``Model.input_specs`` equal the reference's.
  ``repro.launch.dryrun`` sets ``XLA_FLAGS`` when imported, so its
  ``config_for`` runs in a subprocess.
* The CLI runs a pair in a subprocess, writes its record and imports no
  ``jax``.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs.base import get_config as jax_config
from repro.configs.shapes import SHAPES as JAX_SHAPES
from repro.models.model import build_model as jax_build
from repro.sharding.rules import ParallelPlan as JaxPlan
from repro.train import optimizer as jax_opt
from repro_torch.configs.base import ARCH_IDS
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import dryrun
from repro_torch.launch.step_analysis import argument_bytes
from repro_torch.models.model import build_model

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
DTYPES = {"int32": torch.int32, "bfloat16": torch.bfloat16,
          "float32": torch.float32}


def jax_fake_mesh(shape, axes):
    """An abstract mesh over fake devices just for spec computation."""
    devs = np.array(jax.devices() * int(np.prod(shape)))[:int(np.prod(shape))]
    return Mesh(devs.reshape(shape), axes)


def _jax_cfg(arch, shape_name):
    """The reference's ``config_for``, without importing its module."""
    cfg = jax_config(arch)
    if shape_name == "long_500k" and cfg.uses_attention \
            and not cfg.sliding_window:
        cfg = dataclasses.replace(cfg,
                                  sliding_window=dryrun.LONG_CONTEXT_WINDOW)
    return cfg


def _placed_bytes(tree, shardings) -> int:
    leaves = jax.tree_util.tree_leaves(tree)
    specs = jax.tree_util.tree_leaves(
        shardings, is_leaf=lambda x: isinstance(x, jax.sharding.Sharding))
    assert len(leaves) == len(specs)
    return sum(math.prod(sh.shard_shape(leaf.shape)) * leaf.dtype.itemsize
               for leaf, sh in zip(leaves, specs))


@pytest.fixture(scope="module")
def jax_params():
    return {arch: jax.eval_shape(jax_build(jax_config(arch)).init,
                                 jax.random.key(0)) for arch in ARCH_IDS}


@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_per_device_bytes_equal_the_references(arch, shape_name, mesh_kind,
                                               jax_params):
    shape, axes = MESHES[mesh_kind]
    jcfg = _jax_cfg(arch, shape_name)
    jshape = JAX_SHAPES[shape_name]
    jplan = JaxPlan.make(jax_fake_mesh(shape, axes), jcfg, jshape.kind)
    params = jax_params[arch]
    want = _placed_bytes(params, jplan.param_shardings(params))
    if jshape.kind == "train":
        state = jax.eval_shape(jax_opt.init_state, params)
        want += _placed_bytes(state, jplan.param_shardings(state))
    specs = jax_build(jcfg).input_specs(jshape)
    want += _placed_bytes(specs, jplan.input_shardings(specs))
    with dryrun.fake_mesh(mesh_kind) as mesh:
        cfg, shp = dryrun.config_for(arch, shape_name)
        step = dryrun.build_step(cfg, shp, mesh)
        assert argument_bytes(step.args) == want


def _reference_configs() -> dict:
    """{"arch/shape": the reference's config_for fields}, in a subprocess
    (the module sets XLA_FLAGS at import)."""
    code = (
        "import dataclasses, json\n"
        "from repro.launch.dryrun import config_for\n"
        "from repro.configs.base import ARCH_IDS\n"
        "from repro.configs.shapes import SHAPES\n"
        "out = {}\n"
        "for a in ARCH_IDS:\n"
        "    for s in SHAPES:\n"
        "        c, sh = config_for(a, s)\n"
        "        d = {f.name: getattr(c, f.name) for f in dataclasses.fields(c)"
        " if f.name != 'dtype'}\n"
        "        out[a + '/' + s] = [d, dataclasses.asdict(sh)]\n"
        "print(json.dumps(out))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    done = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
    return json.loads(done.stdout.strip().splitlines()[-1])


def test_config_for_and_input_specs_equal_the_references():
    ref = _reference_configs()
    assert set(ref) == {f"{a}/{s}" for a in ARCH_IDS for s in SHAPES}
    for key, (fields, shape) in ref.items():
        arch, shape_name = key.split("/")
        cfg, shp = dryrun.config_for(arch, shape_name)
        got = {f.name: getattr(cfg, f.name)
               for f in dataclasses.fields(cfg) if f.name != "dtype"}
        assert json.loads(json.dumps(got)) == fields, key
        assert dataclasses.asdict(shp) == shape, key
        jspecs = jax_build(_jax_cfg(arch, shape_name)).input_specs(
            JAX_SHAPES[shape_name])
        specs = build_model(cfg, device="meta").input_specs(shp)
        jl = jax.tree_util.tree_flatten_with_path(jspecs)[0]
        pl = jax.tree_util.tree_flatten_with_path(specs)[0]
        assert [jax.tree_util.keystr(p) for p, _ in jl] == \
            [jax.tree_util.keystr(p) for p, _ in pl], key
        for (_, a), (_, b) in zip(jl, pl):
            assert tuple(a.shape) == tuple(b.shape), key
            assert DTYPES[str(a.dtype)] == b.dtype and b.is_meta, key


def test_cli_writes_its_record_without_jax(tmp_path):
    code = ("import runpy, sys\n"
            "sys.argv = ['dryrun', '--arch', 'rwkv6-1.6b', '--shape', "
            f"'long_500k', '--mesh', 'multi', '--out', {str(tmp_path)!r}]\n"
            "runpy.run_module('repro_torch.launch.dryrun', "
            "run_name='__main__')\n"
            "assert not [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')], 'jax or repro imported'\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    done = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
    assert "done: 1 ok, 0 failed" in done.stdout
    rec = json.loads((tmp_path / "rwkv6-1.6b__long_500k__multi.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["n_devices"] == 512
    assert rec["mesh_shape"] == {"pod": 2, "data": 16, "model": 16}
    assert rec["kind"] == "decode" and rec["analysis"]["flops_per_device"] > 0
    assert rec["analysis"]["kernel_launches"] == {"wkv_scan": 24}
