"""Package hygiene of the PyTorch port: it imports neither ``jax`` nor
anything of the JAX package, its entry points never fall back to the CPU
on their own, its kernel wrappers refuse CPU tensors, and
``chip_smoke.py`` fails without a GPU."""
import ast
import ctypes
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import kernel as decode_kernel
from repro_torch.kernels.flash_attention import backward as flash_bwd
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.paged_attention import kernel as pw_kernel
from repro_torch.kernels.rwkv_scan import backward as wkv_bwd
from repro_torch.kernels.rwkv_scan import kernel as wkv_kernel
from repro_torch.kernels.ssm_scan import backward as ssm_bwd
from repro_torch.kernels.ssm_scan import kernel as ssm_kernel
from repro_torch.models.model import build_model, init_params

ROOT = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "repro" or m.startswith("repro."))
print(len(names), "modules;", "leaked:", bad)
train = {"repro_torch.train." + m for m in
         ("checkpoint", "data", "optimizer", "train_loop", "tree")}
train.add("repro_torch.launch.train")
sys.exit(1 if bad or len(names) < 20 or not train <= set(names) else 0)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_port_imports_no_jax_and_nothing_of_repro():
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("path", ["chip_smoke.py",
                                  *sorted(str(p.relative_to(ROOT)) for p in
                                          (ROOT / "src/repro_torch")
                                          .rglob("*.py"))])
def test_sources_import_no_jax(path):
    """Static check of every module: no ``import jax`` / ``repro.``."""
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, n)


def test_chip_smoke_fails_without_gpu(tmp_path):
    """No GPU here: the smoke exits non-zero and prints no result line —
    from the repo and from a directory holding only the script."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    alone = tmp_path / "chip_smoke.py"
    alone.write_bytes((ROOT / "chip_smoke.py").read_bytes())
    for script in (ROOT / "chip_smoke.py", alone):
        r = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode != 0, r.stdout
        assert '"ok"' not in r.stdout


def test_entry_points_default_to_cuda_without_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_config("qwen3-4b").reduced()
    assert build_model(cfg).device.type == "cuda"
    with pytest.raises((RuntimeError, AssertionError)):
        init_params(cfg)                       # device="cuda" by default


def test_launcher_defaults_to_cuda_without_fallback():
    """``python -m repro_torch.launch.serve`` without ``--device`` needs a
    card: here it fails instead of serving on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                        "--requests", "1", "--max-new", "1"], env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "OK" not in r.stdout, r.stdout


def _paged_args():
    q = torch.zeros((1, 1, 4, 32))
    pool = torch.zeros((2, 8, 2, 32))
    return (q, pool, pool, torch.zeros((1, 2), dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32))


def _wkv_args():
    x = torch.zeros((1, 3, 2, 32))
    return x, x, x, x, torch.zeros((2, 32)), torch.zeros((1, 2, 32, 32))


def _ssm_args():
    u = torch.zeros((1, 3, 40))
    bc = torch.zeros((1, 3, 16))
    return (u, u, bc, bc, torch.zeros((40, 16)), torch.zeros(40),
            torch.zeros((1, 40, 16)))


def _flash_args():
    q = torch.zeros((1, 4, 3, 32))
    kv = torch.zeros((1, 2, 5, 32))
    return q, kv, kv


def _wkv_bwd_args():
    a = _wkv_args()
    return (*a, torch.zeros((1, 2, 0, 32, 32)), a[0], a[-1])


def _ssm_bwd_args():
    a = _ssm_args()
    return (*a, torch.zeros((1, 0, 40, 16)), a[0], a[-1])


def _flash_bwd_args():
    q = torch.zeros((1, 4, 3, 32))
    kv = torch.zeros((1, 2, 5, 32))
    return q, kv, kv, q, torch.zeros((1, 4, 3)), q


def _decode_args():
    kv = torch.zeros((2, 2, 5, 32))
    return (torch.zeros((2, 4, 32)), kv, kv,
            torch.ones(2, dtype=torch.int32))


# (binding module, wrapper / C entry name, CPU arguments it must refuse)
KERNELS = {
    "paged_window": (pw_kernel, "paged_window_attention", _paged_args),
    "wkv": (wkv_kernel, "wkv_scan", _wkv_args),
    "ssm_scan": (ssm_kernel, "ssm_scan", _ssm_args),
    "wkv_bwd": (wkv_bwd, "wkv_bwd", _wkv_bwd_args),
    "ssm_scan_bwd": (ssm_bwd, "ssm_scan_bwd", _ssm_bwd_args),
    "flash": (flash_kernel, "flash_attention", _flash_args),
    "flash_bwd": (flash_bwd, "flash_attention_bwd", _flash_bwd_args),
    "decode": (decode_kernel, "decode_attention", _decode_args),
}


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_kernel_wrapper_refuses_cpu_tensors(kernel):
    module, name, args = KERNELS[kernel]
    fn = getattr(module, name)
    before = fn.launches
    with pytest.raises(ValueError, match="CUDA"):
        fn(*args())
    assert fn.launches == before


def test_build_path_follows_source_hash(tmp_path):
    """A library is named by its source's hash: an edit builds anew."""
    src = tmp_path / "k.cu"
    src.write_text("// one")
    one = _build.library_path(src)
    assert one == _build.library_path(src)
    assert one.parent == _build.BUILD_DIR and one.name.startswith("k-")
    src.write_text("// two")
    assert _build.library_path(src) != one
    assert sorted(p.name for p in _build.sources()) == \
        sorted(m.SOURCE.name for m, _, _ in KERNELS.values())


def test_build_path_follows_included_headers(tmp_path):
    """A library is named by the headers its source includes too, and
    theirs in turn: editing one builds anew, an unrelated file does
    not. The attention sources (the flash backward too) and both scans
    (their backwards too) share the helpers header."""
    (tmp_path / "inc").mkdir()
    a, b = tmp_path / "inc" / "a.cuh", tmp_path / "inc" / "b.cuh"
    a.write_text('#include "b.cuh"\n// a')
    b.write_text("// b")
    src = tmp_path / "k.cu"
    src.write_text('#include <cuda_runtime.h>\n#include "inc/a.cuh"\n')
    assert _build.includes(src) == [a.resolve(), b.resolve()]
    one = _build.library_path(src)
    b.write_text("// b, edited")
    two = _build.library_path(src)
    assert two != one
    (tmp_path / "inc" / "c.cuh").write_text("// not included")
    assert _build.library_path(src) == two
    header = (_build.KERNELS_DIR / "include" / "hopper.cuh").resolve()
    assert {p.name for p in _build.sources()
            if header in _build.includes(p)} == {"decode.cu", "flash.cu",
                                                 "flash_bwd.cu",
                                                 "paged_window.cu",
                                                 "ssm_scan.cu",
                                                 "ssm_scan_bwd.cu", "wkv.cu",
                                                 "wkv_bwd.cu"}


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_binding_matches_the_c_signature(kernel):
    """The ctypes argtypes mirror the CUDA source's extern "C" entry:
    pointers as c_void_p, ints as c_int, in order."""
    module, name, _ = KERNELS[kernel]
    assert module.ARGTYPES == _c_argtypes(module.SOURCE, name)


def _c_argtypes(source, name):
    """ctypes argtypes of the extern "C" entry ``name`` in ``source``:
    pointers as c_void_p, ints as c_int, in order."""
    sig = re.search(rf'extern "C" int {name}\((.*?)\)\s*\{{',
                    source.read_text(), re.S).group(1)
    return [ctypes.c_void_p if "*" in p else ctypes.c_int
            for p in sig.split(",")]


@pytest.mark.parametrize("module", [wkv_bwd, ssm_bwd],
                         ids=["wkv_bwd", "ssm_scan_bwd"])
def test_scratch_sizing_matches_the_c_signature(module):
    """The scan backwards' scratch is sized by the CUDA source itself
    (``<kernel>_scratch``): its ctypes argtypes mirror that entry."""
    name = module.SOURCE.stem + "_scratch"
    assert module.SCRATCH_ARGTYPES == _c_argtypes(module.SOURCE, name)
