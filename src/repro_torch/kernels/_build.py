"""Compile the port's CUDA sources into shared libraries at first use.

Each ``kernels/*/csrc/*.cu`` builds with ``nvcc`` for ``sm_90a`` into
``build/<stem>-<hash>.so`` at the repo root, where the hash covers the
source, the headers it includes with ``#include "..."`` (those include
theirs in turn) and the flags: an edited source or header builds anew,
an unchanged one loads the library already built. The library exposes a plain C
interface and is loaded with ``ctypes``. A failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[Path, ctypes.CDLL] = {}


def sources() -> list[Path]:
    """Every CUDA source of the port."""
    return sorted(KERNELS_DIR.glob("*/csrc/*.cu"))


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def includes(src: Path) -> list[Path]:
    """The headers ``src`` includes with quotes, each resolved against
    the directory of the file that includes it, and theirs in turn, each
    once, in the order first met."""
    seen: list[Path] = []
    todo = [Path(src).resolve()]
    while todo:
        f = todo.pop(0)
        for name in _INCLUDE.findall(f.read_bytes()):
            header = (f.parent / name.decode()).resolve()
            if header not in seen:
                seen.append(header)
                todo.append(header)
    return seen


def library_path(src: Path) -> Path:
    h = hashlib.sha256(Path(src).read_bytes())
    for header in includes(src):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(src).stem}-{h.hexdigest()[:16]}.so"


def nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the PATH, else the
    toolkit's default install location."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    if shutil.which("nvcc"):
        candidates.append(Path(shutil.which("nvcc")))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build_all(srcs=None) -> dict[Path, Path]:
    """Build every source in ``srcs`` (default: all) whose library is
    missing, one ``nvcc`` per source, all started together. The compiler
    output (``-Xptxas -v``: registers, shared memory, spills) goes to
    ``build/<stem>.log``. Returns {source: library}; raises naming every
    source that failed."""
    srcs = [Path(s) for s in (sources() if srcs is None else srcs)]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in srcs:
        lib = library_path(src)
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.Popen([nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                                 str(src)], stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((src, lib, tmp, proc))
    failed = []
    for src, lib, tmp, proc in jobs:
        log, _ = proc.communicate()
        (BUILD_DIR / f"{src.stem}.log").write_text(log)
        if proc.returncode:
            failed.append(f"{src.name} (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("CUDA build failed: " + "\n".join(failed))
    return {src: library_path(src) for src in srcs}


def load(src: Path) -> ctypes.CDLL:
    """The loaded library of ``src``, built first if needed."""
    lib = library_path(src)
    if lib not in _loaded:
        build_all([src])
        _loaded[lib] = ctypes.CDLL(str(lib))
    return _loaded[lib]
