"""GridFS-style chunked checkpoint store (paper §3.2.3, adapted; port of
the reference's ``train/checkpoint.py``, in its on-disk format).

Each leaf of a tree is serialized and split into ``chunk_bytes`` files
under ``<root>/<name>/chunks/``, with a JSON index (leaf keys, dtypes,
shapes, chunk lists, sha256 prefixes). Restore reads chunk by chunk and
verifies each. The format is the reference's to the byte: the same
``index.json``, leaf keys (dict keys and list indices joined by "/"),
chunk file names and checksums, so a checkpoint written by either
package restores in the other. bfloat16 has no numpy dtype: its leaves
are stored as their raw 2-byte words under the dtype name "bfloat16",
which is what the reference writes through ``ml_dtypes``.
"""
from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np
import torch

from repro_torch.train import tree as tree_mod

DEFAULT_CHUNK = 8 * 1024 * 1024   # GridFS default is 255KB; 8MB suits arrays


def _to_numpy(leaf) -> tuple:
    """(host numpy array, dtype name) of a tensor or array leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.uint16).numpy(), "bfloat16"
        arr = t.contiguous().numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_bytes(raw: bytes, dtype: str, shape) -> torch.Tensor:
    if dtype == "bfloat16":
        words = np.frombuffer(raw, dtype=np.uint16).reshape(shape)
        return torch.from_numpy(words.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.frombuffer(raw, dtype=np.dtype(dtype))
                            .reshape(shape).copy())


def save(root, name: str, tree, *, chunk_bytes: int = DEFAULT_CHUNK,
         metadata: dict | None = None) -> dict:
    base = Path(root) / name
    cdir = base / "chunks"
    cdir.mkdir(parents=True, exist_ok=True)
    index: dict = {"leaves": {}, "metadata": metadata or {},
                   "chunk_bytes": chunk_bytes}
    for key, leaf in tree_mod.leaves_with_path(tree):
        arr, dtype = _to_numpy(leaf)
        raw = arr.tobytes()
        chunks = []
        for i in range(0, max(len(raw), 1), chunk_bytes):
            blob = raw[i:i + chunk_bytes]
            digest = hashlib.sha256(blob).hexdigest()[:16]
            fname = (f"{hashlib.md5(key.encode()).hexdigest()[:10]}."
                     f"{i // chunk_bytes:05d}")
            (cdir / fname).write_bytes(blob)
            chunks.append({"file": fname, "sha": digest, "n": len(blob)})
        index["leaves"][key] = {"dtype": dtype, "shape": list(arr.shape),
                                "chunks": chunks}
    (base / "index.json").write_text(json.dumps(index))
    return index


def restore(root, name: str, like=None) -> object:
    """Restore a checkpoint as CPU tensors. ``like``: optional tree
    prototype; restored leaves are checked against its shapes, put on
    each prototype leaf's device and structured like it. Without it a
    flat {key: tensor} dict is returned."""
    base = Path(root) / name
    index = json.loads((base / "index.json").read_text())
    flat: dict[str, torch.Tensor] = {}
    for key, meta in index["leaves"].items():
        buf = bytearray()
        for ch in meta["chunks"]:
            blob = (base / "chunks" / ch["file"]).read_bytes()
            if hashlib.sha256(blob).hexdigest()[:16] != ch["sha"]:
                raise IOError(f"checksum mismatch in {name}:{key}:"
                              f"{ch['file']}")
            if len(blob) != ch["n"]:
                raise IOError(f"truncated chunk in {name}:{key}")
            buf.extend(blob)
        flat[key] = _from_bytes(bytes(buf), meta["dtype"], meta["shape"])
    if like is None:
        return flat
    leaves = []
    for key, proto in tree_mod.leaves_with_path(like):
        if key not in flat:
            raise KeyError(f"checkpoint {name} missing leaf {key}")
        t = flat[key]
        if tuple(t.shape) != tuple(proto.shape):
            raise ValueError(f"shape mismatch for {key}: "
                             f"{tuple(t.shape)} vs {tuple(proto.shape)}")
        leaves.append(t.to(proto.device) if isinstance(proto, torch.Tensor)
                      else t)
    return tree_mod.unflatten(like, leaves)


def list_checkpoints(root) -> list[str]:
    root = Path(root)
    if not root.exists():
        return []
    return sorted(p.parent.name if p.parent.name != root.name else p.name
                  for p in root.glob("*/index.json"))
