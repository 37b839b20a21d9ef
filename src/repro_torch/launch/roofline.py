"""Roofline terms from dry-run records (port of the reference's
``launch/roofline.py``).

Reads ``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json`` (written
by ``repro_torch.launch.dryrun``) and derives, per (arch, shape, mesh):

    compute term    = FLOPs_per_device / PEAK_FLOPS_BF16
    memory term     = HBM_bytes_per_device / HBM_BW
    collective term = sum over mesh axes of the axis's collective bytes
                      per device / the rate of the link that axis crosses

(``launch/step_analysis.py`` counts per device already.) The rates are
the H100's, from ``launch/mesh.py``: an axis whose ranks share an NVLink
node moves at ``NVLINK_BW``, one that crosses nodes at ``NET_BW``
(``mesh.link_bw``); on the production meshes every axis crosses nodes.

MODEL_FLOPS as in the reference: 6*N*D for training (forward and
backward), 2*N*D for inference steps, N the active params (MoE: top-k
only) and D the tokens the step processes. MODEL_FLOPS / counted FLOPs
exposes remat recompute and redundant work.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

from repro_torch.launch import mesh as hw
from repro_torch.launch.dryrun import RESULTS_DIR

HBM_GIB = hw.HBM_BYTES / 2**30


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    kind: str
    n_devices: int
    n_params: int
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    hlo_flops_total: float
    collective_bytes: dict
    peak_gib: float
    # the reference's field, its raw CPU-XLA peak beside the corrected
    # peak_gib; kept so that both modules' records have the same fields
    # (tests/test_torch_roofline.py compares them), and equal to peak_gib
    # here, where no correction is ported (launch/step_analysis.py)
    peak_raw_gib: float = 0.0

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs — <1 means remat/redundancy."""
        return self.model_flops / max(self.hlo_flops_total, 1.0)

    @property
    def static_gib(self) -> float:
        """Unavoidable per-device bytes: weights (+ optimizer state when
        training), perfectly sharded. If this alone exceeds the card's
        memory, the (arch, shape, mesh) is capacity-infeasible."""
        n = {"train": 10.0}.get(self.kind, 2.0)    # bf16 w + f32 mu,nu
        return self.n_params * n / self.n_devices / 2**30

    def feasible(self, hbm_gib: float = HBM_GIB) -> bool:
        return self.static_gib <= hbm_gib

    @property
    def mfu_upper_bound(self) -> float:
        """If the step ran exactly at its roofline bound, what MFU would
        the *useful* model flops achieve? (compute-bound & no waste = 1)"""
        ideal = self.model_flops / (self.n_devices * hw.PEAK_FLOPS_BF16)
        return ideal / max(self.bound_s, 1e-30)


def model_flops(rec: dict) -> float:
    n_active = rec["n_active_params"]
    if rec["kind"] == "train":
        return 6.0 * n_active * rec["global_batch"] * rec["seq_len"]
    if rec["kind"] == "prefill":
        return 2.0 * n_active * rec["global_batch"] * rec["seq_len"]
    # decode: one token per sequence against the cache
    return 2.0 * n_active * rec["global_batch"]


def collective_seconds(by_axis: dict, shape: dict) -> float:
    """The collective bytes that cross each link (``mesh.link_bw`` of
    each axis) over that link's rate."""
    per_link: dict = {}
    for axis, b in by_axis.items():
        rate = hw.link_bw(shape, axis)
        per_link[rate] = per_link.get(rate, 0.0) + b
    return sum(b / rate for rate, b in per_link.items())


def from_record(rec: dict) -> Roofline:
    an = rec["analysis"]
    mem = rec["memory"]
    return Roofline(
        arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
        kind=rec["kind"], n_devices=rec["n_devices"],
        n_params=rec["n_params"],
        compute_s=an["flops_per_device"] / hw.PEAK_FLOPS_BF16,
        memory_s=an["hbm_bytes_per_device"] / hw.HBM_BW,
        collective_s=collective_seconds(an["collective_bytes_by_axis"],
                                        rec["mesh_shape"]),
        model_flops=model_flops(rec),
        hlo_flops_total=an["flops_per_device"] * rec["n_devices"],
        collective_bytes=an["collective_bytes"],
        peak_gib=mem["peak_bytes_per_device"] / 2**30,
        peak_raw_gib=mem["peak_bytes_per_device"] / 2**30,
    )


def load(arch: str, shape: str, mesh: str = "single",
         results_dir: Path | None = None) -> Roofline:
    p = (results_dir or RESULTS_DIR) / f"{arch}__{shape}__{mesh}.json"
    rec = json.loads(p.read_text())
    if rec.get("status") != "ok":
        raise ValueError(f"{p.name}: dry-run failed: {rec.get('error')}")
    return from_record(rec)


def load_all(mesh: str = "single", results_dir: Path | None = None):
    out = []
    rd = results_dir or RESULTS_DIR
    for p in sorted(rd.glob(f"*__{mesh}.json")):
        rec = json.loads(p.read_text())
        if rec.get("status") == "ok":
            out.append(from_record(rec))
    return out


def markdown_table(rows: list) -> str:
    head = ("arch | shape | kind | compute (s) | memory (s) | collective (s)"
            " | dominant | peak GiB/dev | useful-FLOPs ratio | MFU bound")
    lines = [head, " | ".join(["---"] * 10)]
    for r in rows:
        lines.append(
            f"{r.arch} | {r.shape} | {r.kind} | {r.compute_s:.3e} | "
            f"{r.memory_s:.3e} | {r.collective_s:.3e} | **{r.dominant}** | "
            f"{r.peak_gib:.2f} | {r.useful_flops_ratio:.2f} | "
            f"{r.mfu_upper_bound:.2f}")
    return "\n".join(lines)
