"""The port's roofline (``repro_torch.launch.roofline``) against the
reference's (``repro.launch.roofline``).

The same records, written by the port's dry-run for a few cheap pairs
(train, prefill, decode; both meshes), go to both modules: the port
reads their ``analysis``, the reference its ``hlo``, here the same
numbers (no ``*_tpu`` field, no TPU peak estimate). The reference's
three rates are set to the H100's (``launch/mesh.py``: bf16 peak, HBM
rate, and the network link as its one ICI link), and both of the port's
link rates to that same link, so every term, property, table and loaded
record must be equal. A second case checks the port's own rule: each
axis's collective bytes over the link it crosses.
"""
import dataclasses
import json

import pytest

from repro.launch import roofline as jax_roofline
from repro_torch.launch import dryrun, mesh as hw, roofline

PAIRS = (("whisper-tiny", "train_4k", "single"),
         ("whisper-tiny", "decode_32k", "multi"),
         ("qwen2-vl-2b", "prefill_32k", "single"),
         ("rwkv6-1.6b", "long_500k", "multi"))
FIELDS = ("arch", "shape", "mesh", "kind", "n_devices", "n_params",
          "compute_s", "memory_s", "collective_s", "model_flops",
          "hlo_flops_total", "collective_bytes", "peak_gib", "peak_raw_gib")
PROPERTIES = ("dominant", "bound_s", "useful_flops_ratio", "static_gib",
              "mfu_upper_bound")


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    recs = []
    for arch, shape, mesh in PAIRS:
        rec = dryrun.run_pair(arch, shape, mesh, force=True, results_dir=out)
        assert rec["status"] == "ok", rec.get("error")
        rec["hlo"] = rec["analysis"]
        (out / f"{arch}__{shape}__{mesh}.json").write_text(json.dumps(rec))
        recs.append(rec)
    return out, recs


@pytest.fixture
def same_rates(monkeypatch):
    monkeypatch.setattr(jax_roofline, "PEAK_FLOPS", hw.PEAK_FLOPS_BF16)
    monkeypatch.setattr(jax_roofline, "HBM_BW", hw.HBM_BW)
    monkeypatch.setattr(jax_roofline, "ICI_BW", hw.NET_BW)
    monkeypatch.setattr(hw, "NVLINK_BW", jax_roofline.ICI_BW)
    monkeypatch.setattr(hw, "NET_BW", jax_roofline.ICI_BW)


def test_every_property_equals_the_references(records, same_rates):
    out, recs = records
    for rec in recs:
        assert roofline.model_flops(rec) == jax_roofline.model_flops(rec)
        got, want = roofline.from_record(rec), jax_roofline.from_record(rec)
        for name in FIELDS + PROPERTIES:
            assert getattr(got, name) == getattr(want, name), name
        for gib in (0.5, 16.0, hw.HBM_BYTES / 2**30):
            assert got.feasible(gib) == want.feasible(gib)
        assert got.collective_s > 0 or rec["n_devices"] == 1
    for mesh in ("single", "multi"):
        got = roofline.load_all(mesh, results_dir=out)
        want = jax_roofline.load_all(mesh, results_dir=out)
        assert [dataclasses.asdict(r) for r in got] == \
            [dataclasses.asdict(r) for r in want]
        assert roofline.markdown_table(got) == \
            jax_roofline.markdown_table(want)
    arch, shape, mesh = PAIRS[0]
    assert roofline.load(arch, shape, mesh, results_dir=out) == \
        roofline.from_record(recs[0])


def test_collective_term_takes_each_axis_link(records):
    """An axis whose ranks lie within one 8-card NVLink node moves at
    NVLINK_BW, one that crosses nodes (every axis of the production
    meshes) or a group that is no axis at NET_BW; the term sums the
    axes; the default capacity is the card's 80 GB."""
    assert hw.link_bw({"data": 16, "model": 16}, "model") == hw.NET_BW
    assert hw.link_bw({"data": 16, "model": 16}, "data") == hw.NET_BW
    assert hw.link_bw({"data": 2, "model": 4}, "model") == hw.NVLINK_BW
    assert hw.link_bw({"data": 2, "model": 4}, "data") == hw.NVLINK_BW
    assert hw.link_bw({"data": 4, "model": 4}, "data") == hw.NET_BW
    assert hw.link_bw({"data": 4, "model": 4}, "world") == hw.NET_BW
    by_axis = {"model": 3e9, "data": 5e9, "world": 1e9}
    shape = {"data": 8, "model": 2}
    assert roofline.collective_seconds(by_axis, shape) == pytest.approx(
        3e9 / hw.NVLINK_BW + 5e9 / hw.NET_BW + 1e9 / hw.NET_BW, rel=1e-12)
    _, recs = records
    rec = dict(recs[0], mesh_shape=shape,
               analysis=dict(recs[0]["analysis"],
                             collective_bytes_by_axis=by_axis))
    r = roofline.from_record(rec)
    assert r.collective_s == roofline.collective_seconds(by_axis, shape)
    assert roofline.HBM_GIB == 80e9 / 2**30
    assert r.feasible() == (r.static_gib <= 80e9 / 2**30)
