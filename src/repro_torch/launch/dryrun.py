"""Multi-pod dry-run: every (arch x input shape) on the production
meshes, its per-device memory, FLOPs, HBM bytes and collectives (port of
the reference's ``launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepseek-7b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh both]
        [--force] [--out DIR]

Results cache to ``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``;
``launch/roofline.py`` reads them. The reference lowers and compiles
each step with XLA on 512 forced host devices. Here the devices are a
``DeviceMesh`` of 256 / 512 ranks on the fake process-group backend, as
rank 0, the group initialised and destroyed around each pair; the step
runs once, eagerly, on meta tensors (DTensors over meta tensors, placed
by the pair's ``ParallelPlan``) under ``step_analysis.analyze``: no
compile, no memory, no device. Kernels take their route on meta (their
ops: one op each, at the kernel's cost). Nothing is set in the
environment at import.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES, get_shape
from repro_torch.launch import step_analysis
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model import build_model
from repro_torch.sharding.rules import ParallelPlan, mesh_shape
from repro_torch.train import optimizer as opt
from repro_torch.train.train_loop import make_train_step

RESULTS_DIR = Path(__file__).resolve().parents[3] / "experiments" \
    / "dryrun_torch"

LONG_CONTEXT_WINDOW = 4096  # sliding window for full-attention archs @500k


def config_for(arch: str, shape_name: str):
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    if shape_name == "long_500k" and cfg.uses_attention and \
            not cfg.sliding_window:
        # full attention is quadratic-infeasible at 524k: use the
        # sliding-window serving variant
        cfg = dataclasses.replace(cfg, sliding_window=LONG_CONTEXT_WINDOW)
    return cfg, shape


@contextlib.contextmanager
def fake_mesh(mesh_kind: str):
    """The production mesh ("single": (data 16, model 16); "multi": (pod
    2, data 16, model 16)) over the fake backend, as rank 0."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    multi = mesh_kind == "multi"
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512 if multi else 256)
    try:
        yield make_production_mesh(multi_pod=multi, device="cpu")
    finally:
        dist.destroy_process_group()


@dataclasses.dataclass
class Step:
    fn: object              # the step: fn(*args)
    args: tuple
    meta: dict              # the record's description of the pair


def build_step(cfg, shape, mesh=None, *, device="meta", seed: int = 0,
               inputs=None) -> Step:
    """The (cfg, shape) step on ``mesh`` (None: plan-free, one device):
    params from ``Model.init`` placed by ``plan.param_shardings``; for
    train the AdamW state from ``optimizer.init_state`` and the step of
    ``train_loop.make_train_step`` (loss, gradient, ``apply_updates``),
    for prefill ``Model.prefill``, for decode one ``Model.decode_step``
    against a cache of capacity ``shape.seq_len``. ``inputs`` default to
    ``Model.input_specs`` on meta (pass tensors on ``device`` to run the
    step there), the batch, a decode step's token and its cache placed by
    ``plan.input_shardings`` (as the reference places them), its
    ``cache_len`` whole on every rank."""
    model = build_model(cfg, device=device)
    plan = ParallelPlan.make(mesh, cfg, shape.kind)
    params = plan.param_shardings(model.init(seed))
    inputs = model.input_specs(shape) if inputs is None else inputs
    if shape.kind == "train":
        batch = plan.input_shardings(inputs["batch"])
        fn = make_train_step(model, opt.AdamWConfig(), plan)
        args = (params, opt.init_state(params), batch)
    elif shape.kind == "prefill":
        batch = plan.input_shardings(inputs["batch"])

        def fn(params, batch):
            with torch.no_grad():
                return model.prefill(params, batch, plan=plan)
        args = (params, batch)
    else:
        placed = plan.input_shardings({"token": inputs["token"],
                                       "cache": inputs["cache"]})

        def fn(params, token, cache, cache_len):
            with torch.no_grad():
                return model.decode_step(params, token, cache, cache_len,
                                         plan=plan)
        args = (params, placed["token"], placed["cache"],
                inputs["cache_len"])
    meta = {"arch": cfg.name, "shape": shape.name, "kind": shape.kind,
            "n_devices": 1 if mesh is None else mesh.size(),
            "mesh_shape": {} if mesh is None else mesh_shape(mesh),
            "n_params": cfg.n_params(),
            "n_active_params": cfg.n_active_params(),
            "seq_len": shape.seq_len, "global_batch": shape.global_batch,
            "moe_mode": plan.moe_mode}
    return Step(fn, args, meta)


def run_pair(arch: str, shape_name: str, mesh_kind: str, force=False,
             results_dir: Path | None = None) -> dict:
    results_dir = results_dir or RESULTS_DIR
    out_path = results_dir / f"{arch}__{shape_name}__{mesh_kind}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())
    results_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_kind}
    try:
        with fake_mesh(mesh_kind) as mesh:
            cfg, shape = config_for(arch, shape_name)
            step = build_step(cfg, shape, mesh)
            rec.update(step.meta)
            rec["build_s"] = round(time.time() - t0, 2)
            _, stats = step_analysis.analyze(step.fn, *step.args,
                                             mesh=mesh)
        rec["memory"] = {"argument_bytes": stats.argument_bytes,
                         "peak_bytes_per_device": stats.peak_bytes}
        rec["analysis"] = stats.as_record()
        rec["status"] = "ok"
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_s"] = round(time.time() - t0, 2)
    out_path.write_text(json.dumps(rec, indent=1))
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", type=Path, default=RESULTS_DIR,
                    help="directory of the records")
    args = ap.parse_args()
    # DTensor warns at every redistribution over two axes of the fake mesh
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    archs = ARCH_IDS if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]

    n_ok = n_err = 0
    for mk in meshes:
        for arch in archs:
            for shp in shapes:
                rec = run_pair(arch, shp, mk, force=args.force,
                               results_dir=args.out)
                ok = rec["status"] == "ok"
                n_ok += ok
                n_err += (not ok)
                msg = (f"peak={rec['memory']['peak_bytes_per_device']/2**30:.2f}GiB "
                       f"flops={rec['analysis']['flops_per_device']:.3g} "
                       f"coll={sum(rec['analysis']['collective_bytes'].values()):.3g}B"
                       if ok else rec.get("error", "?"))
                print(f"[{rec['status']:5s}] {arch:18s} {shp:12s} {mk:6s} "
                      f"({rec['total_s']:6.1f}s) {msg}", flush=True)
    print(f"done: {n_ok} ok, {n_err} failed")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
