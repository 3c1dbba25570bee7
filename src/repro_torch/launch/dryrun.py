"""Multi-pod dry run: port of ``repro.launch.dryrun``.  It shows that the
distribution config is coherent and gives each cell's roofline terms,
without a device and without memory.

For every (architecture x input shape) cell, on the single-pod (16, 16)
mesh and the two-pod (2, 16, 16) mesh, the cell starts a fake process
group of 256 or 512 ranks (``torch.testing``'s ``FakeStore``, backend
"fake": collectives return at once), builds the step's ``StepBundle``
(``launch.steps.make_step``, ``plain=True``: the kernels' plain versions
and the MoE's one-hot einsums) on ``meta`` tensors, lays its abstract
arguments out by the bundle's shardings, and runs the step once under
``hlo_analysis.TraceCounter``.  Every layer runs, so the FLOPs, bytes and
collectives count every layer (the reference extrapolates from 1- and
2-block compiles because XLA counts a scanned loop once).  It records,
per chip (rank 0's view), the reference's keys where the port has a
counterpart:

  status           ok | skipped (with the reference's reason) | failed
  memory           argument_bytes: the local shards of parameters,
                   optimizer state, batch and cache
  cost             FLOPs and bytes read and written by the ops
  collectives      per-op link bytes and counts, link bytes per chip
  roofline         the three terms at one H100's constants
                   (``hlo_analysis``); analytical, not measured
  params_total, params_active, model_flops_per_chip, model_vs_hlo_flops

Records go to ``<out>/<arch>__<shape>__<mesh>.json``.  Run:

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A]
        [--shape S] [--mesh single|multi|both] [--out DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor

from .. import tree as T
from ..configs import ARCH_IDS, SHAPES, applicable, get_config
from ..parallel.hlo_analysis import TraceCounter, collective_stats, roofline
from .mesh import make_production_mesh
from .steps import make_step

MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}


def start_fake_world(world: int) -> None:
    """A fake process group of ``world`` ranks, this process rank 0 (any
    group already started is destroyed first)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def local_bytes(tree) -> int:
    """Bytes of this rank's blocks of the tensors of ``tree``."""
    total = 0
    for t in T.leaves(tree):
        if isinstance(t, torch.Tensor):
            loc = t.to_local() if isinstance(t, DTensor) else t
            total += loc.numel() * loc.element_size()
    return total


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str | None,
             verbose: bool = True, *, cfg=None,
             mesh_shape: tuple[int, ...] | None = None) -> dict:
    """One cell: the production mesh, or ``mesh_shape`` with the same
    axis names (a small fake mesh, for tests), and ``cfg`` (default the
    arch's config)."""
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    dims, axes = MESHES[multi_pod]
    dims = tuple(mesh_shape or dims)
    mesh_name = ("pod" + "x".join(map(str, dims))
                 if mesh_shape is None else "fake" + "x".join(map(str, dims)))
    record: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                    "kind": shape.kind}
    ok, reason = applicable(cfg, shape)
    if not ok:
        record |= {"status": "skipped", "reason": reason}
        _write(out_dir, record)
        if verbose:
            print(f"[skip] {arch} x {shape_name} x {mesh_name}: {reason}")
        return record

    t0 = time.perf_counter()
    n_chips = 1
    for d in dims:
        n_chips *= d
    try:
        start_fake_world(n_chips)
        mesh = (make_production_mesh(multi_pod=multi_pod, device_type="cpu")
                if mesh_shape is None else
                init_device_mesh("cpu", dims, mesh_dim_names=axes))
        bundle = make_step(cfg, mesh, shape, plain=True, device="meta")
        args = bundle.place(*bundle.abstract_args)
        t_build = time.perf_counter() - t0
        arg_bytes = local_bytes(args)
        with TraceCounter() as tc:
            bundle(*args)
        t_trace = time.perf_counter() - t0 - t_build
        coll = collective_stats(tc.records)
        roof = roofline(tc.flops, tc.bytes, coll.link_bytes, n_chips)
        record |= {
            "status": "ok",
            "build_s": round(t_build, 2),
            "trace_s": round(t_trace, 2),
            "n_chips": n_chips,
            "memory": {"argument_bytes": arg_bytes},
            "cost": {"flops": float(tc.flops), "bytes": float(tc.bytes)},
            "collectives": {
                "per_op_bytes": coll.per_op_bytes,
                "per_op_count": coll.per_op_count,
                "link_bytes_per_chip": coll.link_bytes,
            },
            "roofline": roof.as_dict(),
            "params_total": cfg.param_count(),
            "params_active": cfg.active_param_count(),
        }
        # MODEL_FLOPS: the useful FLOPs of this step (6ND train, 2ND
        # inference, N = active parameters), per chip
        tokens = (shape.global_batch * shape.seq_len
                  if shape.kind in ("train", "prefill")
                  else shape.global_batch)
        mult = 6 if shape.kind == "train" else 2
        model_flops = mult * cfg.active_param_count() * tokens / n_chips
        record["model_flops_per_chip"] = model_flops
        record["model_vs_hlo_flops"] = (model_flops / roof.flops
                                        if roof.flops else None)
        if verbose:
            print(f"[ok]   {arch} x {shape_name} x {mesh_name}: build "
                  f"{t_build:.1f}s trace {t_trace:.1f}s args/chip "
                  f"{arg_bytes / 2**30:.2f}GiB bound={roof.bound}")
    except Exception as e:   # noqa: BLE001 — a failed cell is a bug report
        record |= {"status": "failed", "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-4000:]}
        if verbose:
            print(f"[FAIL] {arch} x {shape_name} x {mesh_name}: {e}")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    _write(out_dir, record)
    return record


def _write(out_dir: str | None, record: dict) -> None:
    if out_dir is None:
        return
    os.makedirs(out_dir, exist_ok=True)
    name = f"{record['arch']}__{record['shape']}__{record['mesh']}.json"
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(record, f, indent=1)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(ARCH_IDS))
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="dryrun_torch")
    args = ap.parse_args()

    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    n_fail = 0
    for arch in archs:
        for shape in shapes:
            for multi in meshes:
                rec = run_cell(arch, shape, multi, args.out)
                n_fail += rec["status"] == "failed"
    print(f"dry-run complete; failures: {n_fail}")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
