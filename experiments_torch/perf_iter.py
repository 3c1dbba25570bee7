"""§Perf hillclimbing: re-trace one (arch x shape x mesh) cell with a
named optimization and report the roofline terms.  Port of
``experiments/perf_iter.py`` over the port's dry run
(``launch.dryrun.run_cell``): analytical, on the CPU, over a fake
process group of 256 or 512 ranks, at one H100's constants
(``parallel.hlo_analysis``).  It measures nothing on a device.

The port's trace counts every layer, so the reference's 1- and 2-block
depth probes (which extrapolate from XLA's once-counted scan) are gone.
There is no compiled buffer plan, so the temporaries a chip holds are
not measured.

Levers (--opt, comma-separated; the reference's):
  seq_parallel   sequence-parallel TP (reduce-scatter/all-gather TP)
  bf16_weights   serve with bf16 weights (decode/prefill cells)
  no_remat       disable activation rematerialization
  dots_remat     remat policy: save dot outputs (vs nothing)
  dots_nb_remat  remat policy: save 2-D dot outputs only
  chunked_attn   attention over query chunks past 1,024 tokens
  microbatchN    N gradient-accumulation microbatches
  dup_kv         each KV head twice in the decode cache
  bf16_moments   bf16 optimizer moments
  no_fsdp        disable FSDP param sharding
  fsdp           enable FSDP param sharding

Usage:
  PYTHONPATH=src python experiments_torch/perf_iter.py --arch qwen3-4b \\
      --shape train_4k --opt seq_parallel [--multi-pod]
"""

from __future__ import annotations

import argparse
import dataclasses
import json

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch.dryrun import run_cell


def apply_opts(cfg, opts: list[str]):
    for o in opts:
        if o == "seq_parallel":
            cfg = dataclasses.replace(cfg, seq_parallel=True)
        elif o == "bf16_weights":
            cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
        elif o == "no_remat":
            cfg = dataclasses.replace(cfg, remat=False)
        elif o == "dots_remat":
            cfg = dataclasses.replace(cfg, remat_policy="dots")
        elif o == "dots_nb_remat":
            cfg = dataclasses.replace(cfg, remat_policy="dots_nb")
        elif o == "chunked_attn":
            cfg = dataclasses.replace(cfg, attn_chunk_threshold=1024)
        elif o.startswith("microbatch"):
            cfg = dataclasses.replace(cfg, microbatch=int(o[len("microbatch"):]))
        elif o == "dup_kv":
            cfg = dataclasses.replace(cfg, kv_cache_repeat=2)
        elif o == "bf16_moments":
            cfg = dataclasses.replace(cfg, moment_dtype="bfloat16")
        elif o == "no_fsdp":
            cfg = dataclasses.replace(cfg, fsdp=False)
        elif o == "fsdp":
            cfg = dataclasses.replace(cfg, fsdp=True)
        elif o:
            raise KeyError(o)
    return cfg


def measure(cfg, shape_name: str, multi_pod: bool,
            mesh_shape: tuple[int, ...] | None = None) -> dict:
    """The cell's roofline terms and per-chip argument GiB, on the
    production mesh or ``mesh_shape`` (a small fake mesh, for tests)."""
    rec = run_cell(cfg.name, shape_name, multi_pod, None, verbose=False,
                   cfg=cfg, mesh_shape=mesh_shape)
    if rec["status"] != "ok":
        raise RuntimeError(f"{cfg.name} x {shape_name}: {rec['status']}: "
                           f"{rec.get('reason') or rec.get('error')}")
    roof = rec["roofline"]
    return {"roofline": roof,
            "step_s": max(roof["compute_s"], roof["memory_s"],
                          roof["collective_s"]),
            "args_gib": rec["memory"]["argument_bytes"] / 2**30}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--opt", default="", help="comma-separated levers")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)

    opts = [o for o in args.opt.split(",") if o]
    cfg = apply_opts(get_config(args.arch), opts)

    res = measure(cfg, args.shape, args.multi_pod)
    rf = res["roofline"]
    print(f"cell: {args.arch} x {args.shape} x "
          f"{'pod2x16x16' if args.multi_pod else 'pod16x16'}  opts={opts}")
    print(f"  compute_s    = {rf['compute_s']:.4f}")
    print(f"  memory_s     = {rf['memory_s']:.4f}")
    print(f"  collective_s = {rf['collective_s']:.4f}")
    print(f"  bound        = {rf['bound']}   step_s = {res['step_s']:.4f}")
    print(f"  args/chip    = {res['args_gib']:.2f} GiB   "
          f"temp/chip = not measured")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({"arch": args.arch, "shape": args.shape,
                       "opts": opts, **res}, f, indent=1)


if __name__ == "__main__":
    main()
