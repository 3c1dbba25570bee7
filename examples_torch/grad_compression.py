"""Distributed-optimization trick: int8 error-feedback gradient
compression over the data-parallel ranks
(``optim.compression.compressed_psum``).  Port of
``examples/grad_compression.py``.

Trains a toy regression for 400 steps with and without compression and
compares convergence and the bytes a rank's all-reduce moves a step.

The reference prints ``D * (1 if compressed else 4)`` wire bytes and "4x
fewer bytes on the DP links", a saving its ``psum`` does not make: its
``compressed_psum`` all-reduces each shard's dequantized fp32
contribution (the shards' scales differ, so their int8 payloads cannot
be summed as they are), beside an int32 copy of the payload that it
drops.  The port's ``compressed_psum`` all-reduces that fp32
contribution alone, the same bytes as the uncompressed path.  This
example prints what each path's all-reduce moves, counted by
``parallel.hlo_analysis`` over one recorded step: the all-reduced
tensor's bytes and the ring's link bytes a rank.  What it shows is that
error feedback keeps convergence with int8-rounded gradients.

Worlds: ``--device cpu`` starts a gloo world of ``--world`` processes
(default 8, the reference's 8 host devices); on the card, a NCCL world
of ``torch.cuda.device_count()`` ranks, one a card.  A world of one (one
H100) runs in this process, where ``compressed_psum`` still quantizes
and carries its error.

Run:  PYTHONPATH=src python examples_torch/grad_compression.py [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol

from repro_torch.convert import resolve_device
from repro_torch.launch.mesh import join_world, start_world
from repro_torch.optim.compression import compressed_psum
from repro_torch.parallel.hlo_analysis import TraceCounter, collective_stats

D, ROWS, STEPS, LR = 256, 64, 400, 0.01     # the reference's
WORLD_TIMEOUT_S = 300.0     # a spawned world's deadline, and its ranks'
PATHS = (("fp32 all-reduce", False), ("int8 EF all-reduce", True))
SRC = Path(__file__).resolve().parent.parent / "src"


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--world", type=int, default=8,
                    help="gloo ranks with --device cpu (on the card: one a "
                         "card)")
    return ap.parse_args(argv)


def problem(world: int) -> tuple[np.ndarray, np.ndarray]:
    """The reference's regression: (X, y) of ``world`` x ROWS rows."""
    rng = np.random.default_rng(0)
    w_true = rng.standard_normal(D).astype(np.float32)
    X = rng.standard_normal((world * ROWS, D)).astype(np.float32)
    return X, X @ w_true


def local_grad(w: torch.Tensor, xb: torch.Tensor, yb: torch.Tensor
               ) -> torch.Tensor:
    w = w.detach().requires_grad_(True)
    loss = torch.mean((xb @ w - yb) ** 2)
    return torch.autograd.grad(loss, w)[0]


def train(dev: torch.device) -> dict:
    """Both paths on this rank of the world that exists; the results of
    each (the final mse over every row, the weights, the bytes its
    all-reduce moved in step 0)."""
    rank, world = dist.get_rank(), dist.get_world_size()
    X, y = problem(world)
    xs, ys = torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev)
    xb, yb = xs[rank * ROWS:(rank + 1) * ROWS], ys[rank * ROWS:(rank + 1)
                                                   * ROWS]
    group = dist.group.WORLD
    # divided by a tensor: CUDA divides by a Python number as a product
    # with its reciprocal (as compressed_psum does)
    n = torch.full((), float(world), device=dev)
    out = {}
    for name, compressed in PATHS:
        w = torch.zeros(D, device=dev)
        err = torch.zeros(D, device=dev)
        for step in range(STEPS):
            with (TraceCounter() if step == 0
                  else contextlib.nullcontext()) as tc:
                g = local_grad(w, xb, yb)
                if compressed:
                    g, err = compressed_psum(g, group, err)
                else:
                    g = funcol.all_reduce(g, "sum", group) / n
            if step == 0:
                wire = collective_stats(tc.records)
            w = w - LR * g
        out[name] = {"mse": float(torch.mean((xs @ w - ys) ** 2)),
                     "w": w.cpu().tolist(),
                     "wire_bytes": wire.raw_bytes,
                     "link_bytes": wire.link_bytes,
                     "all_reduces": wire.per_op_count.get("all-reduce", 0)}
    return out


def _worker(args: argparse.Namespace) -> None:
    """One rank of a spawned world: joins it through the FileStore, trains,
    and rank 0 writes the results."""
    dev = join_world(args.rank, args.world, args.store, args.device,
                     WORLD_TIMEOUT_S)
    try:
        out = train(dev)
        if args.rank == 0:
            Path(args.out).write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def _spawn(world: int, device_type: str) -> dict:
    """A world of ``world`` processes of this file, joined by a FileStore
    in a temporary directory (no port to collide on); fails with the
    first failed rank's exit code, or past WORLD_TIMEOUT_S, and stops
    every rank it started."""
    env = dict(os.environ, OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo",
               PYTHONPATH=os.pathsep.join(
                   [str(SRC), os.environ.get("PYTHONPATH", "")]))
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "result.json"
        procs = [subprocess.Popen(
            [sys.executable, __file__, "--worker", "--rank", str(r),
             "--world", str(world), "--store", str(Path(tmp) / "store"),
             "--out", str(out), "--device", device_type], env=env)
            for r in range(world)]
        deadline = time.monotonic() + WORLD_TIMEOUT_S
        try:
            while True:
                codes = [p.poll() for p in procs]
                bad = [c for c in codes if c not in (None, 0)]
                if bad:
                    raise RuntimeError(f"a rank of the {device_type} world "
                                       f"of {world} exited with {bad[0]}")
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the {device_type} world of {world} "
                                       f"ran past {WORLD_TIMEOUT_S} s")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        return json.loads(out.read_text())


def run(args: argparse.Namespace, device=None) -> dict:
    """Both paths over the world ``device`` gives (see the module's
    docstring); returns the world's size and each path's results."""
    dev = resolve_device(device)
    world = args.world if dev.type == "cpu" else torch.cuda.device_count()
    if world > 1 and not dist.is_initialized():
        return {"world": world, "paths": _spawn(world, dev.type)}
    started = not dist.is_initialized()
    dev = start_world(dev)
    try:
        return {"world": dist.get_world_size(), "paths": train(dev)}
    finally:
        if started:
            dist.destroy_process_group()


def _worker_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", action="store_true")
    for flag in ("--rank", "--world"):
        ap.add_argument(flag, type=int, required=True)
    for flag in ("--store", "--out", "--device"):
        ap.add_argument(flag, required=True)
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    r = run(args, device=args.device)
    for name, res in r["paths"].items():
        print(f"{name:20s}: final mse {res['mse']:.3e}   all-reduced bytes "
              f"/step/rank {res['wire_bytes']:.0f} (ring link bytes "
              f"{res['link_bytes']:.0f} over {r['world']} ranks)")
    print("compression: the same all-reduced bytes on both paths (the "
          "int8 payloads are dequantized before the sum); matching "
          "convergence via error feedback")


if __name__ == "__main__":
    if "--worker" in sys.argv:
        _worker(_worker_args())
    else:
        main()
