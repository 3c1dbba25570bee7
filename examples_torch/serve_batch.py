"""Batched serving: prefill + lock-step decode over a mixed batch of
requests (different prompt lengths, greedy & sampled), reporting
prefill latency and decode throughput.  Port of
``examples/serve_batch.py``, on the card's kernels (``rmsnorm``,
``flash_attention``, and ``ssd`` for ``--arch mamba2-2.7b``).

The reference serves on ``make_local_mesh()``.  On one card that mesh is
(1, 1): it gives the meshless numbers bit for bit and only adds
DTensor's host cost to every step, so this example serves without a
mesh.

Run:  PYTHONPATH=src python examples_torch/serve_batch.py --arch qwen2-vl-2b
      PYTHONPATH=src python examples_torch/serve_batch.py --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.launch.serve import BatchServer, Request


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def requests_for(cfg, batch: int, gen: int) -> list[Request]:
    """The reference's requests: prompts of 4-31 tokens from
    ``default_rng(0)``, odd requests sampled at temperature 0.8."""
    rng = np.random.default_rng(0)
    return [
        Request(i,
                rng.integers(0, cfg.vocab_size,
                             int(rng.integers(4, 32))).astype(np.int32),
                max_new=gen,
                temperature=0.8 if i % 2 else 0.0)
        for i in range(batch)
    ]


def run(args: argparse.Namespace, device=None, params=None) -> dict:
    """Serves ``args.arch``'s reduced config on ``device``, its weights
    drawn from seed 0 or taken from ``params`` (e.g. the reference's,
    through ``convert.params_from_jax``); returns the server's stats
    with the config and the requests."""
    cfg = get_config(args.arch, reduced=True)
    server = BatchServer(cfg, max_len=128, device=device, params=params)
    requests = requests_for(cfg, args.batch, args.gen)
    return {"cfg": cfg, "requests": requests, **server.serve(requests)}


def main(argv=None) -> None:
    args = parse_args(argv)
    cfg = get_config(args.arch, reduced=True)
    print(f"serving {cfg.name} ({cfg.param_count() / 1e6:.1f}M reduced)")
    stats = run(args, device=args.device)
    requests = stats["requests"]
    print(f"prefill: {stats['prefill_s'] * 1e3:.1f} ms  |  decode: "
          f"{stats['decode_tok_per_s']:.1f} tok/s")
    for rid, toks in stats["outputs"].items():
        mode = "sampled" if requests[rid].temperature > 0 else "greedy"
        print(f"  req {rid} ({mode}, prompt {len(requests[rid].prompt)}): "
              f"{toks[:10]}...")


if __name__ == "__main__":
    main()
