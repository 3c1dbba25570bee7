"""How far one kernel family alone moves qwen3-4b's bf16 logits at length
(ROADMAP C.8): the probe behind the fp32 witness of ``chip_smoke.py``'s
long-context phase, which prints the rest (each bf16 path against fp32
arithmetic) itself.

qwen3-4b at full width and depth, drawn as the phase serves it
(``lm.init_cast``, seed 0), prefills two prompts (seeds 0 and 1, the
phase's) cut to 512, 4,096 and 32,768 tokens three ways: the plain
versions (P, their attention over 1,024-row query chunks past
``attn_chunk_threshold``), the kernels with attention on its plain
version (KA: only the rmsnorm kernel differs from P) and the kernels with
rmsnorm on its plain version (KR: only attention differs).  Prints each
run's seconds and peak and the relative L2 distance of the last
position's logits of KA and KR from P.

Needs the card (about 2 minutes):

    PYTHONPATH=src python experiments_torch/long_context.py
"""

from __future__ import annotations

import contextlib
import subprocess
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import _build, ops
from repro_torch.models import lm

LENGTHS, ROWS, ARCH = (512, 4096, 32768), 2, "qwen3-4b"
PAIRS = (("KA", "P"), ("KR", "P"))


def rel_l2(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm())


@contextlib.contextmanager
def plain_ops(names):
    """The model's ``kernels.ops`` entries ``names`` on their plain
    versions while open."""
    saved = {n: getattr(ops, n) for n in names}
    for n, fn in saved.items():
        setattr(ops, n, lambda *a, fn=fn, **k: fn(*a, **(k | {"plain": True})))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(ops, n, fn)


def bf16_floor(dev) -> None:
    cfg = get_config(ARCH)
    params = lm.init_cast(cfg, torch.Generator(device=dev).manual_seed(0),
                          dev)
    runs = (("P", (), True), ("KA", ("attention",), False),
            ("KR", ("rmsnorm",), False))
    prompts = np.stack([np.random.default_rng(i).integers(
        0, cfg.vocab_size, max(LENGTHS)) for i in range(ROWS)])
    for S in LENGTHS:
        tokens = torch.from_numpy(prompts[:, :S].astype(np.int64)).to(dev)
        out = {}
        for name, family, plain in runs:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with torch.no_grad(), plain_ops(family):
                logits, cache = lm.prefill(cfg, params, tokens, plain=plain)
            del cache
            torch.cuda.synchronize()
            out[name] = logits.float()
            print(f"{ROWS} x {S} {name}: {time.perf_counter() - t0:.1f} s, "
                  f"peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB",
                  flush=True)
        print(f"{ROWS} x {S}, last-position logits rel L2: " + ", ".join(
            f"{a} vs {b} {rel_l2(out[a], out[b]):.5f}" for a, b in PAIRS),
            flush=True)
    del params
    torch.cuda.empty_cache()


def main() -> None:
    # fp32 products in full fp32, as chip_smoke.py sets them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    bf16_floor(dev)


if __name__ == "__main__":
    main()
