"""ROADMAP C.9: why qwen3-4b's training cut does not descend at train_4k's
2 x 4,096 tokens a step at peak lr 1e-3.

Trains the cut of ``chip_smoke.py`` (qwen3-4b at full width, its first 8
of 36 layers, fp32 parameters and moments, remat, drawn from seed 0) for
10 steps of ``SyntheticLM`` seed 0 with that script's schedule (AdamW, 2
warm-up steps, a cosine over the 10), step by step through
``launch.steps.make_train_step`` as ``Trainer`` runs it:

- at 4 x 512 and at 2 x 4,096 tokens, each at peak lr 1e-3 and 5e-4, in
  bf16 compute on the kernels;
- at 2 x 4,096 and peak lr 1e-3 in fp32 compute on the plain versions
  (``plain=True``): no kernel runs and nothing is rounded to bf16.

For each step it prints the loss, the gradient norm before the clip
(``apply_updates``' ``grad_norm``), the lr, and for each leaf group
(embed, head, attention, MLP, norms) the RMS of the step's update over
the RMS of the parameters before it.  Each run ends with its first loss
and the mean of its last 3, the check ``chip_smoke.py`` makes.

Needs the card (about 2 minutes, the kernels' build included):

    PYTHONPATH=src python experiments_torch/train_lr.py
"""

from __future__ import annotations

import dataclasses
import subprocess
import time

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.data import for_arch
from repro_torch.kernels import _build
from repro_torch.launch.steps import make_train_step
from repro_torch.models import lm
from repro_torch.optim import OptConfig, init_state

ARCH, LAYERS, STEPS, WARMUP = "qwen3-4b", 8, 10, 2
# (batch, seq, peak lr, compute dtype, plain versions)
RUNS = ((4, 512, 1e-3, "bfloat16", False), (4, 512, 5e-4, "bfloat16", False),
        (2, 4096, 1e-3, "bfloat16", False), (2, 4096, 5e-4, "bfloat16", False),
        (2, 4096, 1e-3, "float32", True))
GROUPS = ("embed", "head", "attention", "MLP", "norms")


def group(path: str) -> str:
    """The leaf group of a parameter's path."""
    if "norm" in path:
        return "norms"
    if path == "embed":
        return "embed"
    if path == "lm_head":
        return "head"
    return "attention" if "/attn/" in path else "MLP"


def sums(params, before=None) -> dict:
    """Per group: the sum of squares of the parameters, or of their change
    since ``before`` (a list of the leaves' earlier values)."""
    out = dict.fromkeys(GROUPS, 0.0)
    for i, (path, p) in enumerate(T.leaves_with_paths(params)):
        x = p.detach().float() if before is None else \
            p.detach().float() - before[i]
        out[group(path)] += float(x.square().sum())
    return out


def run(dev, batch: int, seq: int, peak_lr: float, dtype: str,
        plain: bool) -> None:
    cfg = dataclasses.replace(get_config(ARCH), n_layers=LAYERS,
                              compute_dtype=dtype)
    opt = OptConfig(peak_lr=peak_lr, warmup_steps=WARMUP, total_steps=STEPS)
    step = make_train_step(cfg, ShapeSpec("probe", seq, batch, "train"), opt,
                           dev, plain=plain)
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    state = init_state(params, opt)
    data = for_arch(cfg, seq, batch, seed=0)
    label = (f"{batch} x {seq}, peak lr {peak_lr}, {dtype} compute on the "
             f"{'plain versions' if plain else 'kernels'}")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    losses = []
    for i in range(STEPS):
        before = [p.detach().float().clone() for p in T.leaves(params)]
        norm = sums(params)
        params, state, m = step(params, state, data.device_batch(i, dev))
        moved = sums(params, before)
        del before
        losses.append(float(m["loss"]))
        print(f"[{label}] step {i}: loss {losses[-1]:.4f}, grad_norm "
              f"{float(m['grad_norm']):.4g}, lr {float(m['lr']):.3g}; update "
              f"RMS / parameter RMS: " + ", ".join(
                  f"{g} {(moved[g] / norm[g]) ** 0.5:.3g}" for g in GROUPS),
              flush=True)
    torch.cuda.synchronize(dev)
    print(f"[{label}] first {losses[0]:.4f}, mean of the last 3 "
          f"{np.mean(losses[-3:]):.4f}: "
          f"{'falls' if np.mean(losses[-3:]) < losses[0] else 'does not fall'}"
          f"; {time.perf_counter() - t0:.1f} s, peak "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB",
          flush=True)
    del params, state, step
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
    for spec in RUNS:
        run(dev, *spec)


if __name__ == "__main__":
    main()
