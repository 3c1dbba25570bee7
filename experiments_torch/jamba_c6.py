"""ROADMAP C.6: does jamba-1.5-large's training cut learn?  Trains the cut
of ``chip_smoke.py``'s ``MOE_TRAIN_CUTS`` (its first two pattern
positions, attn + dense and ssm + moe, 4 of 16 experts, full width) on
the card under variants of its optimizer and layers, and prints for each
the losses, the gradient norms, and the loss (with the nll, the logits'
standard deviation over the vocabulary and the MoE aux loss) on the
batch after the last step's, which no step trains on, before, every 10
steps and after: its fall against the standard deviation of the
step-to-step loss differences.

Variants: the cut as ``chip_smoke.py`` trains it (AdamW peak lr 3e-4, 2
warm-up steps, a cosine over the run), with the step-0 gradient norms of
its largest leaves; without the clip; without the aux loss; at peak lr
1e-4, 6e-4, 3e-3, and 1e-3 after 10 warm-up steps; its second layer made
ssm + dense or attn + moe; its first layer alone; llama4-maverick's cut
at 3e-4; and the cut for 90 steps.  Needs the card (about 4 minutes):

    PYTHONPATH=src python experiments_torch/jamba_c6.py
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch.train import TrainOptions, Trainer
from repro_torch.models import lm
from repro_torch.optim import OptConfig

SEQ, BATCH = 512, 4          # chip_smoke.py's TRAIN_SEQ x TRAIN_BATCH


def cut(arch: str, **kw):
    """``arch`` at full width, its first ``n_layers`` pattern positions."""
    full = get_config(arch)
    return dataclasses.replace(full, **kw, pattern=full.pattern[:kw[
        "n_layers"]])


def held(cfg, params, batch) -> tuple[float, float, float, float]:
    """(loss_fn, nll, logits' std over the vocabulary, aux) on ``batch``."""
    with torch.no_grad():
        logits, aux = lm.forward(cfg, params, batch["tokens"])
        lse = torch.logsumexp(logits, -1)
        nll = (lse - logits.gather(-1, batch["labels"][..., None])[..., 0])
        return (float(lm.loss_fn(cfg, params, batch["tokens"],
                                 batch["labels"])), float(nll.mean()),
                float(logits.std(-1).mean()), float(aux))


def grad_norms(cfg, params, batch, top: int = 12) -> list:
    """The ``top`` largest leaves' gradient norms of ``batch``'s loss."""
    named = T.leaves_with_paths(params)
    leaves = [p.requires_grad_(True) for _, p in named]
    loss = lm.loss_fn(cfg, params, batch["tokens"], batch["labels"])
    grads = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    return sorted(((round(float(g.float().norm()), 3), n)
                   for (n, _), g in zip(named, grads)), reverse=True)[:top]


def probe(label: str, cfg, steps: int = 30, leaves: bool = False,
          **opt) -> None:
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    tr = Trainer(cfg, ShapeSpec("c6", SEQ, BATCH, "train"),
                 opt=OptConfig(**({"peak_lr": 3e-4, "warmup_steps": 2,
                                   "total_steps": steps} | opt)),
                 options=TrainOptions(steps=steps, ckpt_every=0), seed=0,
                 device=dev)
    params, opt_state, _ = tr.init_state()
    late = tr.data.device_batch(steps, dev)
    before = held(cfg, params, late)
    if leaves:
        print(f"[{label}] step-0 gradient norms, largest leaves: "
              f"{grad_norms(cfg, params, tr.batch(0))}", flush=True)
    losses, gnorms = [], []
    for step in range(steps):
        params, opt_state, m = tr.step_fn(params, opt_state, tr.batch(step))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        if step % 10 == 9 and step < steps - 1:
            print(f"[{label}] held-out after {step + 1} steps: "
                  f"{held(cfg, params, late)}", flush=True)
    after = held(cfg, params, late)
    sd = float(np.std(np.diff(losses)))
    fall = before[0] - after[0]
    print(f"[{label}] losses {[round(x, 4) for x in losses]}; gradient "
          f"norms {[round(x, 3) for x in gnorms]}; held-out (loss, nll, "
          f"logit std, aux) {before} -> {after}; fall {fall:.4f}, sd "
          f"{sd:.4f}, ratio {fall / sd:.2f} [{time.perf_counter() - t0:.1f}"
          f" s]", flush=True)
    del tr, params, opt_state
    torch.cuda.empty_cache()


def variants() -> dict:
    jamba = cut("jamba-1.5-large-398b", n_layers=2, n_experts=4)
    pat = jamba.pattern
    return {
        "base": lambda: probe("base", jamba, leaves=True),
        "no clip": lambda: probe("no clip", jamba, grad_clip=1e12),
        "aux 0": lambda: probe("aux 0", dataclasses.replace(
            jamba, router_aux_weight=0.0)),
        "lr 1e-4": lambda: probe("lr 1e-4", jamba, peak_lr=1e-4),
        "lr 6e-4": lambda: probe("lr 6e-4", jamba, peak_lr=6e-4),
        "lr 3e-3": lambda: probe("lr 3e-3", jamba, peak_lr=3e-3),
        "lr 1e-3 warmup 10": lambda: probe(
            "lr 1e-3 warmup 10", jamba, peak_lr=1e-3, warmup_steps=10),
        "ssm+dense": lambda: probe("ssm+dense", dataclasses.replace(
            jamba, pattern=(pat[0], dataclasses.replace(pat[1],
                                                        ffn="dense")))),
        "attn+moe": lambda: probe("attn+moe", dataclasses.replace(
            jamba, pattern=(pat[0], dataclasses.replace(pat[1],
                                                        mixer="attn")))),
        "first layer": lambda: probe("first layer", cut(
            "jamba-1.5-large-398b", n_layers=1, n_experts=4)),
        "llama4": lambda: probe("llama4", cut(
            "llama4-maverick-400b-a17b", n_layers=2, n_experts=16)),
        "90 steps": lambda: probe("90 steps", jamba, steps=90),
    }


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(torch.cuda.get_device_name(0), flush=True)
    for run_variant in variants().values():
        run_variant()


if __name__ == "__main__":
    main()
