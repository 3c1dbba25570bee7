"""End-to-end training: train a language model on the synthetic
pipeline with checkpointing, fault tolerance, and straggler tracking.
Port of ``examples/train_lm.py``, on the card's kernels (``rmsnorm`` and
``flash_attention`` forward, ``rmsnorm_bwd`` and ``flash_attention_bwd``).

Presets (the reference's, field for field):
  tiny  (default) — seconds on the CPU; CI-sized smoke of the full trainer
  100m            — a ~100M-param qwen3-family model, batch 16 x 512, a
                    few hundred steps (the deliverable-scale run; fits one
                    H100 whole)

Checkpoints go to ``checkpoints/train_lm_torch`` unless ``--ckpt-dir``
says otherwise (the reference writes ``checkpoints/train_lm``; the two
never read each other's files).  A run resumes from the latest
checkpoint there, as the reference's does.

Run:  PYTHONPATH=src python examples_torch/train_lm.py --preset 100m \\
          --steps 300
      PYTHONPATH=src python examples_torch/train_lm.py --device cpu --steps 60
"""

from __future__ import annotations

import argparse
import dataclasses

from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch.train import TrainOptions, Trainer
from repro_torch.optim import adamw

CKPT_EVERY = 25     # the reference's checkpoint interval, in steps


def preset_config(name: str):
    base = get_config("qwen3-4b", reduced=True)
    if name == "tiny":
        return base, ShapeSpec("tiny", 128, 8, "train")
    if name == "100m":
        cfg = dataclasses.replace(
            base, name="qwen3-100m", n_layers=8, d_model=640, n_heads=10,
            n_kv_heads=2, head_dim=64, d_ff=1792, vocab_size=32000,
            remat=True)
        return cfg, ShapeSpec("100m", 512, 16, "train")
    raise KeyError(name)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny", choices=["tiny", "100m"])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--ckpt-dir", default="checkpoints/train_lm_torch")
    ap.add_argument("--fail-at", type=int, default=-1,
                    help="inject a fault at this step (FT demo)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def run(args: argparse.Namespace, device=None) -> dict:
    """Trains ``args.preset`` on ``device`` for ``args.steps`` steps;
    returns the config, the shape and the trainer's record: every step's
    metrics (a replayed step appears again), failures, straggler steps,
    and the mean tokens/s of the steps after the first."""
    cfg, shape = preset_config(args.preset)
    trainer = Trainer(
        cfg, shape,
        opt=adamw.OptConfig(peak_lr=1e-3, warmup_steps=20,
                            total_steps=args.steps),
        options=TrainOptions(steps=args.steps, ckpt_every=CKPT_EVERY,
                             ckpt_dir=args.ckpt_dir,
                             fail_at_step=args.fail_at),
        device=device)
    trainer.run()
    ms = trainer.metrics_log
    return {"cfg": cfg, "shape": shape, "metrics": ms,
            "losses": [m["loss"] for m in ms],
            "mean_tok_per_s": sum(m["tokens_per_s"] for m in ms[1:])
            / max(len(ms) - 1, 1),
            "failures": trainer.failures,
            "straggler_steps": list(trainer.straggler_steps)}


def main(argv=None) -> None:
    args = parse_args(argv)
    cfg, shape = preset_config(args.preset)
    print(f"arch: {cfg.name} — {cfg.param_count() / 1e6:.1f}M params, "
          f"batch {shape.global_batch} x seq {shape.seq_len}")
    r = run(args, device=args.device)
    losses = r["losses"]
    if not losses:
        print(f"no step to run: {args.ckpt_dir} holds step {args.steps}")
        return
    print(f"\nloss {losses[0]:.3f} -> {losses[-1]:.3f} over "
          f"{len(losses)} steps; mean {r['mean_tok_per_s']:,.0f} tok/s; "
          f"{r['failures']} failures recovered; "
          f"{len(r['straggler_steps'])} straggler steps")


if __name__ == "__main__":
    main()
