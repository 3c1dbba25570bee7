"""Fault-tolerant trainer: port of ``repro.launch.train`` on one
device.

  * init from a seed (``lm.init`` / ``encdec.init``, fp32) and the step
    of ``launch.steps``;
  * a checkpoint every ``ckpt_every`` steps (atomic, crc-manifested, off
    thread) and resume from the latest on start;
  * failure isolation: a step that raises (an injected fault, a lost
    device) restores the latest checkpoint and replays, up to
    ``max_failures``; the data pipeline gives the replayed steps the same
    batches;
  * stragglers: step wall times feed an EWMA; a step slower than
    ``straggler_factor`` times it is logged and counted.

With ``mesh`` (a ``launch.mesh`` DeviceMesh with "data" and "model"
axes) the trainer runs the step's ``StepBundle``: parameters laid out by
the arch's sharding rules, ZeRO-1 moments, each step's batch rows over
the data axis (``sharded_batch``), checkpoints gathered to rank 0 and
restored onto whatever mesh the trainer has (elastic rescale).  The CLI
builds the mesh with ``--model-axis``, over the world ``torchrun``
starts:

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch \
        qwen3-4b --reduced --device cpu --model-axis 2

(gloo on the CPU; NCCL takes one rank a card, so one H100 has the
(1, 1) mesh).  ``device=None`` means the CUDA card;
there the kernels of every arch's path (rmsnorm, layernorm, flash
attention's prefill and ``ssd``) run their backward kernels, and the MoE
FFN differentiates through its index dispatch, so every arch trains.
The >= 100B MoE configs keep bf16 moments (``cfg.moment_dtype``), which
an ``OptConfig`` passed in takes unless it names its own.  At full width
they fit one card cut in depth, e.g. dbrx-132b at one of its 40 layers:

    cfg = dataclasses.replace(get_config("dbrx-132b"), n_layers=1)
    Trainer(cfg, ShapeSpec("t", 512, 4, "train"),
            opt=OptConfig(peak_lr=1e-3))

Run:  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
          --reduced --device cpu --steps 40 --batch 8 --seq 64
"""

from __future__ import annotations

import argparse
import time
import traceback
from dataclasses import dataclass

import torch

from .. import checkpoint as ckpt
from ..configs import get_config
from ..configs.shapes import ShapeSpec
from ..convert import resolve_device
from ..data import for_arch
from ..models import encdec, lm
from ..optim import adamw
from .mesh import cli_mesh, mesh_device
from .steps import make_train_step


@dataclass
class TrainOptions:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = "checkpoints"
    max_failures: int = 3
    straggler_factor: float = 3.0
    log_every: int = 10
    fail_at_step: int = -1        # fault injection (tests)


class Trainer:
    def __init__(self, cfg, shape: ShapeSpec,
                 opt: adamw.OptConfig | None = None,
                 options: TrainOptions | None = None, seed: int = 0,
                 device: str | torch.device | None = None, mesh=None):
        self.cfg = cfg
        self.shape = shape
        self.mesh = mesh
        self.device = resolve_device(
            mesh_device(mesh) if mesh is not None and device is None
            else device)
        self.options = options or TrainOptions()
        self.opt_cfg = adamw.for_arch(
            opt or adamw.OptConfig(total_steps=self.options.steps), cfg)
        self.step_fn = make_train_step(cfg, shape, self.opt_cfg, self.device,
                                       mesh)
        self.data = for_arch(cfg, shape.seq_len, shape.global_batch, seed)
        self.saver = ckpt.AsyncSaver()
        self.metrics_log: list[dict] = []
        self.straggler_steps: list[int] = []
        self.fault_log: list[str] = []
        self.failures = 0
        # on a mesh, rank 0 logs the steps (each rank logs its own faults)
        self.lead = mesh is None or mesh.get_rank() == 0

    # ------------------------------------------------------------ state
    def init_state(self, seed: int = 0):
        """Parameters drawn from ``seed`` and zero moments; on the mesh
        drawn into the step's layouts one item at a time (``init``'s
        ``rules``) and the moments made in ZeRO-1's, so that no rank holds
        the whole fp32 tree."""
        model = encdec if self.cfg.is_encdec else lm
        gen = torch.Generator(device=self.device).manual_seed(seed)
        if self.mesh is None:
            params = model.init(self.cfg, gen, self.device)
            return params, adamw.init_state(params, self.opt_cfg), 0
        params = model.init(self.cfg, gen, self.device,
                            rules=self.step_fn.rules)
        return params, adamw.init_state(
            params, self.opt_cfg, self.step_fn.in_shardings[1]), 0

    def _shardings(self):
        if self.mesh is None:
            return None
        p_sh, o_sh = self.step_fn.in_shardings[:2]
        return {"params": p_sh, "opt": o_sh}

    def batch(self, step: int) -> dict:
        """Step ``step``'s batch on the device, or laid out on the mesh."""
        if self.mesh is None:
            return self.data.device_batch(step, self.device)
        return self.data.sharded_batch(step, self.step_fn.in_shardings[2])

    def try_resume(self, params, opt_state, start_step):
        latest = ckpt.latest_step(self.options.ckpt_dir)
        if latest is None:
            return params, opt_state, start_step
        restored, extra = ckpt.restore(self.options.ckpt_dir, latest,
                                       {"params": params, "opt": opt_state},
                                       shardings=self._shardings())
        if self.lead:
            print(f"[resume] restored step {latest}")
        return restored["params"], restored["opt"], int(extra["next_step"])

    # ------------------------------------------------------------- loop
    def run(self, resume: bool = True):
        params, opt_state, step = self.init_state()
        if resume:
            params, opt_state, step = self.try_resume(params, opt_state, step)
        ewma = None
        opts = self.options
        while step < opts.steps:
            t0 = time.perf_counter()
            try:
                if step == opts.fail_at_step and self.failures == 0:
                    raise RuntimeError("injected fault (node failure)")
                batch = self.batch(step)
                params, opt_state, metrics = self.step_fn(
                    params, opt_state, batch)
                loss = float(metrics["loss"])
                failed = False
            except Exception as e:   # noqa: BLE001 — the fault path
                self.failures += 1
                self.fault_log.append(traceback.format_exc())
                print(f"[fault] step {step}: {e} "
                      f"({self.failures}/{opts.max_failures})")
                if self.failures > opts.max_failures:
                    raise
                failed = True
            if failed:
                # outside the except block, whose traceback holds the
                # failed step's frames (its gradients): the old state goes
                # before the new is drawn, or a full-width fault holds two
                self.saver.wait()
                params = opt_state = None
                params, opt_state, step = self.init_state()
                params, opt_state, step = self.try_resume(
                    params, opt_state, step)
                continue
            dt = time.perf_counter() - t0
            ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
            if dt > opts.straggler_factor * ewma and step > 3:
                self.straggler_steps.append(step)
                if self.lead:
                    print(f"[straggler] step {step}: {dt:.3f}s "
                          f"(ewma {ewma:.3f}s)")
            toks = self.shape.global_batch * self.shape.seq_len
            self.metrics_log.append(
                {"step": step, "loss": loss, "dt": dt,
                 "tokens_per_s": toks / dt})
            if step % opts.log_every == 0 and self.lead:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"{toks / dt:,.0f} tok/s")
            step += 1
            if opts.ckpt_every and step % opts.ckpt_every == 0:
                self.saver.save(opts.ckpt_dir, step,
                                {"params": params, "opt": opt_state},
                                extra={"next_step": step,
                                       "arch": self.cfg.name})
        self.saver.wait()
        return params, opt_state


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--model-axis", type=int, default=0,
                    help="train on a (world / m, m) mesh of the world "
                         "that exists (torchrun's, else one rank); 0: "
                         "no mesh (a world of one only)")
    args = ap.parse_args()

    cfg = get_config(args.arch, reduced=args.reduced)
    shape = ShapeSpec("cli", args.seq, args.batch, "train")
    mesh = cli_mesh(args.model_axis, args.device)
    trainer = Trainer(cfg, shape, device=args.device, mesh=mesh,
                      options=TrainOptions(steps=args.steps,
                                           ckpt_every=args.ckpt_every,
                                           ckpt_dir=args.ckpt_dir))
    trainer.run()
    if mesh is not None and mesh.get_rank() != 0:
        return
    losses = [m["loss"] for m in trainer.metrics_log]
    # step wall times past the first (which builds the kernels)
    dts = sorted(m["dt"] for m in trainer.metrics_log[1:]) or [float("nan")]
    print(f"done: loss {losses[0]:.3f} -> {losses[-1]:.3f}, "
          f"{len(trainer.straggler_steps)} straggler steps, "
          f"{trainer.failures} failures recovered; step ms after the "
          f"first: median {1e3 * dts[len(dts) // 2]:.2f}, least "
          f"{1e3 * dts[0]:.2f}")


if __name__ == "__main__":
    main()
