"""The train step on one device: port of ``repro.launch.steps``'
``make_train_step``.

The reference returns a ``StepBundle`` (a jit-able function with its
abstract arguments and shardings for a mesh); the port returns the step
function itself, run eagerly on one device.  The prefill and decode
bundles, and every sharding, wait for the multi-device layer (ROADMAP
A.6).
"""

from __future__ import annotations

from typing import Callable

import torch

from .. import tree as T
from ..configs.shapes import ShapeSpec
from ..convert import resolve_device
from ..models import encdec, lm
from ..models.config import ArchConfig
from ..optim import adamw


def make_train_step(cfg: ArchConfig, shape: ShapeSpec,
                    opt: adamw.OptConfig | None = None,
                    device: str | torch.device | None = None) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "lr", "grad_norm"})``: the loss (``lm.loss_fn``, or
    ``encdec.loss_fn`` with the batch's frames), its gradients by autograd
    and one AdamW update (``adamw.apply_updates``, in place).  With
    ``cfg.microbatch`` = mb > 1 the batch splits into mb microbatches in
    order, their gradients summed into fp32 accumulators, then the mean
    cast to each parameter's dtype, and the loss the mean of theirs (the
    reference's scan, ``steps.py:111-134``).  Metrics stay 0-d tensors on
    the device.  ``device=None`` means the CUDA card."""
    opt = adamw.for_arch(opt, cfg)
    dev = resolve_device(device)
    mb = max(int(cfg.microbatch), 1)
    if shape.global_batch % mb:
        raise ValueError(f"{cfg.name}: batch {shape.global_batch} does not "
                         f"split into {mb} microbatches")

    def loss(params, batch):
        if cfg.is_encdec:
            return encdec.loss_fn(cfg, params, batch["frames"],
                                  batch["tokens"], batch["labels"])
        return lm.loss_fn(cfg, params, batch["tokens"], batch["labels"])

    def train_step(params, opt_state, batch):
        leaves = T.leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        if mb == 1:
            total = loss(params, batch)
            grads = torch.autograd.grad(total, leaves)
        else:
            acc = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
            total = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(mb):
                part = {k: v.reshape(mb, v.shape[0] // mb, *v.shape[1:])[i]
                        for k, v in batch.items()}
                l = loss(params, part)
                for a, g in zip(acc, torch.autograd.grad(l, leaves)):
                    a.add_(g)
                total = total + l.detach()
            total = total / mb
            grads = [(a / mb).to(p.dtype) for a, p in zip(acc, leaves)]
        params, opt_state, om = adamw.apply_updates(
            params, T.unflatten(params, list(grads)), opt_state, opt)
        return params, opt_state, {"loss": total.detach(), **om}

    return train_step
