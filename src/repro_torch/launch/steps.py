"""Step builders: port of ``repro.launch.steps``.

``make_train_step`` without a mesh returns the one-device train step
itself, run eagerly.  With a mesh, every builder returns a
``StepBundle``: the step function, its abstract arguments (``meta``
tensors, no storage), the ``NamedSharding`` trees of its inputs and
outputs, and the rules it runs under.  ``bundle.place(*args)`` lays
full tensors out by ``in_shardings`` (each rank taking its block), and
``bundle(*args)`` runs the step on them.  The dry run
(``launch.dryrun``) calls the same bundle on its abstract arguments over a
fake process group; the trainer and the server feed real tensors through
it.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any, Callable

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from .. import tree as T
from ..configs.shapes import ShapeSpec, input_specs
from ..configs.shapes import enc_len as enc_frames
from ..convert import resolve_device
from ..models import encdec, lm
from ..models.config import ArchConfig
from ..optim import adamw
from ..parallel import sharding as SH
from ..parallel.sharding import (ShardingRules, make_rules,
                                 params_shardings, use_rules)


@dataclass
class StepBundle:
    name: str
    fn: Callable
    abstract_args: tuple
    in_shardings: tuple
    out_shardings: Any
    rules: ShardingRules | None = None
    statics: dict = field(default_factory=dict)

    def place(self, *args) -> tuple:
        """``args`` laid out by ``in_shardings`` (a ``None`` sharding, or
        a non-tensor argument, is kept as it is)."""
        return tuple(a if sh is None or not _has_tensors(a)
                     else SH.distribute_like(a, sh)
                     for a, sh in zip(args, self.in_shardings))

    def __call__(self, *args):
        return self.fn(*args)


def _has_tensors(tree) -> bool:
    return any(isinstance(t, torch.Tensor) for t in T.leaves(tree))


def _model_mod(cfg: ArchConfig):
    return encdec if cfg.is_encdec else lm


def _batch_shardings(cfg: ArchConfig, shape: ShapeSpec,
                     rules: ShardingRules) -> dict[str, SH.NamedSharding]:
    out = {}
    for name, t in input_specs(cfg, shape).items():
        axes = ("batch",) + (None,) * (t.dim() - 1)
        out[name] = rules.sharding_for(axes, tuple(t.shape))
    return out


def abstract_state(cfg: ArchConfig, mesh: DeviceMesh,
                   opt: adamw.OptConfig | None) -> dict:
    """Abstract (``meta``, fp32) parameters and optimizer state with their
    shardings for one arch.  ZeRO-1: the moments also shard their "embed"
    axis over data where the parameters do not (no FSDP)."""
    rules = make_rules(cfg, mesh)
    aparams, specs = _model_mod(cfg).abstract_init(cfg)
    out = {"rules": rules, "params": aparams, "param_specs": specs,
           "param_shardings": params_shardings(rules, aparams, specs)}
    if opt is not None:
        aopt = adamw.init_state(aparams, opt)
        opt_specs = adamw.state_specs(specs)
        zrules = make_rules(cfg, mesh)
        if "data" in zrules.shape:
            zrules.rules["embed"] = "data"
        out |= {"opt": aopt, "opt_shardings": {
            "m": params_shardings(zrules, aopt["m"], opt_specs["m"]),
            "v": params_shardings(zrules, aopt["v"], opt_specs["v"]),
            "step": None}}
    return out


# ---------------------------------------------------------------- train step

def _micro(t: torch.Tensor, mb: int, i: int) -> torch.Tensor:
    """Microbatch ``i`` of ``mb`` of a batch tensor.  A DTensor splits its
    own rows: microbatch i takes 1/mb of every data shard, so the mean
    gradient is the meshless one, summed in another order."""
    if isinstance(t, DTensor):
        loc = t.to_local()
        part = loc.reshape(mb, loc.shape[0] // mb, *loc.shape[1:])[i]
        return DTensor.from_local(part, t.device_mesh, t.placements,
                                  run_check=False)
    return t.reshape(mb, t.shape[0] // mb, *t.shape[1:])[i]


def _as_param(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A gradient in its parameter's layout (a partial sum reduced)."""
    if isinstance(g, DTensor) and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_train_step(cfg: ArchConfig, shape: ShapeSpec,
                    opt: adamw.OptConfig | None = None,
                    device: str | torch.device | None = None,
                    mesh: DeviceMesh | None = None, *,
                    plain: bool = False) -> Callable | StepBundle:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "lr", "grad_norm"})``: the loss (``lm.loss_fn``, or
    ``encdec.loss_fn`` with the batch's frames), its gradients by autograd
    and one AdamW update (``adamw.apply_updates``, in place).  With
    ``cfg.microbatch`` = mb > 1 the batch splits into mb microbatches in
    order, their gradients summed into fp32 accumulators, then the mean
    cast to each parameter's dtype, and the loss the mean of theirs (the
    reference's scan, ``steps.py:111-134``).  Metrics stay 0-d tensors on
    the device.  ``device=None`` means the CUDA card.

    With ``mesh`` the step runs under the arch's rules on DTensors
    (parameters by ``param_specs``, ZeRO-1 moments, batch rows over the
    data axes) and comes in a ``StepBundle``; each gradient is reduced to
    its parameter's layout before the update, and the loss comes back
    whole on every rank."""
    opt = adamw.for_arch(opt, cfg)
    dev = resolve_device(device)
    mb = max(int(cfg.microbatch), 1)
    if shape.global_batch % mb:
        raise ValueError(f"{cfg.name}: batch {shape.global_batch} does not "
                         f"split into {mb} microbatches")

    def loss(params, batch):
        if cfg.is_encdec:
            return encdec.loss_fn(cfg, params, batch["frames"],
                                  batch["tokens"], batch["labels"],
                                  plain=plain)
        return lm.loss_fn(cfg, params, batch["tokens"], batch["labels"],
                          plain=plain)

    def train_step(params, opt_state, batch):
        leaves = T.leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        # on a mesh each gradient takes its parameter's layout as soon as
        # it is computed: left a partial sum over the data axis (an FSDP
        # weight's, gathered for its product) it holds twice the
        # parameter's block until the last gradient arrives
        hooks = [p.register_hook(functools.partial(_as_param, p=p))
                 for p in leaves if isinstance(p, DTensor)]
        try:
            if mb == 1:
                total = loss(params, batch)
                grads = torch.autograd.grad(total, leaves)
            else:
                acc = [torch.zeros_like(p, dtype=torch.float32)
                       for p in leaves]
                total = torch.zeros((), dtype=torch.float32, device=dev)
                for i in range(mb):
                    part = {k: _micro(v, mb, i) for k, v in batch.items()}
                    l = loss(params, part)
                    for a, g in zip(acc, torch.autograd.grad(l, leaves)):
                        a.add_(_as_param(g, a))
                    total = total + l.detach()
                total = total / mb
                grads = [(a / mb).to(p.dtype) for a, p in zip(acc, leaves)]
        finally:
            for h in hooks:
                h.remove()
        grads = [_as_param(g, p) for g, p in zip(grads, leaves)]
        params, opt_state, om = adamw.apply_updates(
            params, T.unflatten(params, list(grads)), opt_state, opt)
        return params, opt_state, {"loss": total.detach(), **om}

    if mesh is None:
        return train_step
    st = abstract_state(cfg, mesh, opt)
    rules = st["rules"]

    def sharded_step(params, opt_state, batch):
        with use_rules(rules):
            params, opt_state, metrics = train_step(params, opt_state, batch)
        return params, opt_state, SH.full(metrics)

    return StepBundle(
        name=f"{cfg.name}:{shape.name}:train",
        fn=sharded_step,
        abstract_args=(st["params"], st["opt"], input_specs(cfg, shape)),
        in_shardings=(st["param_shardings"], st["opt_shardings"],
                      _batch_shardings(cfg, shape, rules)),
        out_shardings=(st["param_shardings"], st["opt_shardings"], None),
        rules=rules,
        statics={"opt": opt, "state": st},
    )


# -------------------------------------------------------------- prefill step

def make_prefill_step(cfg: ArchConfig, mesh: DeviceMesh, shape: ShapeSpec,
                      *, plain: bool = False) -> StepBundle:
    """``prefill_step(params, batch) -> (last logits (B, V), cache)``
    under the arch's rules; the cache is laid out by ``_cache_shardings``
    (the prompt fills it: max_len = the shape's seq_len)."""
    st = abstract_state(cfg, mesh, None)
    rules = st["rules"]

    def prefill_step(params, batch):
        with use_rules(rules):
            if cfg.is_encdec:
                return encdec.prefill(cfg, params, batch["frames"],
                                      batch["tokens"], plain=plain)
            return lm.prefill(cfg, params, batch["tokens"], plain=plain)

    cache_sh, _ = _cache_shardings(cfg, rules, shape.global_batch,
                                   shape.seq_len,
                                   enc_len=enc_frames(cfg, shape))
    return StepBundle(
        name=f"{cfg.name}:{shape.name}:prefill",
        fn=prefill_step,
        abstract_args=(st["params"], input_specs(cfg, shape)),
        in_shardings=(st["param_shardings"],
                      _batch_shardings(cfg, shape, rules)),
        out_shardings=(None, cache_sh),
        rules=rules,
        statics={"state": st},
    )


# --------------------------------------------------------------- decode step

def _cache_shardings(cfg: ArchConfig, rules: ShardingRules, batch: int,
                     max_len: int, enc_len: int = 0):
    """(the cache's ``NamedSharding`` tree, the cache on ``meta``), with
    the reference's sequence-parallel fallbacks (``sharding.
    cache_layout``: where the batch or the KV heads do not divide their
    mesh axes, the sequence axis takes the freed ones, ``kv_seq``)."""
    if cfg.is_encdec:
        acache = encdec.init_cache(cfg, batch, max_len, enc_len,
                                   device="meta")
        cspecs = encdec.cache_specs(cfg)
    else:
        acache = lm.init_cache(cfg, batch, max_len, device="meta")
        cspecs = lm.cache_specs(cfg)
    cspecs = SH.cache_layout(cfg, rules, cspecs, batch, max_len)
    return params_shardings(rules, acache, cspecs), acache


def make_decode_step(cfg: ArchConfig, mesh: DeviceMesh, shape: ShapeSpec,
                     *, plain: bool = False) -> StepBundle:
    """``serve_step(params, cache, tokens (B, 1), pos) -> (logits (B, V),
    cache)`` under the arch's rules, the cache (max_len = the shape's
    seq_len) updated in place.  The abstract ``pos`` is the cache's last
    row, so a dry run reads the whole context."""
    st = abstract_state(cfg, mesh, None)
    rules = st["rules"]
    B, S = shape.global_batch, shape.seq_len
    cache_sh, acache = _cache_shardings(cfg, rules, B, S,
                                        enc_len=enc_frames(cfg, shape))
    model = _model_mod(cfg)

    def serve_step(params, cache, tokens, pos):
        with use_rules(rules):
            return model.decode_step(cfg, params, cache, tokens, pos,
                                     plain=plain)

    tok = torch.empty((B, 1), dtype=torch.int32, device="meta")
    return StepBundle(
        name=f"{cfg.name}:{shape.name}:decode",
        fn=serve_step,
        abstract_args=(st["params"], acache, tok, S - 1),
        in_shardings=(st["param_shardings"], cache_sh,
                      rules.sharding_for(("batch", None), (B, 1)), None),
        out_shardings=(None, cache_sh),
        rules=rules,
        statics={"state": st},
    )


def make_step(cfg: ArchConfig, mesh: DeviceMesh, shape: ShapeSpec,
              opt: adamw.OptConfig | None = None, *, plain: bool = False,
              device: str | torch.device | None = None) -> StepBundle:
    if shape.kind == "train":
        return make_train_step(cfg, shape, opt, device, mesh, plain=plain)
    if shape.kind == "prefill":
        return make_prefill_step(cfg, mesh, shape, plain=plain)
    return make_decode_step(cfg, mesh, shape, plain=plain)
