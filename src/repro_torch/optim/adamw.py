"""AdamW with warmup + cosine schedule, global-norm clipping, and
optionally bf16 moments (``ArchConfig.moment_dtype``).  An ``OptConfig``
whose ``moment_dtype`` is None takes the arch config's where a train
step is built (``for_arch``), fp32 where none is given.

Port of ``repro.optim.adamw``.  The state is ``{"m": tree, "v": tree,
"step": int32 0-d tensor}`` with the parameters' structure;
``state_specs`` gives its logical axes.  On a mesh the leaves are
DTensors: each rank updates its own shard (a moment laid out otherwise
than its parameter, ZeRO-1's, takes the parameter's block of its own
layout, and the updated block is gathered back), and the global norm
sums each rank's squares of the shards it owns in one all-reduce, so that
a replicated leaf counts once.  The
schedule and bias corrections are fp32 0-d tensors on the step's device,
as the reference computes them in fp32, so a step reads nothing back to
the host.  ``apply_updates`` updates the parameters and the moments in
place (the reference returns new arrays): at full width a copy of every
leaf would cost as much again as the parameters.

Weight decay falls where the reference's leaf has two dims or more.  The
reference stacks each layer's leaves over ``n_blocks``, so a layer's norm
gain, ``A_log``, ``dt_bias`` and biases are 2-D there and decayed; the
port keeps one dict per layer in a list, where the same leaves are 1-D.
So the port decays every leaf under a list (``layers``, encdec's
``encoder`` / ``decoder``) and the others (``embed``, ``lm_head``,
``final_norm``, ``enc_norm``) by their own ndim (``decay_mask``).
"""

from __future__ import annotations

import math
import dataclasses
from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Replicate

from .. import tree as T
from ..parallel.sharding import map_specs, zeros_placed


@dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    min_lr: float = 3e-5
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str | None = None   # None: the arch config's


def for_arch(cfg: OptConfig | None, arch) -> OptConfig:
    """``cfg`` (None: the defaults) with the arch config ``arch``'s
    ``moment_dtype`` where it names none."""
    cfg = cfg or OptConfig()
    if cfg.moment_dtype is None:
        cfg = dataclasses.replace(cfg, moment_dtype=arch.moment_dtype)
    return cfg


def lr_at(cfg: OptConfig, step: torch.Tensor | int) -> torch.Tensor:
    """Linear warmup to ``peak_lr``, then a cosine to ``min_lr`` at
    ``total_steps``; fp32."""
    step = torch.as_tensor(step).float()
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    decay_steps = max(cfg.total_steps - cfg.warmup_steps, 1)
    frac = ((step - cfg.warmup_steps) / decay_steps).clamp(0.0, 1.0)
    cos = cfg.min_lr + 0.5 * (cfg.peak_lr - cfg.min_lr) \
        * (1.0 + torch.cos(math.pi * frac))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_state(params, cfg: OptConfig, shardings=None) -> dict:
    """Zero moments of ``params``' shapes in ``cfg.moment_dtype`` and step
    0.  With ``shardings`` (a train step bundle's ``in_shardings[1]``:
    ``{"m": tree, "v": tree, ...}`` of ``NamedSharding``) each moment is
    made in its own layout (ZeRO-1's), every rank allocating its block
    alone."""
    mdt = getattr(torch, cfg.moment_dtype or "float32")
    first = T.leaves(params)[0]

    def zeros(key):
        if shardings is None:
            return T.tree_map(lambda p: torch.zeros_like(p, dtype=mdt),
                              params)
        return map_specs(lambda p, sh: zeros_placed(
            tuple(p.shape), mdt, first.device, sh), params, shardings[key])
    return {"m": zeros("m"), "v": zeros("v"),
            "step": torch.zeros((), dtype=torch.int32, device=first.device)}


def state_specs(param_specs):
    """The state's logical axes mirror the parameters' (``step``: a
    scalar)."""
    return {"m": param_specs, "v": param_specs, "step": ()}


def decay_mask(params) -> dict:
    """True for each leaf the reference decays: every leaf under a list
    (stacked over the layers there), else a leaf of ndim >= 2."""
    def mark(tree, stacked):
        if isinstance(tree, dict):
            return {k: mark(v, stacked) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(mark(t, True) for t in tree)
        return stacked or tree.ndim >= 2
    return mark(params, False)


def _owned_squares(g: DTensor) -> torch.Tensor:
    """The fp32 sum of squares of this rank's shard of ``g``, or 0 where
    another rank holds the same block (a lower coordinate on a mesh dim
    ``g`` is replicated over)."""
    coord = g.device_mesh.get_coordinate()
    local = g.to_local().float().square().sum()
    owner = all(coord[md] == 0 for md, p in enumerate(g.placements)
                if isinstance(p, Replicate))
    return local if owner else torch.zeros_like(local)


def _clip_scale(grads, max_norm: float):
    """(the global L2 norm of ``grads``, the factor that clips it to
    ``max_norm``), both fp32 0-d tensors (on each rank, for DTensor
    gradients: one all-reduce of the owned squares)."""
    leaves = T.leaves(grads)
    if leaves and isinstance(leaves[0], DTensor):
        total = sum(_owned_squares(g) for g in leaves)
        gnorm = torch.sqrt(funcol.all_reduce(total, "sum", dist.group.WORLD))
    else:
        gnorm = torch.sqrt(sum(g.float().square().sum() for g in leaves))
    return gnorm, torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global L2 norm of at most ``max_norm``, the norm
    before scaling as an fp32 0-d tensor)."""
    gnorm, scale = _clip_scale(grads, max_norm)

    def clip(g):
        if isinstance(g, DTensor):     # each rank scales its own shard
            return DTensor.from_local((g.to_local().float() * scale).to(
                g.dtype), g.device_mesh, g.placements, run_check=False)
        return (g.float() * scale).to(g.dtype)
    return T.tree_map(clip, grads), gnorm


# Leaves of more elements than this are updated a slice of a flat view at
# a time: AdamW is element-wise, so the numbers are the whole leaf's to
# the bit, and the update's fp32 temporaries (about six the size of what
# it updates) stay near 1.5 GB where dbrx-132b's 1.06e9-element expert
# leaves would take 25 GB whole.
SLICE = 1 << 26


def _update(p, g, m, v, decay: bool, scale, lr, bc1, bc2,
            cfg: OptConfig) -> None:
    """AdamW on one slice of a leaf's flat view, in place."""
    b1, b2 = cfg.b1, cfg.b2
    g32 = (g.float() * scale).to(g.dtype).float()
    m32 = m if m.dtype == torch.float32 else m.float()
    v32 = v if v.dtype == torch.float32 else v.float()
    m32.mul_(b1).add_((1 - b1) * g32)
    v32.mul_(b2).add_((1 - b2) * g32 * g32)
    delta = (m32 / bc1).div_((v32 / bc2).sqrt_().add_(cfg.eps))
    if decay:   # decoupled weight decay
        delta.add_(cfg.weight_decay * p.float())
    p.copy_(p.float() - lr * delta)
    if m32 is not m:
        m.copy_(m32)
        v.copy_(v32)


@torch.no_grad()
def apply_updates(params, grads, state: dict, cfg: OptConfig):
    """One AdamW step: returns ``(params, state, {"lr", "grad_norm"})``,
    the parameters and moments updated in place.  The gradients are
    clipped leaf by leaf as they are used (``clip_by_global_norm``'s
    numbers, without a clipped copy of every gradient), ``SLICE``
    elements of a leaf at a time."""
    gnorm, scale = _clip_scale(grads, cfg.grad_clip)
    step = state["step"] + 1
    lr = lr_at(cfg, step)
    bc1 = 1.0 - cfg.b1 ** step.float()
    bc2 = 1.0 - cfg.b2 ** step.float()
    for p, g, m, v, decay in zip(T.leaves(params), T.leaves(grads),
                                 T.leaves(state["m"]), T.leaves(state["v"]),
                                 T.leaves(decay_mask(params))):
        if isinstance(p, DTensor):
            _update_shard(p, g, m, v, decay, scale, lr, bc1, bc2, cfg)
        else:
            _update_leaf(p, g, m, v, decay, scale, lr, bc1, bc2, cfg)
    new_state = {"m": state["m"], "v": state["v"], "step": step}
    return params, new_state, {"lr": lr, "grad_norm": gnorm}


def _update_leaf(p, g, m, v, decay, scale, lr, bc1, bc2, cfg) -> None:
    """AdamW on one whole leaf, ``SLICE`` elements of its flat view at a
    time."""
    flat = [t.view(-1) for t in (p, m, v)] + [g.reshape(-1)]
    for s in range(0, p.numel(), SLICE):
        fp, fm, fv, fg = (t[s:s + SLICE] for t in flat)
        _update(fp, fg, fm, fv, decay, scale, lr, bc1, bc2, cfg)


def _update_shard(p: DTensor, g: DTensor, m: DTensor, v: DTensor, decay,
                  scale, lr, bc1, bc2, cfg) -> None:
    """AdamW on this rank's shard.  The moments' layout rules: where the
    parameter's differs (ZeRO-1), the parameter and gradient are taken in
    the moments' layout (a slice of a replicated block, no collective),
    updated there, and the parameter gathered back to its own layout."""
    mesh, pl = m.device_mesh, m.placements
    pm = p.to_local() if p.placements == pl \
        else p.redistribute(mesh, pl).to_local().clone()
    gm = g.redistribute(mesh, pl).to_local() if g.placements != pl \
        else g.to_local()
    _update_leaf(pm, gm, m.to_local(), v.to_local(), decay, scale, lr, bc1,
                 bc2, cfg)
    if p.placements != pl:
        p.to_local().copy_(DTensor.from_local(pm, mesh, pl, run_check=False)
                           .redistribute(mesh, p.placements).to_local())
