"""Logical-axis sharding rules (DP / FSDP / TP / EP / vocab-parallel) on a
``torch.distributed`` ``DeviceMesh``: port of
``repro.parallel.sharding``.

Every parameter has a tuple of *logical* axis names (``lm.param_specs``,
``encdec.param_specs``: the reference's specs without the stacked
leading "layers", since the port keeps one dict a layer).  This module
maps logical names to mesh axes for one (config, mesh) pair:

  batch        -> (pod, data)            data parallel
  vocab        -> model                  vocab-parallel embed / lm head
  heads, kv_heads, q_dim, kv_dim, mlp, ssm_inner -> model   (TP)
  experts      -> model                  expert parallel
  embed        -> data when cfg.fsdp     (ZeRO-3-style parameter shards)
  layers, seq, * -> None

A spec is the reference's ``PartitionSpec`` as a tuple: one entry a
tensor dim, each None, a mesh axis name or a tuple of names.
``ShardingRules.placements`` turns it into DTensor placements, one a mesh
dim: ``Shard(i)`` where tensor dim ``i`` names that mesh axis, else
``Replicate()``.  A logical axis whose dim does not divide its mesh axes
falls back to replication and is recorded in ``fallbacks`` (e.g.
kv_heads=8 on a 16-way model axis: replicated KV).

``distribute`` places a tree of full tensors on the mesh as DTensors, each
rank taking its own slice (every rank holds the same seeded full tree, so
nothing is scattered).  Inside ``use_rules`` the model code's
``constrain`` calls redistribute activations to the rules' placements
(the reference's ``with_sharding_constraint``) and plain tensors mix with
DTensors as replicated ones (``implicit_replication``); outside it, or on
a plain tensor, ``constrain`` returns its argument, so every one-device
path is unchanged.
"""

from __future__ import annotations

import contextlib
import dataclasses
from collections.abc import Mapping
from typing import Any

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import (implicit_replication,
                                                   local_map)

from .. import tree as T


def mesh_shape(mesh: DeviceMesh) -> dict[str, int]:
    """{axis name: size}, the reference's ``mesh.shape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """The reference's ``NamedSharding``: a mesh, the spec and the
    DTensor placements it gives."""
    mesh: DeviceMesh
    spec: tuple
    placements: tuple


def _flat(mesh_axes) -> tuple[str, ...]:
    if mesh_axes is None:
        return ()
    return (mesh_axes,) if isinstance(mesh_axes, str) else tuple(mesh_axes)


@dataclasses.dataclass
class ShardingRules:
    mesh: DeviceMesh
    rules: dict[str, Any]                  # logical name -> mesh axis/axes
    fallbacks: list[tuple[str, int, int]] = dataclasses.field(
        default_factory=list)              # (axis, dim, mesh_size) replaced

    @property
    def shape(self) -> dict[str, int]:
        return mesh_shape(self.mesh)

    def axis_size(self, mesh_axes) -> int:
        n = 1
        for a in _flat(mesh_axes):
            n *= self.shape[a]
        return n

    def spec_for(self, axes: tuple[str | None, ...],
                 shape: tuple[int, ...] | None = None) -> tuple:
        out = []
        used: set[str] = set()
        for i, name in enumerate(axes):
            mesh_axes = self.rules.get(name) if name else None
            if mesh_axes is not None and shape is not None:
                size = self.axis_size(mesh_axes)
                if shape[i] % size != 0:
                    self.fallbacks.append((name, shape[i], size))
                    mesh_axes = None
            if mesh_axes is not None:
                # one tensor dim a mesh axis: the first logical axis wins
                # (MoE experts -> EP; the expert-internal mlp dim stays
                # whole)
                if any(a in used for a in _flat(mesh_axes)):
                    mesh_axes = None
                else:
                    used.update(_flat(mesh_axes))
            if isinstance(mesh_axes, tuple) and len(mesh_axes) == 1:
                mesh_axes = mesh_axes[0]   # as PartitionSpec writes it
            out.append(mesh_axes)
        return tuple(out)

    def placements(self, spec: tuple) -> tuple:
        """DTensor placements of ``spec``, one a mesh dim."""
        out = []
        for name in self.mesh.mesh_dim_names:
            dims = [i for i, s in enumerate(spec) if name in _flat(s)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)

    def sharding_for(self, axes, shape=None) -> NamedSharding:
        spec = self.spec_for(tuple(axes), shape)
        return NamedSharding(self.mesh, spec, self.placements(spec))


def make_rules(cfg, mesh: DeviceMesh) -> ShardingRules:
    """The logical -> mesh mapping for one architecture."""
    axes = mesh_shape(mesh)
    dp = tuple(a for a in ("pod", "data") if a in axes)
    tp = "model" if "model" in axes else None
    rules = {
        "batch": dp if len(dp) > 1 else (dp[0] if dp else None),
        "seq": None,
        "embed": ("data" if (cfg is not None and getattr(cfg, "fsdp", False)
                             and "data" in axes) else None),
        "embed_act": None,
        "vocab": tp,
        "q_dim": tp,
        "kv_dim": tp,
        "heads": tp,
        "kv_heads": tp,
        "mlp": tp,
        "experts": tp,
        "ssm_inner": tp,
        "ssm_heads": tp,
        "conv_dim": tp,
        "layers": None,
        "ssm_state": None,
        "head_dim": None,
        "capacity": None,
        # sequence-parallel TP (opt-in per config)
        "seq_sp": (tp if (cfg is not None
                          and getattr(cfg, "seq_parallel", False)) else None),
    }
    # The reference's remedies for uneven heads (context-parallel q-seq,
    # attention-DP) were refuted there; both alias the plain rules.
    rules["seq_ctx"] = None
    rules["batch_attn"] = rules["batch"]
    return ShardingRules(mesh, rules)


def map_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over ``tree``'s leaves and the matching specs
    (tuples of logical axes) of the spec tree ``specs``."""
    if isinstance(tree, Mapping):
        return {k: map_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_specs(fn, t, s) for t, s in zip(tree, specs))
    return fn(tree, specs)


def params_shardings(rules: ShardingRules, params, specs):
    """A ``NamedSharding`` tree matching ``params``."""
    return map_specs(lambda p, s: rules.sharding_for(s, tuple(p.shape)),
                     params, specs)


def abstract_params(params):
    """The tree as tensors on the ``meta`` device (shapes and dtypes, no
    storage): the reference's ``ShapeDtypeStruct`` tree."""
    return T.tree_map(lambda x: torch.empty(tuple(x.shape), dtype=x.dtype,
                                            device="meta"), params)


def block_index(shape: tuple[int, ...], mesh: DeviceMesh,
                placements) -> tuple[slice, ...]:
    """This rank's block of a tensor of ``shape`` under ``placements``, as
    one slice a dim (mesh dims in order, each splitting what the earlier
    ones left)."""
    lo, size = [0] * len(shape), list(shape)
    coord = mesh.get_coordinate()
    for md, p in enumerate(placements):
        if isinstance(p, Shard):
            n = mesh.size(md)
            if size[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not "
                                 f"split over {n}")
            size[p.dim] //= n
            lo[p.dim] += coord[md] * size[p.dim]
    return tuple(slice(a, a + n) for a, n in zip(lo, size))


def local_slice(t: torch.Tensor, mesh: DeviceMesh, placements) -> torch.Tensor:
    """This rank's block of the full tensor ``t`` under ``placements``."""
    return t[block_index(tuple(t.shape), mesh, placements)]


def from_block(local: torch.Tensor, sharding: NamedSharding,
               shape: tuple[int, ...]) -> DTensor:
    """The DTensor of global ``shape`` whose block on this rank is
    ``local`` (no collective: every rank gives its own)."""
    return DTensor.from_local(local, sharding.mesh, sharding.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape,
                                                 device="meta").stride())


def place(t: torch.Tensor, sharding: NamedSharding,
          device: str | torch.device | None = None) -> DTensor:
    """``t`` on the mesh: a full tensor becomes this rank's slice of it
    (copied out when it is a part, so the full one can be freed; moved to
    ``device`` where given), a DTensor is redistributed."""
    if isinstance(t, DTensor):
        return t.redistribute(sharding.mesh, sharding.placements)
    local = local_slice(t, sharding.mesh, sharding.placements)
    local = local.clone() if local.numel() < t.numel() else local.contiguous()
    if device is not None:
        local = local.to(device)
    return from_block(local, sharding, tuple(t.shape))


def distribute(tree, specs, rules: ShardingRules):
    """A tree of full tensors placed on the rules' mesh by ``specs``."""
    return map_specs(lambda t, s: place(t, rules.sharding_for(
        s, tuple(t.shape))), tree, specs)


def distribute_like(tree, shardings):
    """A tree placed by a tree of ``NamedSharding`` (``None``: kept)."""
    return map_specs(lambda t, sh: t if sh is None else place(t, sh),
                     tree, shardings)


def full(tree):
    """The tree with every DTensor gathered to a full tensor (a
    collective: call it on every rank)."""
    return T.tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor)
                      else t, tree)


def _reshape_on_rank(t: DTensor, fn, in_pl, out_pl) -> DTensor:
    """``fn`` (a reshape) on this rank's block, in ``in_pl`` out to
    ``out_pl``: DTensor's own view rules refuse a split or merge across
    an uneven shard, and its backward would meet the same shard."""
    return local_map(fn, out_placements=out_pl, in_placements=(in_pl,),
                     device_mesh=t.device_mesh, redistribute_inputs=True)(t)


def split_last(t: torch.Tensor, n: int, d: int) -> torch.Tensor:
    """``t`` (..., n·d) as (..., n, d).  A DTensor keeps a shard of its
    last dim on the n heads where n divides over it, and is made whole
    along it otherwise (2 KV heads on a 4-way model axis)."""
    if not isinstance(t, DTensor):
        return t.reshape(*t.shape[:-1], n, d)
    last = t.ndim - 1
    blocks = 1
    for md, p in enumerate(t.placements):
        if isinstance(p, Shard) and p.dim == last:
            blocks *= t.device_mesh.size(md)
    keep = n % blocks == 0
    in_pl = [Replicate() if isinstance(p, Shard) and p.dim == last
             and not keep else p for p in t.placements]
    return _reshape_on_rank(
        t, lambda x: x.reshape(*x.shape[:-1], x.shape[-1] // d, d), in_pl,
        in_pl)


def merge_last(t: torch.Tensor) -> torch.Tensor:
    """``t`` (..., n, d) as (..., n·d).  A DTensor keeps a shard of the n
    heads (then on the merged dim); a shard of d is made whole."""
    if not isinstance(t, DTensor):
        return t.reshape(*t.shape[:-2], -1)
    last = t.ndim - 1
    in_pl = [Replicate() if isinstance(p, Shard) and p.dim == last else p
             for p in t.placements]
    out_pl = [Shard(last - 1) if isinstance(p, Shard) and p.dim == last - 1
              else p for p in in_pl]
    return _reshape_on_rank(t, lambda x: x.reshape(*x.shape[:-2], -1),
                            in_pl, out_pl)


# ---------------------------------------------------------------------------
# Activation constraints inside model code (no-op without a context)
# ---------------------------------------------------------------------------

_ACTIVE_RULES: list[ShardingRules] = []


def active_rules() -> ShardingRules | None:
    return _ACTIVE_RULES[-1] if _ACTIVE_RULES else None


class use_rules:
    """Context manager activating the rules in model code: ``constrain``
    redistributes, and plain tensors mix with DTensors as replicated
    ones."""

    def __init__(self, rules: ShardingRules):
        self.rules = rules
        self._stack = contextlib.ExitStack()

    def __enter__(self):
        _ACTIVE_RULES.append(self.rules)
        self._stack.enter_context(implicit_replication())
        return self.rules

    def __exit__(self, *exc):
        self._stack.close()
        _ACTIVE_RULES.pop()


def constrain(x: torch.Tensor, *axes: str | None) -> torch.Tensor:
    """``x`` redistributed to the active rules' placements for ``axes``
    (the reference's ``with_sharding_constraint``); ``x`` itself without
    rules or when it is no DTensor."""
    rules = active_rules()
    if rules is None or not isinstance(x, DTensor):
        return x
    if len(axes) != x.ndim:
        raise ValueError(f"constrain: {len(axes)} axes for rank {x.ndim}")
    pl = rules.placements(rules.spec_for(tuple(axes), tuple(x.shape)))
    if tuple(x.placements) == pl:
        return x
    return x.redistribute(x.device_mesh, pl)


# ---------------------------------------------------------------------------
# In-place cache writes (the reference's dynamic_update_slice)
# ---------------------------------------------------------------------------

def _as_placed(src: torch.Tensor, like: DTensor, placements) -> torch.Tensor:
    """This rank's block of ``src`` laid out by ``placements`` on
    ``like``'s mesh (``src`` a DTensor or a full tensor)."""
    if isinstance(src, DTensor):
        return src.redistribute(like.device_mesh, placements).to_local()
    return local_slice(src, like.device_mesh, placements)


def assign(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)`` where ``dst`` may be a DTensor (a view of a
    cache): ``src`` is laid out as ``dst`` first."""
    if not isinstance(dst, DTensor):
        dst.copy_(src)
        return
    dst.to_local().copy_(_as_placed(src, dst, dst.placements))


def write_rows(cache: torch.Tensor, rows: torch.Tensor, start: int,
               dim: int = 2) -> None:
    """``cache[..., start:start + n, ...] = rows`` along ``dim`` (the
    sequence of a (B, H, S, D) cache), in the cache's dtype.  A DTensor
    cache whose sequence is sharded (``_cache_shardings``' ``kv_seq``)
    takes on each rank the rows that fall in its block."""
    n = rows.shape[dim]
    if not isinstance(cache, DTensor):
        cache.narrow(dim, start, n).copy_(rows)
        return
    mesh = cache.device_mesh
    seq = [md for md, p in enumerate(cache.placements)
           if isinstance(p, Shard) and p.dim == dim]
    whole = tuple(Replicate() if md in seq else p
                  for md, p in enumerate(cache.placements))
    src = _as_placed(rows, cache, whole)
    local = cache.to_local()
    coord, block = mesh.get_coordinate(), 0
    for md in seq:
        block = block * mesh.size(md) + coord[md]
    lo = block * local.shape[dim]
    a, b = max(start, lo), min(start + n, lo + local.shape[dim])
    if a < b:
        local.narrow(dim, a - lo, b - a).copy_(src.narrow(dim, a - start,
                                                           b - a))


# ---------------------------------------------------------------------------
# Decode caches on the mesh
# ---------------------------------------------------------------------------

def _map_dicts(fn, tree, *rest):
    if isinstance(tree, Mapping):
        return {k: _map_dicts(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def cache_layout(cfg, rules: ShardingRules, cspecs: dict, batch: int,
                 max_len: int) -> dict:
    """Cache specs with the reference's sequence-parallel fallbacks
    (``repro.launch.steps._cache_shardings``).

    A KV cache wants (batch -> data, kv_heads -> model); where either is
    indivisible (kv_heads=8 on a 16-way model axis; batch=1 for
    long_500k) the *sequence* axis takes over the freed mesh axes (rule
    ``kv_seq``, set on ``rules``): split-KV decode, the flash-decoding
    layout.  Attention then gathers the cache's rows (``kernels.ops``),
    and ``write_rows`` writes each rank's block."""
    dp = rules.axis_size(rules.rules.get("batch"))
    tp = rules.axis_size(rules.rules.get("kv_heads"))
    shape = rules.shape
    seq_axes: list[str] = []
    batch_bad = batch % max(dp, 1) != 0
    kv_eff = cfg.n_kv_heads * getattr(cfg, "kv_cache_repeat", 1)
    kv_bad = kv_eff > 0 and kv_eff % max(tp, 1) != 0
    if batch_bad and "data" in shape:
        seq_axes.append("data")
    if kv_bad and "model" in shape:
        seq_axes.append("model")
    seq_total = 1
    for a in seq_axes:
        seq_total *= shape[a]
    if seq_axes and max_len % seq_total == 0:
        rules.rules["kv_seq"] = tuple(seq_axes)

        def respec(axes):
            axes = list(axes)
            if batch_bad:
                axes[1] = None
            if len(axes) == 5 and axes[2] == "kv_heads":
                if kv_bad:
                    axes[2] = None
                axes[3] = "kv_seq"
            return tuple(axes)
    elif batch_bad:
        def respec(axes):
            return (axes[0], None, *axes[2:])
    else:
        return cspecs
    return _map_dicts(respec, cspecs)


def zeros_placed(shape: tuple, dtype: torch.dtype, device,
                 sharding: NamedSharding) -> DTensor:
    """A DTensor of zeros, each rank allocating its block alone."""
    local = local_slice(torch.empty(shape, device="meta"), sharding.mesh,
                        sharding.placements)
    return from_block(torch.zeros(local.shape, dtype=dtype, device=device),
                      sharding, shape)


def zeros_tree(shapes: dict, cspecs: dict, cfg, batch: int, max_len: int,
               device) -> dict:
    """Zeros for a cache given as {..: (shape, dtype)} dicts: plain
    tensors, or under active rules DTensors laid out by
    ``cache_layout``."""
    rules = active_rules()
    if rules is None:
        return _map_dicts(lambda sd: torch.zeros(sd[0], dtype=sd[1],
                                                 device=device), shapes)
    specs = cache_layout(cfg, rules, cspecs, batch, max_len)
    return _map_dicts(lambda sd, s: zeros_placed(
        sd[0], sd[1], device, rules.sharding_for(s, sd[0])), shapes, specs)
