"""Decoder-only language model over a repeating block pattern: the dense
archs (qwen3, qwen1.5, internlm2, nemotron, and qwen2-vl with M-RoPE),
the MoE archs (llama4-maverick, dbrx), the pure-SSM mamba2 and the
hybrid jamba.

Port of ``repro.models.lm``: every layer pattern, a mixer ``attn`` or
``ssm`` and an FFN ``dense``, ``moe`` or ``none``.  The reference scans
over the stacked ``blocks/pos{i}`` leaves; the port keeps one dict per
layer in ``params["layers"]`` (layer ``i`` is block ``i // pattern_len``,
pattern position ``i % pattern_len``) and loops over them in Python.  The
decode cache keeps the reference's layout under ``pos{i}``: for an
attention position one ``(n_blocks, B, Hkv, max_len, D)`` tensor each
for k and v, for an SSM position the conv window ``(n_blocks, B, K-1,
conv_dim)`` in the compute dtype and the fp32 SSD state ``(n_blocks, B,
H, P, N)``.  Prefill and decode write it in place (slice assignment)
where the reference's ``dynamic_update_slice`` builds new arrays: the
cache passed in is the cache returned.

Entry points:
  init(cfg, gen, device=None, rules=None)      -> params (fp32)
  cast_params(cfg, params)                     -> params for compute
  init_cast(cfg, gen, device=None, rules=None) -> cast_params(init(...)),
                                                  one fp32 item at a time
  forward(cfg, params, tokens, positions=None) -> (logits (B, S, V) fp32,
                                                  MoE aux loss)
  loss_fn(cfg, params, tokens, labels)         -> nll + z-loss + aux
  init_cache(cfg, batch, max_len, device=...)  -> cache
  prefill(cfg, params, tokens, max_len)        -> (logits (B, V), cache)
  decode_step(cfg, params, cache, tokens, pos) -> (logits (B, V), cache)

``device=None`` means the CUDA card and raises without one.  ``plain``
runs the norms, attention and the SSD scan on their plain versions
instead of the kernels, and the MoE FFN in the reference's one-hot
einsum form.  ``forward`` sums the MoE aux loss over the layers, as the
reference does, and ``loss_fn`` adds it; ``prefill`` and ``decode_step``
drop it.  ``cfg.remat`` recomputes each layer in the backward
(``torch.utils.checkpoint``) under ``cfg.remat_policy``: "nothing" saves
no activation of the layer, "dots" the output of every product and
"dots_nb" those of the products with no batch dimension (the 2-D weight
products; attention's and the experts' batched products are
recomputed), the reference's ``jax.checkpoint_policies``.  A prefill
routes its S tokens as one group and may drop choices past an expert's
capacity; a decode step routes groups of one token, which never drop:
so prefill + decode equals ``forward`` only where nothing dropped.
``kv_cache_repeat`` = r > 1 keeps r copies of each KV head in the cache
(the reference's ``jnp.repeat``), so that the cached heads divide a
model axis.  An encoder-decoder arch (whisper) raises ``ValueError``: it
runs through ``models.encdec``.

On a mesh (``parallel.sharding``): ``param_specs`` / ``abstract_init``
give the logical axes of the parameters (``meta`` tensors for the dry
run), ``cache_specs`` those of the cache.  Under ``sharding.use_rules``
with parameters placed by ``sharding.distribute``, or drawn onto the mesh
by ``init(..., rules=)``, every entry point runs on DTensors: the
``constrain`` calls sit at the reference's places and ``init_cache`` lays
the cache out by the rules (``sharding.cache_layout``).
"""

from __future__ import annotations

import functools
import math

import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from .. import tree as T
from ..convert import resolve_device
from ..parallel import sharding as SH
from ..parallel.sharding import constrain
from . import layers as L
from . import ssm as SSM
from .config import ArchConfig


def check_supported(cfg: ArchConfig) -> None:
    """Raise for what this module does not run: an encoder-decoder
    (``ValueError``: ``models.encdec`` runs it)."""
    if cfg.is_encdec:
        raise ValueError(f"{cfg.name} is an encoder-decoder model: run it "
                         f"through repro_torch.models.encdec")


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# ---------------------------------------------------------------------- init

def _pattern(cfg: ArchConfig, i: int):
    return cfg.pattern[i % cfg.pattern_len]


def _init_layer(cfg: ArchConfig, pat, gen: torch.Generator,
                device: torch.device, cd: torch.dtype | None = None,
                rules=None) -> dict:
    """One layer's fp32 parameters, but for a MoE layer: its mixer is cast
    to ``cd`` (None: kept fp32), and placed by ``rules`` where given,
    before the experts are drawn, and the experts are drawn into ``cd``
    one at a time (``L.init_moe``)."""
    p = {"norm1": L.init_norm(cfg, device)}
    if pat.mixer == "attn":
        p["attn"] = L.init_attention(cfg, gen, device)
    else:
        p["ssm"] = SSM.init_ssm(cfg, gen, device)
    if pat.ffn == "dense":
        p["norm2"] = L.init_norm(cfg, device)
        p["mlp"] = L.init_mlp(cfg, gen, device)
    elif pat.ffn == "moe":
        p = _cast_layer(place_tree(p, layer_specs(cfg, pat), rules), cd)
        p["norm2"] = L.init_norm(cfg, device)
        p["moe"] = L.init_moe(cfg, gen, device, cd, rules)
    # pat.ffn == "none": a mixer-only layer (mamba2)
    return p


def place_tree(tree, specs, rules):
    """``tree`` laid out on the rules' mesh by its logical axes ``specs``,
    each rank keeping its block of every leaf not placed yet (the full
    leaf can then be freed); ``tree`` itself without rules."""
    if rules is None:
        return tree
    return SH.map_specs(lambda t, s: t if isinstance(t, DTensor) else
                        SH.place(t, rules.sharding_for(s, tuple(t.shape))),
                        tree, specs)


def _draw(cfg: ArchConfig, gen: torch.Generator, device, cd,
          rules=None) -> dict:
    """``init``'s draws in ``init``'s order (embed, lm_head, final_norm,
    then each layer), each item cast to ``cd`` by ``cast_params``'s rule
    as soon as it is drawn (``cd=None`` keeps fp32), so that at most one
    fp32 item (the embedding, the head, one layer, or in a MoE layer its
    mixer or one expert matrix) is held at a time.  With ``rules`` each
    item is placed on their mesh before its cast (``param_specs``), each
    rank keeping its block: every rank draws the whole sequence from the
    same generator, so the blocks gathered are the meshless draw."""
    check_supported(cfg)
    if cfg.param_dtype != "float32":
        raise NotImplementedError(f"{cfg.name}: param_dtype "
                                  f"{cfg.param_dtype!r}; every arch keeps "
                                  f"float32 parameters")
    dev = resolve_device(device)
    if gen.device.type != dev.type and dev.type != "meta":
        raise ValueError(f"generator on {gen.device}, parameters on {dev}")
    V, D = cfg.vocab_size, cfg.d_model
    specs = param_specs(cfg)

    def cast(t):
        return t if cd is None else t.to(cd)

    embed = cast(place_tree(torch.randn((V, D), generator=gen, device=dev)
                       .mul_(0.02), specs["embed"], rules))
    lm_head = cast(place_tree(torch.randn((D, V), generator=gen, device=dev)
                         .mul_(1.0 / math.sqrt(D)), specs["lm_head"], rules))
    return {
        "embed": embed,
        "lm_head": lm_head,
        "final_norm": place_tree(L.init_norm(cfg, dev), specs["final_norm"],
                            rules),
        "layers": [_cast_layer(place_tree(_init_layer(
            cfg, _pattern(cfg, i), gen, dev, cd, rules), specs["layers"][i],
            rules), cd) for i in range(cfg.n_layers)],
    }


def init(cfg: ArchConfig, gen: torch.Generator,
         device: str | torch.device | None = None, rules=None) -> dict:
    """Random fp32 parameters drawn on ``device`` from ``gen`` (a generator
    of that device), with the reference's shapes and scales.  The numbers
    are not the reference's: carry those across with
    ``convert.params_from_jax``.  With ``rules`` (``sharding.make_rules``)
    the parameters come placed on their mesh, drawn one item at a time
    (``_draw``): no rank holds the whole fp32 tree."""
    return _draw(cfg, gen, device, None, rules)


def init_cast(cfg: ArchConfig, gen: torch.Generator,
              device: str | torch.device | None = None, rules=None) -> dict:
    """``cast_params(cfg, init(cfg, gen, device))``, bit for bit, drawn
    and cast one item at a time: the peak is the cast parameters plus the
    largest fp32 item, where ``init`` then ``cast_params`` holds all of
    both (over one card's memory for internlm2-20b and nemotron-4-15b).
    With ``rules`` placed as ``init`` places them: a rank's peak is its
    blocks plus the largest fp32 item."""
    return _draw(cfg, gen, device, _dtype(cfg.compute_dtype), rules)


def layer_specs(cfg: ArchConfig, pat) -> dict:
    """One layer's logical axes (``_init_layer``'s tree)."""
    s = {"norm1": L.norm_specs(cfg)}
    if pat.mixer == "attn":
        s["attn"] = L.attention_specs(cfg)
    else:
        s["ssm"] = SSM.ssm_specs(cfg)
    if pat.ffn == "dense":
        s["norm2"] = L.norm_specs(cfg)
        s["mlp"] = L.mlp_specs(cfg)
    elif pat.ffn == "moe":
        s["norm2"] = L.norm_specs(cfg)
        s["moe"] = L.moe_specs(cfg)
    return s


def param_specs(cfg: ArchConfig) -> dict:
    """The logical axes of every parameter, in ``init``'s tree: the
    reference's specs with the stacked leading "layers" dropped, since
    ``params["layers"]`` is a list here."""
    check_supported(cfg)
    return {"embed": ("vocab", "embed"), "lm_head": ("embed", "vocab"),
            "final_norm": L.norm_specs(cfg),
            "layers": [layer_specs(cfg, _pattern(cfg, i))
                       for i in range(cfg.n_layers)]}


def abstract_init(cfg: ArchConfig) -> tuple[dict, dict]:
    """(``init``'s fp32 parameters as ``meta`` tensors, ``param_specs``):
    shapes and specs without storage (the dry run's path)."""
    return init(cfg, torch.Generator(), "meta"), param_specs(cfg)


# leaves of "attn" / "ssm" / "moe" that the model code uses in fp32: the
# q/k-norm gains, the SSM's A_log (-exp(A_log) in fp32), dt_bias (added to
# the fp32 dt_raw), the gated norm's gain, and the MoE router (the
# reference routes on fp32 logits: a bf16 router would route otherwise)
_KEEP_FP = ("q_norm", "k_norm", "A_log", "dt_bias", "norm", "router")


def _cast_layer(lp: dict, cd: torch.dtype | None) -> dict:
    """One layer as compute sees it (``cd=None``: as it is)."""
    if cd is None:
        return lp
    return {name: sub if name.startswith("norm") else
            {k: t if k in _KEEP_FP else t.to(cd) for k, t in sub.items()}
            for name, sub in lp.items()}


def cast_params(cfg: ArchConfig, params: dict) -> dict:
    """The parameters as compute sees them: embedding, head, weights and
    biases in ``cfg.compute_dtype``; norm gains and the leaves the model
    code uses in fp32 (``_KEEP_FP``) unchanged.  The model code casts each
    weight at use as the reference does (``w.to(x.dtype)``); casting once
    at load gives the same numbers and spares every decode step a pass
    over the fp32 weights."""
    cd = _dtype(cfg.compute_dtype)
    return {"embed": params["embed"].to(cd),
            "lm_head": params["lm_head"].to(cd),
            "final_norm": params["final_norm"],
            "layers": [_cast_layer(lp, cd) for lp in params["layers"]]}


# ------------------------------------------------------------------- blocks

def _ffn(cfg, pat, lp, x, plain):
    """x plus the layer's FFN, and the MoE aux loss (None for a dense or
    FFN-less layer)."""
    if pat.ffn == "none":
        return x, None
    h = L.apply_norm(cfg, lp["norm2"], x, plain=plain)
    if pat.ffn == "moe":
        y, aux = L.moe_fwd(cfg, lp["moe"], h, plain=plain)
        return x + y, aux
    return x + L.mlp_fwd(cfg, lp["mlp"], h), None


def _positions(cfg: ArchConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Positions ``0 .. S-1`` of every row: (B, S), or (3, B, S) for
    M-RoPE, whose three streams are equal for text (a vision frontend
    would give real (t, h, w) ids)."""
    B, S = tokens.shape
    pos = torch.arange(S, dtype=torch.int32, device=tokens.device)
    pos = pos[None, :].expand(B, S)
    return pos[None].expand(3, B, S) if cfg.m_rope else pos


def _embed(cfg, params, tokens):
    # rows first, then the cast: the reference's embed.astype(cd)[tokens]
    e = params["embed"]
    if isinstance(e, DTensor):
        # FSDP's shards of the embed dim gathered first; the vocab stays
        # split where it is split over more than one rank
        mesh = e.device_mesh
        e = e.redistribute(mesh, [
            Shard(0) if isinstance(p, Shard) and p.dim == 0
            and mesh.size(md) > 1 else Replicate()
            for md, p in enumerate(e.placements)])
        rows = _lookup(e, tokens.long())
    else:
        rows = e[tokens.long()]
    return constrain(rows.to(_dtype(cfg.compute_dtype)), "batch", None,
                     "embed_act")


def _lookup(e: DTensor, tokens: torch.Tensor) -> DTensor:
    """``e[tokens]`` on each rank's tokens, the table's columns whole.  A
    table whole on every rank is indexed, as without a mesh, so that its
    gradient sums in the same order.  Where its rows (the vocab) are
    split, each rank looks its tokens up in its own block (0 for a token
    outside it) and the blocks sum, a partial sum over the vocab's mesh
    dims: the gradient of each block then holds its own rows alone, where
    DTensor's embedding gives every rank a gradient of the whole table
    (V x d in fp32, 5.9 GiB for nemotron-4-15b)."""
    mesh = e.device_mesh
    vocab = [md for md, p in enumerate(e.placements) if isinstance(p, Shard)]
    e_pl = [Shard(0) if md in vocab else Replicate()
            for md in range(mesh.ndim)]
    tok = tokens if isinstance(tokens, DTensor) else DTensor.from_local(
        tokens, mesh, [Replicate()] * mesh.ndim, run_check=False)
    tok_pl = [p if isinstance(p, Shard) and md not in vocab else Replicate()
              for md, p in enumerate(tok.placements)]
    out_pl = [Partial() if md in vocab else p for md, p in enumerate(tok_pl)]
    grad_pl = [Partial() if isinstance(p, Shard) else q
               for p, q in zip(tok_pl, e_pl)]
    lo = SH.block_index(tuple(e.shape), mesh, e_pl)[0].start

    def look(el, tl):
        if not vocab:
            return el[tl]
        tl = tl - lo
        inside = (tl >= 0) & (tl < el.shape[0])
        rows = el[tl.clamp(0, el.shape[0] - 1)]
        return torch.where(inside[..., None], rows, rows.new_zeros(()))
    return local_map(look, out_placements=out_pl, in_placements=(e_pl, tok_pl),
                     in_grad_placements=(grad_pl, tok_pl), device_mesh=mesh,
                     redistribute_inputs=True)(e, tok)


def _logits(cfg, params, h, plain):
    h = L.apply_norm(cfg, params["final_norm"], h, plain=plain)
    return (h @ params["lm_head"].to(h.dtype)).float()


# the products each remat policy saves (the reference's
# ``jax.checkpoint_policies.dots_saveable`` and
# ``checkpoint_dots_with_no_batch_dims``); every other op, the kernels'
# launches among them, runs again in the backward
_aten = torch.ops.aten
SAVED_PRODUCTS = {
    "nothing": (),
    "dots": (_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
             _aten.baddbmm.default),
    "dots_nb": (_aten.mm.default, _aten.addmm.default),
}


def remat(cfg: ArchConfig, fn, *args):
    """``fn(*args)``, its activations recomputed in the backward where
    ``cfg.remat`` asks and autograd records: grad mode on and a tensor of
    ``args`` (or of a dict of them) requiring grad.  One layer at a time;
    ``cfg.remat_policy`` names the products whose outputs are saved
    instead (``SAVED_PRODUCTS``)."""
    tensors = [t for a in args
               for t in (T.leaves(a) if isinstance(a, dict) else [a])
               if isinstance(t, torch.Tensor)]
    if not (cfg.remat and torch.is_grad_enabled()
            and any(t.requires_grad for t in tensors)):
        return fn(*args)
    policy = cfg.remat_policy
    if policy not in SAVED_PRODUCTS:
        raise ValueError(f"{cfg.name}: remat_policy {policy!r} is none of "
                         f"{sorted(SAVED_PRODUCTS)}")
    if not SAVED_PRODUCTS[policy]:
        return checkpoint(fn, *args, use_reentrant=False)
    return checkpoint(fn, *args, use_reentrant=False, context_fn=functools.
                      partial(create_selective_checkpoint_contexts,
                              list(SAVED_PRODUCTS[policy])))


def _layer(cfg, pat, lp, h, positions, plain):
    """One layer of ``forward``: (h, MoE aux or None)."""
    hn = L.apply_norm(cfg, lp["norm1"], h, plain=plain)
    if pat.mixer == "attn":
        mix, _ = L.attention_fwd(cfg, lp["attn"], hn, positions,
                                 causal=True, plain=plain)
    else:
        mix = SSM.ssm_fwd(cfg, lp["ssm"], hn, plain=plain)
    return _ffn(cfg, pat, lp, h + mix, plain)


def forward(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
            positions: torch.Tensor | None = None, *,
            plain: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S) -> (logits (B, S, V) in fp32, the MoE aux loss
    summed over the layers, an fp32 0-d tensor: 0 without MoE).
    ``positions``: (B, S), or (3, B, S) ids for M-RoPE; default
    ``0 .. S-1``."""
    check_supported(cfg)
    h = _embed(cfg, params, tokens)
    if positions is None:
        positions = _positions(cfg, tokens)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for i, lp in enumerate(params["layers"]):
        h, a = remat(cfg, _layer, cfg, _pattern(cfg, i), lp, h, positions,
                     plain)
        if a is not None:
            aux = aux + a
        if cfg.seq_parallel:
            # the token dim sharded over the model axis between layers
            h = constrain(h, "batch", "seq_sp", "embed_act")
    return constrain(_logits(cfg, params, h, plain), "batch", None,
                     "vocab"), aux


def lm_loss(logits: torch.Tensor, labels: torch.Tensor,
            z_loss: float = 1e-4) -> torch.Tensor:
    """Mean next-token nll over fp32 logits (B, S, V) plus ``z_loss`` times
    the mean squared log-partition."""
    lse = torch.logsumexp(logits, dim=-1)
    if isinstance(logits, DTensor):
        # each rank's vocab block: the label's logit where the block holds
        # it, zeros elsewhere, summed over the blocks (exact: one term)
        hit = labels.long()[..., None] == torch.arange(
            logits.shape[-1], device=logits.device)
        ll = torch.where(hit, logits, 0.0).sum(-1)
    else:
        ll = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (lse - ll).mean() + z_loss * lse.square().mean()


def loss_fn(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
            labels: torch.Tensor, z_loss: float = 1e-4, *,
            plain: bool = False) -> torch.Tensor:
    """The training loss (reference ``lm.loss_fn``): nll + z-loss on the
    fp32 logits' log-sum-exp + the MoE aux loss."""
    logits, aux = forward(cfg, params, tokens, plain=plain)
    return lm_loss(logits, labels, z_loss) + aux


# -------------------------------------------------------------------- decode

def _cache_shapes(cfg: ArchConfig, batch: int, max_len: int,
                  dtype: torch.dtype) -> dict:
    """{pos{i}: {leaf: (shape, dtype)}} of the cache."""
    out = {}
    for pi, pat in enumerate(cfg.pattern):
        lead = (cfg.n_blocks, batch)
        if pat.mixer == "attn":
            kv = (*lead, cfg.n_kv_heads * cfg.kv_cache_repeat, max_len,
                  cfg.head_dim)
            out[f"pos{pi}"] = {"k": (kv, dtype), "v": (kv, dtype)}
        else:
            conv_dim = cfg.ssm_inner + 2 * cfg.ssm_groups * cfg.ssm_state
            out[f"pos{pi}"] = {
                "conv": ((*lead, cfg.ssm_conv_width - 1, conv_dim), dtype),
                "state": ((*lead, cfg.ssm_heads, cfg.ssm_head_dim,
                           cfg.ssm_state), torch.float32)}
    return out


def cache_specs(cfg: ArchConfig) -> dict:
    """The logical axes of the cache (the reference's)."""
    specs = {}
    for pi, pat in enumerate(cfg.pattern):
        if pat.mixer == "attn":
            ax = ("layers", "batch", "kv_heads", None, None)
            specs[f"pos{pi}"] = {"k": ax, "v": ax}
        else:
            specs[f"pos{pi}"] = {
                "conv": ("layers", "batch", None, "conv_dim"),
                "state": ("layers", "batch", "ssm_heads", None, None)}
    return specs


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype: torch.dtype | None = None,
               device: str | torch.device | None = None) -> dict:
    """Zeros in the reference's layout: per pattern position, k and v
    (n_blocks, B, Hkv·kv_cache_repeat, max_len, D), or the conv window and
    the fp32 SSD state.  Under active rules, DTensors laid out by
    ``sharding.cache_layout``."""
    check_supported(cfg)
    shapes = _cache_shapes(cfg, batch, max_len,
                           dtype or _dtype(cfg.compute_dtype))
    return SH.zeros_tree(shapes, cache_specs(cfg), cfg, batch, max_len,
                         resolve_device(device))


def _cache_at(cfg, cache, i) -> dict:
    """Layer ``i``'s slice of the cache: views of block ``i //
    pattern_len`` under ``pos{i % pattern_len}``."""
    blk = i // cfg.pattern_len
    return {k: t[blk] for k, t in cache[f"pos{i % cfg.pattern_len}"].items()}


def prefill(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
            max_len: int | None = None, *, plain: bool = False
            ) -> tuple[torch.Tensor, dict]:
    """Run the prompt; return last-position logits (B, V) and a cache of
    ``max_len`` (>= prompt length) rows holding the prompt's k/v, and for
    the SSM layers its conv window and the SSD state after it."""
    check_supported(cfg)
    B, Sp = tokens.shape
    max_len = max_len or Sp
    h = _embed(cfg, params, tokens)
    positions = _positions(cfg, tokens)
    cache = init_cache(cfg, B, max_len, device=tokens.device)
    for i, lp in enumerate(params["layers"]):
        pat = _pattern(cfg, i)
        hn = L.apply_norm(cfg, lp["norm1"], h, plain=plain)
        c = _cache_at(cfg, cache, i)
        if pat.mixer == "attn":
            mix, (k, v) = L.attention_fwd(cfg, lp["attn"], hn, positions,
                                          causal=True, plain=plain)
            SH.write_rows(c["k"], L.repeat_kv(cfg, k), 0)
            SH.write_rows(c["v"], L.repeat_kv(cfg, v), 0)
        else:
            mix, state, conv = SSM.ssm_fwd_with_cache(cfg, lp["ssm"], hn,
                                                      plain=plain)
            SH.assign(c["conv"], conv)
            SH.assign(c["state"], state)
        h, _ = _ffn(cfg, pat, lp, h + mix, plain)
    return _logits(cfg, params, h[:, -1:], plain)[:, 0], cache


def decode_step(cfg: ArchConfig, params: dict, cache: dict,
                tokens: torch.Tensor, pos: int, *, plain: bool = False
                ) -> tuple[torch.Tensor, dict]:
    """One decode step.  tokens: (B, 1); pos: tokens already in the cache.
    Returns (logits (B, V), cache), the cache updated in place."""
    check_supported(cfg)
    h = _embed(cfg, params, tokens)
    for i, lp in enumerate(params["layers"]):
        pat = _pattern(cfg, i)
        hn = L.apply_norm(cfg, lp["norm1"], h, plain=plain)
        c = _cache_at(cfg, cache, i)
        if pat.mixer == "attn":
            mix, _, _ = L.attention_decode(cfg, lp["attn"], hn, c["k"],
                                           c["v"], pos, plain=plain)
        else:
            mix, _, _ = SSM.ssm_decode(cfg, lp["ssm"], hn, c["conv"],
                                       c["state"], plain=plain)
        h, _ = _ffn(cfg, pat, lp, h + mix, plain)
    return _logits(cfg, params, h, plain)[:, 0], cache
