"""Decoder-only language model, dense archs (qwen3, qwen1.5, internlm2,
nemotron).

Port of ``repro.models.lm`` for the layer pattern ``attn`` + dense FFN.
The reference scans over the stacked ``blocks/pos{i}`` leaves; the port
keeps one dict per layer in ``params["layers"]`` (layer ``i`` is block
``i // pattern_len``, position ``i % pattern_len``) and loops over them
in Python.  The decode cache keeps the reference's layout, one
``(n_blocks, B, Hkv, max_len, D)`` tensor each for k and v under
``pos{i}``, and prefill and decode write it in place (slice assignment)
where the reference's ``dynamic_update_slice`` builds new arrays: the
cache passed in is the cache returned.

Entry points:
  init(cfg, gen, device=None)                  -> params (fp32)
  cast_params(cfg, params)                     -> params for compute
  forward(cfg, params, tokens)                 -> logits (B, S, V) fp32
  init_cache(cfg, batch, max_len, device=...)  -> cache
  prefill(cfg, params, tokens, max_len)        -> (logits (B, V), cache)
  decode_step(cfg, params, cache, tokens, pos) -> (logits (B, V), cache)

``device=None`` means the CUDA card and raises without one.  ``plain``
runs the norms and attention on their plain versions instead of the
kernels.  SSM, MoE, encoder-decoder and M-RoPE archs, and
``kv_cache_repeat > 1``, raise ``NotImplementedError`` naming the
ROADMAP item that ports them.
"""

from __future__ import annotations

import math

import torch

from ..convert import resolve_device
from . import layers as L
from .config import ArchConfig


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for what this slice does not serve."""
    if cfg.is_encdec:
        raise NotImplementedError(f"{cfg.name}: encoder-decoder models are "
                                  f"not ported yet: ROADMAP A.4")
    if any(p.mixer != "attn" for p in cfg.pattern):
        raise NotImplementedError(f"{cfg.name}: SSM layers (ssd kernel, "
                                  f"models/ssm.py) are not ported yet: "
                                  f"ROADMAP A.2")
    if any(p.ffn == "moe" for p in cfg.pattern):
        raise NotImplementedError(f"{cfg.name}: MoE FFNs are not ported "
                                  f"yet: ROADMAP A.4")
    if cfg.m_rope:
        raise NotImplementedError(f"{cfg.name}: M-RoPE is not ported yet: "
                                  f"ROADMAP A.4")
    if cfg.kv_cache_repeat > 1:
        raise NotImplementedError(f"{cfg.name}: kv_cache_repeat > 1 serves "
                                  f"the sharded cache of the multi-device "
                                  f"layer: ROADMAP A.6")


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# ---------------------------------------------------------------------- init

def _init_layer(cfg: ArchConfig, gen: torch.Generator,
                device: torch.device) -> dict:
    return {"norm1": L.init_norm(cfg, device),
            "attn": L.init_attention(cfg, gen, device),
            "norm2": L.init_norm(cfg, device),
            "mlp": L.init_mlp(cfg, gen, device)}


def init(cfg: ArchConfig, gen: torch.Generator,
         device: str | torch.device | None = None) -> dict:
    """Random fp32 parameters drawn on ``device`` from ``gen`` (a generator
    of that device), with the reference's shapes and scales.  The numbers
    are not the reference's: carry those across with
    ``convert.params_from_jax``."""
    check_supported(cfg)
    if cfg.param_dtype != "float32":
        raise NotImplementedError(f"{cfg.name}: param_dtype "
                                  f"{cfg.param_dtype!r}; every arch keeps "
                                  f"float32 parameters")
    dev = resolve_device(device)
    if gen.device.type != dev.type:
        raise ValueError(f"generator on {gen.device}, parameters on {dev}")
    V, D = cfg.vocab_size, cfg.d_model
    return {
        "embed": torch.randn((V, D), generator=gen, device=dev).mul_(0.02),
        "lm_head": torch.randn((D, V), generator=gen,
                               device=dev).mul_(1.0 / math.sqrt(D)),
        "final_norm": L.init_norm(cfg, dev),
        "layers": [_init_layer(cfg, gen, dev) for _ in range(cfg.n_layers)],
    }


_KEEP_FP = ("q_norm", "k_norm")     # gains inside "attn"


def cast_params(cfg: ArchConfig, params: dict) -> dict:
    """The parameters as compute sees them: embedding, head, weights and
    biases in ``cfg.compute_dtype``, norm gains unchanged.  The model code
    casts each weight at use as the reference does (``w.to(x.dtype)``);
    casting once at load gives the same numbers and spares every decode
    step a pass over the fp32 weights."""
    cd = _dtype(cfg.compute_dtype)

    def layer(lp):
        return {name: sub if name.startswith("norm") else
                {k: t if k in _KEEP_FP else t.to(cd) for k, t in sub.items()}
                for name, sub in lp.items()}

    return {"embed": params["embed"].to(cd),
            "lm_head": params["lm_head"].to(cd),
            "final_norm": params["final_norm"],
            "layers": [layer(lp) for lp in params["layers"]]}


# ------------------------------------------------------------------- blocks

def _ffn(cfg, lp, x, plain):
    return x + L.mlp_fwd(cfg, lp["mlp"],
                         L.apply_norm(cfg, lp["norm2"], x, plain=plain))


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    B, S = tokens.shape
    pos = torch.arange(S, dtype=torch.int32, device=tokens.device)
    return pos[None, :].expand(B, S)


def _embed(cfg, params, tokens):
    # rows first, then the cast: the reference's embed.astype(cd)[tokens]
    return params["embed"][tokens.long()].to(_dtype(cfg.compute_dtype))


def _logits(cfg, params, h, plain):
    h = L.apply_norm(cfg, params["final_norm"], h, plain=plain)
    return (h @ params["lm_head"].to(h.dtype)).float()


def forward(cfg: ArchConfig, params: dict, tokens: torch.Tensor, *,
            plain: bool = False) -> torch.Tensor:
    """tokens: (B, S) -> logits (B, S, V) in fp32 (no loss)."""
    check_supported(cfg)
    h = _embed(cfg, params, tokens)
    positions = _positions(tokens)
    for lp in params["layers"]:
        hn = L.apply_norm(cfg, lp["norm1"], h, plain=plain)
        mix, _ = L.attention_fwd(cfg, lp["attn"], hn, positions, causal=True,
                                 plain=plain)
        h = _ffn(cfg, lp, h + mix, plain)
    return _logits(cfg, params, h, plain)


# -------------------------------------------------------------------- decode

def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype: torch.dtype | None = None,
               device: str | torch.device | None = None) -> dict:
    check_supported(cfg)
    dtype = dtype or _dtype(cfg.compute_dtype)
    shape = (cfg.n_blocks, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    dev = resolve_device(device)
    return {f"pos{pi}": {"k": torch.zeros(shape, dtype=dtype, device=dev),
                         "v": torch.zeros(shape, dtype=dtype, device=dev)}
            for pi in range(cfg.pattern_len)}


def _cache_at(cfg, cache, i):
    c = cache[f"pos{i % cfg.pattern_len}"]
    blk = i // cfg.pattern_len
    return c["k"][blk], c["v"][blk]


def prefill(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
            max_len: int | None = None, *, plain: bool = False
            ) -> tuple[torch.Tensor, dict]:
    """Run the prompt; return last-position logits (B, V) and a cache of
    ``max_len`` (>= prompt length) rows holding the prompt's k/v."""
    check_supported(cfg)
    B, Sp = tokens.shape
    max_len = max_len or Sp
    h = _embed(cfg, params, tokens)
    positions = _positions(tokens)
    cache = init_cache(cfg, B, max_len, device=tokens.device)
    for i, lp in enumerate(params["layers"]):
        hn = L.apply_norm(cfg, lp["norm1"], h, plain=plain)
        mix, (k, v) = L.attention_fwd(cfg, lp["attn"], hn, positions,
                                      causal=True, plain=plain)
        ck, cv = _cache_at(cfg, cache, i)
        ck[:, :, :Sp] = k
        cv[:, :, :Sp] = v
        h = _ffn(cfg, lp, h + mix, plain)
    return _logits(cfg, params, h[:, -1:], plain)[:, 0], cache


def decode_step(cfg: ArchConfig, params: dict, cache: dict,
                tokens: torch.Tensor, pos: int, *, plain: bool = False
                ) -> tuple[torch.Tensor, dict]:
    """One decode step.  tokens: (B, 1); pos: tokens already in the cache.
    Returns (logits (B, V), cache), the cache updated in place."""
    check_supported(cfg)
    h = _embed(cfg, params, tokens)
    for i, lp in enumerate(params["layers"]):
        hn = L.apply_norm(cfg, lp["norm1"], h, plain=plain)
        ck, cv = _cache_at(cfg, cache, i)
        mix, _, _ = L.attention_decode(cfg, lp["attn"], hn, ck, cv, pos,
                                       plain=plain)
        h = _ffn(cfg, lp, h + mix, plain)
    return _logits(cfg, params, h, plain)[:, 0], cache
