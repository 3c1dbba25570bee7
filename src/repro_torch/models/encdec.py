"""Encoder-decoder transformer (the whisper-medium backbone).

Port of ``repro.models.encdec``.  The audio frontend is a stub, as in the
reference: ``frames`` are precomputed frame embeddings (B, S_enc,
d_model).  Positions are sinusoidal.  The reference builds them in numpy
float64 for a whole sequence (``sinusoidal``: the encoder, the decoder's
prompt) and in fp32 for one decode position (``decode_step``); the port
follows each as written.  Decoder blocks: causal self-attention, then
cross-attention over the encoder's states, then the FFN.  The
cross-attention k/v are computed once, at prefill, and cached.

The reference scans over stacked layers; the port keeps one dict per
layer in ``params["encoder"]`` and ``params["decoder"]`` and loops over
them in Python.  The decode cache keeps the reference's layout:
``self_k`` / ``self_v`` (L, B, Hkv, max_len, D) and ``cross_k`` /
``cross_v`` (L, B, Hkv, S_enc, D), in the compute dtype, written in
place.

Entry points:
  init(cfg, gen, device=None)                        -> params (fp32)
  init_cast(cfg, gen, device=None)                   -> lm.cast_params
                                                        rule of init(...),
                                                        one item at a time
  cast_params(cfg, params)                           -> params for compute
  encode(cfg, params, frames)                        -> encoder states
  forward(cfg, params, frames, tokens)               -> logits (B, S, V)
  loss_fn(cfg, params, frames, tokens, labels)       -> nll + z-loss
  init_cache(cfg, batch, max_len, enc_len, ...)      -> cache
  prefill(cfg, params, frames, tokens, max_len)      -> (logits (B, V), cache)
  decode_step(cfg, params, cache, tokens, pos)       -> (logits (B, V), cache)

Every norm runs on the layernorm row kernel and every attention (the
encoder's, the decoder's self- and cross-attention) on the
``flash_attention`` kernel, through ``kernels.ops``; ``plain`` selects
their plain versions.  ``device=None`` means the CUDA card.
``cfg.remat`` recomputes each encoder and decoder layer in the backward
(``lm.remat`` under ``_remat_cfg``: policy "nothing", whatever
``cfg.remat_policy`` says, as the reference's ``encdec`` does).  Under autograd on the card the
layernorm and attention kernels run their backward kernels
(``sfu.layernorm_bwd``, ``flash_attention.flash_attention_bwd``), so
``loss_fn`` trains there; on the CPU the plain versions differentiate.
``param_specs`` / ``abstract_init`` / ``cache_specs`` give the logical
axes of the parameters and the cache for ``parallel.sharding``; under
``sharding.use_rules`` every entry point runs on DTensors, as
``models.lm``'s do.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from ..convert import resolve_device
from ..parallel import sharding as SH
from ..parallel.sharding import constrain
from . import layers as L
from . import lm
from .config import ArchConfig


def check_supported(cfg: ArchConfig) -> None:
    if not cfg.is_encdec:
        raise ValueError(f"{cfg.name} is not an encoder-decoder model: run "
                         f"it through repro_torch.models.lm")


def sinusoidal(seq: int, d: int, offset: int = 0) -> np.ndarray:
    """(seq, d) float32 position encodings, computed in float64: sin on
    the even columns, cos on the odd."""
    pos = np.arange(offset, offset + seq)[:, None]
    dim = np.arange(0, d, 2)[None, :]
    ang = pos / np.power(10000.0, dim / d)
    out = np.zeros((seq, d), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return out


@functools.lru_cache(maxsize=8)
def _device_sinusoidal(seq: int, d: int, device: torch.device,
                       dtype: torch.dtype) -> torch.Tensor:
    """``sinusoidal(seq, d)`` cast to ``dtype`` on ``device``, copied there
    once."""
    return torch.as_tensor(sinusoidal(seq, d), device=device).to(dtype)


def _decode_position(d: int, pos: int, device: torch.device,
                     dtype: torch.dtype) -> torch.Tensor:
    """The encoding of one decode position, as the reference's
    ``decode_step`` computes it: angles in fp32, sin and cos in fp32,
    each cast to ``dtype``."""
    def full(value):      # a device scalar: no copy from the host
        return torch.full((), value, dtype=torch.float32, device=device)

    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)
    ang = full(float(pos)) / torch.pow(full(10000.0), dim / d)
    pe = torch.zeros(d, dtype=dtype, device=device)
    pe[0::2] = torch.sin(ang).to(dtype)
    pe[1::2] = torch.cos(ang).to(dtype)
    return pe


# ---------------------------------------------------------------------- init

def _init_enc_layer(cfg, gen, device) -> dict:
    return {"norm1": L.init_norm(cfg, device), "norm2": L.init_norm(cfg, device),
            "attn": L.init_attention(cfg, gen, device),
            "mlp": L.init_mlp(cfg, gen, device)}


def _init_dec_layer(cfg, gen, device) -> dict:
    return {"norm1": L.init_norm(cfg, device), "norm2": L.init_norm(cfg, device),
            "norm3": L.init_norm(cfg, device),
            "self_attn": L.init_attention(cfg, gen, device),
            "cross_attn": L.init_attention(cfg, gen, device),
            "mlp": L.init_mlp(cfg, gen, device)}


def _draw(cfg: ArchConfig, gen: torch.Generator, device, cd,
          rules=None) -> dict:
    """The parameters in the reference's shapes and scales, drawn in this
    order: embed, lm_head, enc_norm, final_norm, each encoder layer, each
    decoder layer; each item cast by ``lm.cast_params``'s rule as soon as
    it is drawn (``cd=None`` keeps fp32), so that at most one fp32 item
    is held at a time; with ``rules`` placed on their mesh before its
    cast, as ``lm._draw`` places them."""
    check_supported(cfg)
    dev = resolve_device(device)
    if gen.device.type != dev.type and dev.type != "meta":
        raise ValueError(f"generator on {gen.device}, parameters on {dev}")
    V, D = cfg.vocab_size, cfg.d_model
    specs = param_specs(cfg)

    def cast(t):
        return t if cd is None else t.to(cd)

    def item(tree, spec):
        return lm._cast_layer(lm.place_tree(tree, spec, rules), cd)

    embed = cast(lm.place_tree(torch.randn(
        (V, D), generator=gen, device=dev).mul_(0.02), specs["embed"], rules))
    lm_head = cast(lm.place_tree(torch.randn(
        (D, V), generator=gen, device=dev).mul_(1.0 / math.sqrt(D)),
        specs["lm_head"], rules))
    return {
        "embed": embed, "lm_head": lm_head,
        "enc_norm": lm.place_tree(L.init_norm(cfg, dev), specs["enc_norm"],
                                  rules),
        "final_norm": lm.place_tree(L.init_norm(cfg, dev),
                                    specs["final_norm"], rules),
        "encoder": [item(_init_enc_layer(cfg, gen, dev), specs["encoder"][i])
                    for i in range(cfg.encoder_layers)],
        "decoder": [item(_init_dec_layer(cfg, gen, dev), specs["decoder"][i])
                    for i in range(cfg.n_layers)],
    }


def param_specs(cfg: ArchConfig) -> dict:
    """The logical axes of every parameter, in ``init``'s tree (the
    reference's specs without the stacked leading "layers")."""
    check_supported(cfg)
    n = L.norm_specs(cfg)
    enc = {"norm1": n, "norm2": n, "attn": L.attention_specs(cfg),
           "mlp": L.mlp_specs(cfg)}
    dec = {"norm1": n, "norm2": n, "norm3": n,
           "self_attn": L.attention_specs(cfg),
           "cross_attn": L.attention_specs(cfg), "mlp": L.mlp_specs(cfg)}
    return {"embed": ("vocab", "embed"), "lm_head": ("embed", "vocab"),
            "enc_norm": n, "final_norm": n,
            "encoder": [enc] * cfg.encoder_layers,
            "decoder": [dec] * cfg.n_layers}


def abstract_init(cfg: ArchConfig) -> tuple[dict, dict]:
    """(``init``'s fp32 parameters as ``meta`` tensors, ``param_specs``)."""
    return init(cfg, torch.Generator(), "meta"), param_specs(cfg)


def init(cfg: ArchConfig, gen: torch.Generator,
         device: str | torch.device | None = None, rules=None) -> dict:
    """Random fp32 parameters drawn on ``device`` from ``gen``; the
    numbers are not the reference's (carry those across with
    ``convert.encdec_params_from_jax``).  With ``rules`` placed on their
    mesh one item at a time (``lm.init``'s ``rules``)."""
    return _draw(cfg, gen, device, None, rules)


def init_cast(cfg: ArchConfig, gen: torch.Generator,
              device: str | torch.device | None = None, rules=None) -> dict:
    """``cast_params(cfg, init(cfg, gen, device))``, bit for bit, drawn
    and cast one item at a time (placed by ``rules`` where given)."""
    return _draw(cfg, gen, device, lm._dtype(cfg.compute_dtype), rules)


def cast_params(cfg: ArchConfig, params: dict) -> dict:
    """Embedding, head, weights and biases in ``cfg.compute_dtype``; norm
    gains fp32 (``lm.cast_params``'s rule)."""
    cd = lm._dtype(cfg.compute_dtype)
    return {"embed": params["embed"].to(cd),
            "lm_head": params["lm_head"].to(cd),
            "enc_norm": params["enc_norm"], "final_norm": params["final_norm"],
            "encoder": [lm._cast_layer(lp, cd) for lp in params["encoder"]],
            "decoder": [lm._cast_layer(lp, cd) for lp in params["decoder"]]}


# ------------------------------------------------------------------- encoder

def _remat_cfg(cfg: ArchConfig) -> ArchConfig:
    """``cfg`` as ``lm.remat`` reads it here: no activation saved."""
    return dataclasses.replace(cfg, remat_policy="nothing")


def encode(cfg: ArchConfig, params: dict, frames: torch.Tensor, *,
           plain: bool = False) -> torch.Tensor:
    """frames: (B, S_enc, D) stub embeddings -> encoder states, in the
    compute dtype."""
    check_supported(cfg)
    cd = lm._dtype(cfg.compute_dtype)
    _, S, D = frames.shape
    h = frames.to(cd) + _device_sinusoidal(S, D, frames.device, cd)[None]
    h = constrain(h, "batch", None, "embed_act")
    rcfg = _remat_cfg(cfg)
    for lp in params["encoder"]:
        h = lm.remat(rcfg, _enc_layer, cfg, lp, h, plain)
    return L.apply_norm(cfg, params["enc_norm"], h, plain=plain)


def _enc_layer(cfg, lp, h, plain):
    hn = L.apply_norm(cfg, lp["norm1"], h, plain=plain)
    mix, _ = L.attention_fwd(cfg, lp["attn"], hn, None, causal=False,
                             plain=plain)
    h = h + mix
    hn = L.apply_norm(cfg, lp["norm2"], h, plain=plain)
    return h + L.mlp_fwd(cfg, lp["mlp"], hn)


# ------------------------------------------------------------------- decoder

def _embed(cfg, params, tokens):
    cd = lm._dtype(cfg.compute_dtype)
    return lm._embed(cfg, params, tokens) \
        + _device_sinusoidal(tokens.shape[1], cfg.d_model, tokens.device,
                             cd)[None]


def _dec_layer(cfg, lp, h, cross_kv, plain):
    """One decoder layer over the whole sequence; returns (h, (k, v)) of
    its self-attention."""
    hn = L.apply_norm(cfg, lp["norm1"], h, plain=plain)
    mix, kv = L.attention_fwd(cfg, lp["self_attn"], hn, None, causal=True,
                              plain=plain)
    h = h + mix
    hn = L.apply_norm(cfg, lp["norm2"], h, plain=plain)
    mix, _ = L.attention_fwd(cfg, lp["cross_attn"], hn, None, causal=False,
                             kv_override=cross_kv, plain=plain)
    h = h + mix
    hn = L.apply_norm(cfg, lp["norm3"], h, plain=plain)
    return h + L.mlp_fwd(cfg, lp["mlp"], hn), kv


def forward(cfg: ArchConfig, params: dict, frames: torch.Tensor,
            tokens: torch.Tensor, *, plain: bool = False) -> torch.Tensor:
    """Teacher-forced pass: (frames, tokens (B, S)) -> logits (B, S, V)
    in fp32 (no loss)."""
    enc = encode(cfg, params, frames, plain=plain)
    h = _embed(cfg, params, tokens)
    rcfg = _remat_cfg(cfg)
    for lp in params["decoder"]:
        h = lm.remat(rcfg, _dec_train_layer, cfg, lp, h, enc, plain)
    return constrain(lm._logits(cfg, params, h, plain), "batch", None,
                     "vocab")


def _dec_train_layer(cfg, lp, h, enc, plain):
    """A decoder layer of ``forward``, its cross k/v from ``enc`` inside
    (recomputed with it under remat, as the reference's scanned body)."""
    return _dec_layer(cfg, lp, h, L.encode_kv(cfg, lp["cross_attn"], enc),
                      plain)[0]


def loss_fn(cfg: ArchConfig, params: dict, frames: torch.Tensor,
            tokens: torch.Tensor, labels: torch.Tensor, z_loss: float = 1e-4,
            *, plain: bool = False) -> torch.Tensor:
    """The training loss (reference ``encdec.loss_fn``): nll + z-loss on
    the fp32 logits' log-sum-exp."""
    return lm.lm_loss(forward(cfg, params, frames, tokens, plain=plain),
                      labels, z_loss)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, enc_len: int,
               dtype: torch.dtype | None = None,
               device: str | torch.device | None = None) -> dict:
    """Zeros in the reference's layout; under active rules, DTensors laid
    out by ``sharding.cache_layout``."""
    check_supported(cfg)
    dtype = dtype or lm._dtype(cfg.compute_dtype)
    kv = ((cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim),
          dtype)
    ckv = ((cfg.n_layers, batch, cfg.n_kv_heads, enc_len, cfg.head_dim),
           dtype)
    shapes = {"self_k": kv, "self_v": kv, "cross_k": ckv, "cross_v": ckv}
    return SH.zeros_tree(shapes, cache_specs(cfg), cfg, batch, max_len,
                         resolve_device(device))


def cache_specs(cfg: ArchConfig) -> dict:
    ax = ("layers", "batch", "kv_heads", None, None)
    return {"self_k": ax, "self_v": ax, "cross_k": ax, "cross_v": ax}


def prefill(cfg: ArchConfig, params: dict, frames: torch.Tensor,
            tokens: torch.Tensor, max_len: int | None = None, *,
            plain: bool = False) -> tuple[torch.Tensor, dict]:
    """Encode, then run the prompt; returns the last position's logits
    (B, V) and a cache of ``max_len`` (>= prompt length) self rows holding
    the prompt's k/v, with each layer's cross k/v over the encoder."""
    enc = encode(cfg, params, frames, plain=plain)
    B, Sp = tokens.shape
    cache = init_cache(cfg, B, max_len or Sp, enc.shape[1],
                       device=tokens.device)
    h = _embed(cfg, params, tokens)
    for i, lp in enumerate(params["decoder"]):
        ck, cv = L.encode_kv(cfg, lp["cross_attn"], enc)
        SH.assign(cache["cross_k"][i], ck)
        SH.assign(cache["cross_v"][i], cv)
        h, (k, v) = _dec_layer(cfg, lp, h, (cache["cross_k"][i],
                                            cache["cross_v"][i]), plain)
        SH.write_rows(cache["self_k"][i], k, 0)
        SH.write_rows(cache["self_v"][i], v, 0)
    return lm._logits(cfg, params, h[:, -1:], plain)[:, 0], cache


def decode_step(cfg: ArchConfig, params: dict, cache: dict,
                tokens: torch.Tensor, pos: int, *, plain: bool = False
                ) -> tuple[torch.Tensor, dict]:
    """One decode step.  tokens: (B, 1); pos: tokens already in the self
    cache.  Returns (logits (B, V), cache), the self cache updated in
    place."""
    check_supported(cfg)
    cd = lm._dtype(cfg.compute_dtype)
    h = lm._embed(cfg, params, tokens) \
        + _decode_position(cfg.d_model, pos, tokens.device, cd)[None, None]
    for i, lp in enumerate(params["decoder"]):
        hn = L.apply_norm(cfg, lp["norm1"], h, plain=plain)
        mix, _, _ = L.attention_decode(cfg, lp["self_attn"], hn,
                                       cache["self_k"][i], cache["self_v"][i],
                                       pos, rope=False, plain=plain)
        h = h + mix
        hn = L.apply_norm(cfg, lp["norm2"], h, plain=plain)
        mix, _, _ = L.attention_decode(cfg, lp["cross_attn"], hn,
                                       cache["cross_k"][i],
                                       cache["cross_v"][i], pos, cross=True,
                                       plain=plain)
        h = h + mix
        hn = L.apply_norm(cfg, lp["norm3"], h, plain=plain)
        h = h + L.mlp_fwd(cfg, lp["mlp"], hn)
    return lm._logits(cfg, params, h, plain)[:, 0], cache
