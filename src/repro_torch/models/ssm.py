"""Mamba-2 (SSD) sequence-mixer block (arXiv:2405.21060), used by
mamba2-2.7b and the jamba hybrid's SSM layers.

Port of ``repro.models.ssm``.  Per block:
  in_proj -> [z | x | B | C | dt]
  causal conv1d (width 4) over [x | B | C], SiLU
  dt = softplus(dt_raw + dt_bias);  a = -exp(A_log) * dt      (fp32)
  y = SSD(x * dt, a, B, C) + D * (x * dt)          (kernels.ops.ssd)
  y = RMSNorm(y * silu(z));  out = y @ out_proj   (kernels.ops.rmsnorm)

Weights are applied as ``x @ w`` and cast to the activations' dtype at
use, as in the reference (``A_log``, ``dt_bias`` and the gated norm's
gain stay fp32).  The SSD scan and the gated norm run on the port's
kernels through ``kernels.ops``; ``plain`` selects their plain versions.
Under autograd on the card both run their backward kernels
(``ssd.ssd_bwd``, ``sfu.rmsnorm_bwd``); the gradients of dt, A_log, D,
the conv and the projections flow through autograd around them, as on
the CPU.
Decode keeps a (conv window, SSD state) cache, both O(1) in the
sequence length, and ``ssm_decode`` updates it in place.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..parallel.sharding import assign, constrain, merge_last, split_last


def _splits(cfg) -> tuple[int, int, int]:
    return cfg.ssm_inner, cfg.ssm_groups * cfg.ssm_state, cfg.ssm_heads


def init_ssm(cfg, gen: torch.Generator, device: torch.device) -> dict:
    """The reference's parameters, shapes and scales (random draws from
    ``gen``; ``A_log``, ``D``, ``dt_bias``, ``conv_b`` and ``norm`` are
    deterministic, as there)."""
    d = cfg.d_model
    din, gn, nh = _splits(cfg)
    conv_dim = din + 2 * gn
    return {
        "in_proj": torch.randn((d, 2 * din + 2 * gn + nh), generator=gen,
                               device=device).mul_(1.0 / math.sqrt(d)),
        "conv_w": torch.randn((cfg.ssm_conv_width, conv_dim), generator=gen,
                              device=device).mul_(0.1),
        "conv_b": torch.zeros(conv_dim, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, device=device)),
        "D": torch.ones(nh, device=device),
        "dt_bias": torch.full((nh,), 0.01, device=device).expm1_().log_(),
        "norm": torch.ones(din, device=device),
        "out_proj": torch.randn((din, d), generator=gen,
                                device=device).mul_(1.0 / math.sqrt(din)),
    }


def ssm_specs(cfg) -> dict:
    """The logical axes of ``init_ssm``'s leaves (the reference's)."""
    return {"in_proj": ("embed", "ssm_inner"), "conv_w": (None, "conv_dim"),
            "conv_b": ("conv_dim",), "A_log": ("ssm_heads",),
            "D": ("ssm_heads",), "dt_bias": ("ssm_heads",),
            "norm": ("ssm_inner",), "out_proj": ("ssm_inner", "embed")}


def _causal_conv(xbc: torch.Tensor, conv_w: torch.Tensor,
                 conv_b: torch.Tensor, prev: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """Depthwise causal conv1d.  xbc: (B, S, Cdim); conv_w: (K, Cdim);
    prev: (B, K-1, Cdim) history or None (zero history)."""
    K = conv_w.shape[0]
    if prev is None:
        pad = xbc.new_zeros((xbc.shape[0], K - 1, xbc.shape[2]))
    else:
        pad = prev.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)
    S = xbc.shape[1]
    out = sum(xp[:, i:i + S, :] * conv_w[i][None, None] for i in range(K))
    return out + conv_b[None, None]


def _mix(cfg, p: dict, x: torch.Tensor, *, plain: bool):
    """The block up to the output projection: (out, final SSD state,
    xbc before the conv)."""
    S = x.shape[1]
    din, gn, nh = _splits(cfg)
    proj = x @ p["in_proj"].to(x.dtype)
    z, xin, bb, cc, dt_raw = torch.split(proj, [din, din, gn, gn, nh], dim=-1)
    xbc_pre = torch.cat([xin, bb, cc], dim=-1)
    xbc = F.silu(_causal_conv(xbc_pre, p["conv_w"].to(x.dtype),
                              p["conv_b"].to(x.dtype)))
    xin, bb, cc = torch.split(xbc, [din, gn, gn], dim=-1)
    xin = constrain(xin, "batch", None, "ssm_inner")
    dt = F.softplus(dt_raw.float() + p["dt_bias"][None, None])   # (B,S,nh)
    a = -torch.exp(p["A_log"])[None, None] * dt
    xh = split_last(xin, nh, cfg.ssm_head_dim) * dt[..., None].to(x.dtype)
    # b and c stay views into xbc: the kernel reads them in place
    bg = split_last(bb, cfg.ssm_groups, cfg.ssm_state)
    cg = split_last(cc, cfg.ssm_groups, cfg.ssm_state)
    y, state = ops.ssd(xh, a, bg, cg, chunk=min(128, max(16, S)),
                       plain=plain)
    y = y + p["D"][None, None, :, None].to(y.dtype) * xh
    y = ops.rmsnorm(merge_last(y) * F.silu(z), p["norm"], plain=plain)
    out = constrain(y @ p["out_proj"].to(x.dtype), "batch", None, "embed_act")
    return out, state, xbc_pre


def ssm_fwd(cfg, p: dict, x: torch.Tensor, *, plain: bool = False
            ) -> torch.Tensor:
    """Full-sequence path (``forward``).  x: (B, S, D) -> (B, S, D)."""
    return _mix(cfg, p, x, plain=plain)[0]


def ssm_fwd_with_cache(cfg, p: dict, x: torch.Tensor, *,
                       plain: bool = False):
    """Prefill: returns (out, SSD state (B, nh, P, N) fp32, conv window
    (B, K-1, conv_dim), the last K-1 inputs of the conv).

    The reference runs the plain recurrence ``ref.ssd_scan`` here because
    its kernel path returns no final state (``ops.ssd`` gives ``(y,
    None)``), so a faithful copy would run a Python loop of S steps a
    layer on the card.  The port's kernel writes the final state, so
    prefill runs ``ops.ssd`` (the chunked kernel) like ``ssm_fwd``: the
    same function, equal to the recurrence up to fp32 rounding (3e-4 in y
    and state, ``tests/test_kernels.py``).  The window is taken from the
    inputs padded with K-1 zero rows, which is the reference's when the
    prompt has at least K-1 tokens and the zero history the conv assumes
    when it has fewer."""
    out, state, xbc_pre = _mix(cfg, p, x, plain=plain)
    k1 = cfg.ssm_conv_width - 1
    window = torch.cat([xbc_pre.new_zeros((x.shape[0], k1, xbc_pre.shape[2])),
                        xbc_pre], dim=1)[:, -k1:, :]
    return out, state, window


def ssm_decode(cfg, p: dict, x: torch.Tensor, conv_window: torch.Tensor,
               state: torch.Tensor, *, plain: bool = False):
    """Single-token decode.  x: (B, 1, D); conv_window: (B, K-1, conv_dim);
    state: (B, nh, P, N) fp32.  Updates the window and the state in place
    (the reference returns new arrays) and returns (out, conv_window,
    state)."""
    din, gn, nh = _splits(cfg)
    proj = x @ p["in_proj"].to(x.dtype)
    z, xin, bb, cc, dt_raw = torch.split(proj, [din, din, gn, gn, nh], dim=-1)
    xbc_t = torch.cat([xin, bb, cc], dim=-1)                 # (B, 1, cd)
    window = torch.cat([conv_window.to(x.dtype), xbc_t], dim=1)  # (B, K, cd)
    conv_out = (window * p["conv_w"][None].to(x.dtype)).sum(dim=1) \
        + p["conv_b"][None].to(x.dtype)                      # (B, cd)
    xin, bb, cc = torch.split(F.silu(conv_out), [din, gn, gn], dim=-1)
    dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"][None])   # (B, nh)
    a = -torch.exp(p["A_log"])[None] * dt
    xh = split_last(xin, nh, cfg.ssm_head_dim) * dt[..., None].to(x.dtype)
    bg = split_last(bb, cfg.ssm_groups, cfg.ssm_state)
    cg = split_last(cc, cfg.ssm_groups, cfg.ssm_state)
    y, new_state = ops.ssd_decode_step(xh, a, bg, cg, state)
    assign(state, new_state)
    assign(conv_window, window[:, 1:])
    y = y + p["D"][None, :, None].to(y.dtype) * xh
    y = ops.rmsnorm(merge_last(y)[:, None] * F.silu(z), p["norm"],
                    plain=plain)
    return y @ p["out_proj"].to(x.dtype), conv_window, state
