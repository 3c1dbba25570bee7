"""flash_attention: grouped-query attention on the H100.

Replaces the Pallas TPU kernel ``_attn_kernel``
(``src/repro/kernels/flash_attention.py``) with the hand-written CUDA
kernel ``csrc/flash_attention.cu``: one block per (batch, query head,
query tile), a loop over KV tiles inside the block with the running max,
sum and fp32 accumulator in registers, and query head ``h`` reading KV
head ``h // (Hq / Hkv)`` in place.  The true query and KV lengths are
kernel arguments, so one program serves prefill and every decode step;
decode hands it the KV cache with ``kv_len = pos + 1``, and the kernel
reads those rows of the cache where they lie.

Bound on the card: bf16 tensor-core operations or bytes for prefill,
the bytes of the KV cache for decode (the kernel computes with fp32 FMA;
see the source note).

A tensor on the CPU goes to the plain version ``ref.mha_attention``; a
CUDA tensor goes to the kernel, or the call raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build, ref

HEAD_DIMS = (16, 32, 64, 128)   # the head widths the kernel is built for
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = (_P,) * 4 + (_I,) * 8 + (ctypes.c_float, _P)
_SIGNATURES = {"flash_attention_f32": _ARGS, "flash_attention_bf16": _ARGS}


def _check(q, k, v, kv_len) -> int:
    """Validate the operands; returns the number of KV rows read."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention needs q (B,Hq,Sq,D) and k, v "
                         f"(B,Hkv,S,D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, _, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or Hq % k.shape[1]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention takes float32 or bfloat16, got "
                        f"{q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q is on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
    S = k.shape[2]
    if kv_len is None:
        return S
    if not 0 <= kv_len <= S:
        raise ValueError(f"kv_len {kv_len} outside [0, {S}]")
    return int(kv_len)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, kv_len: int | None = None
                    ) -> torch.Tensor:
    """``softmax(q kᵀ / sqrt(D)) v`` per query head over its KV head.

    q: (B, Hq, Sq, D); k, v: (B, Hkv, S, D); reads KV rows
    ``[0, kv_len)`` (default all S).  Causal: query i sees key j when
    ``j <= i + (kv_len - Sq)``.  A row with no visible key gives 0.
    fp32 or bf16 operands, fp32 arithmetic, output in q's dtype.
    """
    skv = _check(q, k, v, kv_len)
    if q.device.type == "cpu":
        return ref.mha_attention(q, k, v, causal=causal, kv_len=kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda (or cpu), not "
                         f"{q.device}")
    B, Hq, Sq, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention's kernel is built for head_dim in "
                         f"{HEAD_DIMS}, got {D}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention's kernel reads 16-byte vectors: "
                         "q, k and v must be 16-byte aligned")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _build.load("flash_attention", _SIGNATURES)
    fn = (lib.flash_attention_f32 if q.dtype == torch.float32
          else lib.flash_attention_bf16)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, Hq, k.shape[1], Sq, skv, k.shape[2], D, int(causal),
                 1.0 / math.sqrt(D),
                 torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
