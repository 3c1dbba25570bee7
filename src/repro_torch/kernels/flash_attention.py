"""flash_attention: grouped-query attention on the H100.

Replaces the Pallas TPU kernel ``_attn_kernel``
(``src/repro/kernels/flash_attention.py``) with the hand-written CUDA
kernels of ``csrc/flash_attention.cu``.  Query head ``h`` reads KV head
``h // (Hq / Hkv)`` in place, and the true query and KV lengths are
kernel arguments, so one program serves prefill and every decode step;
decode hands it the KV cache with ``kv_len = pos + 1``, and the kernels
read those rows of the cache where they lie.

- Prefill (``Sq * Hq / Hkv > DECODE_ROWS``): bf16 operands go to a
  FlashAttention-2 kernel on the tensor cores (``mma.sync`` bf16, fp32
  accumulators, K/V double-buffered by ``cp.async``); fp32 operands to an
  fp32 FMA kernel, since the port uses no TF32.  Bound: the bytes at
  qwen3-4b's prefill, then the bf16 operations.
- Decode (``Sq * Hq / Hkv <= DECODE_ROWS``, both dtypes): split-KV
  flash-decoding, bound by the bytes of the cache.  A block per (batch,
  KV head, split) holds all query rows of the GQA group, so each cache
  row is read once; ``decode_plan`` chooses the splits, and a second
  kernel merges them when there are more than one.

``flash_attention.launches`` counts wrapper calls, whatever number of
device kernels a call launches.  A tensor on the CPU goes to the plain
version ``ref.mha_attention``; a CUDA tensor goes to the kernels, or the
call raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from . import _build, ref

HEAD_DIMS = (16, 32, 64, 128)   # the head widths the kernel is built for
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = (_P,) * 4 + (_I,) * 8 + (ctypes.c_float, _P)
_DECODE_ARGS = (_P,) * 5 + (_I,) * 8 + (ctypes.c_float, _I, _I, _P)
_SIGNATURES = {"flash_attention_f32": _ARGS, "flash_attention_bf16": _ARGS,
               "flash_decode_f32": _DECODE_ARGS,
               "flash_decode_bf16": _DECODE_ARGS}

DECODE_ROWS = 16       # query rows (Sq * Hq / Hkv) a decode block holds
DECODE_CHUNK = 32      # keys a decode block stages at a time
MIN_SPLIT_ROWS = 64    # keys a decode split holds at least


class DecodePlan(NamedTuple):
    """Keys ``[0, Skv)`` cut into ``splits`` slices of ``rows_per_split``
    (whole chunks; the last may be shorter), one block each per (batch,
    KV head); ``combine``: a second kernel merges the splits."""
    splits: int
    rows_per_split: int
    combine: bool


def decode_plan(skv: int, pairs: int, sms: int) -> DecodePlan:
    """Splits for ``pairs`` (batch, KV head) blocks over ``skv`` keys: at
    least two blocks an SM where ``skv`` allows ``MIN_SPLIT_ROWS`` keys a
    split."""
    want = max(1, -(-2 * sms // max(pairs, 1)))
    per = -(-skv // want)
    rows = max(MIN_SPLIT_ROWS, -(-per // DECODE_CHUNK) * DECODE_CHUNK)
    splits = max(1, -(-skv // rows))
    return DecodePlan(splits, rows, splits > 1)


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
    f32 = q.dtype == torch.float32
    Hkv, stride = k.shape[1], k.shape[2]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        if Sq * (Hq // Hkv) <= DECODE_ROWS:
            plan = decode_plan(skv, B * Hkv, _build.sm_count(q.device))
            ws = (torch.empty(B * Hq * Sq * plan.splits * (D + 2),
                              dtype=torch.float32, device=q.device)
                  if plan.combine else None)
            fn = lib.flash_decode_f32 if f32 else lib.flash_decode_bf16
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), ws.data_ptr() if ws is not None else None,
                     B, Hq, Hkv, Sq, skv, stride, D, int(causal),
                     1.0 / math.sqrt(D), plan.rows_per_split, plan.splits,
                     stream)
        else:
            fn = lib.flash_attention_f32 if f32 else lib.flash_attention_bf16
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     B, Hq, Hkv, Sq, skv, stride, D, int(causal),
                     1.0 / math.sqrt(D), stream)
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
