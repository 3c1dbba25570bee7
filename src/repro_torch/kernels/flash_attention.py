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

- Backward (``flash_attention_bwd``, no Pallas counterpart): under
  autograd the prefill runs as ``_FlashAttention``, whose forward also
  writes each query row's fp32 log-sum-exp, and whose backward is
  FlashAttention-2's: ``delta = rowsum(dO·O)``, then a kernel for dK and
  dV a (KV head, key tile) over its whole GQA group and one for dQ a
  (query head, query tile), no atomics.  bf16 operands run on the tensor
  cores (``mma.sync`` bf16, fp32 accumulators; P and dS rounded to bf16
  in registers, never in shared memory; Q/dO or K/V tiles through a
  ``cp.async`` ring; the dQ kernel runs first and forms delta from its
  staged dO); fp32 operands on fp32 FMA kernels after a delta kernel.
  The decode path (``kv_len`` given, or ``Sq * Hq / Hkv <= DECODE_ROWS``) has
  no backward and raises under autograd (ROADMAP A.5b); training never
  takes it.

``flash_attention.launches`` and ``flash_attention_bwd.launches`` count
wrapper calls, whatever number of device kernels a call launches.  A
tensor on the CPU goes to the plain version (``ref.mha_attention``,
differentiable; ``ref.mha_attention_bwd``); a CUDA tensor goes to the
kernels, or the call raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from . import _build, ref

HEAD_DIMS = (16, 32, 64, 128)   # the head widths the kernel is built for
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = (_P,) * 5 + (_I,) * 8 + (ctypes.c_float, _P)
_DECODE_ARGS = (_P,) * 5 + (_I,) * 8 + (ctypes.c_float, _I, _I, _P)
_BWD_ARGS = (_P,) * 10 + (_I,) * 7 + (ctypes.c_float, _P)
_SIGNATURES = {"flash_attention_f32": _ARGS, "flash_attention_bf16": _ARGS,
               "flash_decode_f32": _DECODE_ARGS,
               "flash_decode_bf16": _DECODE_ARGS,
               "flash_attention_bwd_f32": _BWD_ARGS,
               "flash_attention_bwd_bf16": _BWD_ARGS}

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
    _build.refuse_dtensor("flash_attention", q, k, v)
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


def _on_card(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """For checked operands: False on the CPU (the plain versions), True
    on the card once the kernels' own limits hold; raises otherwise."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda (or cpu), not "
                         f"{q.device}")
    D = q.shape[3]
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention's kernel is built for head_dim in "
                         f"{HEAD_DIMS}, got {D}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention's kernel reads 16-byte vectors: "
                         "q, k and v must be 16-byte aligned")
    return True


def _lib() -> ctypes.CDLL:
    return _build.load("flash_attention", _SIGNATURES)


def _stream(q: torch.Tensor) -> int:
    return torch.cuda.current_stream(q.device).cuda_stream


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, kv_len: int | None = None
                    ) -> torch.Tensor:
    """``softmax(q kᵀ / sqrt(D)) v`` per query head over its KV head.

    q: (B, Hq, Sq, D); k, v: (B, Hkv, S, D); reads KV rows
    ``[0, kv_len)`` (default all S).  Causal: query i sees key j when
    ``j <= i + (kv_len - Sq)``.  A row with no visible key gives 0.
    fp32 or bf16 operands, fp32 arithmetic, output in q's dtype.  Under
    autograd (a prefill: no ``kv_len``) the gradient comes from
    ``flash_attention_bwd``.
    """
    skv = _check(q, k, v, kv_len)
    if not _on_card(q, k, v):
        return ref.mha_attention(q, k, v, causal=causal, kv_len=kv_len)
    B, Hq, Sq, D = q.shape
    Hkv = k.shape[1]
    decode = Sq * (Hq // Hkv) <= DECODE_ROWS
    if _build.needs_grad(q, k, v):
        if kv_len is not None or decode:
            _build.refuse_grad("flash_attention's decode path", q, k, v)
        out = _FlashAttention.apply(q, k, v, causal)
        flash_attention.launches += 1
        return out
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        if decode:
            plan = decode_plan(skv, B * Hkv, _build.sm_count(q.device))
            ws = (torch.empty(B * Hq * Sq * plan.splits * (D + 2),
                              dtype=torch.float32, device=q.device)
                  if plan.combine else None)
            fn = (_lib().flash_decode_f32 if q.dtype == torch.float32
                  else _lib().flash_decode_bf16)
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), ws.data_ptr() if ws is not None else None,
                     B, Hq, Hkv, Sq, skv, k.shape[2], D, int(causal),
                     1.0 / math.sqrt(D), plan.rows_per_split, plan.splits,
                     _stream(q))
            _build.check(err, "flash_attention")
        else:
            _prefill(q, k, v, causal, skv, out)
    flash_attention.launches += 1
    return out


def _prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
             skv: int, out: torch.Tensor,
             lse: torch.Tensor | None = None) -> None:
    """Runs the prefill kernel (tensor cores for bf16, FMA for fp32) on
    checked, non-empty CUDA operands over KV rows ``[0, skv)``; ``lse``
    (B, Hq, Sq fp32), where given, takes each query row's log-sum-exp."""
    B, Hq, Sq, D = q.shape
    fn = (_lib().flash_attention_f32 if q.dtype == torch.float32
          else _lib().flash_attention_bf16)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr() if lse is not None else None, B, Hq,
                 k.shape[1], Sq, skv, k.shape[2], D, int(causal),
                 1.0 / math.sqrt(D), _stream(q))
    _build.check(err, "flash_attention")


def attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """The prefill kernel over every KV row, whatever the shape, with each
    query row's fp32 log-sum-exp (B, Hq, Sq): what ``_FlashAttention``
    saves for the backward (``ref.mha_attention_lse`` on the CPU)."""
    skv = _check(q, k, v, None)
    if not _on_card(q, k, v):
        return ref.mha_attention_lse(q, k, v, causal=causal)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    if out.numel():
        _prefill(q, k, v, causal, skv, out, lse)
    return out, lse


class _FlashAttention(torch.autograd.Function):
    """The prefill kernel with its backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = attention_lse(q, k, v, causal=causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout.contiguous(),
                                         causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The prefill's backward over every KV row: ``(dq, dk, dv)`` in the
    operands' dtype from q (B, Hq, Sq, D), k, v (B, Hkv, Skv, D), the
    forward's output ``out`` and fp32 log-sum-exp ``lse`` (B, Hq, Sq),
    and ``dout`` (q's shape and dtype).  fp32 sums (bf16 operands: P and
    dS rounded to bf16 before their products), deterministic (every
    output element one thread's sum in a fixed order)."""
    _check(q, k, v, None)
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device \
                or not t.is_contiguous():
            raise ValueError(f"flash_attention_bwd: {name} must be a "
                             f"contiguous {q.dtype} {tuple(q.shape)} on "
                             f"{q.device}")
    if lse.shape != q.shape[:3] or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"flash_attention_bwd: lse must be a contiguous "
                         f"float32 {tuple(q.shape[:3])} on {q.device}")
    if not _on_card(q, k, v):
        return ref.mha_attention_bwd(q, k, v, out, lse, dout, causal=causal)
    if any(t.data_ptr() % 16 for t in (out, dout)):
        raise ValueError("flash_attention_bwd reads 16-byte vectors: out "
                         "and dout must be 16-byte aligned")
    B, Hq, Sq, D = q.shape
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    fn = (_lib().flash_attention_bwd_f32 if q.dtype == torch.float32
          else _lib().flash_attention_bwd_bf16)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, Hq,
                 k.shape[1], Sq, k.shape[2], D, int(causal),
                 1.0 / math.sqrt(D), _stream(q))
    _build.check(err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention.launches = 0
flash_attention_bwd.launches = 0
