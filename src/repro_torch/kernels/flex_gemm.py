"""flex_gemm: DORA's dynamic-loop-bound MMU (paper §3.3) on the H100.

Replaces the Pallas TPU kernel ``_flex_gemm_kernel``
(``src/repro/kernels/flex_gemm.py``) with the hand-written CUDA kernel
``csrc/flex_gemm.cu``: ``C = epi(A @ B + c + bias)``, fp32 accumulation
(fp32 FMA, never TF32), output in A's dtype.  M, K and N are kernel
arguments, so one compiled program serves every shape; ragged edges are
masked in the kernel.  ``c`` is the accumulator input: the runtime passes
the LMU OUT tile when an ``MMU_GEMM`` has ``accumulate`` set, which keeps
the accumulate-then-epilogue order of ``runtime.py``.

Bound on the card: fp32 FMA throughput for the paper workloads' tiles.
BERT-L's tiles give 16-96 output blocks of 64 x 64 on 132 SMs, so
``gemm_plan`` cuts K into slabs (split-K) as its cost model prices
lowest; the slabs' fp32 partial sums go to a workspace that a second
kernel adds in slab order before the epilogue.  Each block streams its
K tiles through a 3-stage ``cp.async`` ring (see the source note in
``csrc/flex_gemm.cu``).

A tensor on the CPU goes to the plain version ``ref.gemm``; a CUDA tensor
goes to the kernel, or the call raises.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple

import torch

from . import _build, ref
from .ref import EPILOGUES

_DTYPES = (torch.float32, torch.bfloat16)
_ARGS = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 6 + (ctypes.c_void_p,)
_SIGNATURES = {"flex_gemm_f32": _ARGS, "flex_gemm_bf16": _ARGS}

BLOCK_M = BLOCK_N = 64   # output block of the kernel
BLOCK_K = 16             # depth of a K tile
MIN_SPLIT_TILES = 2      # K tiles a split-K slab holds at least
# gemm_plan's cost model, in units of one 64 x 64 x 16 tile on one SM
# (about 0.6 us on the H100 at two blocks an SM): the split-K reduce
# costs about 4 units of launch and 1 unit per 400,000 floats of the
# partial sums it reads and the output it writes (fitted to BERT-L's
# tiles on the H100; PERF.md)
REDUCE_LAUNCH_TILES = 4.0
REDUCE_FLOATS_PER_TILE = 400_000


class GemmPlan(NamedTuple):
    """How the kernel covers one M x K x N product: ``blocks`` output
    blocks, K cut into ``splits`` slabs of ``tiles_per_split`` K tiles
    (the last slab may be shorter).  ``splits > 1`` adds the reduce
    kernel and its ``(splits, M, N)`` fp32 workspace."""
    blocks: int
    splits: int
    tiles_per_split: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@lru_cache(maxsize=None)
def gemm_plan(M: int, K: int, N: int, sms: int) -> GemmPlan:
    """The split-K cut of K that the cost model prices lowest.

    Blocks run in waves of ``sms`` (co-resident blocks share an SM), so a
    cut into slabs of ``depth`` tiles costs ``waves x depth`` tiles, plus
    the reduce kernel when there is more than one slab.  Slabs hold at
    least ``MIN_SPLIT_TILES`` tiles; where some cut gives the card ``sms``
    blocks, only such cuts are considered, so that every SM gets work.
    Ties go to fewer slabs."""
    blocks = _cdiv(M, BLOCK_M) * _cdiv(N, BLOCK_N)
    k_tiles = _cdiv(K, BLOCK_K)
    cuts = {(1, max(k_tiles, 1))}
    for depth in range(MIN_SPLIT_TILES, k_tiles):
        cuts.add((_cdiv(k_tiles, depth), depth))
    if any(blocks * n >= sms for n, _ in cuts):
        cuts = {(n, d) for n, d in cuts if blocks * n >= sms}

    def cost(cut):
        n, depth = cut
        reduce = (REDUCE_LAUNCH_TILES + (n + 1) * M * N
                  / REDUCE_FLOATS_PER_TILE) if n > 1 else 0.0
        return (_cdiv(blocks * n, sms) * depth + reduce, n)

    n, depth = min(cuts, key=cost)
    return GemmPlan(blocks, n, depth)


def _check(a, b, bias, epilogue, c) -> None:
    _build.refuse_dtensor("flex_gemm", a, b, bias, c)
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"flex_gemm needs A (M,K) and B (K,N), got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    M, N = a.shape[0], b.shape[1]
    operands = {"A": a, "B": b}
    if epilogue.startswith("bias"):
        if bias is None or tuple(bias.shape) != (N,):
            raise ValueError(f"epilogue {epilogue!r} needs bias of shape "
                             f"({N},)")
        operands["bias"] = bias
    if c is not None:
        if tuple(c.shape) != (M, N):
            raise ValueError(f"accumulator c must be ({M},{N}), got "
                             f"{tuple(c.shape)}")
        operands["c"] = c
    if a.dtype not in _DTYPES:
        raise TypeError(f"flex_gemm takes float32 or bfloat16, got {a.dtype}")
    for name, t in operands.items():
        if t.dtype != a.dtype:
            raise TypeError(f"{name} is {t.dtype}, A is {a.dtype}")
        if t.device != a.device:
            raise ValueError(f"{name} is on {t.device}, A is on {a.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def flex_gemm(a: torch.Tensor, b: torch.Tensor,
              bias: torch.Tensor | None = None, *, epilogue: str = "none",
              c: torch.Tensor | None = None) -> torch.Tensor:
    """``C[M,N] = epi(A[M,K] @ B[K,N] + c[M,N] + bias[N])``; ``bias`` is
    read only by the ``bias*`` epilogues, ``c`` is optional."""
    _check(a, b, bias, epilogue, c)
    if a.device.type == "cpu":
        return ref.gemm(a, b, bias, epilogue, c)
    if a.device.type != "cuda":
        raise ValueError(f"flex_gemm runs on cuda (or cpu), not {a.device}")
    _build.refuse_grad("flex_gemm", a, b, bias, c)
    M, K = a.shape
    N = b.shape[1]
    if M == 0 or N == 0:
        return torch.empty((M, N), dtype=a.dtype, device=a.device)
    out = _launch(a, b, bias, epilogue, c,
                  gemm_plan(M, K, N, _build.sm_count(a.device)))
    flex_gemm.launches += 1
    return out


def _launch(a, b, bias, epilogue, c, plan: GemmPlan) -> torch.Tensor:
    """Runs the kernel on checked, non-empty CUDA operands as ``plan``
    says."""
    M, K = a.shape
    N = b.shape[1]
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    ws = (torch.empty((plan.splits, M, N), dtype=torch.float32,
                      device=a.device) if plan.splits > 1 else None)
    lib = _build.load("flex_gemm", _SIGNATURES)
    fn = lib.flex_gemm_f32 if a.dtype == torch.float32 else lib.flex_gemm_bf16
    use_bias = epilogue.startswith("bias")
    act = _build.ACT_CODE.get(epilogue.split("_")[-1], 0)
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(),
                 c.data_ptr() if c is not None else None,
                 bias.data_ptr() if use_bias else None,
                 out.data_ptr(), ws.data_ptr() if ws is not None else None,
                 M, K, N, act, plan.tiles_per_split, plan.splits,
                 torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "flex_gemm")
    return out


flex_gemm.launches = 0
