"""SFU row kernels: DORA's special-function unit (paper §3.5) on the H100.

Replaces the Pallas TPU kernels of ``src/repro/kernels/sfu.py``
(``_softmax_kernel``, ``_layernorm_kernel``, ``_gelu_kernel``,
``_rmsnorm_kernel``) with the hand-written CUDA kernels of
``csrc/sfu.cu``.  Softmax and layernorm rows of at most 1024 take one
warp a row, the row held in the warp's registers (``warp_plan``: 16-byte
vectors where the row is a whole number of aligned ones, else scalar
loads).  Both norms' wider rows take a one-pass kernel that holds two
16-byte vectors of the row in each thread's registers (``norm_plan``);
rmsnorm's rows of at most 1024 (the q/k-norm rows of head_dim) a warp a
row of strided loads.  Wider, unaligned or ragged rows take the block
kernels of the same file.  The activations (GELU / ReLU / ReLU² / SiLU)
are one element-wise kernel on 16-byte float4 loads and stores.  All are
bound by device-memory bytes on the card.  softmax and the activations
take fp32, as the runtime's LMU tiles are; layernorm and rmsnorm take
fp32 or bf16 rows (the decoders' activations) with fp32 gamma and beta,
compute in fp32 and return x's dtype.

rmsnorm and layernorm have backward kernels: under autograd (grad mode
on, x, gamma or beta requiring grad) ``rmsnorm_rows`` runs as
``_RmsNorm`` and ``layernorm_rows`` as ``_LayerNorm``, whose forwards also
write each row's rstd (and layernorm's mean) and whose backwards are
``rmsnorm_bwd`` and ``layernorm_bwd``.  Their grid is ``norm_bwd_plan``'s:
rows of a whole number of aligned 16-byte vectors, at least a warp's
worth (whisper-medium's 1,024 bf16 as well as the wide rows), take a
vector kernel that holds two vectors a thread and loads the next row's
while it reduces this one's; narrower rows a warp a row, other rows a
block a row; the dgamma and dbeta partial rows of the blocks are summed
by one more launch (``column_sum_plan``).  ``softmax_rows`` and ``act_rows``
have none (no training path reaches them: the model's activations are
eager PyTorch, and softmax runs only in the DORA runtime) and raise under
autograd on the card (ROADMAP A.5b).

A tensor on the CPU goes to the plain version in ``ref`` (differentiable
by autograd); a CUDA tensor goes to the kernel, or the call raises.
"""

from __future__ import annotations

import ctypes
import torch

from . import _build, ref
from .ref import ACTIVATIONS

_P, _I = ctypes.c_void_p, ctypes.c_int
_NORM = (_P, _P, _P, _P, _I, _I, ctypes.c_float, _I, _P)
_NORM_BWD = (_P,) * 7 + (_I,) * 7 + (_P,)
_LAYERNORM = (_P,) * 6 + (_I, _I, ctypes.c_float, _I, _I, _I, _P)
_LAYERNORM_BWD = (_P,) * 10 + (_I,) * 7 + (_P,)
_SIGNATURES = {
    "sfu_softmax_f32": (_P, _P, _I, _I, _I, _I, _P),
    "sfu_layernorm_f32": _LAYERNORM,
    "sfu_layernorm_bf16": _LAYERNORM,
    "sfu_act_f32": (_P, _P, ctypes.c_longlong, _I, _I, _P),
    "sfu_rmsnorm_f32": _NORM,
    "sfu_rmsnorm_bf16": _NORM,
    "sfu_rmsnorm_bwd_f32": _NORM_BWD,
    "sfu_rmsnorm_bwd_bf16": _NORM_BWD,
    "sfu_layernorm_bwd_f32": _LAYERNORM_BWD,
    "sfu_layernorm_bwd_bf16": _LAYERNORM_BWD,
}

WARP_ROW_MAX = 1024      # widest row of the warp-a-row kernels
LANE_MAX = 32            # fp32 values a lane of the warp kernels holds
ROW_VPT = 2              # 16-byte vectors a thread of the one-pass kernel
MAX_THREADS = 1024
# the norms' backward grids (norm_bwd_plan), measured on the H100 at
# qwen3-4b's training rows (PERF.md): the vector kernel's rows a block fill
# about BWD_VEC_THREADS threads (its launch bound in csrc/sfu.cu: 96
# registers a thread), one block an SM, on rows of at least BWD_VEC_MIN
# 16-byte vectors (a warp's two each); the warp kernel's blocks hold
# BWD_WARP_ROWS rows, two an SM; the block kernel's one row, four an SM
BWD_VEC_THREADS = 640
BWD_VEC_MIN = 64
BWD_WARP_ROWS = 32
BWD_SMEM_FLOATS = 12288  # 48 KB: the warp kernel's shared dgamma (and
                         # dbeta) rows
BWD_VEC_SMEM_FLOATS = 32768  # 128 KB: the vector kernel's row groups' rows
BWD_BLOCKS_PER_SM = {"vector": 1, "warp": 2, "block": 4}
SUM_ROWS = 4             # partial rows a warp of the column sum adds
SUM_WARPS = 32           # warps a block of the column sum, at most
FLOAT_TYPES = (torch.float32,)
NORM_TYPES = (torch.float32, torch.bfloat16)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _aligned(*ts: torch.Tensor | None) -> bool:
    return all(t is None or t.data_ptr() % 16 == 0 for t in ts)


def norm_plan(N: int, esize: int, aligned: bool) -> int:
    """Threads a row of the one-pass norm kernel (layernorm and rmsnorm),
    or 0 for the others.  It takes rows wider than ``WARP_ROW_MAX`` of a
    whole number of 16-byte vectors, with x, y, gamma and beta 16-byte
    aligned: ``ROW_VPT`` vectors a thread, in whole warps of at most
    ``MAX_THREADS``.  Two vectors a thread cover every served width (2560
    to 6144, bf16 or fp32); wider rows take the block kernels."""
    if N <= WARP_ROW_MAX or not aligned or N * esize % 16:
        return 0
    threads = 32 * _cdiv(_cdiv(N * esize // 16, ROW_VPT), 32)
    return threads if threads <= MAX_THREADS else 0


def warp_plan(N: int, esize: int, aligned: bool) -> tuple[int, bool]:
    """``(slots, vector)`` of the layernorm and softmax warp kernels, one
    warp a row of at most ``WARP_ROW_MAX``, or ``(0, False)`` for wider rows
    (the block kernels).  Lane ``l`` holds slots ``l + 32 s``, ``s <
    slots``: 16-byte vectors (``vector``) where the row is a whole number
    of them and its operands are aligned, else elements.  ``slots``, a
    compile-time count of the kernel, is the least power of two that
    covers the row: at most ``LANE_MAX`` fp32 values a lane."""
    if N > WARP_ROW_MAX:
        return 0, False
    vector = aligned and N * esize % 16 == 0
    units = N * esize // 16 if vector else N
    slots = 1
    while 32 * slots < units:
        slots *= 2
    return slots, vector


def norm_bwd_threads(N: int, esize: int, aligned: bool) -> int:
    """Threads a row of the norms' backward vector kernel, or 0 for the
    others: rows of a whole number of 16-byte vectors with aligned
    operands, at least ``BWD_VEC_MIN`` of them (rmsnorm's q/k-norm rows of
    128 keep the warp kernel), ``ROW_VPT`` vectors a thread in whole warps
    of at most ``BWD_VEC_THREADS`` (wider rows, fp32 past 5,120 and bf16
    past 10,240, take the block kernel).  Where the forward's one-pass
    kernel runs (``norm_plan``) up to that width, the same threads."""
    if not aligned or N * esize % 16 or N * esize // 16 < BWD_VEC_MIN:
        return 0
    threads = 32 * _cdiv(_cdiv(N * esize // 16, ROW_VPT), 32)
    return threads if threads <= BWD_VEC_THREADS else 0


def norm_bwd_plan(R: int, N: int, esize: int, aligned: bool,
                  sms: int, parts: int = 1) -> tuple[int, int, int]:
    """``(threads, rows, blocks)`` of the norms' backward (rmsnorm's and
    layernorm's): the row shape (``norm_bwd_threads``' threads for the
    vector kernel, else 0: a warp a row up to ``WARP_ROW_MAX`` wide, or the
    block kernel), the rows a block works on at once, and a grid that walks
    the rows cyclically.  ``parts``: the partial rows each block keeps
    (dgamma, and layernorm's dbeta).  The vector kernel takes the rows that
    fill ``BWD_VEC_THREADS`` threads (fewer where their ``parts`` shared
    rows of N each would pass ``BWD_VEC_SMEM_FLOATS``), the warp kernel
    ``BWD_WARP_ROWS`` (fewer where their ``parts`` shared rows each would
    pass ``BWD_SMEM_FLOATS``), the block kernel one; each over at most ``BWD_BLOCKS_PER_SM`` blocks an SM:
    few blocks, so few partial rows.  The grid is fixed by the shape and
    the card, so the partial sums (one row of N a block) add up in the
    same order every run."""
    threads = norm_bwd_threads(N, esize, aligned)
    parts = max(1, parts)
    if threads:
        kind = "vector"
        rows = max(1, min(BWD_VEC_THREADS // threads,
                          BWD_VEC_SMEM_FLOATS // (parts * N)))
    elif N <= WARP_ROW_MAX:
        kind = "warp"
        rows = min(BWD_WARP_ROWS, BWD_SMEM_FLOATS // (parts * N))
    else:
        kind, rows = "block", 1
    return threads, rows, max(1, min(_cdiv(R, rows),
                                     BWD_BLOCKS_PER_SM[kind] * sms))


def column_sum_plan(blocks: int, N: int) -> tuple[int, int]:
    """``(vec, warps)`` of dgamma's column sum over ``blocks`` partial rows
    of N: a lane adds ``vec`` columns (one 16-byte vector where N is a
    multiple of 4), a block 32 lanes' columns, with ``warps`` warps over
    the rows, about ``SUM_ROWS`` rows each, so every load is in flight at
    once; then the warps' sums in warp order."""
    return (4 if N % 4 == 0 else 1,
            max(1, min(SUM_WARPS, _cdiv(blocks, SUM_ROWS))))


def _on_card(x: torch.Tensor, what: str, *params: torch.Tensor | None,
             dtypes: tuple[torch.dtype, ...] = FLOAT_TYPES) -> bool:
    """Validate ``x`` (2-D, of ``dtypes``) and its per-column fp32 params;
    True when the call goes to the kernel, False when it goes to the CPU's
    plain version."""
    _build.refuse_dtensor(what, x, *params)
    if x.dim() != 2:
        raise ValueError(f"{what} takes a 2-D (rows, cols) tensor, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in dtypes:
        raise TypeError(f"{what} takes {' or '.join(map(str, dtypes))}, got "
                        f"{x.dtype}")
    for t in (x, *(p for p in params if p is not None)):
        if t.device != x.device:
            raise ValueError(f"{what}: operands on {t.device} and {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous")
    for p in params:
        if p is not None and (p.dtype != torch.float32
                              or tuple(p.shape) != (x.shape[1],)):
            raise ValueError(f"{what}: gamma/beta must be float32 "
                             f"({x.shape[1]},), got {p.dtype} "
                             f"{tuple(p.shape)}")
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda (or cpu), not {x.device}")
    return True


def _lib() -> ctypes.CDLL:
    return _build.load("sfu", _SIGNATURES)


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def softmax_rows(x: torch.Tensor) -> torch.Tensor:
    """Row softmax, max-subtracted, fp32."""
    if not _on_card(x, "softmax_rows"):
        return ref.softmax_rows(x)
    _build.refuse_grad("softmax_rows", x)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    _launch_softmax(x, out, *warp_plan(x.shape[1], 4, _aligned(x, out)))
    softmax_rows.launches += 1
    return out


def _launch_softmax(x: torch.Tensor, out: torch.Tensor, slots: int,
                    vector: bool) -> None:
    """Runs the softmax kernel on checked, non-empty CUDA operands: the
    warp kernel with ``slots`` slots a lane (see ``warp_plan``), or the
    block kernel for 0."""
    R, N = x.shape
    with torch.cuda.device(x.device):
        err = _lib().sfu_softmax_f32(x.data_ptr(), out.data_ptr(), R, N,
                                     slots, int(vector), _stream(x))
    _build.check(err, "softmax_rows")


def layernorm_rows(x: torch.Tensor, gamma: torch.Tensor | None = None,
                   beta: torch.Tensor | None = None, eps: float = 1e-5
                   ) -> torch.Tensor:
    """Row layernorm with population variance: x fp32 or bf16, gamma and
    beta fp32 (each optional), fp32 arithmetic, output in x's dtype.
    Under autograd the gradient comes from ``layernorm_bwd``."""
    if not _on_card(x, "layernorm_rows", gamma, beta, dtypes=NORM_TYPES):
        return ref.layernorm_rows(x, gamma, beta, eps)
    if _build.needs_grad(x, gamma, beta):
        out = _LayerNorm.apply(x, gamma, beta, eps)
    else:
        out = torch.empty_like(x)
        if out.numel() == 0:
            return out
        _launch_layernorm(x, gamma, beta, eps, out,
                          *_layernorm_plan(x, out, gamma, beta))
    layernorm_rows.launches += 1
    return out


def _layernorm_plan(x: torch.Tensor, out: torch.Tensor,
                    gamma: torch.Tensor | None, beta: torch.Tensor | None
                    ) -> tuple[int, int, bool]:
    N, esize = x.shape[1], x.element_size()
    aligned = _aligned(x, out, gamma, beta)
    return (norm_plan(N, esize, aligned), *warp_plan(N, esize, aligned))


def _launch_layernorm(x: torch.Tensor, gamma: torch.Tensor | None,
                      beta: torch.Tensor | None, eps: float,
                      out: torch.Tensor, threads: int, slots: int,
                      vector: bool, mean: torch.Tensor | None = None,
                      rstd: torch.Tensor | None = None) -> None:
    """Runs the layernorm kernel on checked, non-empty CUDA operands: the
    one-pass kernel with ``threads`` threads a row (see ``norm_plan``),
    else the warp kernel with ``slots`` slots a lane (see ``warp_plan``),
    else, both 0, the block kernel; ``mean`` and ``rstd`` (R fp32 each,
    both or neither), where given, take each row's mean and ``rsqrt(var +
    eps)``."""
    R, N = x.shape
    fn = (_lib().sfu_layernorm_f32 if x.dtype == torch.float32
          else _lib().sfu_layernorm_bf16)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), _ptr(gamma), _ptr(beta), out.data_ptr(),
                 _ptr(mean), _ptr(rstd), R, N, eps, threads, slots,
                 int(vector), _stream(x))
    _build.check(err, "layernorm_rows")


class _LayerNorm(torch.autograd.Function):
    """layernorm on the card with its backward kernel: the forward keeps
    each row's mean and rstd (8 bytes a row) so that the backward need not
    recompute them."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        out = torch.empty_like(x)
        mean, rstd = (torch.empty(x.shape[0], dtype=torch.float32,
                                  device=x.device) for _ in range(2))
        if out.numel():
            _launch_layernorm(x, gamma, beta, eps, out,
                              *_layernorm_plan(x, out, gamma, beta),
                              mean, rstd)
        ctx.save_for_backward(x, gamma, beta, mean, rstd)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, gamma, beta, mean, rstd = ctx.saved_tensors
        dx, dgamma, dbeta = layernorm_bwd(x, gamma, beta, mean, rstd,
                                          dy.contiguous())
        return (dx, dgamma if ctx.needs_input_grad[1] else None,
                dbeta if ctx.needs_input_grad[2] else None, None)


def _check_bwd(what: str, x: torch.Tensor, dy: torch.Tensor,
               *stats: torch.Tensor) -> None:
    """dy must be x's shape, dtype and device, contiguous; each row
    statistic a contiguous fp32 (R,) on x's device."""
    R = x.shape[0]
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device \
            or not dy.is_contiguous():
        raise ValueError(f"{what}: dy must be a contiguous {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")
    for t in stats:
        if t.dtype != torch.float32 or tuple(t.shape) != (R,) \
                or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{what}: the row statistics must be "
                             f"contiguous float32 ({R},) on {x.device}")


def _bwd_grid(x: torch.Tensor, parts: int, *operands: torch.Tensor | None
              ) -> tuple[int, int, int, int, int]:
    """``(threads, rows, blocks, sum_warps, sum_vec)``: the norms'
    backward grid (``norm_bwd_plan``) and its column sum's
    (``column_sum_plan``)."""
    R, N = x.shape
    threads, rows, blocks = norm_bwd_plan(R, N, x.element_size(),
                                          _aligned(x, *operands),
                                          _build.sm_count(x.device), parts)
    return (threads, rows, blocks, *reversed(column_sum_plan(blocks, N)))


def layernorm_bwd(x: torch.Tensor, gamma: torch.Tensor | None,
                  beta: torch.Tensor | None, mean: torch.Tensor,
                  rstd: torch.Tensor, dy: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor | None,
                             torch.Tensor | None]:
    """layernorm's backward: ``(dx, dgamma, dbeta)`` from x (R, N), gamma
    and beta (fp32, or None: their gradient None), the forward's mean and
    rstd (R fp32 each) and dy (x's shape and dtype).  With x̂ = (x - mean)
    rstd and g = gamma dy, ``dx = rstd (g - mean(g) - x̂ mean(g x̂))`` in x's
    dtype, ``dgamma = Σ_rows dy x̂`` and ``dbeta = Σ_rows dy`` in fp32;
    deterministic (no atomics: per-block partial rows over a grid fixed by
    shape and card, then a column sum of each in a fixed order).  beta's
    values are not read: it only says whether dbeta is wanted."""
    if not _on_card(x, "layernorm_bwd", gamma, beta, dtypes=NORM_TYPES):
        return ref.layernorm_bwd(x, gamma, beta, mean, rstd, dy)
    _check_bwd("layernorm_bwd", x, dy, mean, rstd)
    R, N = x.shape
    dx = torch.empty_like(x)
    wanted = [p is not None for p in (gamma, beta)]
    if x.numel() == 0:
        return dx, *(torch.zeros(N, dtype=torch.float32, device=x.device)
                     if w else None for w in wanted)
    # the column sums write every column of dgamma and dbeta
    dgamma, dbeta = (torch.empty(N, dtype=torch.float32, device=x.device)
                     if w else None for w in wanted)
    threads, rows, blocks, sum_warps, sum_vec = _bwd_grid(
        x, sum(wanted), dy, dx, gamma)
    part, partb = (torch.empty((blocks, N), dtype=torch.float32,
                               device=x.device) if w else None
                   for w in wanted)
    fn = (_lib().sfu_layernorm_bwd_f32 if x.dtype == torch.float32
          else _lib().sfu_layernorm_bwd_bf16)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), _ptr(gamma), mean.data_ptr(), rstd.data_ptr(),
                 dy.data_ptr(), dx.data_ptr(), _ptr(part), _ptr(partb),
                 _ptr(dgamma), _ptr(dbeta), R, N, threads, rows, blocks,
                 sum_warps, sum_vec, _stream(x))
    _build.check(err, "layernorm_bwd")
    layernorm_bwd.launches += 1
    return dx, dgamma, dbeta


def act_rows(x: torch.Tensor, act: str) -> torch.Tensor:
    """Element-wise ``act`` (gelu in the tanh form, relu, relu2, silu)."""
    if act not in ACTIVATIONS:
        raise ValueError(f"unknown activation {act!r}")
    if not _on_card(x, "act_rows"):
        return ref.ACT_FN[act](x)
    _build.refuse_grad("act_rows", x)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    _launch_act(x, out, act, _aligned(x, out))
    act_rows.launches += 1
    return out


def _launch_act(x: torch.Tensor, out: torch.Tensor, act: str,
                vector: bool) -> None:
    """Runs the activation kernel on checked, non-empty CUDA operands: the
    float4 kernel (``vector``, x and out 16-byte aligned) or the scalar
    one."""
    with torch.cuda.device(x.device):
        err = _lib().sfu_act_f32(x.data_ptr(), out.data_ptr(), x.numel(),
                                 _build.ACT_CODE[act], int(vector),
                                 _stream(x))
    _build.check(err, "act_rows")


def rmsnorm_rows(x: torch.Tensor, gamma: torch.Tensor | None = None,
                 eps: float = 1e-6) -> torch.Tensor:
    """Row rmsnorm, ``x * rsqrt(sum(x²)/N + eps) * gamma``: x fp32 or
    bf16, gamma fp32 (optional), fp32 arithmetic, output in x's dtype.
    Under autograd the gradient comes from ``rmsnorm_bwd``."""
    if not _on_card(x, "rmsnorm_rows", gamma, dtypes=NORM_TYPES):
        return ref.rmsnorm_rows(x, gamma, eps)
    if _build.needs_grad(x, gamma):
        out = _RmsNorm.apply(x, gamma, eps)
    else:
        out = torch.empty_like(x)
        if out.numel() == 0:
            return out
        _launch_rmsnorm(x, gamma, eps, out, _plan(x, out, gamma))
    rmsnorm_rows.launches += 1
    return out


def _plan(x: torch.Tensor, out: torch.Tensor,
          gamma: torch.Tensor | None) -> int:
    return norm_plan(x.shape[1], x.element_size(), _aligned(x, out, gamma))


def _launch_rmsnorm(x: torch.Tensor, gamma: torch.Tensor | None, eps: float,
                    out: torch.Tensor, threads: int,
                    rstd: torch.Tensor | None = None) -> None:
    """Runs the rmsnorm kernel on checked, non-empty CUDA operands: the
    one-pass kernel with ``threads`` threads a row, or the scalar kernels
    for 0 (see ``norm_plan``); ``rstd`` (R fp32), where given, takes each
    row's ``rsqrt(sum(x²)/N + eps)``."""
    R, N = x.shape
    fn = (_lib().sfu_rmsnorm_f32 if x.dtype == torch.float32
          else _lib().sfu_rmsnorm_bf16)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), _ptr(gamma), out.data_ptr(), _ptr(rstd), R, N,
                 eps, threads, _stream(x))
    _build.check(err, "rmsnorm_rows")


class _RmsNorm(torch.autograd.Function):
    """rmsnorm on the card with its backward kernel: the forward keeps each
    row's rstd (4 bytes a row) so that the backward need not recompute
    it."""

    @staticmethod
    def forward(ctx, x, gamma, eps):
        out = torch.empty_like(x)
        rstd = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
        if out.numel():
            _launch_rmsnorm(x, gamma, eps, out, _plan(x, out, gamma), rstd)
        ctx.save_for_backward(x, gamma, rstd)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, gamma, rstd = ctx.saved_tensors
        dx, dgamma = rmsnorm_bwd(x, gamma, rstd, dy.contiguous())
        return dx, (dgamma if ctx.needs_input_grad[1] else None), None


def rmsnorm_bwd(x: torch.Tensor, gamma: torch.Tensor | None,
                rstd: torch.Tensor, dy: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """rmsnorm's backward: ``(dx, dgamma)`` from x (R, N), gamma (fp32, or
    None: dgamma None), the forward's rstd (R fp32) and dy (x's shape and
    dtype).  ``dx = rstd (gamma dy - x̂ mean(gamma dy x̂))`` in x's dtype and
    ``dgamma = Σ_rows dy x̂`` in fp32, x̂ = x rstd; deterministic (no
    atomics: per-block partial sums over a grid fixed by shape and card,
    then a second kernel sums them in a fixed order)."""
    if not _on_card(x, "rmsnorm_bwd", gamma, dtypes=NORM_TYPES):
        return ref.rmsnorm_bwd(x, gamma, rstd, dy)
    _check_bwd("rmsnorm_bwd", x, dy, rstd)
    R, N = x.shape
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return dx, None if gamma is None else torch.zeros(
            N, dtype=torch.float32, device=x.device)
    # the column sum writes every column of dgamma
    dgamma = None if gamma is None else torch.empty(
        N, dtype=torch.float32, device=x.device)
    threads, rows, blocks, sum_warps, sum_vec = _bwd_grid(x, 1, dy, dx,
                                                          gamma)
    part = None if gamma is None else torch.empty(
        (blocks, N), dtype=torch.float32, device=x.device)
    fn = (_lib().sfu_rmsnorm_bwd_f32 if x.dtype == torch.float32
          else _lib().sfu_rmsnorm_bwd_bf16)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), _ptr(gamma), rstd.data_ptr(), dy.data_ptr(),
                 dx.data_ptr(), _ptr(part), _ptr(dgamma), R, N, threads,
                 rows, blocks, sum_warps, sum_vec, _stream(x))
    _build.check(err, "rmsnorm_bwd")
    rmsnorm_bwd.launches += 1
    return dx, dgamma


softmax_rows.launches = 0
layernorm_rows.launches = 0
act_rows.launches = 0
rmsnorm_rows.launches = 0
rmsnorm_bwd.launches = 0
layernorm_bwd.launches = 0
