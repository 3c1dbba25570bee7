"""The kernel entry points: port of ``repro.kernels.ops``.

The DORA half: ``matmul`` (a 2-D GEMM with a fused epilogue), ``linear``
(leading dims flattened into rows), ``softmax`` and ``gelu`` over the
last dim (``src/repro/kernels/ops.py:54-110``).  A CUDA tensor goes to
``flex_gemm`` (its tiles and split-K cut from ``flex_gemm.gemm_plan``,
not the reference's TPU plan ``plan_tpu_gemm_tiles``), ``softmax_rows``
and ``act_rows(x, "gelu")``; a CPU tensor to ``ref.gemm``,
``ref.softmax_rows`` and ``ref.gelu_rows``.  No model calls these four,
so they take no DTensor (it raises, as in the wrappers).  Under autograd
on the card they raise (the kernels have no backward); on the CPU they
differentiate through their plain versions.

The serving half: ``rmsnorm`` and ``layernorm`` flatten the leading dims
into rows for the row kernels in x's own dtype
(``src/repro/kernels/ops.py:95-103``), ``attention`` takes the
``(B, H, S, D)`` layout of the attention kernel, ``ssd`` the
``(B, S, H, P)`` layout of the SSM block, and ``ssd_decode_step`` is
the plain one-token update (no kernel in either package).  A CUDA tensor
goes to the kernel and a CPU tensor to its plain version, through the
wrappers.

There is no ``set_kernel_mode``: the port keeps no global mode.  The
reference's "ref" is ``plain=True``, which names the plain version on
any device (``chip_smoke.py`` uses it to run the same model on the card
without the kernels); its "pallas" is a CUDA tensor.  ``plain`` is an
argument, never a fallback.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from . import _build, ref
from .flash_attention import flash_attention
from .flex_gemm import flex_gemm
from .sfu import act_rows, layernorm_rows, rmsnorm_rows, softmax_rows
from .ssd import ssd as ssd_kernel


# ------------------------------------------------------------ DTensor seam
#
# Under ``parallel.sharding.use_rules`` the model's tensors are DTensors.
# The serving half's entry points then call themselves through
# ``local_map`` on this rank's tensors: a kernel (ctypes, ``data_ptr()``)
# cannot read a DTensor, and its wrapper raises on one.  Inputs are
# redistributed to the placements each entry point states (a collective
# where they differ).

def _keep(x: DTensor, dims) -> list:
    """x's placements with a shard kept only on the tensor dims ``dims``."""
    return [p if isinstance(p, Shard) and p.dim in dims else Replicate()
            for p in x.placements]


def _as_dtensor(t, mesh):
    if t is None or isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _on_rank(fn, out_pl, in_pl, mesh, *args, grad_pl=None):
    """``fn`` on this rank's tensors of ``args`` laid out by ``in_pl``.
    ``grad_pl``: the layout of each input's gradient where it differs
    from the input's (a whole input used with each rank's part of the
    others gets a partial sum of its gradient on every rank)."""
    return local_map(fn, out_placements=out_pl, in_placements=in_pl,
                     in_grad_placements=grad_pl or in_pl, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def _partial_where(pl, whole) -> list:
    """The gradient layout of an input laid out by ``whole`` used beside
    an input laid out by ``pl``: a partial sum on the mesh dims where
    ``pl`` splits and ``whole`` does not."""
    return [Partial() if isinstance(p, Shard) and not isinstance(w, Shard)
            else w for p, w in zip(pl, whole)]


def _shard_index(mesh, placements, dim: int) -> tuple[int, int]:
    """(number of blocks, this rank's block) of tensor dim ``dim`` under
    ``placements``."""
    coord, n, idx = mesh.get_coordinate(), 1, 0
    for md, p in enumerate(placements):
        if isinstance(p, Shard) and p.dim == dim:
            n *= mesh.size(md)
            idx = idx * mesh.size(md) + coord[md]
    return n, idx


def _heads_for(n_q: int, n_kv: int, n_blocks: int, block: int
               ) -> list[int] | None:
    """The KV heads (or SSM groups) that this rank's query heads (block
    ``block`` of ``n_blocks``) read, when the KV heads are whole on every
    rank: one entry a local KV head, grouped as the local query heads
    expect (each KV head's query heads consecutive and as many), else one
    a query head.  None where the KV heads split with the query heads."""
    if n_kv % n_blocks == 0:
        return None
    nq = n_q // n_blocks
    of = [(block * nq + j) // (n_q // n_kv) for j in range(nq)]
    uniq = sorted(set(of))
    per = nq // len(uniq)
    if nq % len(uniq) == 0 and all(of[j] == uniq[j // per]
                                   for j in range(nq)):
        return uniq
    return of


def _select(t: torch.Tensor, heads: list[int] | None, dim: int):
    if heads is None:
        return t
    return t.index_select(dim, torch.tensor(heads, device=t.device))


# ---------------------------------------------------------- entry points

def matmul(a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor | None = None,
           epilogue: str = "none", *, plain: bool = False) -> torch.Tensor:
    """``epi(a @ b + bias)`` for a (M, K) and b (K, N), fp32 accumulation,
    in a's dtype; ``bias`` (N,) is read only by the ``bias*`` epilogues."""
    _build.refuse_dtensor("ops.matmul", a, b, bias)
    if plain:
        return ref.gemm(a, b, bias, epilogue)
    return flex_gemm(a.contiguous(), b.contiguous(), bias, epilogue=epilogue)


def linear(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None,
           epilogue: str = "none", *, plain: bool = False) -> torch.Tensor:
    """(..., K) @ (K, N) with the leading dims flattened into rows."""
    _build.refuse_dtensor("ops.linear", x, w, bias)
    rows = x.reshape(-1, x.shape[-1]).contiguous()
    out = matmul(rows, w, bias, epilogue, plain=plain)
    return out.reshape(*x.shape[:-1], w.shape[-1])


def softmax(x: torch.Tensor, *, plain: bool = False) -> torch.Tensor:
    """Softmax over the last dim (fp32 on the card)."""
    _build.refuse_dtensor("ops.softmax", x)
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    out = ref.softmax_rows(x2) if plain else softmax_rows(x2)
    return out.reshape(x.shape)


def gelu(x: torch.Tensor, *, plain: bool = False) -> torch.Tensor:
    """GELU in the tanh form, element-wise (fp32 on the card)."""
    _build.refuse_dtensor("ops.gelu", x)
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    out = ref.gelu_rows(x2) if plain else act_rows(x2, "gelu")
    return out.reshape(x.shape)


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor | None = None,
            eps: float = 1e-6, *, plain: bool = False) -> torch.Tensor:
    """rmsnorm over the last dim; fp32 or bf16 x, fp32 gamma.  A DTensor
    keeps its row shards; the normalised dim is made whole."""
    if isinstance(x, DTensor):
        pl = _keep(x, range(x.ndim - 1))
        g = _as_dtensor(gamma, x.device_mesh)
        rep = [Replicate()] * x.device_mesh.ndim
        if g is None:
            return _on_rank(lambda xl: rmsnorm(xl, None, eps, plain=plain),
                            pl, (pl,), x.device_mesh, x)
        return _on_rank(lambda xl, gl: rmsnorm(xl, gl, eps, plain=plain),
                        pl, (pl, rep), x.device_mesh, x, g,
                        grad_pl=(pl, _partial_where(pl, rep)))
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    out = ref.rmsnorm_rows(x2, gamma, eps) if plain \
        else rmsnorm_rows(x2, gamma, eps)
    return out.reshape(x.shape)


def layernorm(x: torch.Tensor, gamma: torch.Tensor | None = None,
              beta: torch.Tensor | None = None, eps: float = 1e-5, *,
              plain: bool = False) -> torch.Tensor:
    """layernorm over the last dim; fp32 or bf16 x, fp32 gamma and beta,
    fp32 arithmetic, output in x's dtype (one rounding, at the store).  A
    DTensor keeps its row shards."""
    if isinstance(x, DTensor):
        mesh = x.device_mesh
        pl = _keep(x, range(x.ndim - 1))
        rep = [Replicate()] * mesh.ndim
        if gamma is None or beta is None:
            raise ValueError("a sharded layernorm takes gamma and beta")
        part = _partial_where(pl, rep)
        return _on_rank(
            lambda xl, gl, bl: layernorm(xl, gl, bl, eps, plain=plain),
            pl, (pl, rep, rep), mesh, x, _as_dtensor(gamma, mesh),
            _as_dtensor(beta, mesh), grad_pl=(pl, part, part))
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    out = ref.layernorm_rows(x2, gamma, beta, eps) if plain \
        else layernorm_rows(x2, gamma, beta, eps)
    return out.reshape(x.shape)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, kv_len: int | None = None,
              chunked: bool = False, plain: bool = False) -> torch.Tensor:
    """GQA attention, q (B, Hq, Sq, D), k/v (B, Hkv, S, D), over the first
    ``kv_len`` KV rows.  ``kv_len`` is one length for the whole batch,
    as decode's ``pos + 1`` is (``repro``'s ``ops.attention`` takes a
    (B,) array and sends it to the oracle).  ``chunked`` (a long prefill)
    runs the plain version over query chunks (``ref.mha_attention_
    chunked``); the kernel is the same either way.

    DTensors keep their batch and head shards.  Where the query heads
    split over more blocks than the KV heads divide into (qwen3-4b's 8 KV
    heads on a 16-way model axis), the KV heads are whole on every rank
    and each rank reads the ones its query heads map to."""
    if isinstance(q, DTensor):
        mesh = q.device_mesh
        q_pl = _keep(q, (0, 1))
        n, block = _shard_index(mesh, q_pl, 1)
        heads = _heads_for(q.shape[1], k.shape[1], n, block)
        kv_pl = [p if heads is None or not (isinstance(p, Shard)
                                            and p.dim == 1) else Replicate()
                 for p in q_pl]

        def local(ql, kl, vl):
            return attention(ql, _select(kl, heads, 1).contiguous(),
                             _select(vl, heads, 1).contiguous(),
                             causal=causal, kv_len=kv_len, chunked=chunked,
                             plain=plain)

        kv_grad = _partial_where(q_pl, kv_pl)
        return _on_rank(local, q_pl, (q_pl, kv_pl, kv_pl), mesh, q,
                        _as_dtensor(k, mesh), _as_dtensor(v, mesh),
                        grad_pl=(q_pl, kv_grad, kv_grad))
    if plain:
        if chunked and kv_len is None:
            return ref.mha_attention_chunked(q, k, v, causal=causal)
        return ref.mha_attention(q, k, v, causal=causal, kv_len=kv_len)
    return flash_attention(q, k, v, causal=causal, kv_len=kv_len)


def ssd(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
        *, chunk: int = 128, initial_state: torch.Tensor | None = None,
        plain: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba-2 SSD over x (B, S, H, P), a (B, S, H), b/c (B, S, G, N) ->
    (y, final fp32 state (B, H, P, N)); see ``ref.ssd_scan``.  The
    reference's ``ops.ssd`` returns ``(y, None)`` on its kernel path; the
    kernel here writes the final state, so prefill takes it from there.
    ``plain`` chooses between the chunked algorithm and the recurrence as
    the reference does (``ref.ssd_plain``).

    DTensors keep their batch and head shards; b and c split on their
    groups where G divides as the heads do, else are whole on every rank,
    which reads the groups of its heads."""
    if isinstance(x, DTensor):
        mesh = x.device_mesh
        x_pl = _keep(x, (0, 2))
        n, block = _shard_index(mesh, x_pl, 2)
        groups = _heads_for(x.shape[2], b.shape[2], n, block)
        bc_pl = [p if groups is None or not (isinstance(p, Shard)
                                             and p.dim == 2) else Replicate()
                 for p in x_pl]
        st_pl = [Shard(1) if isinstance(p, Shard) and p.dim == 2 else p
                 for p in x_pl]
        args = [x, _as_dtensor(a, mesh), _as_dtensor(b, mesh),
                _as_dtensor(c, mesh)]
        in_pl = [x_pl, x_pl, bc_pl, bc_pl]
        bc_grad = _partial_where(x_pl, bc_pl)
        grad_pl = [x_pl, x_pl, bc_grad, bc_grad]
        if initial_state is not None:
            args.append(_as_dtensor(initial_state, mesh))
            in_pl.append(st_pl)
            grad_pl.append(st_pl)

        def local(xl, al, bl, cl, sl=None):
            return ssd(xl, al, _select(bl, groups, 2),
                       _select(cl, groups, 2), chunk=chunk,
                       initial_state=sl, plain=plain)

        return _on_rank(local, (x_pl, st_pl), tuple(in_pl), mesh, *args,
                        grad_pl=tuple(grad_pl))
    if plain:
        return ref.ssd_plain(x, a, b, c, chunk=chunk,
                             initial_state=initial_state)
    return ssd_kernel(x, a, b, c, chunk=chunk, initial_state=initial_state)


def ssd_decode_step(x_t: torch.Tensor, a_t: torch.Tensor, b_t: torch.Tensor,
                    c_t: torch.Tensor, state: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """One token of SSD (plain PyTorch on every device, as the reference's
    ``ops.ssd_decode_step`` is plain jnp): x_t (B, H, P), a_t (B, H),
    b_t/c_t (B, G, N), state (B, H, P, N) -> (y_t, new state).
    DTensors are laid out as ``ssd``'s."""
    if isinstance(x_t, DTensor):
        mesh = x_t.device_mesh
        x_pl = _keep(x_t, (0, 1))
        n, block = _shard_index(mesh, x_pl, 1)
        groups = _heads_for(x_t.shape[1], b_t.shape[1], n, block)
        bc_pl = [p if groups is None or not (isinstance(p, Shard)
                                             and p.dim == 1) else Replicate()
                 for p in x_pl]

        def local(xl, al, bl, cl, sl):
            return ref.ssd_decode_step(xl, al, _select(bl, groups, 1),
                                       _select(cl, groups, 1), sl)

        return _on_rank(local, (x_pl, x_pl), (x_pl, x_pl, bc_pl, bc_pl, x_pl),
                        mesh, x_t, _as_dtensor(a_t, mesh),
                        _as_dtensor(b_t, mesh), _as_dtensor(c_t, mesh),
                        _as_dtensor(state, mesh))
    return ref.ssd_decode_step(x_t, a_t, b_t, c_t, state)
