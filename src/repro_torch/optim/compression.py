"""Gradient compression for bandwidth-bound data parallelism: port of
``repro.optim.compression``.

int8 error-feedback quantization (the 1-bit-Adam / EF-SGD family): each
participant quantizes its gradient to int8 with one fp32 scale a tensor
and keeps the quantization residual as feedback for the next step.

  * ``compress`` / ``decompress`` and ``ef_quantize``: the numeric core;
  * ``ef_tree_init`` / ``ef_tree_quantize``: the same over a gradient
    tree (the numbers the wire compression gives after the all-reduce);
  * ``compressed_psum``: the data-parallel mean of the quantized
    gradients over a process group.  As the reference's ``psum`` does, it
    all-reduces each rank's dequantized fp32 contribution (the ranks'
    scales differ, so their int8 payloads cannot be summed as they are):
    its link traffic is an fp32 all-reduce's, 2·4·numel·(n-1)/n bytes a
    rank by the ring formula, which ``parallel.hlo_analysis`` counts from
    the recorded collective.  The train step keeps its fp32 gradient
    all-reduce, as the reference's does.

Rounding is half to even (``torch.round``, as ``jnp.round``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol

from .. import tree as T


def compress(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 symmetric quantization with one fp32 scale: (q, scale)."""
    g32 = g.float()
    # divided by a tensor: CUDA divides by a Python number as a product
    # with its reciprocal, one ulp off the quotient the CPU and XLA give
    scale = g32.abs().max() / torch.full((), 127.0, device=g.device) + 1e-12
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def ef_quantize(g: torch.Tensor, error: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One error-feedback step: quantize ``g + error``; returns (q, scale,
    the new error)."""
    target = g.float() + error.float()
    q, scale = compress(target)
    return q, scale, target - decompress(q, scale)


def ef_tree_init(grads):
    return T.tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                            device=g.device), grads)


def ef_tree_quantize(grads, errors):
    """Quantize and dequantize a whole gradient tree with error feedback:
    (the dequantized tree in each gradient's dtype, the new errors)."""
    flat_g, flat_e = T.leaves(grads), T.leaves(errors)
    ghat, new_e = [], []
    for g, e in zip(flat_g, flat_e):
        q, s, ne = ef_quantize(g, e)
        ghat.append(decompress(q, s, g.dtype))
        new_e.append(ne)
    return T.unflatten(grads, ghat), T.unflatten(grads, new_e)


def compressed_psum(g: torch.Tensor, group, error: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The int8-quantized mean of ``g`` over ``group`` (a process group,
    e.g. ``mesh.get_group("data")``) with error feedback: (the mean in
    g's dtype, this rank's new error).  One all-reduce of the dequantized
    contribution ``q * scale`` in fp32, as the reference's ``psum``."""
    q, scale, new_error = ef_quantize(g, error)
    total = funcol.all_reduce(decompress(q, scale), "sum", group)
    # divided by a tensor, as in compress
    n = torch.full((), float(dist.get_world_size(group)), device=g.device)
    return (total / n).to(g.dtype), new_error
