"""Roofline terms of a traced step: port of
``repro.parallel.hlo_analysis`` (the name is kept so that a reader finds
the counterpart; there is no HLO here).

The reference reads FLOPs and bytes from XLA's ``cost_analysis`` and
parses the collectives out of the optimized HLO text.  The port runs the
step once on ``meta`` DTensors over a fake process group under
``TraceCounter``, a ``TorchDispatchMode`` that lets DTensor turn each op
into its local ops and collectives first, then counts on this rank:

  * FLOPs of every product (``torch.utils.flop_counter``'s formulas, on
    the local shapes: per chip);
  * bytes each op reads and writes (its tensor operands and results, view
    ops excluded): eager PyTorch runs one kernel an op, so this counts
    what XLA's fusion would spare;
  * every functional collective (``_c10d_functional.*``) as a record
    ``(op, bytes, group size)``.

``collective_stats`` turns records into per-chip link bytes with the
reference's ring formulas (T = the full tensor's bytes):

  all-gather      T * (g-1)/g      (T = the gathered tensor)
  reduce-scatter  T * (g-1)/g      (T = the tensor before the scatter)
  all-reduce      2T * (g-1)/g
  all-to-all      T * (g-1)/g
  collective-permute  T

Hardware constants (one NVIDIA H100 SXM, dense, NVIDIA's data sheet):
989e12 bf16 FLOP/s, 3.35e12 B/s HBM, and one link constant, as the
reference's ``ICI_BW``: NVLink 4 at 450e9 B/s a direction.  A 16-wide
model axis spans two 8-GPU nodes, whose link between them is slower than
NVLink, so the collective term is optimistic there.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

PEAK_FLOPS = 989e12          # bf16 per chip
HBM_BW = 3.35e12             # bytes/s per chip
LINK_BW = 450e9              # bytes/s per chip, one direction of NVLink 4


@dataclass
class CollectiveStats:
    per_op_bytes: dict[str, float] = field(default_factory=dict)
    per_op_count: dict[str, int] = field(default_factory=dict)
    link_bytes: float = 0.0          # per-chip bytes over the links
    raw_bytes: float = 0.0           # sum of tensor sizes (diagnostic)

    def dominant(self) -> str:
        if not self.per_op_bytes:
            return "none"
        return max(self.per_op_bytes, key=self.per_op_bytes.get)


def collective_stats(records) -> CollectiveStats:
    """Per-chip link bytes of ``records``, each ``(op, T bytes, group
    size)`` with ``op`` one of the reference's names."""
    stats = CollectiveStats()
    for op, T, g in records:
        if op == "all-reduce":
            link = 2.0 * T * (g - 1) / max(g, 1)
        elif op == "collective-permute":
            link = float(T)
        else:
            link = float(T) * (g - 1) / max(g, 1)
        stats.per_op_bytes[op] = stats.per_op_bytes.get(op, 0.0) + link
        stats.per_op_count[op] = stats.per_op_count.get(op, 0) + 1
        stats.link_bytes += link
        stats.raw_bytes += T
    return stats


@dataclass
class Roofline:
    flops: float
    hbm_bytes: float
    link_bytes: float
    n_chips: int

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.link_bytes / LINK_BW

    @property
    def bound(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def as_dict(self) -> dict:
        return {
            "flops_per_chip": self.flops,
            "hbm_bytes_per_chip": self.hbm_bytes,
            "link_bytes_per_chip": self.link_bytes,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bound": self.bound,
            "n_chips": self.n_chips,
        }


def roofline(flops: float, hbm_bytes: float, link_bytes: float,
             n_chips: int) -> Roofline:
    return Roofline(float(flops), float(hbm_bytes), float(link_bytes),
                    n_chips)


# functional collective -> the reference's name for it
_COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_size(name: str) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return dist.get_world_size(_resolve_process_group(name))


class TraceCounter(TorchDispatchMode):
    """Counts this rank's FLOPs, bytes read and written, and collective
    records (see the module's docstring) of the ops run under it.  An op
    on DTensors is handed back to DTensor (``NotImplemented``), which
    runs it as local ops and collectives that this mode then sees, as
    ``CommDebugMode`` does."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.records: list[tuple[str, int, int]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types):
            return out     # DTensor's shape inference, on global shapes
        packet = getattr(func, "_overloadpacket", None)
        ns = getattr(func, "namespace", "")
        if ns == "_c10d_functional":
            self._collective(func, args, out)
            return out
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if not getattr(func, "is_view", False):
            ins = [a for a in tree_flatten((args, kwargs))[0]
                   if isinstance(a, torch.Tensor)]
            outs = [o for o in tree_flatten(out)[0]
                    if isinstance(o, torch.Tensor)]
            self.bytes += sum(_nbytes(t) for t in ins + outs)
        return out

    def _collective(self, func, args, out) -> None:
        name = func._overloadpacket.__name__
        op = _COLLECTIVES.get(name)
        if op is None:           # wait_tensor and the like
            return
        tensors = [a for a in tree_flatten(args[0])[0]
                   if isinstance(a, torch.Tensor)]
        size = sum(_nbytes(t) for t in tensors)
        if op == "all-gather":
            g = int(args[1])
            self.records.append((op, size * g, g))
        elif op == "reduce-scatter":
            self.records.append((op, size, int(args[2])))
        else:
            self.records.append((op, size, _group_size(args[-1])))
