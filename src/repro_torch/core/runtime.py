"""Functional DORA runtime on PyTorch: a sequential interpreter of the
*binary* instruction stream (paper §5.2 control/data flow, numerics only).

Port of ``repro.core.runtime``.  The interpreter is the same; the DRAM
tensors and the LMU logical buffers (``groups``) are tensors on the
runtime's device, ``MMU_GEMM`` runs on the hand-written ``flex_gemm``
kernel (the paper's MMU) and the ``SFU_*`` ops on the SFU row kernels.
On a CPU device the kernels' wrappers use their plain versions.

The flat program order is the IDU fetch order; codegen guarantees every
consumer instruction appears after its producers, so sequential
interpretation is functionally exact.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Mapping

import numpy as np
import torch

from ..convert import inputs_to_torch, resolve_device
from ..kernels.flex_gemm import flex_gemm
from ..kernels.sfu import act_rows, layernorm_rows, softmax_rows
from .codegen import MemoryMap
from .isa import Epilogue, OpType, Program

# element-wise SFU ops -> activation of the act_rows kernel
SFU_ACT = {OpType.SFU_GELU: "gelu", OpType.SFU_RELU: "relu",
           OpType.SFU_RELU2: "relu2", OpType.SFU_SILU: "silu"}
_SFU_FN = {OpType.SFU_SOFTMAX: softmax_rows,
           OpType.SFU_LAYERNORM: layernorm_rows,
           **{op: partial(act_rows, act=act) for op, act in SFU_ACT.items()}}

# Epilogue.BIAS is a no-op, as in the reference runtime: the ISA carries
# no bias operand.
EPILOGUE_NAME = {Epilogue.NONE: "none", Epilogue.BIAS: "none",
                 Epilogue.GELU: "gelu", Epilogue.RELU: "relu",
                 Epilogue.RELU2: "relu2", Epilogue.SILU: "silu"}


@dataclass
class DoraRuntime:
    memmap: MemoryMap
    device: str | torch.device | None = None   # None: the CUDA card
    dram: dict[int, torch.Tensor] = field(default_factory=dict)
    groups: dict[int, torch.Tensor] = field(default_factory=dict)
    instr_executed: int = 0

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)

    def load_inputs(self, tensors: Mapping[str, np.ndarray | torch.Tensor]
                    ) -> None:
        for name, t in inputs_to_torch(tensors, self.memmap,
                                       self.device).items():
            self.dram[self.memmap.by_name[name][0]] = t

    def _tensor(self, addr: int) -> torch.Tensor:
        if addr not in self.dram:
            name, r, c = self.memmap.by_addr[addr]
            self.dram[addr] = torch.zeros((r, c), dtype=torch.float32,
                                          device=self.device)
        return self.dram[addr]

    def execute(self, program: Program | bytes) -> dict[str, torch.Tensor]:
        if isinstance(program, (bytes, bytearray)):
            program = Program.decode(bytes(program))
        for instr in program.instructions:
            op = instr.op_type
            b = instr.body
            if op == OpType.LMU_CFG or op == OpType.LMU_MOVE:
                pass  # routing only; dataflow is positional in the binary
            elif op == OpType.MIU_LOAD:
                t = self._tensor(b.ddr_addr)
                self.groups[b.des_lmu] = \
                    t[b.start_row:b.end_row, b.start_col:b.end_col].clone(
                        memory_format=torch.contiguous_format)
            elif op == OpType.MIU_STORE:
                t = self._tensor(b.ddr_addr)
                tile = self.groups[b.src_lmu]
                t[b.start_row:b.end_row, b.start_col:b.end_col] = tile
            elif op == OpType.MMU_GEMM:
                if b.ping_op != 1:
                    continue  # worker MMU: timing-only mirror of the lead
                lhs = self.groups[b.src_lmu]
                rhs = self.groups[b.src_lmu_rhs]
                if tuple(lhs.shape) != (b.bound_i, b.bound_k) or \
                        tuple(rhs.shape) != (b.bound_k, b.bound_j):
                    raise ValueError(
                        f"MMU bounds {b.bound_i}x{b.bound_k}x{b.bound_j} "
                        f"!= tiles {tuple(lhs.shape)} @ {tuple(rhs.shape)}")
                acc = self.groups[b.des_lmu] if b.accumulate else None
                epi = EPILOGUE_NAME[Epilogue(b.epilogue)]
                self.groups[b.des_lmu] = flex_gemm(lhs, rhs, epilogue=epi,
                                                   c=acc)
            elif op in _SFU_FN:
                x = self.groups[b.src_lmu]
                if tuple(x.shape) != (b.count, b.ele_num):
                    raise ValueError(f"SFU shape {tuple(x.shape)} != "
                                     f"({b.count},{b.ele_num})")
                self.groups[b.des_lmu] = _SFU_FN[op](x)
            elif op == OpType.IDU_HALT:
                break
            else:
                raise NotImplementedError(op)
            self.instr_executed += 1

        return {name: self.dram[addr]
                for name, (addr, _, _) in self.memmap.by_name.items()
                if addr in self.dram}
