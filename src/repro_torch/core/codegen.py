"""Instruction generation: lower a Schedule to per-unit DORA instruction
streams (paper §4.1 step 3, case study §5).

Loop structure per MM layer (matching the stage-1 tile plan):

  for mi in tiles(M, lmu_m):
    for ni in tiles(N, lmu_n):
      for ki in tiles(K, lmu_k):            # OUT accumulates over ki
        MIU LOAD  lhs[mi,ki] -> group_lhs   (ready-list deps on 1st iter)
        MIU LOAD  rhs[ki,ni] -> group_rhs
        LMU MOVE  group_lhs  -> lead MMU    (count = #launches)
        LMU MOVE  group_rhs  -> lead MMU
        MMU GEMM  dynamic bounds, accumulate=(ki>0)   [lead + workers]
      SFU op      group_out -> group_nl     (if fused NL, full rows)
      MIU STORE   group_out/nl -> DRAM      (last store marks layer ready)

The flat emission order is the IDU fetch order (§5.2): every consumer
appears after its producers, so a *sequential* interpretation of the
binary is functionally correct (runtime.py), while the side-table
``meta`` carries the true dataflow dependencies + byte/cycle weights for
the *parallel* event-driven timing simulation (simulator.py). The binary
itself is self-contained; meta is derived information only.

The emission order (and the full ISA) is documented in docs/ISA.md;
``interleave.py`` may permute the stream at tile granularity afterwards
(see the ``interleave`` argument to :func:`generate`).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .graph import LayerKind, NonLinear, WorkloadGraph
from .isa import (Epilogue, Instruction, LMUBody, LmuRole, MIUBody, MMUBody,
                  OpType, Program, SFUBody, UnitKind, mk)
from .perf_model import DoraPlatform, ceil_div, round_up
from .schedule import Schedule

_NL_OP = {
    NonLinear.SOFTMAX: OpType.SFU_SOFTMAX,
    NonLinear.GELU: OpType.SFU_GELU,
    NonLinear.LAYERNORM: OpType.SFU_LAYERNORM,
    NonLinear.RELU: OpType.SFU_RELU,
    NonLinear.RELU2: OpType.SFU_RELU2,
    NonLinear.SILU: OpType.SFU_SILU,
}

_GROUP_MOD = 240  # group ids cycle; >60 concurrently-live layers never happen
                  # (bounded by #LMUs), so ids are unambiguous.


@dataclass
class MemoryMap:
    """DRAM linker table: tensor name <-> base address and shape."""

    by_name: dict[str, tuple[int, int, int]] = field(default_factory=dict)
    by_addr: dict[int, tuple[str, int, int]] = field(default_factory=dict)
    _next: int = 0

    def alloc(self, name: str, rows: int, cols: int,
              dtype_bytes: int = 4) -> int:
        addr = self._next
        self.by_name[name] = (addr, rows, cols)
        self.by_addr[addr] = (name, rows, cols)
        self._next = round_up(addr + rows * cols * dtype_bytes, 64)
        return addr


@dataclass
class InstrMeta:
    """Timing/dataflow side-table entry for one emitted instruction."""

    deps: list[int] = field(default_factory=list)   # producer instr indices
    bytes_moved: int = 0                            # MIU / LMU / SFU traffic
    mmu_cycles: int = 0                             # MMU compute cycles
    layer_id: int = -1
    unit_key: tuple[UnitKind, int] = (UnitKind.IDU, 0)
    tenant: int = -1                                # multi-tenant tag


@dataclass
class CodegenResult:
    program: Program
    memmap: MemoryMap
    meta: list[InstrMeta]
    # layer id -> index of the store instruction that marks it ready
    ready_store: dict[int, int] = field(default_factory=dict)
    # layer id -> tenant index (empty for single-tenant programs)
    tenant_of: dict[int, int] = field(default_factory=dict)


def generate(graph: WorkloadGraph, schedule: Schedule,
             platform: DoraPlatform,
             tenant_of: dict[int, int] | None = None,
             interleave: str = "none",
             interleave_priorities: dict[int, float] | None = None
             ) -> CodegenResult:
    """Lower ``schedule`` to the flat DORA instruction stream.

    ``interleave``: post-pass re-ordering the stream at tile granularity
    ("none" | "rr" | "priority", see ``interleave.interleave_stream``) so
    per-tenant/per-layer MIU traffic alternates instead of arriving one
    full tile loop at a time.  ``interleave_priorities`` weights the
    priority policy's channels (tenant index -> weight for multi-tenant
    programs, layer id -> weight otherwise)."""
    memmap = MemoryMap()
    for name, (r, c) in graph.inputs.items():
        memmap.alloc(name, r, c, platform.dtype_bytes)
    for layer in graph.topo_order():
        memmap.alloc(layer.name, *layer.out_shape(), platform.dtype_bytes)

    program = Program()
    meta: list[InstrMeta] = []
    ready_store: dict[int, int] = {}

    def emit(instr: Instruction, m: InstrMeta) -> int:
        m.unit_key = (instr.unit_kind, instr.unit_index)
        if tenant_of is not None and m.layer_id >= 0:
            m.tenant = tenant_of.get(m.layer_id, -1)
        program.append(instr)
        meta.append(m)
        return len(program) - 1

    by_layer = schedule.by_layer()
    for entry in sorted(schedule.entries, key=lambda e: (e.start, e.layer_id)):
        layer = graph.layers[entry.layer_id]
        g_lhs = (4 * layer.id) % _GROUP_MOD
        g_rhs, g_out, g_nl = g_lhs + 1, g_lhs + 2, g_lhs + 3
        dep_ids = tuple(layer.deps)
        lmu_lead = entry.lmu_ids[0] if entry.lmu_ids else 0
        sfu_id = entry.sfu_ids[0] if entry.sfu_ids else 0

        # -- LMU role configuration (flexible memory management, §3.2) ----
        if entry.lmu_ids:
            plan = entry.mode.plan
            roles: list[tuple[int, int]] = []
            if plan is not None:
                for _ in range(plan.lhs_lmus):
                    roles.append((int(LmuRole.LHS), g_lhs))
                for _ in range(plan.rhs_lmus):
                    roles.append((int(LmuRole.RHS), g_rhs))
                for _ in range(plan.out_lmus):
                    roles.append((int(LmuRole.OUT), g_out))
                for _ in range(plan.nl_lmus):
                    roles.append((int(LmuRole.NL), g_nl))
            while len(roles) < len(entry.lmu_ids):
                roles.append((int(LmuRole.OUT), g_out))
            for uid, (role, group) in zip(entry.lmu_ids, roles):
                emit(mk(UnitKind.LMU, uid, OpType.LMU_CFG,
                        LMUBody(0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                role=role, group=group)),
                     InstrMeta(layer_id=layer.id))

        if layer.kind is LayerKind.NL:
            _emit_streamed_nl(layer, entry, memmap, platform, emit,
                              dep_ids, g_out, g_nl, sfu_id, ready_store)
            continue

        plan = entry.mode.plan
        assert plan is not None
        M, K, N = layer.M, layer.K, layer.N
        lm = min(plan.lmu_m, round_up(M, 1))
        lk = min(plan.lmu_k, round_up(K, 1))
        ln = min(plan.lmu_n, round_up(N, 1))
        lhs_addr = memmap.by_name[layer.lhs][0]
        rhs_addr = memmap.by_name[layer.rhs][0]
        out_addr = memmap.by_name[layer.name][0]
        n_mi, n_ki, n_ni = ceil_div(M, lm), ceil_div(K, lk), ceil_div(N, ln)
        fused_nl = (layer.nonlinear is not None and ln >= N
                    and entry.mode.n_sfu > 0)
        lead_mmu = entry.mmu_ids[0] if entry.mmu_ids else 0
        dsz = platform.dtype_bytes

        prev_gemm_idx: list[int] = []     # ping/pong depth-2 back-pressure
        first_load = True
        for mi in range(n_mi):
            r0, r1 = mi * lm, min((mi + 1) * lm, M)
            for ni in range(n_ni):
                c0, c1 = ni * ln, min((ni + 1) * ln, N)
                gemm_of_iter = -1
                for ki in range(n_ki):
                    k0, k1 = ki * lk, min((ki + 1) * lk, K)
                    bp = [prev_gemm_idx[-2]] if len(prev_gemm_idx) >= 2 else []
                    i_lhs = emit(mk(UnitKind.MIU, 0, OpType.MIU_LOAD,
                                    MIUBody(lhs_addr, 0, g_lhs, M, K,
                                            r0, r1, k0, k1, layer.id,
                                            deps=dep_ids if first_load else ())),
                                 InstrMeta(deps=list(bp),
                                           bytes_moved=(r1 - r0) * (k1 - k0) * dsz,
                                           layer_id=layer.id))
                    i_rhs = emit(mk(UnitKind.MIU, 0, OpType.MIU_LOAD,
                                    MIUBody(rhs_addr, 0, g_rhs, K, N,
                                            k0, k1, c0, c1, layer.id,
                                            deps=dep_ids if first_load else ())),
                                 InstrMeta(deps=list(bp),
                                           bytes_moved=(k1 - k0) * (c1 - c0) * dsz,
                                           layer_id=layer.id))
                    first_load = False
                    launches = (ceil_div(r1 - r0, plan.launch_m)
                                * ceil_div(k1 - k0, plan.launch_k)
                                * ceil_div(c1 - c0, plan.launch_n))
                    i_mvl = emit(mk(UnitKind.LMU, lmu_lead, OpType.LMU_MOVE,
                                    LMUBody(0, 1, 1, 1, 0, lead_mmu,
                                            max(launches, 1),
                                            0, r1 - r0, 0, k1 - k0)),
                                 InstrMeta(deps=[i_lhs],
                                           bytes_moved=(r1 - r0) * (k1 - k0) * dsz,
                                           layer_id=layer.id))
                    i_mvr = emit(mk(UnitKind.LMU, lmu_lead, OpType.LMU_MOVE,
                                    LMUBody(0, 1, 1, 1, 0, lead_mmu,
                                            max(launches, 1),
                                            0, k1 - k0, 0, c1 - c0)),
                                 InstrMeta(deps=[i_rhs],
                                           bytes_moved=(k1 - k0) * (c1 - c0) * dsz,
                                           layer_id=layer.id))
                    epi = Epilogue.NONE
                    if (fused_nl and ki == n_ki - 1
                            and layer.nonlinear in (NonLinear.RELU,
                                                    NonLinear.RELU2,
                                                    NonLinear.GELU,
                                                    NonLinear.SILU)):
                        # element-wise NLs fuse into the MMU epilogue;
                        # row-reductions (softmax/LN) go to the SFU below
                        epi = {NonLinear.RELU: Epilogue.RELU,
                               NonLinear.RELU2: Epilogue.RELU2,
                               NonLinear.GELU: Epilogue.GELU,
                               NonLinear.SILU: Epilogue.SILU}[layer.nonlinear]
                    from .perf_model import mmu_launch_cycles, Policy
                    cyc = mmu_launch_cycles(
                        min(plan.launch_m, r1 - r0), plan.launch_k,
                        min(plan.launch_n, c1 - c0), platform,
                        Policy.dora()) * max(launches, 1)
                    gemm_deps = [i_mvl, i_mvr]
                    if ki > 0 and gemm_of_iter >= 0:
                        gemm_deps.append(gemm_of_iter)
                    i_gemm = emit(mk(UnitKind.MMU, lead_mmu, OpType.MMU_GEMM,
                                     MMUBody(1, 0, r1 - r0, k1 - k0, c1 - c0,
                                             g_lhs, g_rhs, g_out,
                                             accumulate=int(ki > 0),
                                             epilogue=int(epi),
                                             count=max(launches, 1))),
                                  InstrMeta(deps=gemm_deps, mmu_cycles=cyc,
                                            layer_id=layer.id))
                    # worker MMUs mirror the lead with their m/n slice
                    for w, wid in enumerate(entry.mmu_ids[1:], start=1):
                        share_m = ceil_div(r1 - r0, plan.mmu_m)
                        share_n = ceil_div(c1 - c0, plan.mmu_n)
                        emit(mk(UnitKind.MMU, wid, OpType.MMU_GEMM,
                                MMUBody(0, 0, share_m, k1 - k0, share_n,
                                        g_lhs, g_rhs, g_out,
                                        accumulate=int(ki > 0),
                                        epilogue=int(epi),
                                        count=max(launches, 1))),
                             InstrMeta(deps=[i_mvl, i_mvr],
                                       mmu_cycles=cyc, layer_id=layer.id))
                    gemm_of_iter = i_gemm
                    prev_gemm_idx.append(i_gemm)

                src_group, store_deps = g_out, [gemm_of_iter]
                if (fused_nl and layer.nonlinear in (NonLinear.SOFTMAX,
                                                     NonLinear.LAYERNORM)):
                    i_sfu = emit(mk(UnitKind.SFU, sfu_id,
                                    _NL_OP[layer.nonlinear],
                                    SFUBody(g_out, g_nl, r1 - r0, c1 - c0)),
                                 InstrMeta(deps=[gemm_of_iter],
                                           bytes_moved=2 * (r1 - r0)
                                           * (c1 - c0) * dsz,
                                           layer_id=layer.id))
                    src_group, store_deps = g_nl, [i_sfu]
                i_store = emit(mk(UnitKind.MIU, 0, OpType.MIU_STORE,
                                  MIUBody(out_addr, src_group, 0, M, N,
                                          r0, r1, c0, c1, layer.id)),
                               InstrMeta(deps=store_deps,
                                         bytes_moved=(r1 - r0) * (c1 - c0) * dsz,
                                         layer_id=layer.id))
                ready_store[layer.id] = i_store

        # un-fused row-reduction NL (tiled N): separate streamed pass
        if (layer.nonlinear is not None and not fused_nl
                and layer.nonlinear in (NonLinear.SOFTMAX, NonLinear.LAYERNORM)):
            _emit_inplace_nl(layer, entry, memmap, platform, emit,
                             g_out, g_nl, sfu_id, ready_store)
        elif (layer.nonlinear is not None and not fused_nl):
            _emit_inplace_nl(layer, entry, memmap, platform, emit,
                             g_out, g_nl, sfu_id, ready_store)

    _finalize_is_last(program)
    result = CodegenResult(program, memmap, meta, ready_store,
                           dict(tenant_of or {}))
    if interleave != "none":
        from .interleave import interleave_stream
        result = interleave_stream(result, policy=interleave,
                                   priorities=interleave_priorities)
    return result


def _emit_streamed_nl(layer, entry, memmap, platform, emit, dep_ids,
                      g_out, g_nl, sfu_id, ready_store):
    """Standalone NL layer: DRAM -> SFU (row stream) -> DRAM (§3.5)."""
    src_addr = memmap.by_name[layer.lhs][0]
    out_addr = memmap.by_name[layer.name][0]
    M, N = layer.M, layer.N
    dsz = platform.dtype_bytes
    i_ld = emit(mk(UnitKind.MIU, 0, OpType.MIU_LOAD,
                   MIUBody(src_addr, 0, g_out, M, N, 0, M, 0, N,
                           layer.id, deps=dep_ids)),
                InstrMeta(bytes_moved=M * N * dsz, layer_id=layer.id))
    i_sfu = emit(mk(UnitKind.SFU, sfu_id, _NL_OP[layer.nonlinear],
                    SFUBody(g_out, g_nl, M, N)),
                 InstrMeta(deps=[i_ld], bytes_moved=2 * M * N * dsz,
                           layer_id=layer.id))
    i_st = emit(mk(UnitKind.MIU, 0, OpType.MIU_STORE,
                   MIUBody(out_addr, g_nl, 0, M, N, 0, M, 0, N, layer.id)),
                InstrMeta(deps=[i_sfu], bytes_moved=M * N * dsz,
                          layer_id=layer.id))
    ready_store[layer.id] = i_st


def _emit_inplace_nl(layer, entry, memmap, platform, emit,
                     g_out, g_nl, sfu_id, ready_store):
    """Row-reduction NL over a tiled-N output: re-stream the stored MM
    result through the SFU (the paper's super-large-layer fallback)."""
    addr = memmap.by_name[layer.name][0]
    M, N = layer.M, layer.N
    dsz = platform.dtype_bytes
    prev = ready_store[layer.id]
    i_ld = emit(mk(UnitKind.MIU, 0, OpType.MIU_LOAD,
                   MIUBody(addr, 0, g_out, M, N, 0, M, 0, N, layer.id)),
                InstrMeta(deps=[prev], bytes_moved=M * N * dsz,
                          layer_id=layer.id))
    i_sfu = emit(mk(UnitKind.SFU, sfu_id, _NL_OP[layer.nonlinear],
                    SFUBody(g_out, g_nl, M, N)),
                 InstrMeta(deps=[i_ld], bytes_moved=2 * M * N * dsz,
                           layer_id=layer.id))
    i_st = emit(mk(UnitKind.MIU, 0, OpType.MIU_STORE,
                   MIUBody(addr, g_nl, 0, M, N, 0, M, 0, N, layer.id)),
                InstrMeta(deps=[i_sfu], bytes_moved=M * N * dsz,
                          layer_id=layer.id))
    ready_store[layer.id] = i_st


def _finalize_is_last(program: Program) -> None:
    last_of_unit: dict[tuple[UnitKind, int], int] = {}
    for i, instr in enumerate(program.instructions):
        last_of_unit[(instr.unit_kind, instr.unit_index)] = i
    for idx in last_of_unit.values():
        program.instructions[idx].is_last = True
