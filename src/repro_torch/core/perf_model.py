"""Stage-1 DSE: analytical performance model + candidate execution tables
(paper §4.2) and the baseline-accelerator policy models used by the
benchmark harness (CHARM-a/b, RSN, DORA ablations — Figs. 1/10/11).

The model follows the paper's derivation:

  per-PE kernel cycles  ->  MMU launch latency (4x4x4 PE composition)
  ->  latency_MMU (compute vs operand streaming)  ->  latency_LMU
  (one on-chip data-reuse iteration, DRAM overlap via ping/pong)
  ->  total = latency_LMU * iter_times,
      iter_times = ceil(M/LMU_m) * ceil(K/LMU_k) * ceil(N/LMU_n)

Two policy axes reproduce the paper's comparisons:
  flexible_parallelism (FP): dynamic loop bounds -> remainder tiles cost
      their true cycles; OFF -> every tile pads to the fixed PE tile.
  flexible_memory (FM): per-operand LMU roles/composition -> buffers
      sized to the operand; OFF -> operands quantize to a fixed square
      buffer granularity (padding inflates both storage and DRAM traffic).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from functools import lru_cache

import numpy as np

from .graph import Layer, LayerKind, NonLinear, WorkloadGraph


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return ceil_div(a, b) * b


# ---------------------------------------------------------------------------
# Platform
# ---------------------------------------------------------------------------

# MIU virtual-channel arbitration policies (see simulator._simulate_vc)
VC_ARBITRATIONS = ("fifo", "rr", "priority", "wfq")

# Stage-1 latency pricing models (CompileOptions.latency_model):
#   analytic — layer_latency's steady-state max(compute, stream, dram)
#              with perfect ping/pong overlap (the classic table);
#   pipeline — pipeline_layer_latency's explicit k-stage tile pipeline
#              (fill/drain per output group, in-order MIU issue
#              serialization, finite double-buffer depth).
LATENCY_MODELS = ("analytic", "pipeline")


@dataclass(frozen=True)
class DoraPlatform:
    """The DORA machine template (paper §3.7 / §6: 6 MMUs of 4x4x4 AIE
    tiles, 14 LMUs, 3 SFUs on VCK190)."""

    name: str = "vck190"
    freq_mmu_hz: float = 1.0e9        # AIE clock
    freq_pl_hz: float = 150.0e6      # PL clock (SFU/MIU/LMU control)
    n_mmu: int = 6
    n_lmu: int = 14
    n_sfu: int = 3
    pe_grid: tuple[int, int, int] = (4, 4, 4)   # PEs per MMU (m,k,n)
    macs_per_cycle_pe: int = 8        # fp32 vector MACs / cycle / AIE tile
    pe_mem_bytes: int = 24 * 1024     # usable AIE tile data memory
    lmu_bytes: int = 32 * 36 * 1024   # 32 URAM blocks per LMU
    dram_bw_bytes: float = 25.6e9     # LPDDR4 aggregate
    stream_bw_bytes: float = 2.4e9    # one PLIO stream port
    mmu_ports: int = 8                # parallel ingest ports per MMU
    sfu_elems_per_cycle: int = 8      # row-streaming NL throughput @ PL clk
    pipeline_fill_cycles: int = 12
    decode_overhead_cycles: int = 6   # dynamic-loop-bound decode (paper: ~1%)
    sync_overhead_s: float = 2.0e-6   # per on-chip iteration handshake
    startup_s: float = 10.0e-6        # per-layer instruction fetch/dispatch
    dtype_bytes: int = 4              # fp32 prototype
    # MIU virtual channels (simulator): number of per-tenant (or
    # per-layer-group) channels the physical MIU arbitrates between.
    # 1 = today's single in-order stream; the head of a blocked channel
    # never stalls ready traffic on another channel when vc_count > 1.
    vc_count: int = 1
    vc_arbitration: str = "fifo"      # fifo | rr | priority

    def __post_init__(self) -> None:
        if self.vc_count < 1:
            raise ValueError(f"vc_count must be >= 1, got {self.vc_count}")
        if self.vc_arbitration not in VC_ARBITRATIONS:
            raise ValueError(
                f"unknown vc_arbitration {self.vc_arbitration!r}; "
                f"expected one of {VC_ARBITRATIONS}")

    @property
    def pes_per_mmu(self) -> int:
        m, k, n = self.pe_grid
        return m * k * n

    @property
    def peak_macs_per_s(self) -> float:
        return (self.n_mmu * self.pes_per_mmu * self.macs_per_cycle_pe
                * self.freq_mmu_hz)

    @classmethod
    def vck190(cls) -> "DoraPlatform":
        return cls()

    def with_vc(self, vc_count: int, arbitration: str = "rr"
                ) -> "DoraPlatform":
        """Same platform with ``vc_count`` MIU virtual channels under the
        given arbitration policy (fifo | rr | priority | wfq); both
        values are validated by ``__post_init__``."""
        return replace(self, vc_count=vc_count, vc_arbitration=arbitration)

    def with_dram_bw(self, dram_bw_bytes: float) -> "DoraPlatform":
        """Same platform behind a different DRAM port bandwidth — how a
        mesh PE views the *shared* DRAM (``mesh.DoraMesh``): the mesh
        swaps each PE's private port rate for the shared aggregate,
        then prices the PE's guaranteed fraction of it via
        ``share_scaled_platform``."""
        if dram_bw_bytes <= 0.0:
            raise ValueError(
                f"dram_bw_bytes must be > 0, got {dram_bw_bytes}")
        return replace(self, dram_bw_bytes=dram_bw_bytes)

    @classmethod
    def tpu_v5e(cls) -> "DoraPlatform":
        """TPU v5e viewed through the DORA template: one MXU-equipped
        core = 1 'MMU' (128x128 systolic treated as a 1x1x1 PE grid with
        a wide vector), VMEM = 16 'LMUs' of 8 MiB."""
        return cls(
            name="tpu_v5e",
            freq_mmu_hz=0.94e9,
            freq_pl_hz=0.94e9,
            n_mmu=1,
            n_lmu=16,
            n_sfu=1,
            pe_grid=(1, 1, 1),
            macs_per_cycle_pe=128 * 128 * 4 // 2,  # ~197 bf16 TFLOP/s at .94GHz / 2 flops
            pe_mem_bytes=8 * 1024 * 1024,
            lmu_bytes=8 * 1024 * 1024,
            dram_bw_bytes=819.0e9,
            stream_bw_bytes=819.0e9,
            mmu_ports=1,
            sfu_elems_per_cycle=8 * 128,
            dtype_bytes=2,
        )


# ---------------------------------------------------------------------------
# Policies (DORA vs baselines)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Policy:
    name: str = "dora"
    flexible_parallelism: bool = True
    flexible_memory: bool = True
    fixed_pe_tile: tuple[int, int, int] = (32, 32, 32)
    buffer_granularity: int = 512     # rows/cols quantum when FM off
    # static accelerators cannot re-shape the MMU composition per layer:
    fixed_mmu_grid: tuple[int, int] | None = None   # (MMU_m, MMU_n)
    # static accelerators execute layers one-at-a-time on the whole array:
    monolithic: bool = False

    @classmethod
    def dora(cls) -> "Policy":
        return cls()

    @classmethod
    def dora_fp_only(cls) -> "Policy":
        return cls(name="dora-fp", flexible_memory=False)

    @classmethod
    def dora_fm_only(cls) -> "Policy":
        return cls(name="dora-fm", flexible_parallelism=False)

    @classmethod
    def charm_a(cls) -> "Policy":
        # monolithic CHARM design: fixed 3x2 MMU composition, padding
        return cls(name="charm-a", flexible_parallelism=False,
                   flexible_memory=False, fixed_mmu_grid=(3, 2),
                   monolithic=True)

    @classmethod
    def charm_b(cls) -> "Policy":
        # CHARM two-accelerator split: handled by CharmBModel below;
        # per-accelerator behaviour is still static.
        return cls(name="charm-b", flexible_parallelism=False,
                   flexible_memory=False, fixed_mmu_grid=(2, 2),
                   monolithic=True)

    @classmethod
    def rsn(cls) -> "Policy":
        # RSN: flexible on-chip routing (FM-ish) but parallelism/buffer
        # granularity tailored to medium models (paper §1 point d/e).
        return cls(name="rsn", flexible_parallelism=False,
                   flexible_memory=True, buffer_granularity=1024,
                   fixed_mmu_grid=(3, 2), monolithic=True)


# ---------------------------------------------------------------------------
# Candidate modes
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TilePlan:
    """Everything the code generator needs to emit instructions for one
    layer executed under one candidate mode."""

    aie_m: int
    aie_k: int
    aie_n: int
    mmu_m: int            # MMU composition along M
    mmu_n: int            # MMU composition along N
    lmu_m: int            # on-chip tile (data-reuse) sizes
    lmu_k: int
    lmu_n: int
    lhs_lmus: int         # LMUs holding each operand
    rhs_lmus: int
    out_lmus: int
    nl_lmus: int = 0

    @property
    def launch_m(self) -> int:
        return self.aie_m * 4 * self.mmu_m

    @property
    def launch_k(self) -> int:
        return self.aie_k * 4

    @property
    def launch_n(self) -> int:
        return self.aie_n * 4 * self.mmu_n


@dataclass(frozen=True)
class CandidateMode:
    """One row of the candidate execution table (paper Fig. 8b).

    ``priced_share`` records the effective DRAM-bandwidth fraction the
    mode's ``latency_s`` was priced at (share-aware stage 1 prices a
    tenant's rows at its guaranteed share; 1.0 = the classic
    full-bandwidth table).  ``latency_model`` records which pricing
    model produced ``latency_s`` (one of ``LATENCY_MODELS``) so later
    re-pricings — ``mode_latency_at_share``, the schedule bounds —
    stay consistent with the model the row was built under."""

    layer_id: int
    mode_id: int
    n_lmu: int
    n_mmu: int
    n_sfu: int
    latency_s: float
    plan: TilePlan | None = None
    priced_share: float = 1.0
    latency_model: str = "analytic"

    def dominates(self, other: "CandidateMode") -> bool:
        return (self.n_lmu <= other.n_lmu and self.n_mmu <= other.n_mmu
                and self.n_sfu <= other.n_sfu
                and self.latency_s <= other.latency_s
                and (self.n_lmu, self.n_mmu, self.n_sfu, self.latency_s)
                != (other.n_lmu, other.n_mmu, other.n_sfu, other.latency_s))


# ---------------------------------------------------------------------------
# Single-PE / single-MMU kernel model
# ---------------------------------------------------------------------------

def pe_mm_cycles(m: int, k: int, n: int, platform: DoraPlatform,
                 policy: Policy) -> int:
    """Cycles for one PE to compute an m x k x n tile.

    Dynamic loop bounds (FP on): the VLIW kernel runs its loop nest with
    the *actual* bounds; the vectorized innermost (n) dimension rounds up
    to the vector width; a small decode overhead reads the bounds
    (paper: ~1% degradation, Fig. 10 point b).

    Static kernel (FP off): the loop bounds are compile-time fixed, so
    the tile pads to ``fixed_pe_tile`` and always costs the full nest.
    """
    v = platform.macs_per_cycle_pe
    if policy.flexible_parallelism:
        body = m * k * ceil_div(n, v) if platform.pe_grid != (1, 1, 1) else \
            ceil_div(m * k * n, v)
        return body + platform.pipeline_fill_cycles + platform.decode_overhead_cycles
    tm, tk, tn = policy.fixed_pe_tile
    pm, pk, pn = round_up(max(m, 1), tm), round_up(max(k, 1), tk), round_up(max(n, 1), tn)
    body = pm * pk * ceil_div(pn, v) if platform.pe_grid != (1, 1, 1) else \
        ceil_div(pm * pk * pn, v)
    return body + platform.pipeline_fill_cycles


def mmu_launch_cycles(tm: int, tk: int, tn: int, platform: DoraPlatform,
                      policy: Policy) -> int:
    """One MMU (pe_grid composition) computing a (tm, tk, tn) tile."""
    gm, gk, gn = platform.pe_grid
    pm, pk, pn = ceil_div(tm, gm), ceil_div(tk, gk), ceil_div(tn, gn)
    cyc = pe_mm_cycles(pm, pk, pn, platform, policy)
    # cascade/reduction across the k dimension of the PE grid
    cyc += (gk - 1) * ceil_div(pn, platform.macs_per_cycle_pe)
    return cyc


def single_pe_efficiency(m: int, k: int, n: int, platform: DoraPlatform,
                         policy: Policy) -> float:
    """Fig. 10 metric: useful MACs / (cycles * MACs-per-cycle)."""
    cyc = pe_mm_cycles(m, k, n, platform, policy)
    ideal = m * k * n / platform.macs_per_cycle_pe
    return ideal / cyc


# ---------------------------------------------------------------------------
# Layer latency (paper §4.2)
# ---------------------------------------------------------------------------

def _operand_lmus(rows: int, cols: int, platform: DoraPlatform,
                  policy: Policy) -> tuple[int, int]:
    """(#LMUs, effective stored bytes incl. padding) for one operand tile,
    double-buffered (ping/pong)."""
    if policy.flexible_memory:
        r, c = rows, cols
    else:
        g = policy.buffer_granularity
        r, c = round_up(rows, g), round_up(cols, g)
    bytes_needed = 2 * r * c * platform.dtype_bytes   # ping + pong
    return max(1, ceil_div(bytes_needed, platform.lmu_bytes)), bytes_needed


def layer_latency(layer: Layer, plan: TilePlan, platform: DoraPlatform,
                  policy: Policy, n_sfu: int) -> float:
    """Total latency of one layer under one tile plan (seconds)."""
    if layer.kind is LayerKind.NL:
        rows, cols = layer.M, layer.N
        nl_t = rows * cols / (platform.sfu_elems_per_cycle * platform.freq_pl_hz)
        dram_t = 2 * rows * cols * platform.dtype_bytes / platform.dram_bw_bytes
        return max(nl_t, dram_t) + platform.startup_s

    M, K, N = layer.M, layer.K, layer.N
    if not policy.flexible_memory:
        g = policy.buffer_granularity
        M_eff, K_eff, N_eff = round_up(M, g), round_up(K, g), round_up(N, g)
    else:
        M_eff, K_eff, N_eff = M, K, N

    lm, lk, ln = (min(plan.lmu_m, round_up(M_eff, plan.launch_m)),
                  min(plan.lmu_k, round_up(K_eff, plan.launch_k)),
                  min(plan.lmu_n, round_up(N_eff, plan.launch_n)))
    launches = (ceil_div(lm, plan.launch_m) * ceil_div(lk, plan.launch_k)
                * ceil_div(ln, plan.launch_n))
    # remainder launches run with true bounds when FP is on
    lc = mmu_launch_cycles(min(plan.launch_m, M_eff), plan.launch_k,
                           min(plan.launch_n, N_eff), platform, policy)
    compute_t = launches * lc / platform.freq_mmu_hz

    # operand streaming LMU->MMU per on-chip iteration (port-parallel)
    stream_bytes = (lm * lk + lk * ln) * platform.dtype_bytes
    stream_t = stream_bytes / (platform.stream_bw_bytes * platform.mmu_ports)

    # DRAM traffic per on-chip iteration (ping/pong overlaps with compute)
    dram_bytes = (lm * lk + lk * ln) * platform.dtype_bytes
    k_iters = ceil_div(K_eff, lk)
    # OUT written once per (m,n) iteration (after the k loop)
    out_bytes = lm * ln * platform.dtype_bytes / k_iters
    dram_t = (dram_bytes + out_bytes) / platform.dram_bw_bytes

    iter_t = max(compute_t, stream_t, dram_t) + platform.sync_overhead_s
    iters = ceil_div(M_eff, lm) * k_iters * ceil_div(N_eff, ln)

    total = iters * iter_t + platform.startup_s

    # fused non-linearity, matching what codegen emits: element-wise NLs
    # with the full output row on chip fold into the MMU epilogue of the
    # last-k GEMM — zero extra instructions, zero simulator cost — so
    # they price at nothing here.  Row-reduction NLs (softmax/layernorm)
    # run on the SFU between the last GEMM and the STORE; row-streaming
    # overlaps at tile granularity, so an SFU adds only the drain of the
    # last tile.  Without an SFU grant (or with the row split across
    # tiles) codegen falls back to a separate streamed pass that re-reads
    # and re-writes the output through DRAM.
    if layer.nonlinear is not None:
        nl_t = M * N / (platform.sfu_elems_per_cycle * platform.freq_pl_hz)
        elementwise = layer.nonlinear not in (NonLinear.SOFTMAX,
                                              NonLinear.LAYERNORM)
        if n_sfu >= 1 and ln >= N_eff and elementwise:
            pass                          # free MMU epilogue
        elif n_sfu >= 1:
            total = max(total, nl_t) + nl_t / max(iters, 1)
        else:
            total += nl_t + 2 * M * N * platform.dtype_bytes / platform.dram_bw_bytes
    return total


# ---------------------------------------------------------------------------
# Pipeline-aware layer latency (stage-1 "pipeline" pricing model)
# ---------------------------------------------------------------------------

def _tile_sizes(total: int, tile: int) -> list[tuple[int, int]]:
    """(size, count) classes of the 1-D tiling of ``total`` by ``tile``:
    at most one remainder class, so a full 3-D grid has <= 8 distinct
    iteration classes regardless of how many iterations it runs."""
    if total <= tile:
        return [(total, 1)]
    full, rem = divmod(total, tile)
    out = [(tile, full)]
    if rem:
        out.append((rem, 1))
    return out


@lru_cache(maxsize=65536)
def _launch_cycles_cached(tm: int, tk: int, tn: int,
                          platform: DoraPlatform, policy: Policy) -> int:
    """Memoized ``mmu_launch_cycles``: the pipeline walk prices every
    iteration class of every enumerated tile combo, and the clamped
    launch bounds repeat heavily across reuse factors."""
    return mmu_launch_cycles(tm, tk, tn, platform, policy)


def plan_buffer_depth(plan: TilePlan, platform: DoraPlatform) -> int:
    """Operand-buffer depth the plan's LMU allocation actually sustains:
    how many in-flight tile copies (ping/pong = 2) fit in the LMUs
    reserved for the smaller of LHS/RHS.  The emitted stream's
    back-pressure (codegen: loads of iteration i wait on the GEMM of
    iteration i-2) caps the usable depth at 2, so this returns 1 (fully
    serial — a degenerate plan whose budget holds a single copy) or 2
    (the double-buffered steady state)."""
    dsz = platform.dtype_bytes
    lhs_copy = plan.lmu_m * plan.lmu_k * dsz
    rhs_copy = plan.lmu_k * plan.lmu_n * dsz
    depth = min(plan.lhs_lmus * platform.lmu_bytes // max(lhs_copy, 1),
                plan.rhs_lmus * platform.lmu_bytes // max(rhs_copy, 1))
    return max(1, min(2, int(depth)))


def pipeline_layer_latency(layer: Layer, plan: TilePlan | None,
                           platform: DoraPlatform, policy: Policy,
                           n_sfu: int, max_k_dp: int = 512,
                           analytic_floor: float | None = None) -> float:
    """Latency of one layer under one tile plan, pricing the tile loop
    as the explicit pipeline the code generator actually emits (seconds).

    ``layer_latency`` assumes perfect ping/pong overlap: every on-chip
    iteration costs ``max(compute, stream, dram)``, as if loads,
    LMU->MMU streaming, and GEMMs of different iterations overlapped
    freely.  The emitted stream cannot do that: the single in-order MIU
    serializes every LOAD/STORE, each iteration's GEMM sits behind its
    own loads and moves, the double-buffer back-pressure lets loads run
    at most ``plan_buffer_depth`` (= 2) iterations ahead, and each
    output group's STORE is an MIU barrier — the next group's loads
    queue behind it, so the pipeline refills per (mi, ni) group.  This
    model replays exactly that structure:

      - per (mi, ni) output group: prologue fill (first loads + first
        stream-in), then per k-iteration
        ``load -> move -> gemm`` with the in-order recurrences
        (load_i >= gemm_{i-depth}, one MIU, one LMU lead, one MMU
        chain), then the group's fused-SFU pass (row-reduction NLs)
        and the STORE drain;
      - remainder tiles are priced at their true sizes (the grid has
        <= 8 distinct iteration classes, so the walk is closed-form in
        the grid size; a per-class steady-state formula replaces the
        k-loop recurrence when ``k_iters > max_k_dp``);
      - groups serialize at their stores (the in-order MIU), so the
        layer total is the class-weighted sum of group times.

    Calibrated so it is provably >= the analytic bound: the result is
    ``max(pipeline replay, layer_latency(...))`` — never faster than
    the model every existing table, engine, and schedule bound already
    trusts — and it shrinks monotonically as ``dram_bw_bytes`` grows,
    so share-scaled re-pricing (``mode_latency_at_share``) keeps the
    contiguous <= interleave-aware <= oversubscription bound ordering.
    NL layers have no tile pipeline (one streamed pass) and price
    identically under both models.

    ``analytic_floor``: the caller's already-computed
    ``layer_latency(layer, plan, platform, policy, n_sfu)`` for the
    identical arguments, to skip recomputing it (the enumeration's
    pruning path prices it anyway).
    """
    analytic = (analytic_floor if analytic_floor is not None else
                layer_latency(layer, plan, platform, policy, n_sfu))
    if layer.kind is LayerKind.NL or plan is None:
        return analytic

    M, K, N = layer.M, layer.K, layer.N
    if not policy.flexible_memory:
        g = policy.buffer_granularity
        M, K, N = round_up(M, g), round_up(K, g), round_up(N, g)
    lm = min(plan.lmu_m, round_up(M, plan.launch_m))
    lk = min(plan.lmu_k, round_up(K, plan.launch_k))
    ln = min(plan.lmu_n, round_up(N, plan.launch_n))

    dsz = platform.dtype_bytes
    bw = platform.dram_bw_bytes
    sbw = platform.stream_bw_bytes * platform.mmu_ports
    sync = platform.sync_overhead_s
    depth = plan_buffer_depth(plan, platform)
    m_classes = _tile_sizes(M, lm)
    n_classes = _tile_sizes(N, ln)
    k_classes = _tile_sizes(K, lk)
    k_iters = sum(cnt for _, cnt in k_classes)
    # fused row-reduction NLs run on the SFU inside each group, between
    # the last GEMM and the STORE (codegen's fused_nl path needs the
    # whole row on chip: ln >= N); element-wise NLs fold into the MMU
    # epilogue and the un-fused fallback re-streams after the loop.
    fused_sfu = (layer.nonlinear is not None
                 and layer.nonlinear in (NonLinear.SOFTMAX,
                                         NonLinear.LAYERNORM)
                 and ln >= N and n_sfu >= 1)

    def _iter_times(mr: int, nr: int, ks: int) -> tuple[float, float, float]:
        """(load, move, gemm) stage times of one (mr, ks, nr) k-iteration
        — the same byte/cycle weights codegen attaches to the emitted
        instructions."""
        op_bytes = (mr * ks + ks * nr) * dsz
        launches = (ceil_div(mr, plan.launch_m) * ceil_div(ks, plan.launch_k)
                    * ceil_div(nr, plan.launch_n))
        cyc = _launch_cycles_cached(min(plan.launch_m, mr), plan.launch_k,
                                    min(plan.launch_n, nr), platform, policy)
        return (op_bytes / bw, op_bytes / sbw,
                max(launches, 1) * cyc / platform.freq_mmu_hz + sync)

    def _group_time(mr: int, nr: int) -> float:
        """One (mi, ni) output group: fill + k-loop pipeline + SFU +
        STORE drain, starting from an idle machine (the previous
        group's STORE drained every unit)."""
        if k_iters <= max_k_dp:
            # explicit per-iteration recurrence; the back-pressure
            # window only ever reaches `depth` (<= 2) iterations back,
            # so two rolling GEMM ends carry the whole DP state
            lend = mend = g1 = g2 = 0.0
            for ks, cnt in k_classes:
                l_t, m_t, g_t = _iter_times(mr, nr, ks)
                for _ in range(cnt):
                    bp = g2 if depth == 2 else g1
                    lend = max(lend, bp) + l_t
                    mend = max(mend, lend) + m_t
                    g2 = g1 if depth == 2 else 0.0
                    g1 = max(g1, mend) + g_t
            last = g1
        else:
            # closed-form steady state for huge k grids: the first
            # iteration runs its full serial chain (the pipeline fill —
            # its GEMM cannot start before its own load and stream-in),
            # then every later iteration advances the pipe by its
            # bottleneck period — the slowest stage, or the whole serial
            # chain split across the buffer depth when no stage
            # dominates.  Charging the fill *and* a full period for
            # iteration 0 would double-count the prologue per group.
            last = 0.0
            first = True
            for ks, cnt in k_classes:
                l_t, m_t, g_t = _iter_times(mr, nr, ks)
                if first:
                    last = l_t + m_t + g_t
                    cnt -= 1
                    first = False
                last += cnt * max(l_t, m_t, g_t, (l_t + m_t + g_t) / depth)
        if fused_sfu:
            last += mr * nr / (platform.sfu_elems_per_cycle
                               * platform.freq_pl_hz)
        return last + mr * nr * dsz / bw          # the STORE drain

    total = platform.startup_s
    for mr, cm in m_classes:
        for nr, cn in n_classes:
            total += cm * cn * _group_time(mr, nr)

    # non-fused NL epilogues, matching what codegen emits: element-wise
    # NLs with the full row on chip fold into the MMU epilogue (already
    # inside the GEMM cycles above); everything else re-streams the
    # stored output through the SFU as a separate DRAM pass.
    if layer.nonlinear is not None and not fused_sfu:
        row_on_chip = ln >= N and n_sfu >= 1
        elementwise = layer.nonlinear not in (NonLinear.SOFTMAX,
                                              NonLinear.LAYERNORM)
        if not (row_on_chip and elementwise):
            nl_t = layer.M * layer.N / (platform.sfu_elems_per_cycle
                                        * platform.freq_pl_hz)
            total += nl_t + 2 * layer.M * layer.N * dsz / bw
    return max(total, analytic)


# ---------------------------------------------------------------------------
# Process-level stage-1 memoization
# ---------------------------------------------------------------------------
#
# Stage-1 pricing is a pure function of (layer shape, platform, policy,
# share, latency_model, max_mmu): transformer stacks repeat the same few
# shapes dozens of times, every tenant of a multi-tenant compile repeats
# its neighbours' shapes, and the schedule bounds re-price the same rows
# at the same shares on every replay.  Two process-level memos exploit
# that: ``_TABLE_MEMO`` caches whole candidate-table rows for
# ``build_candidate_table``; ``_REPRICE_MEMO`` caches the scalar
# re-pricings behind ``mode_latency_at_share`` / ``mode_dram_demand``
# (the schedule bounds' hot loop).  Both are bounded (FIFO eviction) and
# resettable via ``clear_candidate_memo`` — the benchmark's cold/warm
# stage-1 timing hook.

_TABLE_MEMO: dict[tuple, tuple[CandidateMode, ...]] = {}
_REPRICE_MEMO: dict[tuple, float] = {}
_MEMO_STATS = {"table_hits": 0, "table_misses": 0,
               "reprice_hits": 0, "reprice_misses": 0}
_TABLE_MEMO_CAP = 4096
_REPRICE_MEMO_CAP = 65536


def _layer_signature(layer: Layer) -> tuple:
    """The shape signature stage-1 pricing depends on: two layers with
    equal signatures get identical candidate rows (modulo ``layer_id``).
    ``Layer`` itself is mutable/unhashable, so memo keys use this."""
    return (layer.kind, layer.M, layer.K, layer.N, layer.nonlinear)


def clear_candidate_memo() -> None:
    """Drop every process-level stage-1 memo entry (candidate tables and
    bound re-pricings) and zero the hit counters."""
    _TABLE_MEMO.clear()
    _REPRICE_MEMO.clear()
    for k in _MEMO_STATS:
        _MEMO_STATS[k] = 0


def candidate_memo_stats() -> dict[str, int]:
    """Snapshot of the stage-1 memo counters and current sizes."""
    return {**_MEMO_STATS, "table_size": len(_TABLE_MEMO),
            "reprice_size": len(_REPRICE_MEMO)}


def _memo_put(memo: dict, cap: int, key: tuple, value) -> None:
    if len(memo) >= cap:
        memo.pop(next(iter(memo)))    # FIFO: dicts keep insertion order
    memo[key] = value


# ---------------------------------------------------------------------------
# Interleave-aware transfer-time model (QoS)
# ---------------------------------------------------------------------------

def share_scaled_platform(platform: DoraPlatform,
                          share: float) -> DoraPlatform:
    """The platform as one tenant sees it while its MIU traffic is
    interleaved with other tenants' traffic under weighted-fair
    arbitration: the DRAM bandwidth shrinks to the tenant's guaranteed
    share, everything on-chip is unchanged.  This is the transfer-time
    model behind the interleave-aware schedule bound
    (``schedule.interleave_aware_bound``)."""
    if not 0.0 < share <= 1.0:
        raise ValueError(f"bandwidth share must be in (0, 1], got {share}")
    return replace(platform, dram_bw_bytes=platform.dram_bw_bytes * share)


def mode_latency_at_share(layer: Layer, mode: "CandidateMode",
                          platform: DoraPlatform, policy: Policy,
                          share: float) -> float:
    """Re-evaluate one candidate mode's latency with the layer's DRAM
    transfers running at ``share`` of the platform bandwidth (the
    tenant's guaranteed share while other tenants' interleaved traffic
    contends for the MIU).  ``share=1`` reproduces ``mode.latency_s``;
    shrinking the share can only inflate the DRAM-bound component, so
    the result is monotonically >= the contiguous-assumption latency.
    The re-pricing honours the model the row was built under
    (``mode.latency_model``): a pipeline-priced row is re-priced with
    ``pipeline_layer_latency``, keeping the schedule bounds' ordering
    intact under either stage-1 pricing.  Results are memoized
    process-wide (``_REPRICE_MEMO``): the schedule bounds re-price the
    same (shape, plan, share) triples on every replay and across
    repeated layers, so the bound loops hit instead of re-walking the
    pipeline model."""
    if share >= 1.0:
        return mode.latency_s
    key = ("lat", _layer_signature(layer), mode.plan, mode.n_sfu,
           mode.latency_model, share, platform, policy)
    hit = _REPRICE_MEMO.get(key)
    if hit is not None:
        _MEMO_STATS["reprice_hits"] += 1
        return hit
    _MEMO_STATS["reprice_misses"] += 1
    scaled = share_scaled_platform(platform, share)
    price = (pipeline_layer_latency if mode.latency_model == "pipeline"
             else layer_latency)
    val = price(layer, mode.plan, scaled, policy,
                n_sfu=mode.n_sfu)
    _memo_put(_REPRICE_MEMO, _REPRICE_MEMO_CAP, key, val)
    return val


def layer_dram_bytes(layer: Layer, plan: TilePlan | None,
                     platform: DoraPlatform, policy: Policy) -> float:
    """Total DRAM traffic (bytes) one layer moves under one tile plan —
    the numerator of the layer's average bandwidth demand.  Mirrors the
    per-iteration traffic terms of ``layer_latency`` (operands streamed
    every on-chip iteration, OUT written once per (m, n) iteration); NL
    layers read and write their tensor once."""
    if layer.kind is LayerKind.NL or plan is None:
        return 2.0 * layer.M * layer.N * platform.dtype_bytes

    M, K, N = layer.M, layer.K, layer.N
    if not policy.flexible_memory:
        g = policy.buffer_granularity
        M, K, N = round_up(M, g), round_up(K, g), round_up(N, g)
    lm = min(plan.lmu_m, round_up(M, plan.launch_m))
    lk = min(plan.lmu_k, round_up(K, plan.launch_k))
    ln = min(plan.lmu_n, round_up(N, plan.launch_n))
    k_iters = ceil_div(K, lk)
    iters = ceil_div(M, lm) * k_iters * ceil_div(N, ln)
    per_iter = ((lm * lk + lk * ln) * platform.dtype_bytes
                + lm * ln * platform.dtype_bytes / k_iters)
    # a fused non-linearity stays on chip with an SFU (candidate modes
    # always grant one), so it adds no DRAM round trip here
    return iters * per_iter


def mode_dram_demand(layer: Layer, mode: "CandidateMode",
                     platform: DoraPlatform, policy: Policy) -> float:
    """Average DRAM bandwidth demand (fraction of ``dram_bw_bytes``)
    while the mode runs at full speed: total traffic over the mode's
    full-bandwidth latency.  Used by the oversubscription-aware bound to
    split a tenant's bandwidth among its *concurrent* layers in
    proportion to what each actually pulls.

    Always re-derived on the *physical* platform — ``mode.latency_s``
    may be share-priced (share-aware stage 1), and a share-priced
    denominator would understate the demand by up to the priced-share
    factor.  The denominator follows the row's ``latency_model``
    (pipeline-priced rows spread the same bytes over the longer
    pipeline latency, so their average demand is lower).  NL candidates
    carry no plan; ``layer_latency``'s NL branch ignores the plan, so a
    placeholder is enough to re-price them.  Memoized process-wide
    (``_REPRICE_MEMO``) for the oversubscription bound's per-window
    demand splits."""
    key = ("demand", _layer_signature(layer), mode.plan, mode.n_sfu,
           mode.latency_model, mode.latency_s, platform, policy)
    hit = _REPRICE_MEMO.get(key)
    if hit is not None:
        _MEMO_STATS["reprice_hits"] += 1
        return hit
    _MEMO_STATS["reprice_misses"] += 1
    price = (pipeline_layer_latency if mode.latency_model == "pipeline"
             else layer_latency)
    if mode.plan is not None:
        lat = price(layer, mode.plan, platform, policy,
                    n_sfu=mode.n_sfu)
    elif layer.kind is LayerKind.NL:
        lat = layer_latency(layer, TilePlan(8, 8, 8, 1, 1, layer.M, 1,
                                            layer.N, 1, 0, 1),
                            platform, policy, n_sfu=mode.n_sfu)
    else:
        lat = mode.latency_s
    if lat <= 0.0:
        val = 0.0
    else:
        bytes_total = layer_dram_bytes(layer, mode.plan, platform, policy)
        val = min(1.0, bytes_total / lat / platform.dram_bw_bytes)
    _memo_put(_REPRICE_MEMO, _REPRICE_MEMO_CAP, key, val)
    return val


# ---------------------------------------------------------------------------
# Stage-1 enumeration: candidate execution table
# ---------------------------------------------------------------------------

_AIE_TILE_MENU = (8, 16, 32, 64)
# on-chip reuse factors: grow the LMU tile while it fits
_REUSE_M = (1, 2, 4, 8)
_REUSE_N = (1, 2, 4, 8)
_REUSE_K = (1, 2, 4)


def _pe_tile_options(platform: DoraPlatform, policy: Policy):
    if not policy.flexible_parallelism:
        yield policy.fixed_pe_tile
        return
    for am in _AIE_TILE_MENU:
        for ak in _AIE_TILE_MENU:
            for an in _AIE_TILE_MENU:
                need = (am * ak + ak * an + am * an) * platform.dtype_bytes
                if need <= platform.pe_mem_bytes:
                    yield (am, ak, an)


def _mmu_grid_options(n_mmu: int, policy: Policy,
                      max_mmu: int | None = None):
    if max_mmu is not None:
        n_mmu = max(1, min(n_mmu, max_mmu))
    if policy.fixed_mmu_grid is not None:
        gm, gn = policy.fixed_mmu_grid
        if gm * gn <= n_mmu:
            yield (gm, gn)
        else:
            yield (1, 1)
        return
    for gm in range(1, n_mmu + 1):
        for gn in range(1, n_mmu // gm + 1):
            yield (gm, gn)


def _check_enum_args(bandwidth_share: float, latency_model: str) -> None:
    if not 0.0 < bandwidth_share <= 1.0:
        raise ValueError(
            f"bandwidth_share must be in (0, 1], got {bandwidth_share}")
    if latency_model not in LATENCY_MODELS:
        raise ValueError(f"unknown latency_model {latency_model!r}; "
                         f"expected one of {LATENCY_MODELS}")


def _nl_candidate(layer: Layer, platform: DoraPlatform,
                  pricing: DoraPlatform, policy: Policy, price,
                  bandwidth_share: float, latency_model: str
                  ) -> list[CandidateMode]:
    """NL layers have one streamed execution mode — no tile grid."""
    lmus, _ = _operand_lmus(layer.M, layer.N, platform, policy)
    lat = price(layer, TilePlan(8, 8, 8, 1, 1, layer.M, 1,
                                layer.N, 1, 0, 1), pricing,
                policy, n_sfu=1)
    return [CandidateMode(layer.id, 0, min(lmus, platform.n_lmu), 0, 1,
                          lat, None, priced_share=bandwidth_share,
                          latency_model=latency_model)]


def _skip_grid(gm: int, gn: int, platform: DoraPlatform,
               policy: Policy) -> bool:
    return policy.monolithic and gm * gn < min(
        platform.n_mmu, (policy.fixed_mmu_grid or (1, 1))[0]
        * (policy.fixed_mmu_grid or (1, 1))[1])


def _pareto_cap(cands: list[CandidateMode],
                max_modes: int) -> list[CandidateMode]:
    """Pareto prune (resources vs latency), cap, re-id."""
    pareto: list[CandidateMode] = []
    for c in sorted(cands, key=lambda c: (c.latency_s, c.n_mmu, c.n_lmu)):
        if not any(p.dominates(c) for p in pareto):
            pareto.append(c)
    pareto = pareto[:max_modes]
    return [replace(c, mode_id=i) for i, c in enumerate(pareto)]


def _grid_combo_arrays(layer: Layer, platform: DoraPlatform,
                       policy: Policy, gm: int, gn: int,
                       pe_opts: tuple[tuple[int, int, int], ...]):
    """All (pe tile x reuse) combos of one (gm, gn) MMU grid as int64
    arrays of shape (P, |rm|, |rn|, |rk|) — C-order ravel matches the
    scalar reference loop's iteration order exactly, which is what makes
    the vectorized tie-breaking bit-for-bit identical.

    Returns (launch_m, launch_k, launch_n, lm, lk, ln, n_lmu, feasible);
    the capacity check runs on the *physical* platform, like the scalar
    loop, regardless of any share-scaled pricing platform."""
    M, K, N = layer.M, layer.K, layer.N
    P = len(pe_opts)
    am = np.asarray([o[0] for o in pe_opts], dtype=np.int64).reshape(P, 1, 1, 1)
    ak = np.asarray([o[1] for o in pe_opts], dtype=np.int64).reshape(P, 1, 1, 1)
    an = np.asarray([o[2] for o in pe_opts], dtype=np.int64).reshape(P, 1, 1, 1)
    rm = np.asarray(_REUSE_M, dtype=np.int64).reshape(1, -1, 1, 1)
    rn = np.asarray(_REUSE_N, dtype=np.int64).reshape(1, 1, -1, 1)
    rk = np.asarray(_REUSE_K, dtype=np.int64).reshape(1, 1, 1, -1)
    launch_m, launch_k, launch_n = am * 4 * gm, ak * 4, an * 4 * gn

    def rup(x, b):
        return -(-x // b) * b

    lm = np.minimum(launch_m * rm, rup(M, launch_m))
    lk = np.minimum(launch_k * rk, rup(K, launch_k))
    ln = np.minimum(launch_n * rn, rup(N, launch_n))

    def op_lmus(rows, cols):
        # vectorized _operand_lmus (LMU count only)
        if not policy.flexible_memory:
            g = policy.buffer_granularity
            rows, cols = rup(rows, g), rup(cols, g)
        need = 2 * rows * cols * platform.dtype_bytes
        return np.maximum(1, -(-need // platform.lmu_bytes))

    l_nl = 1 if layer.nonlinear is not None else 0
    n_lmu = op_lmus(lm, lk) + op_lmus(lk, ln) + op_lmus(lm, ln) + l_nl
    feasible = n_lmu <= platform.n_lmu
    return launch_m, launch_k, launch_n, lm, lk, ln, n_lmu, feasible


def _analytic_latency_array(layer: Layer, pricing: DoraPlatform,
                            policy: Policy, n_sfu: int,
                            launch_m, launch_k, launch_n,
                            lm, lk, ln) -> np.ndarray:
    """``layer_latency``'s MM path over a whole combo array at once,
    replicating the scalar arithmetic operation for operation (same
    int->float conversions, same division and max order) so every
    element is bit-for-bit the scalar result."""
    M, K, N = layer.M, layer.K, layer.N
    if not policy.flexible_memory:
        g = policy.buffer_granularity
        M_eff, K_eff, N_eff = round_up(M, g), round_up(K, g), round_up(N, g)
    else:
        M_eff, K_eff, N_eff = M, K, N

    def rup(x, b):
        return -(-x // b) * b

    def cdiv(a, b):
        return -(-a // b)

    lm = np.minimum(lm, rup(M_eff, launch_m))
    lk = np.minimum(lk, rup(K_eff, launch_k))
    ln = np.minimum(ln, rup(N_eff, launch_n))
    launches = cdiv(lm, launch_m) * cdiv(lk, launch_k) * cdiv(ln, launch_n)
    lc = np.asarray(
        [_launch_cycles_cached(min(int(bm), M_eff), int(bk),
                               min(int(bn), N_eff), pricing, policy)
         for bm, bk, bn in zip(launch_m.ravel(), launch_k.ravel(),
                               launch_n.ravel())],
        dtype=np.int64).reshape(launch_m.shape)
    compute_t = launches * lc / pricing.freq_mmu_hz

    stream_bytes = (lm * lk + lk * ln) * pricing.dtype_bytes
    stream_t = stream_bytes / (pricing.stream_bw_bytes * pricing.mmu_ports)

    dram_bytes = (lm * lk + lk * ln) * pricing.dtype_bytes
    k_iters = cdiv(K_eff, lk)
    out_bytes = lm * ln * pricing.dtype_bytes / k_iters
    dram_t = (dram_bytes + out_bytes) / pricing.dram_bw_bytes

    iter_t = np.maximum(np.maximum(compute_t, stream_t), dram_t) \
        + pricing.sync_overhead_s
    iters = cdiv(M_eff, lm) * k_iters * cdiv(N_eff, ln)
    total = iters * iter_t + pricing.startup_s

    if layer.nonlinear is not None:
        nl_t = M * N / (pricing.sfu_elems_per_cycle * pricing.freq_pl_hz)
        elementwise = layer.nonlinear not in (NonLinear.SOFTMAX,
                                              NonLinear.LAYERNORM)
        if n_sfu >= 1:
            charged = np.maximum(total, nl_t) + nl_t / np.maximum(iters, 1)
            total = np.where(ln >= N_eff, total, charged) if elementwise \
                else charged
        else:
            total = total + nl_t \
                + 2 * M * N * pricing.dtype_bytes / pricing.dram_bw_bytes
    return total


def _lex_argmin(lat: np.ndarray, n_lmu: np.ndarray) -> int:
    """First index of the lexicographic minimum over (lat, n_lmu, index)
    — the scalar loop's best-for-grid update rule."""
    sel = lat == lat.min()
    sel &= n_lmu == n_lmu[sel].min()
    return int(np.argmax(sel))


def _combo_plan(layer: Layer, platform: DoraPlatform, policy: Policy,
                gm: int, gn: int,
                pe_opts: tuple[tuple[int, int, int], ...],
                flat_idx: int, shape: tuple[int, ...]) -> TilePlan:
    """Materialize the TilePlan of one flat combo index, with exactly
    the scalar loop's integer arithmetic."""
    p, irm, irn, irk = np.unravel_index(flat_idx, shape)
    am, ak, an = pe_opts[p]
    launch_m, launch_k, launch_n = am * 4 * gm, ak * 4, an * 4 * gn
    lm = min(launch_m * _REUSE_M[irm], round_up(layer.M, launch_m))
    lk = min(launch_k * _REUSE_K[irk], round_up(layer.K, launch_k))
    ln = min(launch_n * _REUSE_N[irn], round_up(layer.N, launch_n))
    l_lhs, _ = _operand_lmus(lm, lk, platform, policy)
    l_rhs, _ = _operand_lmus(lk, ln, platform, policy)
    l_out, _ = _operand_lmus(lm, ln, platform, policy)
    l_nl = 1 if layer.nonlinear is not None else 0
    return TilePlan(am, ak, an, gm, gn, lm, lk, ln,
                    l_lhs, l_rhs, l_out, l_nl)


def _grid_best_vectorized(layer: Layer, platform: DoraPlatform,
                          pricing: DoraPlatform, policy: Policy,
                          gm: int, gn: int,
                          pe_opts: tuple[tuple[int, int, int], ...],
                          bandwidth_share: float, latency_model: str
                          ) -> CandidateMode | None:
    """Winner of one (gm, gn) MMU grid over every (pe tile, reuse)
    combo — identical (value and tie-break) to the scalar inner loop.

    Analytic pricing is batched over the whole combo array.  For
    pipeline pricing the analytic array is the exact prune:
    ``pipeline >= analytic`` per row, so after seeding the bound with
    the pipeline latency of the analytic argmin combo, any combo whose
    analytic latency exceeds the bound is strictly slower than the
    winner and provably cannot win or tie; the survivors are walked in
    original order with the scalar update rule."""
    if not pe_opts:
        return None
    needs_sfu = layer.nonlinear is not None
    n_sfu = 1 if needs_sfu else 0
    (launch_m, launch_k, launch_n,
     lm, lk, ln, n_lmu, feasible) = _grid_combo_arrays(
        layer, platform, policy, gm, gn, pe_opts)
    if not feasible.any():
        return None
    a_lat = _analytic_latency_array(layer, pricing, policy, n_sfu,
                                    launch_m, launch_k, launch_n,
                                    lm, lk, ln)
    shape = np.broadcast_shapes(a_lat.shape, n_lmu.shape)
    flat_lat = np.where(feasible, a_lat, np.inf).ravel()
    flat_lmu = np.broadcast_to(n_lmu, shape).ravel()

    best_idx = _lex_argmin(flat_lat, flat_lmu)
    if latency_model != "pipeline":
        plan = _combo_plan(layer, platform, policy, gm, gn, pe_opts,
                           best_idx, shape)
        return CandidateMode(layer.id, -1, int(flat_lmu[best_idx]), gm * gn,
                             n_sfu, float(flat_lat[best_idx]), plan,
                             priced_share=bandwidth_share,
                             latency_model=latency_model)

    seed_plan = _combo_plan(layer, platform, policy, gm, gn, pe_opts,
                            best_idx, shape)
    seed_lat = pipeline_layer_latency(layer, seed_plan, pricing, policy,
                                      n_sfu=n_sfu,
                                      analytic_floor=float(flat_lat[best_idx]))
    best: CandidateMode | None = None
    for i in np.flatnonzero(flat_lat <= seed_lat):
        i = int(i)
        if best is not None and flat_lat[i] > best.latency_s:
            continue
        if i == best_idx:
            plan, lat = seed_plan, seed_lat
        else:
            plan = _combo_plan(layer, platform, policy, gm, gn, pe_opts,
                               i, shape)
            lat = pipeline_layer_latency(layer, plan, pricing, policy,
                                         n_sfu=n_sfu,
                                         analytic_floor=float(flat_lat[i]))
        cand = CandidateMode(layer.id, -1, int(flat_lmu[i]), gm * gn,
                             n_sfu, lat, plan,
                             priced_share=bandwidth_share,
                             latency_model=latency_model)
        if (best is None or cand.latency_s < best.latency_s
                or (cand.latency_s == best.latency_s
                    and cand.n_lmu < best.n_lmu)):
            best = cand
    return best


def enumerate_layer_candidates(layer: Layer, platform: DoraPlatform,
                               policy: Policy,
                               max_modes: int = 12,
                               max_mmu: int | None = None,
                               bandwidth_share: float = 1.0,
                               latency_model: str = "analytic"
                               ) -> list[CandidateMode]:
    """Build the candidate table rows for one layer: Pareto-optimal
    (resources -> latency) execution modes (paper Fig. 8b).

    The per-grid argmin over (pe tile x reuse) combos is numpy-batched
    (``_grid_best_vectorized``): capacity masks, per-combo DRAM /
    stream / compute terms, and the lexicographic argmin all run as
    array operations, bit-for-bit identical to the scalar reference
    loop (``enumerate_layer_candidates_scalar``, regression-locked).
    Pipeline pricing keeps its exact analytic prune: the batched
    analytic array bounds which combos ``pipeline_layer_latency`` must
    walk, and only those survivors run the scalar pipeline model.

    ``max_mmu`` caps the MMUs any single mode may claim — the
    multi-tenant fairness knob: with several tenants resident, capping
    per-layer parallelism keeps units available for co-scheduled
    tenants instead of letting one layer monopolize the array.

    ``bandwidth_share`` prices every row at the DRAM bandwidth the
    layer's tenant is *guaranteed* under weighted-fair QoS
    (``share_scaled_platform``) instead of the full-bandwidth
    contiguous assumption: latency pricing, dominance pruning, and the
    per-grid argmin all see the share-scaled DRAM term, so a low-share
    tenant's table shifts toward smaller, less MIU-hungry tiles.
    Capacity checks (LMU/PE memory fits) are share-independent and stay
    on the physical platform.  ``bandwidth_share=1.0`` reproduces the
    classic table bit for bit.

    ``latency_model`` selects the pricing model for every row
    (``LATENCY_MODELS``): ``"analytic"`` is ``layer_latency``'s
    perfect-overlap steady state (the classic table, bit for bit);
    ``"pipeline"`` is ``pipeline_layer_latency``'s explicit tile
    pipeline (fill/drain, in-order MIU serialization, finite
    double-buffer depth) — monotonically >= analytic per row.  It
    composes with ``bandwidth_share``: pipeline rows priced at a share
    see the share-scaled DRAM term in every pipeline stage."""
    _check_enum_args(bandwidth_share, latency_model)
    price = (pipeline_layer_latency if latency_model == "pipeline"
             else layer_latency)
    pricing = platform if bandwidth_share >= 1.0 else \
        share_scaled_platform(platform, bandwidth_share)
    if layer.kind is LayerKind.NL:
        return _nl_candidate(layer, platform, pricing, policy, price,
                             bandwidth_share, latency_model)

    pe_opts = tuple(_pe_tile_options(platform, policy))
    cands: list[CandidateMode] = []
    for (gm, gn) in _mmu_grid_options(platform.n_mmu, policy, max_mmu):
        if _skip_grid(gm, gn, platform, policy):
            continue
        best = _grid_best_vectorized(layer, platform, pricing, policy,
                                     gm, gn, pe_opts, bandwidth_share,
                                     latency_model)
        if best is not None:
            cands.append(best)
    return _pareto_cap(cands, max_modes)


def enumerate_layer_candidates_scalar(layer: Layer, platform: DoraPlatform,
                                      policy: Policy,
                                      max_modes: int = 12,
                                      max_mmu: int | None = None,
                                      bandwidth_share: float = 1.0,
                                      latency_model: str = "analytic"
                                      ) -> list[CandidateMode]:
    """Reference implementation of ``enumerate_layer_candidates``: the
    original pure-Python 5-deep loop over (grid, pe tile, reuse)
    combos.  Kept as the ground truth the vectorized path is
    regression-locked against (bit-for-bit table equality under both
    latency models and any share) — not for production use."""
    _check_enum_args(bandwidth_share, latency_model)
    price = (pipeline_layer_latency if latency_model == "pipeline"
             else layer_latency)
    pricing = platform if bandwidth_share >= 1.0 else \
        share_scaled_platform(platform, bandwidth_share)
    if layer.kind is LayerKind.NL:
        return _nl_candidate(layer, platform, pricing, policy, price,
                             bandwidth_share, latency_model)

    M, K, N = layer.M, layer.K, layer.N
    needs_sfu = layer.nonlinear is not None
    cands: list[CandidateMode] = []
    for (gm, gn) in _mmu_grid_options(platform.n_mmu, policy, max_mmu):
        n_mmu_used = gm * gn
        if _skip_grid(gm, gn, platform, policy):
            continue
        best_for_grid: CandidateMode | None = None
        for (am, ak, an) in _pe_tile_options(platform, policy):
            plan_launch_m = am * 4 * gm
            plan_launch_k = ak * 4
            plan_launch_n = an * 4 * gn
            for rm in _REUSE_M:
                for rn in _REUSE_N:
                    for rk in _REUSE_K:
                        lm = min(plan_launch_m * rm, round_up(M, plan_launch_m))
                        lk = min(plan_launch_k * rk, round_up(K, plan_launch_k))
                        ln = min(plan_launch_n * rn, round_up(N, plan_launch_n))
                        l_lhs, _ = _operand_lmus(lm, lk, platform, policy)
                        l_rhs, _ = _operand_lmus(lk, ln, platform, policy)
                        l_out, _ = _operand_lmus(lm, ln, platform, policy)
                        l_nl = 1 if needs_sfu else 0
                        n_lmu_used = l_lhs + l_rhs + l_out + l_nl
                        if n_lmu_used > platform.n_lmu:
                            continue
                        plan = TilePlan(am, ak, an, gm, gn, lm, lk, ln,
                                        l_lhs, l_rhs, l_out, l_nl)
                        if latency_model == "pipeline":
                            # exact pruning: pipeline >= analytic, so a
                            # combo whose (cheap) analytic latency is
                            # already strictly worse than the grid's
                            # best pipeline row can never win the argmin
                            a_lat = layer_latency(
                                layer, plan, pricing, policy,
                                n_sfu=1 if needs_sfu else 0)
                            if (best_for_grid is not None
                                    and a_lat > best_for_grid.latency_s):
                                continue
                            lat = pipeline_layer_latency(
                                layer, plan, pricing, policy,
                                n_sfu=1 if needs_sfu else 0,
                                analytic_floor=a_lat)
                        else:
                            lat = price(layer, plan, pricing, policy,
                                        n_sfu=1 if needs_sfu else 0)
                        cand = CandidateMode(layer.id, -1, n_lmu_used,
                                             n_mmu_used,
                                             1 if needs_sfu else 0, lat, plan,
                                             priced_share=bandwidth_share,
                                             latency_model=latency_model)
                        if (best_for_grid is None
                                or cand.latency_s < best_for_grid.latency_s
                                or (cand.latency_s == best_for_grid.latency_s
                                    and cand.n_lmu < best_for_grid.n_lmu)):
                            best_for_grid = cand
        if best_for_grid is not None:
            cands.append(best_for_grid)
    return _pareto_cap(cands, max_modes)


def build_candidate_table(graph: WorkloadGraph, platform: DoraPlatform,
                          policy: Policy, max_mmu: int | None = None,
                          bandwidth_share: float = 1.0,
                          layer_shares: dict[int, float] | None = None,
                          latency_model: str = "analytic",
                          use_memo: bool = True
                          ) -> dict[int, list[CandidateMode]]:
    """Stage-1 output: layer id -> candidate modes (paper Fig. 6/8).

    ``max_mmu`` (multi-tenant): per-layer MMU ceiling, see
    enumerate_layer_candidates.

    Share-aware stage 1 (QoS): ``bandwidth_share`` prices every layer's
    rows at that fraction of the DRAM bandwidth; ``layer_shares``
    overrides it per layer (the compiler passes each joint layer its
    tenant's resolved guarantee, so every tenant's table is priced at
    the bandwidth it will actually receive under wfq arbitration).

    ``latency_model`` ("analytic" | "pipeline") selects the per-row
    pricing model, see ``enumerate_layer_candidates``.  The defaults
    reproduce the classic full-bandwidth analytic table bit for bit.

    ``use_memo``: rows are memoized *process-wide* keyed on
    (layer-shape signature, platform, policy, share, latency_model,
    max_mmu) — repeated layers, co-tenant graphs with shared shapes,
    template-search sweeps (``arch_gen``), and bound replays all reuse
    enumerations instead of re-running them (``candidate_memo_stats`` /
    ``clear_candidate_memo``).  ``use_memo=False`` falls back to a
    call-local cache (same keys, no cross-call reuse)."""
    table: dict[int, list[CandidateMode]] = {}
    local: dict[tuple, tuple[CandidateMode, ...]] = {}
    layer_shares = layer_shares or {}
    for layer in graph.topo_order():
        share = layer_shares.get(layer.id, bandwidth_share)
        key = (_layer_signature(layer), platform, policy, share,
               latency_model, max_mmu)
        memo = _TABLE_MEMO if use_memo else local
        hit = memo.get(key)
        if hit is not None:
            if use_memo:
                _MEMO_STATS["table_hits"] += 1
            table[layer.id] = [replace(c, layer_id=layer.id) for c in hit]
            continue
        if use_memo:
            _MEMO_STATS["table_misses"] += 1
        cands = enumerate_layer_candidates(layer, platform, policy,
                                           max_mmu=max_mmu,
                                           bandwidth_share=share,
                                           latency_model=latency_model)
        if not cands:
            raise ValueError(f"no feasible candidate for layer {layer.name} "
                             f"({layer.M}x{layer.K}x{layer.N}) on {platform.name}")
        if use_memo:
            _memo_put(_TABLE_MEMO, _TABLE_MEMO_CAP, key, tuple(cands))
        else:
            local[key] = tuple(cands)
        table[layer.id] = cands
    return table


# ---------------------------------------------------------------------------
# TPU Pallas tile planner (stage-1 DSE reused as the kernel autotuner)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TpuGemmTiles:
    block_m: int
    block_k: int
    block_n: int
    est_hbm_bytes: float
    est_flops: float

    @property
    def arithmetic_intensity(self) -> float:
        return self.est_flops / max(self.est_hbm_bytes, 1.0)


@lru_cache(maxsize=4096)
def plan_tpu_gemm_tiles(M: int, K: int, N: int, dtype_bytes: int = 2,
                        vmem_budget: int = 96 * 1024 * 1024,
                        lane: int = 128, sublane: int = 8) -> TpuGemmTiles:
    """Choose MXU-aligned VMEM block shapes minimizing HBM traffic — the
    TPU instantiation of DORA's flexible memory management. Every block
    dim is a multiple of (sublane, lane) but *clamped to the operand*
    (dynamic bounds: remainders are masked in-kernel, never padded in
    HBM)."""
    def clamp_align(x: int, a: int) -> int:
        return min(round_up(x, a), round_up(x, a))

    best: TpuGemmTiles | None = None
    m_opts = sorted({min(round_up(M, sublane), v) for v in
                     (128, 256, 512, 1024, 2048)})
    n_opts = sorted({min(round_up(N, lane), v) for v in
                     (128, 256, 512, 1024, 2048)})
    k_opts = sorted({min(round_up(K, lane), v) for v in
                     (128, 256, 512, 1024, 2048, 4096)})
    for bm in m_opts:
        for bn in n_opts:
            for bk in k_opts:
                # double-buffered working set
                ws = 2 * (bm * bk + bk * bn) * dtype_bytes + bm * bn * 4
                if ws > vmem_budget:
                    continue
                traffic = (ceil_div(N, bn) * M * K
                           + ceil_div(M, bm) * K * N
                           + M * N) * dtype_bytes
                cand = TpuGemmTiles(bm, bk, bn, float(traffic),
                                    2.0 * M * K * N)
                if best is None or cand.est_hbm_bytes < best.est_hbm_bytes \
                        or (cand.est_hbm_bytes == best.est_hbm_bytes
                            and (bm * bn) > (best.block_m * best.block_n)):
                    best = cand
    assert best is not None, (M, K, N)
    return best
