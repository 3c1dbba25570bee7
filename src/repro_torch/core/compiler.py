"""DoraCompiler: the end-to-end compilation framework (paper Fig. 6).

  model graph --[stage-1 DSE]--> candidate table
              --[stage-2 DSE: MILP | GA | list | sequential]--> schedule
              --[codegen]--> per-unit instruction streams (binary)

plus the two execution backends: the functional runtime (numerics) and
the event-driven simulator (timing).

Copy of ``repro.core.compiler``; only ``execute`` differs: it runs the
encoded binary on the port's runtime, on the CUDA card by default.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .codegen import CodegenResult, generate
from .ga import GAConfig, GAScheduler
from .graph import WorkloadGraph
from .interleave import POLICIES as INTERLEAVE_POLICIES
from .milp import MilpScheduler, SolveResult
from .multi_tenant import (PLACEMENT_STRATEGIES, QOS_POLICIES,
                           MultiTenantWorkload)
from .partition import partitioned_solve
from .perf_model import (LATENCY_MODELS, CandidateMode, DoraPlatform, Policy,
                         build_candidate_table)
from .runtime import DoraRuntime
from .schedule import (InterleaveBound, OversubscriptionBound, Schedule,
                       interleave_aware_bound, list_schedule,
                       oversubscription_aware_bound, sequential_schedule)
from .simulator import SimReport, simulate

# stage-2 engines (docs-synced by tests/test_docs.py)
ENGINES = ("milp", "ga", "list", "sequential")


@dataclass
class CompileOptions:
    engine: str = "milp"          # milp | ga | list | sequential
    n_segments: int = 1           # DAG-partitioned DSE (paper §4.4)
    time_budget_s: float = 10.0
    ga: GAConfig = field(default_factory=GAConfig)
    # tile-granularity MIU interleave pass applied after codegen:
    # "none" | "rr" | "priority"; None defers to the workload's own
    # ``MultiTenantWorkload.interleave`` setting ("none" single-tenant).
    interleave: str | None = None
    # multi-tenant QoS: "wfq" resolves per-tenant bandwidth shares
    # (MultiTenantWorkload.bandwidth_shares, else priority-proportional),
    # computes the interleave-aware + oversubscription-aware schedule
    # bounds, and makes DoraCompiler.simulate feed the shares to the wfq
    # arbitration.  "none" disables; None defers to the workload ("wfq"
    # iff it carries explicit bandwidth_shares).
    qos: str | None = None
    # share-aware stage 1: price every tenant's candidate table at its
    # resolved bandwidth share (perf_model.build_candidate_table
    # layer_shares) instead of the full-bandwidth contiguous assumption,
    # so latency/dominance pruning and the engines' mode selection see
    # the bandwidth each tenant is actually guaranteed.  Requires qos to
    # resolve to "wfq"; None defers to the workload's own
    # ``share_aware_stage1`` (default: on iff the workload carries
    # explicit bandwidth_shares).
    share_aware_stage1: bool | None = None
    # tenant->PE placement strategy for multi-PE mesh compiles
    # (multi_tenant.PLACEMENT_STRATEGIES: "exhaustive" | "lpt" | "auto");
    # consumed by mesh.DoraMeshCompiler as the stage-0 solver above the
    # two-stage DSE.  None defers to the workload's own
    # ``MultiTenantWorkload.placement`` (default "auto").  A single-PE
    # DoraCompiler validates the knob and otherwise ignores it — there
    # is only one PE to place onto.
    placement: str | None = None
    # stage-1 latency pricing model (perf_model.LATENCY_MODELS):
    # "analytic" is layer_latency's perfect-overlap steady state (the
    # classic table); "pipeline" is pipeline_layer_latency's explicit
    # tile pipeline (fill/drain per output group, in-order MIU issue
    # serialization, finite double-buffer depth) — provably >= analytic
    # per row, and much closer to the event-driven simulator on
    # DRAM-bound layers.  None defers to "analytic" (bit-for-bit lock
    # on the default).  Composes with share-aware stage 1: pipeline
    # rows priced at a share see the share-scaled DRAM term in every
    # pipeline stage.
    latency_model: str | None = None


@dataclass
class CompileResult:
    graph: WorkloadGraph
    platform: DoraPlatform
    policy: Policy
    candidates: dict[int, list[CandidateMode]]
    schedule: Schedule
    codegen: CodegenResult
    # per-stage compile-time instrumentation (wall-clock seconds):
    # stage-1 candidate enumeration, stage-2 scheduling engine, the QoS
    # schedule-bound replays, and code generation.  The benchmark emits
    # these per scenario and compare_bench.py gates CI on DSE-time
    # regressions exactly like makespans.
    stage1_s: float
    stage2_s: float
    codegen_s: float
    bounds_s: float = 0.0
    solver_trace: list[tuple[float, float]] = field(default_factory=list)
    optimal: bool | None = None
    # multi-tenant compilations only:
    workload: MultiTenantWorkload | None = None
    tenant_of: dict[int, int] = field(default_factory=dict)
    release: dict[int, float] = field(default_factory=dict)
    # QoS compilations only (CompileOptions.qos resolved to "wfq"):
    bandwidth_shares: dict[int, float] = field(default_factory=dict)
    qos_bound: InterleaveBound | None = None
    oversubscription_bound: OversubscriptionBound | None = None
    # True when stage 1 priced each tenant's candidate table at its
    # resolved bandwidth share (CompileOptions.share_aware_stage1):
    share_aware_stage1: bool = False
    # the resolved stage-1 pricing model (CompileOptions.latency_model;
    # None resolves to "analytic"):
    latency_model: str = "analytic"

    @property
    def compile_s(self) -> float:
        """Total wall-clock compile time across all instrumented stages
        (stage 1 + stage 2 + schedule bounds + codegen)."""
        return self.stage1_s + self.stage2_s + self.bounds_s + self.codegen_s

    @property
    def makespan_s(self) -> float:
        return self.schedule.makespan

    @property
    def interleave_aware_makespan_s(self) -> float:
        """The interleave-aware schedule bound when QoS was resolved
        (share-scaled MIU transfer times during cross-tenant overlap),
        else the engine's contiguous-assumption makespan."""
        if self.qos_bound is not None:
            return self.qos_bound.makespan_s
        return self.makespan_s

    @property
    def oversubscription_aware_makespan_s(self) -> float:
        """The oversubscription-aware schedule bound when QoS was
        resolved (same-tenant concurrent layers additionally split
        their tenant's bandwidth), else the interleave-aware bound /
        contiguous makespan fallback chain."""
        if self.oversubscription_bound is not None:
            return self.oversubscription_bound.makespan_s
        return self.interleave_aware_makespan_s

    def per_tenant_makespan(self) -> dict[str, float]:
        """Tenant name -> completion of its last layer minus its
        arrival (the tenant's service latency in the joint schedule)."""
        if self.workload is None:
            return {self.graph.name: self.makespan_s}
        finish: dict[int, float] = {}
        for e in self.schedule.entries:
            ti = self.tenant_of[e.layer_id]
            finish[ti] = max(finish.get(ti, 0.0), e.end)
        return {t.name: finish.get(ti, t.arrival_s) - t.arrival_s
                for ti, t in enumerate(self.workload.tenants)}

    @property
    def throughput_gflops(self) -> float:
        return self.graph.total_flops / self.makespan_s / 1e9

    @property
    def program_bytes(self) -> int:
        return self.codegen.program.byte_size()


class DoraCompiler:
    def __init__(self, platform: DoraPlatform | None = None,
                 policy: Policy | None = None):
        self.platform = platform or DoraPlatform.vck190()
        self.policy = policy or Policy.dora()

    # ------------------------------------------------------------- stage 1+2
    def compile(self, workload: WorkloadGraph | MultiTenantWorkload,
                options: CompileOptions | None = None) -> CompileResult:
        options = options or CompileOptions()
        if isinstance(workload, MultiTenantWorkload):
            merged = workload.merge()
            graph = merged.graph
            release = merged.release
            priorities = merged.priorities
            tenant_of = merged.tenant_of
            mmu_cap = workload.mmu_cap
            mt_workload = workload
        else:
            graph = workload
            release = {}
            priorities = None
            tenant_of = {}
            mmu_cap = None
            mt_workload = None
        graph.validate()
        # resolve + validate the interleave policy *before* the expensive
        # DSE stages so a typo'd knob fails fast
        ilv = options.interleave
        if ilv is None:
            ilv = mt_workload.interleave if mt_workload is not None else "none"
        if ilv not in INTERLEAVE_POLICIES:
            raise ValueError(f"unknown interleave policy {ilv!r}; "
                             f"expected one of {INTERLEAVE_POLICIES}")
        qos = options.qos
        if qos is None:
            qos = ("wfq" if mt_workload is not None
                   and mt_workload.bandwidth_shares is not None else "none")
        if qos not in QOS_POLICIES:
            raise ValueError(f"unknown qos policy {qos!r}; "
                             f"expected one of {QOS_POLICIES}")
        shares: dict[int, float] = {}
        if qos == "wfq":
            if mt_workload is None:
                raise ValueError(
                    "qos='wfq' requires a MultiTenantWorkload (bandwidth "
                    "shares are per-tenant guarantees)")
            shares = mt_workload.resolve_bandwidth_shares()
        share_aware = options.share_aware_stage1
        if share_aware is None and mt_workload is not None:
            share_aware = mt_workload.share_aware_stage1
        if share_aware is None:
            # default: a workload that pinned explicit guarantees wants
            # its tables priced at them; priority-proportional wfq keeps
            # the classic full-bandwidth stage 1 unless asked
            share_aware = (qos == "wfq" and mt_workload is not None
                           and mt_workload.bandwidth_shares is not None)
        if share_aware and not shares:
            raise ValueError(
                "share_aware_stage1 requires resolved bandwidth shares "
                "(a MultiTenantWorkload compiled with qos='wfq')")
        latency_model = options.latency_model or "analytic"
        if latency_model not in LATENCY_MODELS:
            raise ValueError(f"unknown latency_model {latency_model!r}; "
                             f"expected one of {LATENCY_MODELS}")
        if options.placement is not None \
                and options.placement not in PLACEMENT_STRATEGIES:
            raise ValueError(f"unknown placement strategy "
                             f"{options.placement!r}; expected one of "
                             f"{PLACEMENT_STRATEGIES}")

        t0 = time.perf_counter()
        layer_shares = ({lid: shares[ti] for lid, ti in tenant_of.items()}
                        if share_aware else None)
        candidates = build_candidate_table(graph, self.platform, self.policy,
                                           max_mmu=mmu_cap,
                                           layer_shares=layer_shares,
                                           latency_model=latency_model)
        t1 = time.perf_counter()

        trace: list[tuple[float, float]] = []
        optimal: bool | None = None
        if self.policy.monolithic or options.engine == "sequential":
            schedule = sequential_schedule(graph, candidates, self.platform,
                                           release=release)
        elif options.engine == "list":
            schedule = list_schedule(graph, candidates, self.platform,
                                     priorities=priorities, release=release)
        elif options.engine in ("milp", "ga"):
            if options.engine == "milp":
                def make_engine():
                    return MilpScheduler(self.platform,
                                         time_budget_s=options.time_budget_s
                                         / max(options.n_segments, 1))
            else:
                def make_engine():
                    cfg = options.ga
                    return GAScheduler(self.platform, cfg)
            if options.n_segments > 1:
                if release and any(release.values()):
                    raise ValueError(
                        "partitioned DSE (n_segments > 1) does not support "
                        "tenant arrival offsets; use n_segments=1")
                res = partitioned_solve(graph, candidates, self.platform,
                                        options.n_segments, make_engine)
                schedule, trace = res.schedule, res.trace
            else:
                engine = make_engine()
                if isinstance(engine, GAScheduler):
                    res = engine.solve(graph, candidates, release=release,
                                       seed_priorities=priorities)
                else:
                    res = engine.solve(graph, candidates, release=release)
                schedule = res.schedule
                trace = list(res.trace)
                if isinstance(res, SolveResult):
                    optimal = res.optimal
        else:
            raise ValueError(f"unknown engine {options.engine!r}")
        t2 = time.perf_counter()

        schedule.validate(graph, self.platform, release=release)
        qos_bound = None
        oversub_bound = None
        if shares:
            qos_bound = interleave_aware_bound(
                schedule, graph, self.platform, self.policy, tenant_of,
                shares, release=release)
            oversub_bound = oversubscription_aware_bound(
                schedule, graph, self.platform, self.policy, tenant_of,
                shares, release=release, interleave_bound=qos_bound)
        t_bounds = time.perf_counter()
        ilv_prios = None
        if mt_workload is not None:
            # the priority interleave weights channels by the guaranteed
            # share when QoS is on, so the emitted chunk mix matches what
            # the wfq arbitration will grant; plain priorities otherwise
            ilv_prios = shares or {ti: t.priority
                                   for ti, t in enumerate(mt_workload.tenants)}
        cg = generate(graph, schedule, self.platform, tenant_of=tenant_of,
                      interleave=ilv, interleave_priorities=ilv_prios)
        t3 = time.perf_counter()

        return CompileResult(graph, self.platform, self.policy, candidates,
                             schedule, cg, t1 - t0, t2 - t1, t3 - t_bounds,
                             bounds_s=t_bounds - t2,
                             solver_trace=trace, optimal=optimal,
                             workload=mt_workload, tenant_of=tenant_of,
                             release=release, bandwidth_shares=shares,
                             qos_bound=qos_bound,
                             oversubscription_bound=oversub_bound,
                             share_aware_stage1=bool(share_aware),
                             latency_model=latency_model)

    # -------------------------------------------------------------- backends
    def execute(self, result: CompileResult,
                inputs: dict[str, np.ndarray | torch.Tensor] | None = None,
                device: str | torch.device | None = None
                ) -> dict[str, torch.Tensor]:
        """Run the compiled binary (its encoded bytes, as the IDU fetches
        them) on ``device``: None is the CUDA card, and raises where there
        is none.  Returns every DRAM tensor by name, on ``device``."""
        rt = DoraRuntime(result.codegen.memmap, device=device)
        inputs = inputs if inputs is not None else result.graph.random_inputs()
        rt.load_inputs(inputs)
        return rt.execute(result.codegen.program.encode())

    def simulate(self, result: CompileResult,
                 platform: DoraPlatform | None = None) -> SimReport:
        """Event-driven simulation of a compiled program.  ``platform``
        overrides the compile-time platform for the *timing* run only —
        the serving layer uses this to replay one compiled schedule on a
        VC/wfq-enabled variant (``DoraPlatform.with_vc``) without
        recompiling."""
        arrivals = None
        priorities = None
        if result.workload is not None:
            arrivals = {ti: t.arrival_s
                        for ti, t in enumerate(result.workload.tenants)}
            priorities = {ti: t.priority
                          for ti, t in enumerate(result.workload.tenants)}
        return simulate(result.codegen, platform or self.platform,
                        arrivals=arrivals, priorities=priorities,
                        bandwidth_shares=result.bandwidth_shares or None)
