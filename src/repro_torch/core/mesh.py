"""Multi-PE DORA mesh: N (possibly heterogeneous) DORA PEs behind one
shared DRAM, with tenant->PE placement as a stage-0 DSE above the
existing two-stage compile.

The paper prototypes DORA on a single vector processor; scaling out
keeps each PE exactly the single-PE machine (``DoraPlatform``) and adds
two things:

  shared DRAM   Every PE sits behind the same aggregate DRAM port
                (``DoraMesh.shared_dram_bw_bytes``).  A PE's effective
                platform swaps its private port rate for the shared
                aggregate (``DoraPlatform.with_dram_bw``) and then
                prices its granted fraction of it with the *same*
                ``share_scaled_platform`` machinery the per-tenant QoS
                bound uses — shares are weight-proportional among the
                *occupied* PEs and sum to <= 1 (an idle PE's share is
                redistributed, never double-counted).

  placement     ``DoraMeshCompiler.compile`` first estimates each
                tenant's solo makespan on each PE (stage-1 candidate
                table + a fast list schedule, both memoized), then
                solves the tenant->PE assignment: branch-and-bound over
                every assignment while ``n_pes ** n_tenants`` stays
                under ``EXHAUSTIVE_LIMIT`` (exact), else an LPT greedy
                seed refined by a node-capped branch-and-bound — both
                pruned by ``schedule.makespan_lower_bound``-style
                bounds.  Each occupied PE then compiles its tenant
                subset (``MultiTenantWorkload.subset``) through the
                unchanged two-stage ``DoraCompiler`` on its effective
                platform.

A mesh of one PE is bit-for-bit the existing single-PE path: the full
DRAM share leaves the platform values unchanged, the subset of all
tenants is the original workload, and compile/simulate route through
the very same ``DoraCompiler`` / ``simulate`` code (regression-locked
by ``tests/test_mesh.py``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Sequence

from .arch_gen import ArchTemplate, generate_platform
from .compiler import CompileOptions, CompileResult, DoraCompiler
from .graph import WorkloadGraph
from .multi_tenant import PLACEMENT_STRATEGIES, MultiTenantWorkload
from .perf_model import (DoraPlatform, Policy, build_candidate_table,
                         share_scaled_platform)
from .schedule import list_schedule, makespan_lower_bound
from .simulator import SimReport, TenantSimStats, simulate_mesh

# placement auto-resolution: exhaustive while n_pes ** n_tenants stays
# at or under this, LPT + node-capped branch-and-bound beyond
EXHAUSTIVE_LIMIT = 4096
# branch-and-bound node budget of the "lpt" strategy (the greedy seed
# is kept whenever the budget runs out before an improvement)
LPT_NODE_BUDGET = 20000


@dataclass(frozen=True)
class PESpec:
    """One PE of the mesh: a name, its single-PE machine template, and
    its DRAM arbitration weight (larger = a bigger fraction of the
    shared bandwidth when the PE is occupied)."""

    name: str
    platform: DoraPlatform
    weight: float = 1.0

    def __post_init__(self) -> None:
        if self.weight <= 0.0:
            raise ValueError(f"PE {self.name!r}: weight must be > 0, "
                             f"got {self.weight}")


@dataclass(frozen=True)
class DoraMesh:
    """N DORA PEs behind one shared DRAM.

    ``dram_bw_bytes`` is the aggregate bandwidth of the shared DRAM;
    None defaults to the largest PE port rate, so a one-PE mesh is
    exactly that PE (the N=1 bit-for-bit lock).
    """

    name: str
    pes: tuple[PESpec, ...]
    dram_bw_bytes: float | None = None

    def __post_init__(self) -> None:
        if not self.pes:
            raise ValueError(f"mesh {self.name!r}: needs at least one PE")
        names = [pe.name for pe in self.pes]
        if len(set(names)) != len(names):
            dupes = sorted({n for n in names if names.count(n) > 1})
            raise ValueError(f"mesh {self.name!r}: duplicate PE names "
                             f"{dupes}")
        if self.dram_bw_bytes is not None and self.dram_bw_bytes <= 0.0:
            raise ValueError(f"mesh {self.name!r}: dram_bw_bytes must be "
                             f"> 0, got {self.dram_bw_bytes}")

    # ------------------------------------------------------------ topology
    @property
    def n_pes(self) -> int:
        return len(self.pes)

    @property
    def shared_dram_bw_bytes(self) -> float:
        """Aggregate bandwidth of the shared DRAM all PEs contend for."""
        if self.dram_bw_bytes is not None:
            return self.dram_bw_bytes
        return max(pe.platform.dram_bw_bytes for pe in self.pes)

    def dram_shares(self, occupied: Sequence[int] | None = None
                    ) -> dict[int, float]:
        """PE index -> granted fraction of the shared DRAM bandwidth,
        weight-proportional among the *occupied* PEs (default: all).
        The shares of the occupied PEs sum to exactly 1.0 — never more
        (the mesh invariant ``tests/test_mesh.py`` locks)."""
        idxs = sorted(set(occupied)) if occupied is not None \
            else list(range(self.n_pes))
        if not idxs:
            raise ValueError(f"mesh {self.name!r}: no occupied PEs")
        for i in idxs:
            if not 0 <= i < self.n_pes:
                raise ValueError(f"mesh {self.name!r}: PE index {i} out "
                                 f"of range (have {self.n_pes})")
        wsum = sum(self.pes[i].weight for i in idxs)
        return {i: self.pes[i].weight / wsum for i in idxs}

    def pe_port_platform(self, idx: int) -> DoraPlatform:
        """PE ``idx``'s view of the shared DRAM port: its own template
        with the private DRAM rate swapped for the shared aggregate."""
        return self.pes[idx].platform.with_dram_bw(self.shared_dram_bw_bytes)

    def pricing_platform(self, idx: int, share: float) -> DoraPlatform:
        """The effective platform PE ``idx`` compiles and simulates
        against when granted ``share`` of the shared DRAM."""
        return share_scaled_platform(self.pe_port_platform(idx), share)

    # --------------------------------------------------------- constructors
    @classmethod
    def homogeneous(cls, n: int, platform: DoraPlatform | None = None,
                    name: str = "mesh",
                    dram_bw_bytes: float | None = None) -> "DoraMesh":
        """N identical PEs (``pe0`` .. ``peN-1``) behind one DRAM."""
        if n < 1:
            raise ValueError(f"mesh {name!r}: n must be >= 1, got {n}")
        plat = platform or DoraPlatform.vck190()
        return cls(name, tuple(PESpec(f"pe{i}", plat) for i in range(n)),
                   dram_bw_bytes=dram_bw_bytes)

    @classmethod
    def from_templates(cls, templates: Sequence[ArchTemplate],
                       base: DoraPlatform | None = None,
                       names: Sequence[str] | None = None,
                       name: str = "mesh",
                       dram_bw_bytes: float | None = None) -> "DoraMesh":
        """A heterogeneous mesh from ``arch_gen`` templates (e.g. the
        per-tenant specializations of ``search_mesh_templates``); each
        PE instantiates via ``generate_platform`` on the shared base."""
        if not templates:
            raise ValueError(f"mesh {name!r}: no templates")
        if names is not None and len(names) != len(templates):
            raise ValueError(f"mesh {name!r}: {len(templates)} templates "
                             f"but {len(names)} names")
        pes = tuple(
            PESpec(names[i] if names is not None else f"pe{i}",
                   generate_platform(t, base))
            for i, t in enumerate(templates))
        return cls(name, pes, dram_bw_bytes=dram_bw_bytes)


# ---------------------------------------------------------------------------
# Stage 0: tenant -> PE placement
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Placement:
    """The solved tenant->PE assignment.

    ``assignment[t]`` is the PE index of tenant ``t`` (declaration
    order) — a partition by construction: every tenant lands on exactly
    one PE.  ``proxy_makespan_s`` is the objective the solver minimized
    (max over PEs of the summed per-tenant cost estimates), not the
    compiled makespan; ``explored`` counts branch-and-bound nodes."""

    assignment: tuple[int, ...]
    strategy: str                 # resolved: "exhaustive" | "lpt"
    explored: int
    proxy_makespan_s: float

    def pe_tenants(self) -> dict[int, list[int]]:
        """Occupied PE index -> its tenants (declaration order)."""
        out: dict[int, list[int]] = {}
        for ti, p in enumerate(self.assignment):
            out.setdefault(p, []).append(ti)
        return {p: out[p] for p in sorted(out)}


def solve_placement(costs: Sequence[Sequence[float]],
                    lower_bounds: Sequence[float] | None = None,
                    strategy: str = "auto") -> Placement:
    """Minimize the max per-PE summed cost over tenant->PE assignments.

    ``costs[t][p]`` estimates tenant ``t``'s solo makespan on PE ``p``
    (arrival offsets excluded — the proxy treats each PE's tenants as
    back-to-back work, which the real per-PE compile then overlaps).
    ``lower_bounds[t]`` optionally tightens the prune with a true lower
    bound on tenant ``t``'s cost on *any* PE (default: the row min).

    Both strategies run the same depth-first branch-and-bound in LPT
    order (largest min-cost tenant first), pruned when
    ``max(partial loads, (assigned + remaining lower bounds) / n_pes,
    largest remaining lower bound)`` cannot beat the incumbent;
    "exhaustive" explores to completion (exact), "lpt" starts from the
    greedy longest-processing-time seed and stops after
    ``LPT_NODE_BUDGET`` nodes.  Deterministic: ties never replace the
    incumbent and PEs are tried in index order."""
    n_t = len(costs)
    if n_t == 0:
        raise ValueError("solve_placement: no tenants")
    n_p = len(costs[0])
    if n_p == 0 or any(len(row) != n_p for row in costs):
        raise ValueError("solve_placement: ragged or empty cost matrix")
    if strategy not in PLACEMENT_STRATEGIES:
        raise ValueError(f"unknown placement strategy {strategy!r}; "
                         f"expected one of {PLACEMENT_STRATEGIES}")
    resolved = strategy
    if resolved == "auto":
        resolved = "exhaustive" if n_p ** n_t <= EXHAUSTIVE_LIMIT else "lpt"
    lbs = ([min(row) for row in costs] if lower_bounds is None
           else [min(lb, min(row))
                 for lb, row in zip(lower_bounds, costs)])

    # LPT order: biggest tenants first makes both the greedy seed and
    # the branch-and-bound prune early
    order = sorted(range(n_t), key=lambda t: (-min(costs[t]), t))

    # greedy seed: place each tenant on the PE minimizing its resulting
    # load (ties: lowest PE index)
    loads = [0.0] * n_p
    seed = [0] * n_t
    for t in order:
        p = min(range(n_p), key=lambda q: (loads[q] + costs[t][q], q))
        seed[t] = p
        loads[p] += costs[t][p]
    best = list(seed)
    best_make = max(loads)

    # depth-first branch and bound over the same order
    budget = None if resolved == "exhaustive" else LPT_NODE_BUDGET
    explored = 0
    tail_lb = [0.0] * (n_t + 1)     # sum of remaining tenants' lbs
    tail_max = [0.0] * (n_t + 1)    # max of remaining tenants' lbs
    for d in range(n_t - 1, -1, -1):
        tail_lb[d] = tail_lb[d + 1] + lbs[order[d]]
        tail_max[d] = max(tail_max[d + 1], lbs[order[d]])

    loads = [0.0] * n_p
    partial = [0] * n_t

    def dfs(depth: int) -> bool:
        """True while the node budget allows further exploration."""
        nonlocal best_make, explored
        if budget is not None and explored >= budget:
            return False
        explored += 1
        if depth == n_t:
            make = max(loads)
            if make < best_make:
                best_make = make
                best[:] = partial
            return True
        bound = max(max(loads),
                    (sum(loads) + tail_lb[depth]) / n_p,
                    tail_max[depth])
        if bound >= best_make:
            return True
        t = order[depth]
        for p in sorted(range(n_p), key=lambda q: (loads[q] + costs[t][q],
                                                   q)):
            loads[p] += costs[t][p]
            partial[t] = p
            alive = dfs(depth + 1)
            loads[p] -= costs[t][p]
            if not alive:
                return False
        return True

    dfs(0)
    final_loads = [0.0] * n_p
    for t, p in enumerate(best):
        final_loads[p] += costs[t][p]
    return Placement(tuple(best), resolved, explored, max(final_loads))


# ---------------------------------------------------------------------------
# Mesh compile / simulate
# ---------------------------------------------------------------------------

@dataclass
class MeshCompileResult:
    """Per-PE ``CompileResult``s plus the placement that produced them.

    ``pe_results`` / ``pe_platforms`` / ``dram_shares`` are keyed by
    occupied PE index; ``makespan_s`` is the mesh-level makespan — the
    max over the occupied PEs' (release-respecting, hence absolute)
    schedule makespans."""

    mesh: DoraMesh
    placement: Placement
    tenant_names: tuple[str, ...]
    pe_results: dict[int, CompileResult]
    pe_platforms: dict[int, DoraPlatform]
    dram_shares: dict[int, float]
    stage0_s: float

    @property
    def makespan_s(self) -> float:
        return max(r.makespan_s for r in self.pe_results.values())

    def pe_makespans(self) -> dict[int, float]:
        return {p: r.makespan_s for p, r in sorted(self.pe_results.items())}

    def per_tenant_makespan(self) -> dict[str, float]:
        """Tenant name -> service latency, merged across PEs (disjoint
        by the placement partition)."""
        out: dict[str, float] = {}
        for p in sorted(self.pe_results):
            for name, mk in self.pe_results[p].per_tenant_makespan().items():
                if name in out:
                    raise AssertionError(
                        f"tenant {name!r} appears on more than one PE")
                out[name] = mk
        return out

    def pe_of_tenant(self) -> dict[str, int]:
        """Tenant name -> the PE index it was placed on."""
        return {self.tenant_names[ti]: p
                for ti, p in enumerate(self.placement.assignment)}

    @property
    def compile_s(self) -> float:
        """Placement stage 0 plus every PE's instrumented compile."""
        return self.stage0_s + sum(r.compile_s
                                   for r in self.pe_results.values())


@dataclass
class MeshSimReport:
    """Mesh-level replay: per-PE ``SimReport``s plus the per-tenant
    stats merged across PEs (tenant *name* keyed — local per-PE tenant
    indices are not mesh-global)."""

    pe_reports: dict[int, SimReport]
    tenant_stats: dict[str, TenantSimStats]
    pe_of_tenant: dict[str, int]

    @property
    def makespan_s(self) -> float:
        return max(r.makespan_s for r in self.pe_reports.values())

    @property
    def n_instructions(self) -> int:
        return sum(len(r.instr_start) for r in self.pe_reports.values())


class DoraMeshCompiler:
    """``DoraCompiler`` lifted onto a ``DoraMesh``: stage-0 placement,
    then the unchanged two-stage compile per occupied PE on its
    share-scaled effective platform."""

    def __init__(self, mesh: DoraMesh, policy: Policy | None = None):
        self.mesh = mesh
        self.policy = policy or Policy.dora()

    # ----------------------------------------------------------- placement
    def _estimate_costs(self, graphs: Sequence[WorkloadGraph],
                        mmu_cap: int | None, latency_model: str
                        ) -> tuple[list[list[float]], list[float]]:
        """Tenant x PE cost matrix (solo list-schedule makespans on each
        PE's all-occupied-share platform) plus per-tenant lower bounds
        for the branch-and-bound prune.  Stage-1 tables hit the process
        memo, so a T x P estimate prices each distinct (shape, platform)
        pair once."""
        plan_shares = self.mesh.dram_shares()
        costs: list[list[float]] = []
        lbs: list[float] = []
        for g in graphs:
            row: list[float] = []
            lb = float("inf")
            for p in range(self.mesh.n_pes):
                plat = self.mesh.pricing_platform(p, plan_shares[p])
                table = build_candidate_table(g, plat, self.policy,
                                              max_mmu=mmu_cap,
                                              latency_model=latency_model)
                row.append(list_schedule(g, table, plat).makespan)
                lb = min(lb, makespan_lower_bound(g, table, plat))
            costs.append(row)
            lbs.append(lb)
        return costs, lbs

    # ------------------------------------------------------------- compile
    def compile(self, workload: WorkloadGraph | MultiTenantWorkload,
                options: CompileOptions | None = None) -> MeshCompileResult:
        options = options or CompileOptions()
        strategy = options.placement
        if strategy is None and isinstance(workload, MultiTenantWorkload):
            strategy = workload.placement
        strategy = strategy or "auto"
        if strategy not in PLACEMENT_STRATEGIES:
            raise ValueError(f"unknown placement strategy {strategy!r}; "
                             f"expected one of {PLACEMENT_STRATEGIES}")
        latency_model = options.latency_model or "analytic"

        if isinstance(workload, MultiTenantWorkload):
            if not workload.tenants:
                raise ValueError(f"{workload.name}: no tenants")
            graphs = [t.graph for t in workload.tenants]
            names = tuple(t.name for t in workload.tenants)
            mmu_cap = workload.mmu_cap
        else:
            graphs = [workload]
            names = (workload.name,)
            mmu_cap = None

        t0 = time.perf_counter()
        costs, lbs = self._estimate_costs(graphs, mmu_cap, latency_model)
        placement = solve_placement(costs, lower_bounds=lbs,
                                    strategy=strategy)
        stage0_s = time.perf_counter() - t0

        groups = placement.pe_tenants()
        shares = self.mesh.dram_shares(list(groups))
        pe_results: dict[int, CompileResult] = {}
        pe_platforms: dict[int, DoraPlatform] = {}
        for p, tis in groups.items():
            plat = self.mesh.pricing_platform(p, shares[p])
            comp = DoraCompiler(plat, self.policy)
            if isinstance(workload, MultiTenantWorkload):
                sub = workload.subset(
                    tis, name=(workload.name
                               if len(tis) == len(workload.tenants)
                               else f"{workload.name}@{self.mesh.pes[p].name}"))
            else:
                sub = workload
            pe_results[p] = comp.compile(sub, options)
            pe_platforms[p] = plat
        return MeshCompileResult(self.mesh, placement, names, pe_results,
                                 pe_platforms, shares, stage0_s)

    # ------------------------------------------------------------ simulate
    def simulate(self, result: MeshCompileResult) -> MeshSimReport:
        """Per-PE replay on the shared-DRAM share-scaled platforms
        (``simulator.simulate_mesh``), merged into a mesh report."""
        occupied = sorted(result.pe_results)
        codegens = []
        ports = []
        shares = []
        arrivals = []
        priorities = []
        bw_shares = []
        for p in occupied:
            r = result.pe_results[p]
            codegens.append(r.codegen)
            ports.append(self.mesh.pe_port_platform(p))
            shares.append(result.dram_shares[p])
            if r.workload is not None:
                arrivals.append({ti: t.arrival_s
                                 for ti, t in enumerate(r.workload.tenants)})
                priorities.append({ti: t.priority
                                   for ti, t in enumerate(r.workload.tenants)})
            else:
                arrivals.append(None)
                priorities.append(None)
            bw_shares.append(r.bandwidth_shares or None)
        reports = simulate_mesh(codegens, ports, dram_shares=shares,
                                arrivals=arrivals, priorities=priorities,
                                bandwidth_shares=bw_shares)
        pe_reports = dict(zip(occupied, reports))
        tenant_stats: dict[str, TenantSimStats] = {}
        pe_of: dict[str, int] = {}
        for p in occupied:
            r = result.pe_results[p]
            if r.workload is None:
                continue
            for ti, t in enumerate(r.workload.tenants):
                if t.name in tenant_stats:
                    raise AssertionError(
                        f"tenant {t.name!r} simulated on more than one PE")
                tenant_stats[t.name] = pe_reports[p].tenant_stats[ti]
                pe_of[t.name] = p
        return MeshSimReport(pe_reports, tenant_stats, pe_of)
