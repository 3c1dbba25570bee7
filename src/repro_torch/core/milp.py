"""Stage-2 exact engine: branch-and-bound over (layer order x mode
choice) — the executable equivalent of the paper's MILP (Fig. 7).

The formulation is identical in constraints: one mode per layer
(line 4), precedence S_i >= E_j (line 5), unit exclusivity (lines 7-11)
and resource counts (lines 12-14); the objective min T (line 2).

Instead of handing the model to CPLEX (unavailable offline), we solve it
with depth-first branch-and-bound over *active schedules*: each decision
schedules one ready layer in one candidate mode at its earliest feasible
time. Two admissible lower bounds prune the tree:

  LB-cp : critical path of the remaining DAG at per-layer min latency
  LB-res: per-unit-class workload bound, sum(lat*units)/capacity

Like the GA, the engine consumes the stage-1 candidate table as-is:
under share-aware stage 1 every ``CandidateMode.latency_s`` feeding the
branch-and-bound (and both lower bounds LB-cp / LB-res) is already
priced at the layer's tenant bandwidth share, so the search optimizes
the makespan each tenant can actually achieve under its QoS guarantee.

The solver is *anytime*: it keeps an incumbent and a trace of
(elapsed_seconds, best_makespan) improvements, matching how the paper
plots MILP progress under a time budget (Fig. 12). On small DAGs it
proves optimality (verified against exhaustive search in tests); on
large DAGs it behaves like the paper's MILP — good incumbents early,
possible stall — which is exactly what the DAG-partition and GA options
are for.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from .graph import WorkloadGraph
from .perf_model import CandidateMode, DoraPlatform
from .schedule import Schedule, ScheduleEntry, _UnitPool, list_schedule


@dataclass
class SolveResult:
    schedule: Schedule
    optimal: bool
    nodes_explored: int
    elapsed_s: float
    trace: list[tuple[float, float]] = field(default_factory=list)


class MilpScheduler:
    """Branch-and-bound makespan minimizer (the paper's MILP engine)."""

    def __init__(self, platform: DoraPlatform, time_budget_s: float = 10.0,
                 max_nodes: int = 2_000_000):
        self.platform = platform
        self.time_budget_s = time_budget_s
        self.max_nodes = max_nodes

    def solve(self, graph: WorkloadGraph,
              candidates: dict[int, list[CandidateMode]],
              release: dict[int, float] | None = None) -> SolveResult:
        t0 = time.perf_counter()
        release = release or {}
        layers = {l.id: l for l in graph.layers}
        succ = graph.successors()
        min_lat = {lid: min(c.latency_s for c in cands)
                   for lid, cands in candidates.items()}

        # tail[l] = critical path from l to sink at min latencies
        tail: dict[int, float] = {}
        for l in reversed(graph.topo_order()):
            tail[l.id] = min_lat[l.id] + max(
                (tail[s] for s in succ[l.id]), default=0.0)

        # warm start: greedy list schedule with critical-path priorities
        warm = list_schedule(graph, candidates, self.platform,
                             priorities={lid: -tail[lid] for lid in tail},
                             release=release)
        incumbent = warm
        best = warm.makespan
        trace = [(time.perf_counter() - t0, best)]
        nodes = 0
        optimal = True
        deadline = t0 + self.time_budget_s

        cap = {"lmu": self.platform.n_lmu, "mmu": self.platform.n_mmu,
               "sfu": self.platform.n_sfu}

        def lb(finish: dict[int, float], remaining: set[int],
               pools: dict[str, _UnitPool]) -> float:
            if not remaining:
                return max(finish.values(), default=0.0)
            # LB-cp
            cp = 0.0
            for lid in remaining:
                ready_at = max((finish.get(d, 0.0)
                                for d in layers[lid].deps), default=0.0)
                ready_at = max(ready_at, release.get(lid, 0.0))
                cp = max(cp, ready_at + tail[lid])
            # LB-res
            lb_res = 0.0
            for kind in ("lmu", "mmu", "sfu"):
                if cap[kind] == 0:
                    continue
                area = 0.0
                for lid in remaining:
                    area += min(c.latency_s * getattr(c, f"n_{kind}")
                                for c in candidates[lid])
                start = min(pools[kind].free_at) if pools[kind].free_at else 0.0
                lb_res = max(lb_res, start + area / cap[kind])
            done = max((finish[l] for l in finish), default=0.0)
            return max(cp, lb_res, done if not remaining else 0.0)

        entries_stack: list[ScheduleEntry] = []

        def dfs(finish: dict[int, float], remaining: set[int],
                pools: dict[str, _UnitPool]) -> None:
            nonlocal best, incumbent, nodes, optimal
            nodes += 1
            if nodes >= self.max_nodes or time.perf_counter() > deadline:
                optimal = False
                return
            if not remaining:
                ms = max(finish.values(), default=0.0)
                if ms < best - 1e-12:
                    best = ms
                    incumbent = Schedule(sorted(
                        entries_stack, key=lambda e: (e.start, e.layer_id)))
                    trace.append((time.perf_counter() - t0, best))
                return
            if lb(finish, remaining, pools) >= best - 1e-12:
                return
            ready = sorted((lid for lid in remaining
                            if set(layers[lid].deps) <= finish.keys()),
                           key=lambda lid: -tail[lid])
            for lid in ready:
                dep_done = max((finish[d] for d in layers[lid].deps),
                               default=0.0)
                dep_done = max(dep_done, release.get(lid, 0.0))
                for mode in sorted(candidates[lid],
                                   key=lambda c: c.latency_s):
                    t = dep_done
                    snapshot = {k: list(p.free_at) for k, p in pools.items()}
                    for _ in range(64):
                        t1, lmu_ids = pools["lmu"].earliest(mode.n_lmu, t)
                        t2, mmu_ids = pools["mmu"].earliest(mode.n_mmu, t1)
                        t3, sfu_ids = pools["sfu"].earliest(mode.n_sfu, t2)
                        if t3 == t:
                            break
                        t = t3
                    end = t + mode.latency_s
                    if end + max((tail[s] - min_lat[s] + min_lat[s]
                                  for s in succ[lid]), default=0.0) >= best - 1e-12 \
                            and end >= best - 1e-12:
                        for k, v in snapshot.items():
                            pools[k].free_at = v
                        continue
                    pools["lmu"].occupy(lmu_ids, end)
                    pools["mmu"].occupy(mmu_ids, end)
                    pools["sfu"].occupy(sfu_ids, end)
                    finish[lid] = end
                    remaining.remove(lid)
                    entries_stack.append(ScheduleEntry(
                        lid, mode, t, end, tuple(lmu_ids), tuple(mmu_ids),
                        tuple(sfu_ids)))
                    dfs(finish, remaining, pools)
                    entries_stack.pop()
                    remaining.add(lid)
                    del finish[lid]
                    for k, v in snapshot.items():
                        pools[k].free_at = v
                    if nodes >= self.max_nodes or time.perf_counter() > deadline:
                        optimal = False
                        return

        pools = {"lmu": _UnitPool(self.platform.n_lmu),
                 "mmu": _UnitPool(self.platform.n_mmu),
                 "sfu": _UnitPool(self.platform.n_sfu)}
        dfs({}, {l.id for l in graph.layers}, pools)

        elapsed = time.perf_counter() - t0
        incumbent.validate(graph, self.platform, release=release)
        return SolveResult(incumbent, optimal, nodes, elapsed, trace)
