"""DAG partitioning for parallel DSE (paper §4.4, Fig. 12a/b).

The workload DAG is split into ``n_segments`` contiguous topological
segments balanced by minimum-latency workload; each sub-DAG is solved
independently (the paper launches one DSE engine per segment on its own
CPU thread) and the resulting schedules are concatenated with an
inter-segment barrier (dependencies between segments always point
forward, so a barrier is sufficient for feasibility).

The reported wall-clock for the partitioned search is the *max* of the
per-segment solve times (engines run in parallel); schedule quality is
the concatenated makespan.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .graph import Layer, WorkloadGraph
from .perf_model import CandidateMode, DoraPlatform
from .schedule import Schedule, ScheduleEntry


@dataclass
class PartitionedResult:
    schedule: Schedule
    makespan: float
    wall_s: float                  # max over segments (parallel engines)
    total_cpu_s: float             # sum over segments
    per_segment: list[tuple[int, float, float]] = field(default_factory=list)
    trace: list[tuple[float, float]] = field(default_factory=list)


def split_segments(graph: WorkloadGraph,
                   candidates: dict[int, list[CandidateMode]],
                   n_segments: int) -> list[list[Layer]]:
    layers = graph.topo_order()
    n_segments = max(1, min(n_segments, len(layers)))
    weight = {l.id: min(c.latency_s for c in candidates[l.id])
              for l in layers}
    total = sum(weight.values())
    target = total / n_segments
    segments: list[list[Layer]] = [[]]
    acc = 0.0
    for l in layers:
        if (acc >= target and len(segments) < n_segments
                and len(segments[-1]) > 0):
            segments.append([])
            acc = 0.0
        segments[-1].append(l)
        acc += weight[l.id]
    return [s for s in segments if s]


def _subgraph(graph: WorkloadGraph, segment: list[Layer]
              ) -> tuple[WorkloadGraph, dict[int, int]]:
    """Re-index a segment as a standalone graph; cross-segment deps are
    dropped (handled by the barrier)."""
    ids = {l.id for l in segment}
    remap = {l.id: i for i, l in enumerate(sorted(segment, key=lambda x: x.id))}
    sub = WorkloadGraph(f"{graph.name}.seg")
    sub.inputs = dict(graph.inputs)
    for l in sorted(segment, key=lambda x: x.id):
        deps = tuple(remap[d] for d in l.deps if d in ids)
        sub.layers.append(Layer(remap[l.id], l.name, l.kind, l.M, l.K, l.N,
                                l.nonlinear, l.lhs, l.rhs, deps))
    sub.validate()
    return sub, remap


def partitioned_solve(graph: WorkloadGraph,
                      candidates: dict[int, list[CandidateMode]],
                      platform: DoraPlatform, n_segments: int,
                      make_engine) -> PartitionedResult:
    """``make_engine()`` -> object with .solve(graph, candidates) that
    returns something with .schedule / .elapsed_s / .trace."""
    segments = split_segments(graph, candidates, n_segments)
    offset = 0.0
    entries: list[ScheduleEntry] = []
    per_seg: list[tuple[int, float, float]] = []
    wall = 0.0
    cpu = 0.0
    merged_trace: list[tuple[float, float]] = []
    base_quality = 0.0
    for si, seg in enumerate(segments):
        sub, remap = _subgraph(graph, seg)
        inv = {v: k for k, v in remap.items()}
        sub_cands = {remap[l.id]: [type(c)(remap[l.id], c.mode_id, c.n_lmu,
                                           c.n_mmu, c.n_sfu, c.latency_s,
                                           c.plan)
                                   for c in candidates[l.id]]
                     for l in seg}
        engine = make_engine()
        res = engine.solve(sub, sub_cands)
        sched = res.schedule
        for e in sched.entries:
            entries.append(ScheduleEntry(inv[e.layer_id], e.mode,
                                         e.start + offset, e.end + offset,
                                         e.lmu_ids, e.mmu_ids, e.sfu_ids))
        seg_ms = sched.makespan
        per_seg.append((si, seg_ms, res.elapsed_s))
        for (t, q) in getattr(res, "trace", []):
            merged_trace.append((t, base_quality + q))
        base_quality += seg_ms
        offset += seg_ms          # barrier between segments
        wall = max(wall, res.elapsed_s)
        cpu += res.elapsed_s
    entries.sort(key=lambda e: (e.start, e.layer_id))
    schedule = Schedule(entries)
    schedule.validate(graph, platform)
    merged_trace.sort(key=lambda x: x[0])
    return PartitionedResult(schedule, schedule.makespan, wall, cpu,
                             per_seg, merged_trace)
