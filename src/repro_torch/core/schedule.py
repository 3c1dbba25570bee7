"""Schedule IR + the dependency-aware serial schedule-generation scheme
(SGS) shared by the GA decoder, the MILP warm start, and the baselines.

A schedule assigns every layer one candidate mode, a start time, and a
concrete set of functional units; validity means (paper Fig. 7):
  - precedence: S_i >= E_j for every dep edge (j -> i)   [line 5]
  - exclusivity: unit intervals never overlap            [lines 7-11]
  - resources: |units| match the mode's requirement      [lines 12-14]

Multi-tenant extension: every scheduler here additionally accepts a
``release`` map (layer id -> earliest permissible start).  A tenant's
arrival offset becomes the release time of all its layers; unit
exclusivity *across* tenants falls out of the shared unit pools.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

from .graph import WorkloadGraph
from .perf_model import (CandidateMode, DoraPlatform, Policy,
                         mode_dram_demand, mode_latency_at_share)


@dataclass(frozen=True)
class ScheduleEntry:
    layer_id: int
    mode: CandidateMode
    start: float
    end: float
    lmu_ids: tuple[int, ...]
    mmu_ids: tuple[int, ...]
    sfu_ids: tuple[int, ...]


def dispatch_overlap_s(mode: CandidateMode,
                       platform: DoraPlatform) -> float:
    """How far a layer's slot may lap into its producers' slots.

    Every emitted layer opens with dependency-free head instructions —
    the LMU_CFG and the weight prefetch — and the simulator charges the
    per-layer IDU dispatch cost (``platform.startup_s``) on that first
    instruction, so for any layer that is not at the very front of the
    machine the whole dispatch window runs hidden under its producers'
    tails.  ``pipeline_layer_latency`` prices the layer from an idle
    machine and therefore includes the dispatch at the head of its
    latency; chaining such layers back-to-back without credit charges
    the hidden window once per layer (the NCF-S under-unity ratio).
    The analytic model keeps its regression-locked no-overlap timing."""
    if mode.latency_model == "pipeline":
        return platform.startup_s
    return 0.0


@dataclass
class Schedule:
    entries: list[ScheduleEntry] = field(default_factory=list)

    @property
    def makespan(self) -> float:
        return max((e.end for e in self.entries), default=0.0)

    def by_layer(self) -> dict[int, ScheduleEntry]:
        return {e.layer_id: e for e in self.entries}

    def shifted(self, dt: float) -> Schedule:
        """A copy with every entry translated ``dt`` seconds later —
        the incremental-replay surface: a request's solo schedule,
        compiled once at t=0 and cached by batch shape, re-anchors at
        its absolute dispatch time without recompiling.  Unit
        assignments, modes, and durations are untouched, so a shifted
        schedule validates against the same graph with every release
        time shifted by the same ``dt``."""
        return Schedule(entries=[
            replace(e, start=e.start + dt, end=e.end + dt)
            for e in self.entries])

    def validate(self, graph: WorkloadGraph, platform: DoraPlatform,
                 eps: float = 1e-9,
                 release: dict[int, float] | None = None) -> None:
        by_layer = self.by_layer()
        if set(by_layer) != {l.id for l in graph.layers}:
            raise ValueError("schedule does not cover every layer exactly once")
        for l in graph.layers:
            e = by_layer[l.id]
            if e.end < e.start - eps:
                raise ValueError(f"layer {l.id}: end < start")
            if release and e.start < release.get(l.id, 0.0) - eps:
                raise ValueError(
                    f"layer {l.id} starts {e.start} before its release "
                    f"time {release[l.id]} (tenant not yet arrived)")
            if abs((e.end - e.start) - e.mode.latency_s) > max(
                    1e-6 * e.mode.latency_s, eps):
                raise ValueError(f"layer {l.id}: duration != mode latency")
            if (len(e.lmu_ids) != e.mode.n_lmu
                    or len(e.mmu_ids) != e.mode.n_mmu
                    or len(e.sfu_ids) != e.mode.n_sfu):
                raise ValueError(f"layer {l.id}: unit counts != mode")
            if (max(e.lmu_ids, default=-1) >= platform.n_lmu
                    or max(e.mmu_ids, default=-1) >= platform.n_mmu
                    or max(e.sfu_ids, default=-1) >= platform.n_sfu):
                raise ValueError(f"layer {l.id}: unit id out of range")
            lap = dispatch_overlap_s(e.mode, platform)
            for d in l.deps:
                if e.start < by_layer[d].end - lap - eps:
                    raise ValueError(
                        f"precedence violated: layer {l.id} starts {e.start} "
                        f"before dep {d} ends {by_layer[d].end} "
                        f"(dispatch overlap {lap})")
        # unit exclusivity: a later entry's slot may lap an earlier one
        # by its own dispatch window (no unit is held while dispatching)
        for kind, count in (("lmu", platform.n_lmu), ("mmu", platform.n_mmu),
                            ("sfu", platform.n_sfu)):
            for uid in range(count):
                ivs = sorted((e.start, e.end, e.layer_id, e.mode)
                             for e in self.entries
                             if uid in getattr(e, f"{kind}_ids"))
                for (s1, e1, l1, _), (s2, e2, l2, m2) in zip(ivs, ivs[1:]):
                    if s2 < e1 - dispatch_overlap_s(m2, platform) - eps:
                        raise ValueError(
                            f"{kind}{uid} overlap: layers {l1} and {l2}")


# ---------------------------------------------------------------------------
# Serial SGS decoder
# ---------------------------------------------------------------------------

class _UnitPool:
    """Tracks per-unit busy-until times; allocates earliest-free units."""

    def __init__(self, n: int):
        self.free_at = [0.0] * n

    def earliest(self, count: int, not_before: float) -> tuple[float, list[int]]:
        """Earliest time >= not_before at which ``count`` units are
        simultaneously free, and which units."""
        if count == 0:
            return not_before, []
        if count > len(self.free_at):
            raise ValueError(f"requested {count} units, pool has {len(self.free_at)}")
        order = sorted(range(len(self.free_at)), key=lambda i: self.free_at[i])
        chosen = order[:count]
        t = max(not_before, max(self.free_at[i] for i in chosen))
        return t, chosen

    def occupy(self, ids: list[int], until: float) -> None:
        for i in ids:
            self.free_at[i] = until


def list_schedule(graph: WorkloadGraph,
                  candidates: dict[int, list[CandidateMode]],
                  platform: DoraPlatform,
                  priorities: dict[int, float] | None = None,
                  mode_choice: dict[int, int] | None = None,
                  release: dict[int, float] | None = None) -> Schedule:
    """Dependency-aware greedy scheduler (the GA's decoder and the
    baseline heuristic): repeatedly pick the ready layer with the best
    priority and place it at its earliest feasible time on earliest-free
    units.

    priorities: smaller = earlier (defaults to topological id).
    mode_choice: layer -> candidate index (defaults to fastest mode that
    fits the platform).
    release: layer -> earliest permissible start (tenant arrival).
    """
    priorities = priorities or {}
    mode_choice = mode_choice or {}
    release = release or {}
    lmu = _UnitPool(platform.n_lmu)
    mmu = _UnitPool(platform.n_mmu)
    sfu = _UnitPool(platform.n_sfu)

    finish: dict[int, float] = {}
    entries: list[ScheduleEntry] = []
    remaining = {l.id for l in graph.layers}
    deps = {l.id: set(l.deps) for l in graph.layers}

    while remaining:
        ready = [lid for lid in remaining if deps[lid] <= finish.keys()]
        if not ready:
            raise RuntimeError("cycle in graph?")
        # release first: the serial SGS commits units monotonically, so
        # placing a not-yet-arrived tenant's layer ahead of arrived work
        # would wall off the idle window before its release.  Priority
        # orders layers *within* the same arrival.
        ready.sort(key=lambda lid: (release.get(lid, 0.0),
                                    priorities.get(lid, float(lid)), lid))
        lid = ready[0]
        modes = candidates[lid]
        mi = mode_choice.get(lid)
        mode = modes[mi % len(modes)] if mi is not None else \
            min(modes, key=lambda c: c.latency_s)
        dep_done = max((finish[d] for d in deps[lid]), default=0.0)
        ov = dispatch_overlap_s(mode, platform) if deps[lid] else 0.0
        if ov:
            # pipeline-priced layers lap their dep-free dispatch/prefetch
            # head into the producers' tails, as the simulator does; the
            # dispatch window holds no LMU/MMU/SFU, so the units need to
            # be free only from start + ov onward
            dep_done = max(dep_done - ov, 0.0)
        dep_done = max(dep_done, release.get(lid, 0.0))
        # earliest time all unit classes have capacity
        t = dep_done
        for _ in range(64):   # fixed-point on unit availability
            t1, lmu_ids = lmu.earliest(mode.n_lmu, t + ov)
            t2, mmu_ids = mmu.earliest(mode.n_mmu, t1)
            t3, sfu_ids = sfu.earliest(mode.n_sfu, t2)
            if t3 - ov == t:
                break
            t = t3 - ov
        end = t + mode.latency_s
        lmu.occupy(lmu_ids, end)
        mmu.occupy(mmu_ids, end)
        sfu.occupy(sfu_ids, end)
        finish[lid] = end
        entries.append(ScheduleEntry(lid, mode, t, end,
                                     tuple(lmu_ids), tuple(mmu_ids),
                                     tuple(sfu_ids)))
        remaining.remove(lid)

    entries.sort(key=lambda e: (e.start, e.layer_id))
    return Schedule(entries)


def makespan_lower_bound(graph: WorkloadGraph,
                         candidates: dict[int, list[CandidateMode]],
                         platform: DoraPlatform,
                         release: dict[int, float] | None = None) -> float:
    """Engine-independent lower bound on *any* schedule's makespan:
    the larger of

      - the release-respecting critical path with every layer priced at
        its fastest candidate mode, and
      - the per-unit-class area bounds — the total of each layer's
        cheapest unit-seconds (min over modes of latency * units)
        spread over the platform's unit count,

    both ignoring dispatch overlap (which only makes real schedules
    longer).  The mesh placement stage uses this to prune tenant->PE
    assignments without running a stage-2 engine
    (``mesh.DoraMeshCompiler``): no placement of a tenant on a PE can
    ever beat this value on that PE."""
    release = release or {}
    best = {lid: min(m.latency_s for m in modes)
            for lid, modes in candidates.items()}
    finish: dict[int, float] = {}
    for l in graph.topo_order():
        start = max((finish[d] for d in l.deps),
                    default=0.0)
        finish[l.id] = max(start, release.get(l.id, 0.0)) + best[l.id]
    path = max(finish.values(), default=0.0)
    area = {"lmu": 0.0, "mmu": 0.0, "sfu": 0.0}
    for lid, modes in candidates.items():
        area["lmu"] += min(m.latency_s * m.n_lmu for m in modes)
        area["mmu"] += min(m.latency_s * m.n_mmu for m in modes)
        area["sfu"] += min(m.latency_s * m.n_sfu for m in modes)
    # units cannot run before the earliest release; only sound when
    # every layer carries one (a partial release map defaults to 0)
    earliest = (min(release.values())
                if release and len(release) >= len(candidates) else 0.0)
    return max(path,
               earliest + area["lmu"] / max(platform.n_lmu, 1),
               earliest + area["mmu"] / max(platform.n_mmu, 1),
               earliest + area["sfu"] / max(platform.n_sfu, 1))


# ---------------------------------------------------------------------------
# Interleave-aware schedule bound (QoS)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class InterleaveBound:
    """Re-timed analytic makespan under the interleave-aware transfer
    model (``perf_model.share_scaled_platform``)."""

    makespan_s: float                 # interleave-aware bound
    contiguous_makespan_s: float      # the engine's original bound
    tenant_finish_s: dict[int, float] = field(default_factory=dict)
    layer_end_s: dict[int, float] = field(default_factory=dict)


def interleave_aware_bound(schedule: Schedule, graph: WorkloadGraph,
                           platform: DoraPlatform, policy: Policy,
                           tenant_of: dict[int, int],
                           shares: dict[int, float],
                           release: dict[int, float] | None = None
                           ) -> InterleaveBound:
    """Correct the stage-2 engines' MIU-occupancy assumption for
    interleaved multi-tenant streams.

    The list/sequential (and MILP/GA) engines price every layer with
    ``layer_latency`` at the *full* DRAM bandwidth — the contiguous
    tile-loop assumption.  Once the codegen interleave pass alternates
    the tenants' MIU traffic and the simulator arbitrates it
    (weighted-fair or rr), a layer that temporally overlaps foreign
    tenants' layers streams its tiles at only its tenant's guaranteed
    share of the bandwidth, so the analytic bound under-estimates every
    DRAM-bound region.  This pass re-times the committed schedule:

      1. from the engine's own timing, measure each entry's *foreign
         overlap fraction* (the part of its interval co-resident with
         at least one other tenant's entry);
      2. inflate its duration toward the share-scaled latency
         (``mode_latency_at_share``) in proportion to that fraction —
         full bandwidth while alone, the guaranteed share while
         contended;
      3. replay the placements in the engine's commit order against the
         same unit assignment, propagating the inflation through
         precedence and unit exclusivity.

    Since the share-scaled latency is monotonically >= the contiguous
    one, the re-timed makespan is always >= the engine's bound; overlap
    fractions are measured on the engine's timing (first-order model),
    so the result is a tighter *analytic* bound, not a simulation.
    Single-tenant schedules (or empty ``shares``) re-time to the
    original makespan exactly.
    """
    release = release or {}
    entries = sorted(schedule.entries, key=lambda e: (e.start, e.layer_id))
    by_tenant: dict[int, list[ScheduleEntry]] = {}
    for e in entries:
        by_tenant.setdefault(tenant_of.get(e.layer_id, -1), []).append(e)

    def _foreign_frac(e: ScheduleEntry, tenant: int) -> float:
        dur = e.end - e.start
        if dur <= 0.0 or len(by_tenant) <= 1:
            return 0.0
        # union of foreign intervals clipped to [start, end)
        clipped = []
        for t, es in by_tenant.items():
            if t == tenant:
                continue
            for f in es:
                s, x = max(f.start, e.start), min(f.end, e.end)
                if x > s:
                    clipped.append((s, x))
        clipped.sort()
        covered, cur_s, cur_e = 0.0, None, None
        for s, x in clipped:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    covered += cur_e - cur_s
                cur_s, cur_e = s, x
            else:
                cur_e = max(cur_e, x)
        if cur_e is not None:
            covered += cur_e - cur_s
        return covered / dur

    durations: dict[int, float] = {}
    for e in entries:
        t = tenant_of.get(e.layer_id, -1)
        frac = _foreign_frac(e, t)
        dur = e.end - e.start
        share = shares.get(t, 1.0)
        if frac > 0.0 and share < 1.0:
            layer = graph.layers[e.layer_id]
            scaled = mode_latency_at_share(layer, e.mode, platform,
                                           policy, share)
            dur = dur + frac * max(scaled - dur, 0.0)
        durations[e.layer_id] = dur
    finish, tenant_finish = _replay_inflated(entries, graph, platform,
                                             tenant_of, durations, release)
    return InterleaveBound(
        makespan_s=max(finish.values(), default=0.0),
        contiguous_makespan_s=schedule.makespan,
        tenant_finish_s=tenant_finish,
        layer_end_s=finish)


def _replay_inflated(entries: list[ScheduleEntry], graph: WorkloadGraph,
                     platform: DoraPlatform,
                     tenant_of: dict[int, int],
                     durations: dict[int, float],
                     release: dict[int, float]
                     ) -> tuple[dict[int, float], dict[int, float]]:
    """Replay the committed placements in the engine's commit order with
    per-layer inflated durations, propagating the inflation through
    precedence and unit exclusivity.  Each entry is anchored at the
    engine's own start, so the replay may only delay — never compress a
    gap the engine chose to leave — keeping every re-timed bound
    monotonically >= the contiguous bound (and monotone in the supplied
    durations, which is what makes the oversubscription bound >= the
    interleave-aware one).  Precedence grants the same dispatch-overlap
    credit as ``list_schedule``, so at uninflated durations the replay
    reproduces the engine's timing exactly."""
    unit_free: dict[tuple[str, int], float] = {}
    finish: dict[int, float] = {}
    tenant_finish: dict[int, float] = {}
    deps = {l.id: l.deps for l in graph.layers}
    for e in entries:
        t0 = max((finish[d] for d in deps[e.layer_id]),
                 default=0.0)
        ov = (dispatch_overlap_s(e.mode, platform)
              if deps[e.layer_id] else 0.0)
        if ov:
            t0 = max(t0 - ov, 0.0)
        t0 = max(t0, release.get(e.layer_id, 0.0), e.start)
        for kind, ids in (("lmu", e.lmu_ids), ("mmu", e.mmu_ids),
                          ("sfu", e.sfu_ids)):
            for uid in ids:
                t0 = max(t0, unit_free.get((kind, uid), 0.0) - ov)
        end = t0 + durations[e.layer_id]
        finish[e.layer_id] = end
        for kind, ids in (("lmu", e.lmu_ids), ("mmu", e.mmu_ids),
                          ("sfu", e.sfu_ids)):
            for uid in ids:
                unit_free[(kind, uid)] = end
        t = tenant_of.get(e.layer_id, -1)
        if t >= 0:
            tenant_finish[t] = max(tenant_finish.get(t, 0.0), end)
    return finish, tenant_finish


# ---------------------------------------------------------------------------
# Oversubscription-aware schedule bound (same-tenant MIU concurrency)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class OversubscriptionBound:
    """Re-timed analytic makespan under the oversubscription-aware
    transfer model: cross-tenant overlap shrinks a layer's bandwidth to
    its tenant's guaranteed share (as in ``InterleaveBound``) *and*
    concurrent same-tenant layers split whatever their tenant has."""

    makespan_s: float                 # oversubscription-aware bound
    interleave_aware_makespan_s: float  # foreign-overlap-only re-timing
    contiguous_makespan_s: float      # the engine's original bound
    tenant_finish_s: dict[int, float] = field(default_factory=dict)
    layer_end_s: dict[int, float] = field(default_factory=dict)


def oversubscription_aware_bound(schedule: Schedule, graph: WorkloadGraph,
                                 platform: DoraPlatform, policy: Policy,
                                 tenant_of: dict[int, int],
                                 shares: dict[int, float],
                                 release: dict[int, float] | None = None,
                                 interleave_bound: InterleaveBound | None
                                 = None) -> OversubscriptionBound:
    """Close the residual ``interleave_aware_bound`` deliberately leaves
    open: windows where *one* tenant has k concurrent MIU-active layers
    (the llm_pair residual — intra-tenant DRAM serialization).

    The interleave-aware bound re-prices a layer only while *foreign*
    tenants overlap it, at the tenant's guaranteed share; concurrent
    layers of the same tenant are assumed to stream for free.  On a
    DRAM-bound workload they cannot: k co-resident tile loops of one
    tenant split that tenant's bandwidth among themselves.  This bound
    partitions every entry's interval at the start/end events of all
    overlapping entries and, per elementary window, re-prices the entry
    at the bandwidth a fluid-fair MIU would actually grant it:

      - available to the tenant: its guaranteed share while any foreign
        tenant is resident, the full bandwidth while alone;
      - split among the tenant's k concurrent layers in proportion to
        each layer's average demand (``perf_model.mode_dram_demand``) —
        work-conserving: a layer is never priced below the bandwidth its
        siblings leave unclaimed;
      - windows at effective share 1 (alone, or siblings demand less
        than the headroom) cost nothing extra.

    Durations inflate window-by-window toward ``mode_latency_at_share``
    and replay through precedence and unit exclusivity exactly like the
    interleave-aware bound.  Every window's effective share is <= the
    share the interleave-aware bound would use there, and the replay is
    monotone in durations, so the result is always >= the
    interleave-aware bound (and therefore >= the contiguous one); it
    remains a first-order analytic bound, not a simulation.

    ``interleave_bound``: pass an already-computed
    ``interleave_aware_bound`` of the same schedule/shares to skip
    recomputing it (the compiler computes both per QoS compile).
    """
    release = release or {}
    entries = sorted(schedule.entries, key=lambda e: (e.start, e.layer_id))
    ilv = interleave_bound if interleave_bound is not None else \
        interleave_aware_bound(schedule, graph, platform, policy,
                               tenant_of, shares, release=release)
    layers = {l.id: l for l in graph.layers}

    def _demand(e: ScheduleEntry) -> float:
        # mode_dram_demand is memoized process-wide (perf_model's
        # _REPRICE_MEMO), so repeated windows — and repeated bound
        # replays across compiles — hit the shared cache directly
        return mode_dram_demand(layers[e.layer_id], e.mode, platform,
                                policy)

    durations: dict[int, float] = {}
    for e in entries:
        dur = e.end - e.start
        if dur <= 0.0:
            durations[e.layer_id] = dur
            continue
        t = tenant_of.get(e.layer_id, -1)
        s_t = shares.get(t, 1.0)
        overlapping = [f for f in entries
                       if f is not e and f.start < e.end - 1e-18
                       and f.end > e.start + 1e-18]
        if not overlapping:
            durations[e.layer_id] = dur
            continue
        cuts = {e.start, e.end}
        for f in overlapping:
            cuts.add(min(max(f.start, e.start), e.end))
            cuts.add(min(max(f.end, e.start), e.end))
        bounds = sorted(cuts)
        window_frac: dict[float, float] = {}
        for a, b in zip(bounds, bounds[1:]):
            if b - a <= 0.0:
                continue
            mid = 0.5 * (a + b)
            same = [f for f in overlapping
                    if f.start <= mid < f.end
                    and tenant_of.get(f.layer_id, -1) == t]
            foreign = any(f.start <= mid < f.end
                          and tenant_of.get(f.layer_id, -1) != t
                          for f in overlapping)
            avail = s_t if foreign else 1.0
            if not same:
                share_w = avail
            else:
                d_e = _demand(e)
                sum_d = d_e + sum(_demand(f) for f in same)
                if sum_d <= 0.0:
                    share_w = avail
                else:
                    prop = avail * d_e / sum_d
                    leftover = avail - (sum_d - d_e)
                    share_w = min(avail, max(prop, leftover))
            share_w = min(max(share_w, 1e-9), 1.0)
            if share_w < 1.0:
                window_frac[share_w] = window_frac.get(share_w, 0.0) \
                    + (b - a) / dur
        layer = layers[e.layer_id]
        inflated = dur
        for share_w, frac in window_frac.items():
            scaled = mode_latency_at_share(layer, e.mode, platform,
                                           policy, share_w)
            inflated += frac * max(scaled - dur, 0.0)
        durations[e.layer_id] = inflated
    finish, tenant_finish = _replay_inflated(entries, graph, platform,
                                             tenant_of, durations, release)
    return OversubscriptionBound(
        makespan_s=max(finish.values(), default=0.0),
        interleave_aware_makespan_s=ilv.makespan_s,
        contiguous_makespan_s=schedule.makespan,
        tenant_finish_s=tenant_finish,
        layer_end_s=finish)


def sequential_schedule(graph: WorkloadGraph,
                        candidates: dict[int, list[CandidateMode]],
                        platform: DoraPlatform,
                        release: dict[int, float] | None = None) -> Schedule:
    """Monolithic baseline behaviour (CHARM-a/RSN): layers run strictly
    one after another on the whole array."""
    release = release or {}
    t = 0.0
    entries = []
    for l in graph.topo_order():
        mode = min(candidates[l.id], key=lambda c: c.latency_s)
        t = max(t, release.get(l.id, 0.0))
        end = t + mode.latency_s
        entries.append(ScheduleEntry(
            l.id, mode, t, end,
            tuple(range(mode.n_lmu)), tuple(range(mode.n_mmu)),
            tuple(range(mode.n_sfu))))
        t = end
    return Schedule(entries)
