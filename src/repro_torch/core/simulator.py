"""Event-driven DORA machine simulator (paper §3 runtime behaviour,
Fig. 5 / Fig. 8d).

Models, at instruction granularity:
  - the MIU serializing DRAM traffic at ``dram_bw_bytes``;
  - the Sync Unit's Ready List Table: MIU LOADs with a ``deps`` list
    block until every dependency layer's final STORE has drained (§3.4);
  - stream back-pressure: a consumer instruction cannot start before its
    producers' data is on the network (§5.2 — MMU stalls on empty
    streams), encoded as the dataflow edges in ``CodegenResult.meta``;
  - unit occupancy: each functional unit processes its own instruction
    stream strictly in order.

Output: per-instruction (start, end) times, per-unit busy time, and the
makespan — used to validate schedules and to drive Fig. 11 throughput.

Multi-tenant extension: when codegen tagged instructions with tenants,
``simulate`` additionally (a) holds every tenant's instructions until
that tenant's arrival time, and (b) reports per-tenant makespan, tail
latency (p95 of layer completion), and cross-tenant interference — the
time a tenant's MIU transfers spent queued while *other* tenants'
traffic occupied (or head-blocked) the shared MIU.

MIU virtual channels (``DoraPlatform.vc_count > 1``): each physical
MIU's queue splits into per-tenant (or per-layer-group, for untagged
programs) virtual channels.  Every channel stays in order internally,
but a channel head blocked on the ready list or on stream back-pressure
no longer stalls ready traffic queued on the other channels — the MIU
arbitrates among ready channel heads:

  fifo     — serve the ready head with the lowest program (IDU fetch)
             index; with vc_count=1 this is bit-for-bit the single
             in-order stream (the pre-VC behaviour).
  rr       — rotate across channels with ready heads.
  priority — serve the ready head of the highest-weight channel
             (weights from the ``priorities`` argument, e.g. tenant
             priorities; work-conserving: an absent channel never
             reserves bandwidth).
  wfq      — weighted-fair (DRR-style) arbitration: each channel owns a
             bandwidth share (``bandwidth_shares``, else priorities
             normalized, else equal) and a byte-denominated *deficit
             counter*.  Under contention a channel may only be served
             once its deficit covers the head transfer's bytes; deficits
             are topped up in proportion to the shares by the minimal
             amount that makes some contender eligible, so every
             backlogged channel's credit grows at its share rate and no
             tenant can ever be starved, however adversarial the shares.
             Deficits stay in [0, head bytes] by construction — credit
             never banks across idle periods.

All policies are work-conserving and deterministic; arbitration only
chooses among heads that are ready at the earliest possible service
time, so adding channels can only remove head-of-line blocking, never
add idle time.

QoS accounting: every MIU byte a tenant moves is classified as
*guaranteed* (served under contention, paid for by the weighted-fair
machinery) or *opportunistic* (served while no other channel contended
— the work-conserving bonus).  ``TenantSimStats.expected_bytes`` is the
fluid-fair entitlement while backlogged: at every MIU grant, each
channel with a ready head is entitled to its weight's fraction of the
granted bytes (all of them when it is alone).  ``miu_bytes /
expected_bytes`` is the tenant's guaranteed-share satisfaction — ~1.0
under wfq arbitration, dipping only as far as the within-channel FIFO
order deviates from the share mix when ``vc_count`` < #tenants forces
channel sharing.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

from .codegen import CodegenResult
from .isa import OpType, UnitKind
from .perf_model import (VC_ARBITRATIONS, DoraPlatform,
                         share_scaled_platform)

_MIU_OPS = (OpType.MIU_LOAD, OpType.MIU_STORE)


def nearest_rank(sorted_vals, q: float) -> float | None:
    """Deterministic nearest-rank quantile of an ascending-sorted sample
    — the idiom behind ``TenantSimStats.tail_latency_s`` (p95) and the
    serving layer's per-tenant p50/p95/p99 latency reporting.  Monotone
    in ``q`` by construction (so p50 <= p95 <= p99 always holds).

    An empty sample has no quantile: returns ``None`` (a tenant that
    served zero requests grades as "no data", not as a phantom 0.0
    latency).  An out-of-range ``q`` still raises — that is a caller
    bug, not a data condition."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    if not sorted_vals:
        return None
    n = len(sorted_vals)
    return sorted_vals[min(n - 1, int(q * (n - 1) + 0.5))]


@dataclass
class TenantSimStats:
    """Per-tenant timing extracted from one multi-tenant simulation."""

    tenant: int
    arrival_s: float
    finish_s: float               # absolute end of the tenant's last instr
    makespan_s: float             # finish_s - arrival_s (service latency)
    tail_latency_s: float         # p95 of layer completion - arrival_s
    miu_wait_s: float             # MIU queueing behind OTHER tenants
    n_instructions: int = 0
    # QoS byte accounting (see module docstring):
    miu_bytes: float = 0.0            # total DRAM bytes the tenant moved
    guaranteed_bytes: float = 0.0     # bytes served under contention
    opportunistic_bytes: float = 0.0  # bytes served with no contender
    expected_bytes: float = 0.0       # fluid-fair entitlement while
                                      # backlogged (share-weighted)

    @property
    def guaranteed_share_satisfaction(self) -> float:
        """Bytes actually served relative to the tenant's share-weighted
        fluid-fair entitlement while it had traffic backlogged; 1.0 for
        single-stream (vc_count=1) simulations where no entitlement is
        tracked."""
        if self.expected_bytes <= 0.0:
            return 1.0
        return self.miu_bytes / self.expected_bytes


@dataclass(frozen=True)
class TenantTelemetry:
    """One tenant's observed execution signals over one window — the
    currency between a producer (a round's ``SimReport``, the
    incremental simulator's per-program accounting, the serving loop's
    queue depths) and a telemetry consumer such as
    ``tuning.AdaptiveSharePolicy.observe``.

    ``span_s`` is the window the wait accumulated over (a round's
    makespan, a completion-to-completion gap); ``satisfaction`` is the
    window's ``guaranteed_share_satisfaction`` (1.0 when no entitlement
    was tracked); ``slo_s`` is the tenant's end-to-end latency target
    when it has one — consumers use it to weight pressure by urgency
    (a queued request of a 0.6 ms-SLO tenant outranks one of a 3 ms-SLO
    tenant)."""

    tenant: str
    queue_depth: int = 0
    miu_wait_s: float = 0.0
    satisfaction: float = 1.0
    served: int = 0
    span_s: float = 0.0
    slo_s: float | None = None


@dataclass
class SimReport:
    makespan_s: float
    instr_start: list[float]
    instr_end: list[float]
    unit_busy_s: dict[tuple[UnitKind, int], float]
    layer_ready_s: dict[int, float] = field(default_factory=dict)
    tenant_stats: dict[int, TenantSimStats] = field(default_factory=dict)

    def utilization(self, unit: tuple[UnitKind, int]) -> float:
        if self.makespan_s <= 0:
            return 0.0
        return self.unit_busy_s.get(unit, 0.0) / self.makespan_s

    def miu_wait_by_tenant(self) -> dict[int, float]:
        """Tenant index -> MIU wait behind other tenants (telemetry
        accessor for the adaptive-policy loop)."""
        return {ti: s.miu_wait_s for ti, s in self.tenant_stats.items()}

    def satisfaction_by_tenant(self) -> dict[int, float]:
        """Tenant index -> guaranteed-share satisfaction (1.0 when no
        entitlement was tracked, e.g. vc_count=1)."""
        return {ti: s.guaranteed_share_satisfaction
                for ti, s in self.tenant_stats.items()}


def _duration(i: int, result: CodegenResult,
              platform: DoraPlatform) -> float:
    instr = result.program.instructions[i]
    meta = result.meta[i]
    op = instr.op_type
    if op in (OpType.MIU_LOAD, OpType.MIU_STORE):
        return meta.bytes_moved / platform.dram_bw_bytes
    if op == OpType.LMU_MOVE:
        return meta.bytes_moved / (platform.stream_bw_bytes
                                   * platform.mmu_ports)
    if op == OpType.LMU_CFG:
        return 4.0 / platform.freq_pl_hz
    if op == OpType.MMU_GEMM:
        return (meta.mmu_cycles / platform.freq_mmu_hz
                + platform.sync_overhead_s)
    if op in (OpType.SFU_SOFTMAX, OpType.SFU_GELU, OpType.SFU_LAYERNORM,
              OpType.SFU_RELU, OpType.SFU_RELU2, OpType.SFU_SILU):
        body = instr.body
        elems = body.count * body.ele_num
        return elems / (platform.sfu_elems_per_cycle * platform.freq_pl_hz)
    return 0.0


class _SimState:
    """Shared per-simulation state: issue bookkeeping used identically by
    the in-order path and the virtual-channel path (so vc_count=1 + fifo
    reproduces the in-order timings bit-for-bit)."""

    def __init__(self, result: CodegenResult, platform: DoraPlatform,
                 arrivals: dict[int, float] | None):
        self.result = result
        self.platform = platform
        self.arrivals = arrivals
        n = len(result.program)
        self.n = n
        self.start = [-1.0] * n
        self.end = [-1.0] * n
        self.unit_free: dict[tuple[UnitKind, int], float] = {}
        self.unit_busy: dict[tuple[UnitKind, int], float] = {}
        self.layer_ready: dict[int, float] = {}
        self.miu_wait: dict[int, float] = {}
        # QoS byte accounting (tenant -> bytes); expected is filled by
        # the arbitration loop, the rest by issue()
        self.miu_bytes: dict[int, float] = {}
        self.g_bytes: dict[int, float] = {}
        self.o_bytes: dict[int, float] = {}
        self.x_bytes: dict[int, float] = {}
        # per-MIU occupancy history in service order, as prefix sums so
        # each wait query is O(log n): interval k's *span* is
        # (end_k - end_{k-1}), i.e. its busy time plus the idle gap
        # before it (attributed to its tenant: the head that sat blocked
        # during the gap).
        self._occ_ends: dict[tuple[UnitKind, int], list[float]] = {}
        self._occ_tenant: dict[tuple[UnitKind, int], list[int]] = {}
        self._occ_cum: dict[tuple[UnitKind, int], list[float]] = {}
        self._occ_cum_own: dict[tuple[UnitKind, int],
                                dict[int, list[float]]] = {}
        self._tenants = sorted({m.tenant for m in result.meta
                                if m.tenant >= 0})
        # per-layer instruction fetch/dispatch cost (IDU startup, §3.6):
        # charged on the first instruction of each layer in stream order.
        startup_of: dict[int, int] = {}
        for i, m in enumerate(result.meta):
            if m.layer_id >= 0 and m.layer_id not in startup_of:
                startup_of[m.layer_id] = i
        self.startup_idx = set(startup_of.values())

    def ready_time(self, i: int) -> float | None:
        """Earliest time instruction ``i`` may start, ignoring unit
        occupancy — or None while some producer is still unsimulated."""
        meta = self.result.meta[i]
        instr = self.result.program.instructions[i]
        dep_times = []
        for d in meta.deps:
            if self.end[d] < 0:
                return None
            dep_times.append(self.end[d])
        # ready-list RAW sync for MIU LOAD deps
        if instr.op_type == OpType.MIU_LOAD and instr.body.deps:
            for lid in instr.body.deps:
                rs = self.result.ready_store.get(lid)
                if rs is not None:
                    if self.end[rs] < 0:
                        return None
                    dep_times.append(self.end[rs])
        if self.arrivals and meta.tenant >= 0:
            dep_times.append(self.arrivals.get(meta.tenant, 0.0))
        return max(dep_times, default=0.0)

    def issue(self, i: int, key: tuple[UnitKind, int], ready: float,
              contended: bool = False) -> None:
        instr = self.result.program.instructions[i]
        meta = self.result.meta[i]
        t0 = max(self.unit_free.get(key, 0.0), ready)
        # cross-tenant interference: attribute the queued window
        # [ready, t0) to the occupancy intervals that actually blocked it
        if (instr.op_type in _MIU_OPS and meta.tenant >= 0 and t0 > ready):
            w = self._foreign_occupancy(key, ready, t0, meta.tenant)
            if w > 0.0:
                self.miu_wait[meta.tenant] = (
                    self.miu_wait.get(meta.tenant, 0.0) + w)
        if instr.op_type in _MIU_OPS and meta.tenant >= 0:
            b = float(meta.bytes_moved)
            self.miu_bytes[meta.tenant] = (
                self.miu_bytes.get(meta.tenant, 0.0) + b)
            pot = self.g_bytes if contended else self.o_bytes
            pot[meta.tenant] = pot.get(meta.tenant, 0.0) + b
        dur = _duration(i, self.result, self.platform)
        if i in self.startup_idx:
            dur += self.platform.startup_s
        self.start[i] = t0
        self.end[i] = t0 + dur
        self.unit_free[key] = self.end[i]
        self.unit_busy[key] = self.unit_busy.get(key, 0.0) + dur
        if instr.op_type in _MIU_OPS:
            ends = self._occ_ends.setdefault(key, [])
            span = self.end[i] - (ends[-1] if ends else 0.0)
            cum = self._occ_cum.setdefault(key, [])
            cum.append((cum[-1] if cum else 0.0) + span)
            own = self._occ_cum_own.setdefault(
                key, {t: [] for t in self._tenants})
            for t, lst in own.items():
                lst.append((lst[-1] if lst else 0.0)
                           + (span if t == meta.tenant else 0.0))
            ends.append(self.end[i])
            self._occ_tenant.setdefault(key, []).append(meta.tenant)
        if instr.op_type == OpType.MIU_STORE:
            rs = self.result.ready_store.get(meta.layer_id)
            if rs == i:
                self.layer_ready[meta.layer_id] = self.end[i]

    def _foreign_occupancy(self, key: tuple[UnitKind, int], w0: float,
                           w1: float, tenant: int) -> float:
        """Time within the queued window [w0, w1) during which the MIU
        was occupied by (or head-blocked on) another tenant's transfer.

        The previous accounting charged the whole wait iff the
        *immediately preceding* instruction on the unit belonged to a
        different tenant — undercounting whenever one of the tenant's own
        short transfers ran in the middle of a long foreign queue, and
        overcounting self-inflicted queueing behind the tenant's own
        traffic.  Here each busy interval in the window is attributed to
        the tenant that held the MIU, and each idle gap to the tenant of
        the *next* serviced transfer (the head that sat blocked during
        the gap).

        The query window always ends at the unit's current free time
        (``w1 == unit_free``, the end of the last recorded interval), so
        foreign time = (foreign span suffix from the interval covering
        w0) minus the part of that interval's span before w0."""
        ends = self._occ_ends.get(key)
        if not ends:
            return 0.0
        lo, hi = 0, len(ends)
        while lo < hi:                       # first interval ending > w0
            mid = (lo + hi) // 2
            if ends[mid] <= w0:
                lo = mid + 1
            else:
                hi = mid
        if lo == len(ends):
            return 0.0
        cum = self._occ_cum[key]
        own = self._occ_cum_own[key].get(tenant)
        foreign = cum[-1] - (own[-1] if own else 0.0)
        if lo > 0:
            foreign -= cum[lo - 1] - (own[lo - 1] if own else 0.0)
        if self._occ_tenant[key][lo] != tenant:
            # interval lo's span starts at the previous interval's end;
            # the slice [span start, w0) lies outside the window
            foreign -= w0 - (ends[lo - 1] if lo > 0 else 0.0)
        return max(foreign, 0.0)

    def report(self) -> SimReport:
        report = SimReport(max(self.end), self.start, self.end,
                           self.unit_busy, self.layer_ready)
        if self.result.tenant_of:
            report.tenant_stats = _tenant_stats(
                self.result, self.end, self.layer_ready,
                self.arrivals or {}, self.miu_wait,
                self.miu_bytes, self.g_bytes, self.o_bytes, self.x_bytes)
        return report


def simulate(result: CodegenResult, platform: DoraPlatform,
             arrivals: dict[int, float] | None = None,
             priorities: dict[int, float] | None = None,
             bandwidth_shares: dict[int, float] | None = None) -> SimReport:
    """``arrivals``: tenant index -> arrival time; instructions of a
    tenant never start before it arrives (multi-tenant runs only).
    ``priorities``: tenant index -> weight, consumed by the ``priority``
    virtual-channel arbitration (ignored otherwise).
    ``bandwidth_shares``: tenant index -> guaranteed DRAM bandwidth
    fraction, consumed by the ``wfq`` arbitration (ignored by every
    other policy; wfq without explicit shares falls back to
    priority-proportional, then equal, shares)."""
    if platform.vc_count > 1:
        return _simulate_vc(result, platform, arrivals, priorities,
                            bandwidth_shares)
    return _simulate_inorder(result, platform, arrivals)


def simulate_mesh(codegens: list[CodegenResult],
                  platforms: list[DoraPlatform],
                  dram_shares: list[float] | None = None,
                  arrivals: list[dict[int, float] | None] | None = None,
                  priorities: list[dict[int, float] | None] | None = None,
                  bandwidth_shares: list[dict[int, float] | None]
                  | None = None) -> list[SimReport]:
    """Per-PE replay of a placed mesh compile (``mesh.DoraMeshCompiler``).

    Each PE's program replays independently on its own platform —
    cross-PE coupling is *only* through the shared DRAM, priced by
    share-scaling each PE's platform to its granted fraction of the
    aggregate bandwidth (``share_scaled_platform``, the same machinery
    the per-tenant QoS bound uses).  ``platforms[k]`` is PE *k*'s view
    of the shared DRAM port (``DoraPlatform.with_dram_bw``), and
    ``dram_shares[k]`` its guaranteed fraction (default 1.0; a full
    share leaves the platform bit-identical, the N=1 lock).  The
    per-PE ``arrivals`` / ``priorities`` / ``bandwidth_shares`` carry
    the usual per-tenant dicts, keyed by each PE's *local* tenant
    indices."""
    n = len(codegens)
    if len(platforms) != n:
        raise ValueError(f"simulate_mesh: {n} programs but "
                         f"{len(platforms)} platforms")
    shares = dram_shares if dram_shares is not None else [1.0] * n
    if len(shares) != n:
        raise ValueError(f"simulate_mesh: {n} programs but "
                         f"{len(shares)} dram_shares")
    if sum(shares) > 1.0 + 1e-9 and n > 1:
        raise ValueError(f"simulate_mesh: dram_shares sum to "
                         f"{sum(shares):.6g} > 1")
    reports: list[SimReport] = []
    for k in range(n):
        plat = share_scaled_platform(platforms[k], shares[k])
        reports.append(simulate(
            codegens[k], plat,
            arrivals=arrivals[k] if arrivals else None,
            priorities=priorities[k] if priorities else None,
            bandwidth_shares=bandwidth_shares[k] if bandwidth_shares
            else None))
    return reports


def _simulate_inorder(result: CodegenResult, platform: DoraPlatform,
                      arrivals: dict[int, float] | None) -> SimReport:
    """The single-stream machine: every unit (including the MIU) drains
    its queue strictly in program order."""
    st = _SimState(result, platform, arrivals)
    # per-unit queues in program (IDU-dispatch) order
    queues: dict[tuple[UnitKind, int], list[int]] = {}
    for i, instr in enumerate(result.program.instructions):
        queues.setdefault((instr.unit_kind, instr.unit_index), []).append(i)
    heads = {k: 0 for k in queues}

    done = 0
    stalled_rounds = 0
    n = st.n
    while done < n:
        progressed = False
        for key, q in queues.items():
            while heads[key] < len(q):
                i = q[heads[key]]
                ready = st.ready_time(i)
                if ready is None:
                    break
                st.issue(i, key, ready)
                m = result.meta[i]
                if (result.program.instructions[i].op_type in _MIU_OPS
                        and m.tenant >= 0):
                    # single in-order queue: the served instruction IS
                    # the head, so the full entitlement is its tenant's
                    st.x_bytes[m.tenant] = (st.x_bytes.get(m.tenant, 0.0)
                                            + float(m.bytes_moved))
                heads[key] += 1
                done += 1
                progressed = True
        if not progressed:
            stalled_rounds += 1
            if stalled_rounds > 2:
                missing = [i for i in range(n) if st.end[i] < 0]
                raise RuntimeError(
                    f"simulator deadlock: {len(missing)} instructions "
                    f"blocked, first = {missing[:5]}")
        else:
            stalled_rounds = 0
    return st.report()


def _channel_shares(result: CodegenResult,
                    vcq: dict[tuple[UnitKind, int], dict[int, list[int]]],
                    priorities: dict[int, float],
                    bandwidth_shares: dict[int, float] | None
                    ) -> dict[tuple[UnitKind, int], dict[int, float]]:
    """wfq weighting: resolve per-tenant shares (explicit
    ``bandwidth_shares``, else priority-proportional, else equal) into
    per-channel weights — the sum of the shares of the tenants mapped
    into each channel, so tenants sharing a channel pool their
    guarantee."""
    tenants = sorted({m.tenant for m in result.meta if m.tenant >= 0})
    if bandwidth_shares:
        for t, s in bandwidth_shares.items():
            if s <= 0.0:
                raise ValueError(
                    f"bandwidth share for tenant {t} must be > 0, got {s}")
        if sum(bandwidth_shares.values()) > 1.0 + 1e-9:
            raise ValueError("bandwidth shares sum to "
                             f"{sum(bandwidth_shares.values()):.6g} > 1")
        share = {t: bandwidth_shares.get(t, 0.0) for t in tenants}
        missing = [t for t in tenants if share[t] <= 0.0]
        if missing:
            rest = 1.0 - sum(share.values())
            if rest <= 0.0:
                raise ValueError(
                    f"tenants {missing} have no bandwidth share and the "
                    "explicit shares leave no headroom to split")
            psum = sum(priorities.get(t, 1.0) for t in missing)
            for t in missing:
                share[t] = rest * priorities.get(t, 1.0) / psum
    elif priorities:
        psum = sum(priorities.get(t, 1.0) for t in tenants) or 1.0
        share = {t: priorities.get(t, 1.0) / psum for t in tenants}
    else:
        share = {t: 1.0 / max(len(tenants), 1) for t in tenants}
    weight: dict[tuple[UnitKind, int], dict[int, float]] = {}
    for k, q in vcq.items():
        weight[k] = {}
        for c, idxs in q.items():
            ts = {result.meta[i].tenant for i in idxs
                  if result.meta[i].tenant >= 0}
            weight[k][c] = sum(share[t] for t in ts) if ts else 1.0
    return weight


def _wfq_grant(st: _SimState, key: tuple[UnitKind, int], pool: list,
               w: dict[int, float], d: dict[int, float],
               chan_list: dict, rr_ptr: dict) -> tuple[int, int, float]:
    """One contended weighted-fair grant (DRR-style).

    A channel is *eligible* once its deficit counter covers its head
    transfer's bytes.  When no contender is eligible, every contending
    channel's deficit is topped up in proportion to its weight by the
    minimal amount that makes one eligible — so credit accrues at
    exactly the share rate and a 1% channel is guaranteed ~1% of the
    contended bytes, never zero.  Ties resolve by round-robin rotation;
    the winner's deficit is charged.  Deficits never exceed the head's
    bytes (the top-up stops at the first eligible channel), so no
    channel can bank credit and burst later."""
    bytes_of = {cd[0]: float(st.result.meta[cd[1]].bytes_moved)
                for cd in pool}

    def _tol(c: int) -> float:
        return max(1e-9, 1e-12 * bytes_of[c])

    eligible = {c for c in bytes_of if d[c] >= bytes_of[c] - _tol(c)}
    if not eligible:
        q = min((bytes_of[c] - d[c]) / w[c] for c in bytes_of)
        for c in bytes_of:
            d[c] = min(d[c] + q * w[c], bytes_of[c])
        eligible = {c for c in bytes_of if d[c] >= bytes_of[c] - _tol(c)}
    clist = chan_list[key]
    by_chan = {cd[0]: cd for cd in pool}
    for off in range(len(clist)):
        cc = clist[(rr_ptr[key] + off) % len(clist)]
        if cc in eligible:
            c, i, _, ready = by_chan[cc]
            rr_ptr[key] = (clist.index(cc) + 1) % len(clist)
            d[c] = max(d[c] - bytes_of[c], 0.0)
            return c, i, ready
    raise RuntimeError("wfq arbitration found no eligible channel")


def _simulate_vc(result: CodegenResult, platform: DoraPlatform,
                 arrivals: dict[int, float] | None,
                 priorities: dict[int, float] | None,
                 bandwidth_shares: dict[int, float] | None = None
                 ) -> SimReport:
    """The arbitrated machine: MIU queues split into ``vc_count`` virtual
    channels; every other unit stays strictly in order.

    Each outer round first drains every in-order unit to a fixed point,
    then commits exactly one MIU service per physical MIU.  Committing
    only at drain fixed points keeps arbitration sound: any channel head
    whose ready time is still unknown is transitively blocked on a
    *future* MIU service, so it cannot become ready before the candidates
    being compared."""
    arb = platform.vc_arbitration      # validated by DoraPlatform
    st = _SimState(result, platform, arrivals)
    vc = platform.vc_count
    priorities = priorities or {}

    inorder: dict[tuple[UnitKind, int], list[int]] = {}
    vcq: dict[tuple[UnitKind, int], dict[int, list[int]]] = {}
    for i, instr in enumerate(result.program.instructions):
        key = (instr.unit_kind, instr.unit_index)
        if instr.unit_kind == UnitKind.MIU:
            m = result.meta[i]
            ch = (m.tenant if m.tenant >= 0 else max(m.layer_id, 0)) % vc
            vcq.setdefault(key, {}).setdefault(ch, []).append(i)
        else:
            inorder.setdefault(key, []).append(i)
    heads = {k: 0 for k in inorder}
    vheads = {k: {c: 0 for c in q} for k, q in vcq.items()}
    chan_list = {k: sorted(q) for k, q in vcq.items()}
    rr_ptr = {k: 0 for k in vcq}
    # channel weight: max priority among the tenants mapped into the
    # channel (priority arbitration) or the pooled bandwidth share (wfq)
    if arb == "wfq":
        weight = _channel_shares(result, vcq, priorities,
                                 bandwidth_shares)
    else:
        weight = {
            k: {c: max((priorities.get(result.meta[i].tenant, 1.0)
                        for i in idxs), default=1.0)
                if arb == "priority" else 1.0
                for c, idxs in q.items()}
            for k, q in vcq.items()}
    # wfq deficit counters, bytes (see module docstring)
    deficit = {k: {c: 0.0 for c in q} for k, q in vcq.items()}

    done = 0
    n = st.n
    while done < n:
        progressed_any = False
        # 1. drain the strictly in-order units to a fixed point
        while True:
            progressed = False
            for key, q in inorder.items():
                while heads[key] < len(q):
                    i = q[heads[key]]
                    ready = st.ready_time(i)
                    if ready is None:
                        break
                    st.issue(i, key, ready)
                    heads[key] += 1
                    done += 1
                    progressed = True
            if not progressed:
                break
            progressed_any = True
        # 2. one arbitration commit per physical MIU
        for key, q in vcq.items():
            cands = []    # (channel, instr idx, service start, ready)
            for c in chan_list[key]:
                h = vheads[key][c]
                if h >= len(q[c]):
                    continue
                i = q[c][h]
                ready = st.ready_time(i)
                if ready is None:
                    continue
                cands.append((c, i, max(st.unit_free.get(key, 0.0), ready),
                              ready))
            if not cands:
                continue
            t_star = min(t for (_, _, t, _) in cands)
            pool = [cd for cd in cands if cd[2] == t_star]
            if arb == "fifo":
                c, i, _, ready = min(pool, key=lambda cd: cd[1])
            elif arb == "priority":
                c, i, _, ready = max(
                    pool, key=lambda cd: (weight[key][cd[0]], -cd[1]))
            elif arb == "wfq" and len(pool) > 1:
                c, i, ready = _wfq_grant(st, key, pool, weight[key],
                                         deficit[key], chan_list, rr_ptr)
            else:   # rr (and an uncontended wfq grant): rotation wins
                clist = chan_list[key]
                by_chan = {cd[0]: cd for cd in pool}
                for off in range(len(clist)):
                    cc = clist[(rr_ptr[key] + off) % len(clist)]
                    if cc in by_chan:
                        c, i, _, ready = by_chan[cc]
                        rr_ptr[key] = (clist.index(cc) + 1) % len(clist)
                        break
            contended = len(pool) > 1
            if st.result.meta[i].tenant >= 0:
                # fluid-fair entitlement: every channel with a ready
                # head at this grant is entitled to its weight's share
                # of the granted bytes (all of them when alone).  Within
                # a FIFO channel the guarantee extends to the *head*, so
                # the entitlement goes to the tenant whose instruction
                # is at the channel head right now (cd[1]).
                b = float(st.result.meta[i].bytes_moved)
                w_pool = sum(weight[key][cd[0]] for cd in pool)
                for cd in pool:
                    t_head = st.result.meta[cd[1]].tenant
                    if t_head >= 0:
                        st.x_bytes[t_head] = (
                            st.x_bytes.get(t_head, 0.0)
                            + b * weight[key][cd[0]] / w_pool)
            st.issue(i, key, ready, contended=contended)
            vheads[key][c] += 1
            done += 1
            progressed_any = True
        if not progressed_any and done < n:
            missing = [i for i in range(n) if st.end[i] < 0]
            raise RuntimeError(
                f"simulator deadlock (vc): {len(missing)} instructions "
                f"blocked, first = {missing[:5]}")
    return st.report()


# ---------------------------------------------------------------------------
# Incremental replay: extend a running simulation with new programs
# ---------------------------------------------------------------------------

class _IncrProgram:
    """One admitted program inside an :class:`IncrementalSimulator`: a
    compiled instruction stream, its release time (nothing of it may
    start earlier), the MIU virtual channel it rides, and the per-
    instruction commit bookkeeping."""

    __slots__ = ("pid", "result", "release_s", "channel", "n", "start",
                 "end", "committed", "finish_s", "miu_wait_s", "miu_bytes",
                 "startup_idx")

    def __init__(self, pid: int, result: CodegenResult, release_s: float,
                 channel: int):
        self.pid = pid
        self.result = result
        self.release_s = release_s
        self.channel = channel
        n = len(result.program)
        self.n = n
        self.start = [-1.0] * n
        self.end = [-1.0] * n
        self.committed = 0
        self.finish_s = release_s
        self.miu_wait_s = 0.0        # MIU queueing behind other programs
        self.miu_bytes = 0.0
        # per-layer IDU dispatch cost: charged on the first instruction
        # of each layer in stream order, exactly like _SimState
        startup_of: dict[int, int] = {}
        for i, m in enumerate(result.meta):
            if m.layer_id >= 0 and m.layer_id not in startup_of:
                startup_of[m.layer_id] = i
        self.startup_idx = set(startup_of.values())

    @property
    def done(self) -> bool:
        return self.committed == self.n


class IncrementalSimulator:
    """Event-driven machine simulation that *grows while it runs*: new
    programs join mid-flight instead of restarting the whole replay.

    The batch simulators (`_simulate_inorder` / `_simulate_vc`) need the
    complete merged program up front — fine for a static workload, but
    an online dispatcher learns about new requests only as simulated
    time advances.  This class keeps the same machine primitives
    (per-instruction durations, per-layer IDU startup, ready-list RAW
    sync, MIU virtual channels with fifo/rr/priority/wfq arbitration)
    over a set of *independently compiled* programs:

      ``add_program``  appends a compiled ``CodegenResult`` with a
                       release time: each unit gets the program's
                       in-order instruction stream for that unit, and
                       the program's MIU traffic joins the given
                       virtual channel.
      ``advance``      commits instructions in globally nondecreasing
                       start-time order while the next start lies
                       strictly below the gate, and reports programs
                       that completed.  Committed work is never rolled
                       back — preemption points are instruction
                       boundaries, so a caller may add programs between
                       ``advance`` calls at any time >= the last
                       committed start.

    Cross-program issue is *dependence-driven*, not program-order: a
    unit holds one in-order stream per program and serves whichever
    stream's head is ready first (ties by admission order), exactly the
    role the batch path's compile-time merge plays — there the joint
    schedule decides the per-unit interleaving ahead of time; here the
    dispatcher decides it at run time from the ready list, which is the
    paper's dynamic-orchestration pitch.  A long-running program
    blocked on a transfer no longer head-blocks a later-admitted short
    program on shared units; *within* one program every unit stream
    stays strictly in order.  Deadlock is impossible: each program's
    earliest uncommitted instruction always heads its unit stream with
    all deps committed.

    Commit-order soundness: always committing the globally minimal
    start time means no later commit can change an earlier one — unit
    frontiers only move forward and a newly enabled instruction is
    never ready before the instruction that enabled it ended.  Ties
    break non-MIU-first (in unit-key order, so an equal-time commit
    that makes another MIU channel head ready joins that arbitration
    pool), then by admission order.  When a commit completes a program
    at ``T_c``, the gate caps at ``T_c``: a caller reacting to the
    completion (dispatching a new request at ``T_c``) sees a machine
    state in which nothing at-or-after ``T_c`` was granted yet.

    MIU wait attribution is simplified relative to ``_SimState``: a
    queued window [ready, start) charges the busy time of *other*
    programs' occupancy intervals overlapping it (idle gaps are not
    attributed).  The wfq deficit machinery matches ``_wfq_grant``.
    Channels stay in admission order internally (a channel head blocked
    on the ready list blocks its channel, as in ``_simulate_vc``).
    """

    def __init__(self, platform: DoraPlatform,
                 arbitration: str = "fifo",
                 channel_weights: dict[int, float] | None = None):
        if arbitration not in VC_ARBITRATIONS:
            raise ValueError(f"unknown vc arbitration {arbitration!r}; "
                             f"expected one of {VC_ARBITRATIONS}")
        self.platform = platform
        self.arbitration = arbitration
        self.channel_weights = dict(channel_weights or {})
        self.programs: list[_IncrProgram] = []
        # per-unit, per-program in-order streams: unit key -> pid ->
        # deque of local instruction indices (deleted when exhausted,
        # so the candidate scan only touches live programs)
        self._queues: dict[tuple[UnitKind, int],
                           dict[int, deque[int]]] = {}
        self._unit_order: list[tuple[UnitKind, int]] = []
        # MIU virtual channels (single physical MIU, as emitted by codegen)
        self._chan_q: dict[int, list[tuple[int, int]]] = {}
        self._chan_head: dict[int, int] = {}
        self._chan_list: list[int] = []
        self._deficit: dict[int, float] = {}
        self._rr_ptr = 0
        self._unit_free: dict[tuple[UnitKind, int], float] = {}
        self.unit_busy: dict[tuple[UnitKind, int], float] = {}
        # MIU occupancy history [(start, end, pid)] in service order
        self._occ: list[tuple[float, float, int]] = []
        # commit log [(pid, local idx, start, end)] in commit order
        self.log: list[tuple[int, int, float, float]] = []
        self._max_start = 0.0
        self._pending = 0            # uncommitted instructions

    # ------------------------------------------------------------- telemetry
    def set_channel_weights(self, weights: dict[int, float]) -> None:
        """Replace the wfq/priority channel weights.  Weights are read
        at every MIU grant (never cached), so a caller reacting to an
        ``advance`` gate — e.g. an adaptive share policy at a program
        completion — re-weights the arbitration deterministically from
        that simulated instant on; committed grants are untouched."""
        for c, w in weights.items():
            if w <= 0.0:
                raise ValueError(
                    f"channel {c} weight must be > 0, got {w}")
        self.channel_weights = dict(weights)

    def program_telemetry(self, pid: int) -> TenantTelemetry:
        """The accumulated wait/byte signals of one admitted program,
        as a :class:`TenantTelemetry` row (tenant = the program id as a
        string; callers re-key by their own tenant names)."""
        prog = self.programs[pid]
        return TenantTelemetry(
            tenant=str(pid), miu_wait_s=prog.miu_wait_s,
            served=int(prog.committed == prog.n),
            span_s=max(0.0, self._max_start - prog.release_s))

    # ------------------------------------------------------------- admission
    def add_program(self, result: CodegenResult, release_s: float,
                    channel: int = 0) -> int:
        """Admit a compiled program released at ``release_s``; returns
        its program id.  The release may not predate the commit
        frontier (that work is already committed and never rolled
        back)."""
        if release_s < 0.0:
            raise ValueError(f"release_s must be >= 0, got {release_s}")
        if release_s < self._max_start - 1e-12:
            raise ValueError(
                f"release_s={release_s:.6g} predates the commit frontier "
                f"{self._max_start:.6g}; committed work is never rolled "
                "back")
        pid = len(self.programs)
        prog = _IncrProgram(pid, result, release_s, channel)
        self.programs.append(prog)
        self._pending += prog.n
        for i, instr in enumerate(result.program.instructions):
            key = (instr.unit_kind, instr.unit_index)
            if instr.unit_kind == UnitKind.MIU:
                if channel not in self._chan_q:
                    self._chan_q[channel] = []
                    self._chan_head[channel] = 0
                    self._chan_list = sorted(self._chan_q)
                    self._deficit.setdefault(channel, 0.0)
                self._chan_q[channel].append((pid, i))
            else:
                if key not in self._queues:
                    self._queues[key] = {}
                    self._unit_order = sorted(
                        self._queues, key=lambda k: (k[0].value, k[1]))
                self._queues[key].setdefault(pid, deque()).append(i)
        return pid

    @property
    def has_pending(self) -> bool:
        return self._pending > 0

    @property
    def frontier_s(self) -> float:
        """Latest committed start time (the no-rollback boundary)."""
        return self._max_start

    # ------------------------------------------------------------ the engine
    def _ready(self, pid: int, li: int) -> float | None:
        """Earliest start of instruction ``li`` of program ``pid``
        ignoring unit occupancy, or None while a producer is
        uncommitted.  Mirrors ``_SimState.ready_time`` with the
        program's release time as the arrival floor."""
        p = self.programs[pid]
        meta = p.result.meta[li]
        t = p.release_s
        for d in meta.deps:
            e = p.end[d]
            if e < 0:
                return None
            if e > t:
                t = e
        instr = p.result.program.instructions[li]
        if instr.op_type == OpType.MIU_LOAD and instr.body.deps:
            for lid in instr.body.deps:
                rs = p.result.ready_store.get(lid)
                if rs is not None:
                    e = p.end[rs]
                    if e < 0:
                        return None
                    if e > t:
                        t = e
        return t

    def _miu_candidates(self) -> list[tuple[int, int, int, float, float]]:
        """Ready MIU channel heads as (channel, pid, li, service start,
        ready)."""
        key = (UnitKind.MIU, 0)
        free = self._unit_free.get(key, 0.0)
        cands = []
        for c in self._chan_list:
            h = self._chan_head[c]
            q = self._chan_q[c]
            if h >= len(q):
                continue
            pid, li = q[h]
            ready = self._ready(pid, li)
            if ready is None:
                continue
            cands.append((c, pid, li, max(free, ready), ready))
        return cands

    def _wfq_pick(self, pool: list[tuple[int, int, int, float, float]]
                  ) -> tuple[int, int, int, float]:
        """One contended DRR grant over the candidate pool — the same
        eligibility/top-up/rotation discipline as ``_wfq_grant``."""
        w = {c: self.channel_weights.get(c, 1.0)
             for (c, _, _, _, _) in pool}
        bytes_of = {}
        for (c, pid, li, _, _) in pool:
            bytes_of[c] = float(self.programs[pid].result.meta[li].bytes_moved)

        def _tol(c: int) -> float:
            return max(1e-9, 1e-12 * bytes_of[c])

        d = self._deficit
        eligible = {c for c in bytes_of if d[c] >= bytes_of[c] - _tol(c)}
        if not eligible:
            q = min((bytes_of[c] - d[c]) / w[c] for c in bytes_of)
            for c in bytes_of:
                d[c] = min(d[c] + q * w[c], bytes_of[c])
            eligible = {c for c in bytes_of
                        if d[c] >= bytes_of[c] - _tol(c)}
        clist = self._chan_list
        by_chan = {cd[0]: cd for cd in pool}
        for off in range(len(clist)):
            cc = clist[(self._rr_ptr + off) % len(clist)]
            if cc in eligible:
                c, pid, li, _, ready = by_chan[cc]
                self._rr_ptr = (clist.index(cc) + 1) % len(clist)
                d[c] = max(d[c] - bytes_of[c], 0.0)
                return c, pid, li, ready
        raise RuntimeError("wfq arbitration found no eligible channel")

    def _grant_miu(self) -> tuple[float, int, int, int, float, bool] | None:
        """The next MIU grant under the configured arbitration:
        (start, channel, pid, li, ready, contended) or None."""
        cands = self._miu_candidates()
        if not cands:
            return None
        t_star = min(cd[3] for cd in cands)
        pool = [cd for cd in cands if cd[3] == t_star]
        arb = self.arbitration
        if arb == "fifo":
            # lowest admission (pid, li) — the merged IDU fetch order
            c, pid, li, _, ready = min(pool, key=lambda cd: (cd[1], cd[2]))
        elif arb == "priority":
            c, pid, li, _, ready = max(
                pool, key=lambda cd: (self.channel_weights.get(cd[0], 1.0),
                                      -cd[1], -cd[2]))
        elif arb == "wfq" and len(pool) > 1:
            c, pid, li, ready = self._wfq_pick(pool)
        else:   # rr (and an uncontended wfq grant): rotation wins
            clist = self._chan_list
            by_chan = {cd[0]: cd for cd in pool}
            for off in range(len(clist)):
                cc = clist[(self._rr_ptr + off) % len(clist)]
                if cc in by_chan:
                    c, pid, li, _, ready = by_chan[cc]
                    self._rr_ptr = (clist.index(cc) + 1) % len(clist)
                    break
        return t_star, c, pid, li, ready, len(pool) > 1

    def _next_commit(self):
        """The globally minimal-start committable instruction:
        (start, miu?, key-or-channel, pid, li, ready, contended) or
        None.  Non-MIU units win start-time ties (unit-key order), so a
        tied commit that enables another MIU channel head reaches the
        arbitration pool before the MIU grants."""
        best = None
        for key in self._unit_order:
            streams = self._queues[key]
            if not streams:
                continue
            free = self._unit_free.get(key, 0.0)
            # dependence-driven pick among program heads: earliest
            # ready wins, ties by admission order (ascending pid)
            for pid in sorted(streams):
                li = streams[pid][0]
                ready = self._ready(pid, li)
                if ready is None:
                    continue
                start = max(free, ready)
                if best is None or start < best[0]:
                    best = (start, False, key, pid, li, ready, False)
        miu = self._grant_miu()
        if miu is not None:
            start, c, pid, li, ready, contended = miu
            if best is None or start < best[0]:
                best = (start, True, c, pid, li, ready, contended)
        return best

    def _foreign_busy(self, w0: float, w1: float, pid: int) -> float:
        """Busy time of other programs' MIU occupancy inside [w0, w1)."""
        total = 0.0
        for s, e, owner in reversed(self._occ):
            if e <= w0:
                break
            if owner != pid:
                total += max(0.0, min(e, w1) - max(s, w0))
        return total

    def advance(self, gate_s: float = float("inf")
                ) -> list[tuple[int, float]]:
        """Commit every instruction whose start lies strictly below the
        gate, in nondecreasing start order; returns the programs that
        completed as (pid, finish time).  A discovered completion at
        ``T_c`` caps the effective gate at ``T_c`` so the caller can
        react (dispatch at ``T_c``) before anything at-or-after ``T_c``
        is granted — call ``advance`` again to continue."""
        completed: list[tuple[int, float]] = []
        eff = gate_s
        while self._pending:
            cand = self._next_commit()
            if cand is None:
                blocked = [(p.pid, i) for p in self.programs if not p.done
                           for i in range(p.n) if p.end[i] < 0]
                raise RuntimeError(
                    f"incremental simulator deadlock: {len(blocked)} "
                    f"instructions blocked, first = {blocked[:5]}")
            start, is_miu, where, pid, li, ready, contended = cand
            if start >= eff:
                break
            p = self.programs[pid]
            instr = p.result.program.instructions[li]
            key = (instr.unit_kind, instr.unit_index)
            dur = _duration(li, p.result, self.platform)
            if li in p.startup_idx:
                dur += self.platform.startup_s
            end = start + dur
            if instr.op_type in _MIU_OPS:
                if start > ready:
                    p.miu_wait_s += self._foreign_busy(ready, start, pid)
                p.miu_bytes += float(p.result.meta[li].bytes_moved)
                self._occ.append((start, end, pid))
            p.start[li] = start
            p.end[li] = end
            p.committed += 1
            if end > p.finish_s:
                p.finish_s = end
            self._unit_free[key] = end
            self.unit_busy[key] = self.unit_busy.get(key, 0.0) + dur
            if is_miu:
                self._chan_head[where] += 1
            else:
                stream = self._queues[where][pid]
                stream.popleft()
                if not stream:
                    del self._queues[where][pid]
            self._pending -= 1
            if start > self._max_start:
                self._max_start = start
            self.log.append((pid, li, start, end))
            if p.done:
                completed.append((pid, p.finish_s))
                if p.finish_s < eff:
                    eff = p.finish_s
        return completed


def _tenant_stats(result: CodegenResult, end: list[float],
                  layer_ready: dict[int, float],
                  arrivals: dict[int, float],
                  miu_wait: dict[int, float],
                  miu_bytes: dict[int, float],
                  g_bytes: dict[int, float],
                  o_bytes: dict[int, float],
                  x_bytes: dict[int, float]) -> dict[int, TenantSimStats]:
    stats: dict[int, TenantSimStats] = {}
    instr_of: dict[int, list[int]] = {}
    for i, m in enumerate(result.meta):
        ti = m.tenant if m.tenant >= 0 else result.tenant_of.get(m.layer_id, -1)
        if ti >= 0:
            instr_of.setdefault(ti, []).append(i)
    for ti, idxs in sorted(instr_of.items()):
        arr = arrivals.get(ti, 0.0)
        finish = max(end[i] for i in idxs)
        done = sorted(layer_ready[lid] - arr
                      for lid, owner in result.tenant_of.items()
                      if owner == ti and lid in layer_ready)
        tail = nearest_rank(done, 0.95) if done else finish - arr
        stats[ti] = TenantSimStats(
            tenant=ti, arrival_s=arr, finish_s=finish,
            makespan_s=finish - arr, tail_latency_s=tail,
            miu_wait_s=miu_wait.get(ti, 0.0), n_instructions=len(idxs),
            miu_bytes=miu_bytes.get(ti, 0.0),
            guaranteed_bytes=g_bytes.get(ti, 0.0),
            opportunistic_bytes=o_bytes.get(ti, 0.0),
            expected_bytes=x_bytes.get(ti, 0.0))
    return stats
