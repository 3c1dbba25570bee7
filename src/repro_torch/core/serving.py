"""Online serving simulation: dynamic per-tenant request streams with
SLOs, layered on the static compiler/simulator stack.

Everything below the compiler schedules a *static*
``MultiTenantWorkload`` known at compile time.  Production traffic is a
stream of requests per tenant — each request an inference of that
tenant's model — arriving over time with a latency SLO attached.  This
module closes that gap with a deterministic event-loop simulator:

  arrivals   ``RequestStream`` draws each tenant's arrival trace up
             front: seeded Poisson (exponential inter-arrivals at
             ``TenantStream.rps``) or trace-driven (explicit
             ``TenantStream.trace`` timestamps).  The per-tenant RNG is
             seeded from ``(seed, tenant name)`` via crc32, so the same
             seed reproduces the same trace bit-for-bit, per tenant,
             regardless of which other tenants are configured.
  admission  Per-tenant FIFO queues, optionally bounded
             (``queue_capacity``).  An arrival that finds its queue
             full is handled by the ``admission`` policy: ``reject``
             drops the new request, ``shed-oldest`` drops the oldest
             *queued* request and admits the new one (both count as
             rejected; a dispatched request is never shed).
  dispatch   The machine serves *rounds*.  At each round start the
             dispatcher pops up to ``max_batch_per_tenant`` requests
             from every tenant's queue head (stream declaration order),
             builds the joint ``MultiTenantWorkload`` of those model
             instances (request k of tenant T becomes merged tenant
             ``T#k``), compiles it, and simulates it on the configured
             VC/QoS platform (``vc_count``/``vc_arbitration``, wfq fed
             the per-tenant ``bandwidth_shares`` split across the
             tenant's in-flight requests).  Batches repeat heavily in
             steady state, so compile+simulate results are cached on
             the batch *shape* (model multiset + knobs) — the stage-1
             memo already makes the cold compiles cheap, and cache hits
             make repeat rounds O(1).
  clock      A request dispatched at round start ``t`` finishes at
             ``t + finish_s`` of its merged-tenant slot in the round's
             simulation; the next round starts when the whole joint
             batch drains (``t + makespan_s``).  Arrivals during the
             round queue up (or are rejected) at their own timestamps.
             An idle machine fast-forwards to the next arrival.

Per-tenant ``ServingStats`` extends the ``TenantSimStats`` accounting
across rounds (``miu_wait_s``, ``miu_bytes`` accumulate over every
round the tenant appeared in) with serving-level metrics: p50/p95/p99
end-to-end latency (arrival -> finish, nearest-rank quantiles),
SLO-violation rate among served requests (``latency_s > slo_s``),
reject counts, and queue-depth high-water marks.

Conservation invariant (checked by tests/test_serving.py): per tenant,
``submitted == served + rejected + in_queue`` at the end of the run.
With ``drain=True`` (default) the loop serves every queued request
after the arrival horizon, so ``in_queue == 0``; with ``drain=False``
the machine stops at the first round boundary past ``horizon_s`` and
leftover requests stay queued.

A single-request stream degenerates exactly to the static path: one
round, one merged tenant, so its end-to-end latency equals the solo
``compile`` + ``simulate`` makespan of that model (bit-for-bit under
the default config).
"""

from __future__ import annotations

import zlib
from collections import deque
from dataclasses import dataclass, field
from heapq import heappop, heappush
from random import Random

from .compiler import ENGINES, CompileOptions, CompileResult, DoraCompiler
from .graph import WorkloadGraph
from .interleave import POLICIES as INTERLEAVE_POLICIES
from .multi_tenant import QOS_POLICIES, TENANT_SEP, MultiTenantWorkload
from .perf_model import LATENCY_MODELS, DoraPlatform, Policy
from .simulator import (IncrementalSimulator, SimReport, TenantTelemetry,
                        nearest_rank)

# admission-control policies for a full queue (docs-synced by
# tests/test_docs.py): "reject" drops the arriving request,
# "shed-oldest" drops the oldest queued request and admits the new one.
ADMISSION_POLICIES = ("reject", "shed-oldest")

# dispatch modes (docs-synced by tests/test_docs.py): "rounds" is the
# synchronous round loop (the original loop's behaviour, regression-
# locked bit for bit); "preemptive" is the instruction-level dynamic
# dispatcher — new arrivals join the machine mid-flight at instruction
# boundaries instead of waiting for a round barrier.
DISPATCH_MODES = ("rounds", "preemptive")

# merged-tenant separator: request k of tenant T joins a batch as "T#k"
SLOT_SEP = "#"


@dataclass(frozen=True)
class Request:
    """One arrival: ``seq``-th request of ``tenant`` at ``arrival_s``."""

    tenant: str
    seq: int
    arrival_s: float


@dataclass(frozen=True)
class TenantStream:
    """One tenant's traffic contract: the model it runs, its arrival
    process (exactly one of ``rps`` — Poisson rate in requests/s — or
    ``trace`` — explicit ascending arrival timestamps), its latency SLO
    and queueing limits.

    ``priority`` feeds the merged workload exactly like
    ``TenantSpec.priority`` (list-engine pick order, priority-
    proportional share fallback).  ``slo_s`` is the end-to-end latency
    target a served request is graded against (None = no SLO).
    ``queue_capacity`` overrides ``ServingConfig.queue_capacity`` for
    this tenant (None = use the config default)."""

    name: str
    graph: WorkloadGraph
    rps: float | None = None
    trace: tuple[float, ...] | None = None
    priority: float = 1.0
    slo_s: float | None = None
    queue_capacity: int | None = None

    def validate(self) -> None:
        if not self.name:
            raise ValueError("tenant stream needs a name")
        for sep in (TENANT_SEP, SLOT_SEP):
            if sep in self.name:
                raise ValueError(
                    f"tenant name {self.name!r} may not contain {sep!r} "
                    "(reserved for merged-workload namespacing)")
        if (self.rps is None) == (self.trace is None):
            raise ValueError(f"tenant {self.name!r}: exactly one of rps "
                             "(Poisson) or trace (explicit arrivals) "
                             "must be set")
        if self.rps is not None and self.rps <= 0:
            raise ValueError(f"tenant {self.name!r}: rps must be > 0")
        if self.trace is not None:
            if any(t < 0 for t in self.trace):
                raise ValueError(f"tenant {self.name!r}: trace arrivals "
                                 "must be >= 0")
            if list(self.trace) != sorted(self.trace):
                raise ValueError(f"tenant {self.name!r}: trace must be "
                                 "ascending")
        if self.priority <= 0:
            raise ValueError(f"tenant {self.name!r}: priority must be > 0")
        if self.slo_s is not None and self.slo_s <= 0:
            raise ValueError(f"tenant {self.name!r}: slo_s must be > 0")
        if self.queue_capacity is not None and self.queue_capacity < 1:
            raise ValueError(f"tenant {self.name!r}: queue_capacity "
                             "must be >= 1")


@dataclass
class RequestStream:
    """The merged, time-ordered arrival trace of every tenant.

    Poisson tenants draw exponential inter-arrival gaps from a
    ``Random(crc32(f"{seed}:{name}"))`` stream until ``horizon_s``;
    trace tenants contribute their explicit timestamps verbatim (the
    horizon only bounds generated arrivals).  Ties are broken by stream
    declaration order then sequence number, so the merged order — and
    therefore the whole serving run — is a pure function of
    (streams, seed, horizon)."""

    streams: list[TenantStream]
    horizon_s: float
    seed: int = 0

    def generate(self) -> list[Request]:
        order = {st.name: i for i, st in enumerate(self.streams)}
        requests: list[Request] = []
        for st in self.streams:
            st.validate()
            if st.trace is not None:
                times = list(st.trace)
            else:
                rng = Random(zlib.crc32(f"{self.seed}:{st.name}".encode()))
                times = []
                t = 0.0
                while True:
                    t += rng.expovariate(st.rps)
                    if t >= self.horizon_s:
                        break
                    times.append(t)
            requests.extend(Request(st.name, k, tt)
                            for k, tt in enumerate(times))
        requests.sort(key=lambda r: (r.arrival_s, order[r.tenant], r.seq))
        return requests


@dataclass
class ServingConfig:
    """The serving knob surface, following the ``CompileOptions`` /
    ``MultiTenantWorkload`` conventions: compile-side knobs (``engine``,
    ``qos``, ``interleave``, ``latency_model``, ``share_aware_stage1``,
    ``mmu_cap``) are forwarded verbatim — None defers exactly as it
    does there (``qos`` resolves to "wfq" iff ``bandwidth_shares`` are
    set) — while the serving-side knobs shape the event loop:

      ``horizon_s``             Poisson arrivals are generated in
                                [0, horizon); with ``drain=False`` the
                                machine also stops dispatching at the
                                first round boundary >= horizon.
      ``seed``                  arrival-trace RNG seed (bit-for-bit
                                reproducible runs).
      ``queue_capacity``        default per-tenant queue bound (None =
                                unbounded; ``TenantStream`` may
                                override per tenant).
      ``admission``             full-queue policy, one of
                                ``ADMISSION_POLICIES``.
      ``max_batch_per_tenant``  requests per tenant co-dispatched in
                                one round (its share splits across
                                them).
      ``vc_count``/``vc_arbitration``  the simulation platform's MIU
                                virtual-channel setup
                                (``DoraPlatform.with_vc``); wfq is what
                                makes ``bandwidth_shares`` defend tail
                                latency.
      ``bandwidth_shares``      tenant name -> guaranteed DRAM share
                                (sum <= 1), split evenly across the
                                tenant's in-flight requests each round.
      ``drain``                 serve every queued request after the
                                horizon (True) or stop at the horizon
                                and report leftovers as ``in_queue``.
      ``dispatch``              one of ``DISPATCH_MODES``: "rounds"
                                (synchronous round barriers, the
                                regression-locked default) or
                                "preemptive" (instruction-level
                                dynamic dispatch via
                                ``DynamicDispatcher``).  In preemptive
                                mode ``max_batch_per_tenant`` bounds a
                                tenant's *concurrent in-flight*
                                requests instead of its per-round
                                batch.
      ``policy``                optional online share policy (duck-
                                typed ``start(shares)`` /
                                ``observe(time_s, telemetry)``, e.g.
                                ``tuning.AdaptiveSharePolicy``).  When
                                set, the loop seeds it with the
                                resolved tenant shares, feeds it
                                per-tenant ``TenantTelemetry`` after
                                every round (rounds mode) or completion
                                (preemptive mode), and applies each
                                returned re-weight to the next
                                dispatch; every decision is logged
                                (``DispatchRound.shares``, "reweight"
                                ``DispatchEvent``s,
                                ``ServingResult.reweights``), so runs
                                stay pure seeded functions of their
                                inputs.
    """

    horizon_s: float = 1.0
    seed: int = 0
    queue_capacity: int | None = None
    admission: str = "reject"
    max_batch_per_tenant: int = 1
    drain: bool = True
    dispatch: str = "rounds"
    vc_count: int = 1
    vc_arbitration: str = "fifo"
    bandwidth_shares: dict[str, float] | None = None
    engine: str = "list"
    qos: str | None = None
    interleave: str | None = None
    latency_model: str | None = None
    share_aware_stage1: bool | None = None
    mmu_cap: int | None = None
    policy: object | None = None

    def __post_init__(self) -> None:
        if self.horizon_s <= 0:
            raise ValueError(f"horizon_s must be > 0, got {self.horizon_s}")
        if self.admission not in ADMISSION_POLICIES:
            raise ValueError(f"unknown admission policy {self.admission!r}; "
                             f"expected one of {ADMISSION_POLICIES}")
        if self.dispatch not in DISPATCH_MODES:
            raise ValueError(f"unknown dispatch mode {self.dispatch!r}; "
                             f"expected one of {DISPATCH_MODES}")
        if self.queue_capacity is not None and self.queue_capacity < 1:
            raise ValueError("queue_capacity must be >= 1, got "
                             f"{self.queue_capacity}")
        if self.max_batch_per_tenant < 1:
            raise ValueError("max_batch_per_tenant must be >= 1, got "
                             f"{self.max_batch_per_tenant}")
        if self.engine not in ENGINES:
            raise ValueError(f"unknown engine {self.engine!r}; "
                             f"expected one of {ENGINES}")
        if self.qos is not None and self.qos not in QOS_POLICIES:
            raise ValueError(f"unknown qos policy {self.qos!r}; "
                             f"expected one of {QOS_POLICIES}")
        if (self.interleave is not None
                and self.interleave not in INTERLEAVE_POLICIES):
            raise ValueError(f"unknown interleave policy "
                             f"{self.interleave!r}; expected one of "
                             f"{INTERLEAVE_POLICIES}")
        if (self.latency_model is not None
                and self.latency_model not in LATENCY_MODELS):
            raise ValueError(f"unknown latency_model "
                             f"{self.latency_model!r}; expected one of "
                             f"{LATENCY_MODELS}")
        if self.policy is not None and not (
                callable(getattr(self.policy, "start", None))
                and callable(getattr(self.policy, "observe", None))):
            raise ValueError(
                "policy must expose start(shares) and observe(time_s, "
                f"telemetry) — got {type(self.policy).__name__}")
        # vc_count / vc_arbitration are validated by DoraPlatform.with_vc
        # at serve time (the platform owns those invariants)


@dataclass
class RequestRecord:
    """Lifecycle of one request through the event loop."""

    tenant: str
    seq: int
    arrival_s: float
    status: str = "queued"        # queued | served | rejected
    dispatch_s: float = -1.0      # round start that served it
    finish_s: float = -1.0        # absolute completion time

    @property
    def latency_s(self) -> float:
        """End-to-end latency (queue wait + service); -1 until served."""
        if self.status != "served":
            return -1.0
        return self.finish_s - self.arrival_s


@dataclass(frozen=True)
class DispatchRound:
    """One batch the machine served: start time, joint makespan, the
    (tenant, seq) requests in merged-slot order, and whether the
    compile+simulate came from the batch-shape cache.

    ``shares`` records the effective per-tenant bandwidth-share vector
    the round dispatched under — None for static runs; under an
    adaptive ``ServingConfig.policy`` it is the policy's current
    vector, so the re-weight trajectory is replayable from the round
    log alone."""

    start_s: float
    makespan_s: float
    requests: tuple[tuple[str, int], ...]
    cache_hit: bool
    shares: tuple[tuple[str, float], ...] | None = None


@dataclass
class ServingStats:
    """Per-tenant serving report: conservation counters, end-to-end
    latency quantiles, SLO grading, and the ``TenantSimStats``
    accounting accumulated across every round the tenant appeared in."""

    tenant: str
    slo_s: float | None = None
    queue_capacity: int | None = None
    submitted: int = 0
    served: int = 0
    rejected: int = 0
    in_queue: int = 0
    max_queue_depth: int = 0
    latencies_s: list[float] = field(default_factory=list)
    # TenantSimStats accounting, summed over rounds:
    miu_wait_s: float = 0.0
    miu_bytes: float = 0.0
    busy_s: float = 0.0           # sum of per-round service makespans

    def _q(self, q: float) -> float | None:
        """Nearest-rank latency quantile; ``None`` when the tenant
        served zero requests (no data is not a 0.0-latency tail)."""
        return nearest_rank(sorted(self.latencies_s), q)

    @property
    def p50_s(self) -> float | None:
        return self._q(0.50)

    @property
    def p95_s(self) -> float | None:
        return self._q(0.95)

    @property
    def p99_s(self) -> float | None:
        return self._q(0.99)

    @property
    def mean_latency_s(self) -> float:
        if not self.latencies_s:
            return 0.0
        return sum(self.latencies_s) / len(self.latencies_s)

    @property
    def slo_violations(self) -> int:
        """Served requests whose end-to-end latency exceeded the SLO
        (rejected requests are reported separately, not graded)."""
        if self.slo_s is None:
            return 0
        return sum(1 for lt in self.latencies_s if lt > self.slo_s)

    @property
    def slo_violation_rate(self) -> float:
        if not self.served:
            return 0.0
        return self.slo_violations / self.served

    @property
    def reject_rate(self) -> float:
        if not self.submitted:
            return 0.0
        return self.rejected / self.submitted


@dataclass(frozen=True)
class DispatchEvent:
    """One state transition of the preemptive dispatcher, with a
    snapshot of the request state machine *after* the transition.

    ``kind`` is one of ``arrive`` (admitted to its tenant queue),
    ``reject`` (dropped — the newcomer under "reject", the shed queue
    head under "shed-oldest"), ``dispatch`` (popped from its queue,
    compiled program admitted to the incremental simulator),
    ``complete`` (every instruction committed; request served), or
    ``reweight`` (the adaptive ``ServingConfig.policy`` accepted a new
    share vector — recorded in ``shares``; the (tenant, seq) names the
    completion that triggered it, and the request partition state is
    unchanged).

    ``queued``/``inflight`` list (tenant, seq) pairs in queue/admission
    order; ``executed``/``rejected`` are running counts.  At every
    event, admitted = queued + inflight + executed — the partition
    invariant the property suite checks.  The instruction-level "ready"
    set is transient (the simulator drains ready instructions up to the
    event time before the event is processed), so it never appears in
    a snapshot."""

    time_s: float
    kind: str
    tenant: str
    seq: int
    queued: tuple[tuple[str, int], ...]
    inflight: tuple[tuple[str, int], ...]
    executed: int
    rejected: int
    shares: tuple[tuple[str, float], ...] | None = None


@dataclass
class ServingResult:
    """One serving run: per-tenant stats, the full request log, the
    dispatch rounds, and the batch-cache hit counters.

    Under ``dispatch="preemptive"`` the result additionally carries the
    dispatcher's event log (``events``) and the ``DynamicDispatcher``
    itself (``dispatcher`` — its ``sim.log`` holds the per-instruction
    commit trace for the property suite); ``rounds`` then holds one
    single-request entry per served request in completion order, with
    ``makespan_s`` the request's service time."""

    stats: dict[str, ServingStats]
    requests: list[RequestRecord]
    rounds: list[DispatchRound]
    arrivals: list[Request]
    end_s: float                  # time the machine went idle / stopped
    compile_cache_hits: int = 0
    compile_cache_misses: int = 0
    dispatch: str = "rounds"
    events: list[DispatchEvent] = field(default_factory=list)
    dispatcher: "DynamicDispatcher | None" = None
    # accepted adaptive-policy re-weights (ShareDecision objects from
    # core/tuning.py), in decision order; empty for static runs
    reweights: list = field(default_factory=list)

    @property
    def total_served(self) -> int:
        return sum(s.served for s in self.stats.values())

    @property
    def total_rejected(self) -> int:
        return sum(s.rejected for s in self.stats.values())


class ServingSimulator:
    """The event loop.  One instance may run many ``serve()`` sweeps —
    the batch-shape compile+simulate cache persists across calls (keys
    include every knob that affects the compiled round), which is what
    makes an rps sweep over the same scenario nearly free after the
    first point."""

    def __init__(self, platform: DoraPlatform | None = None,
                 policy: Policy | None = None):
        self.platform = platform or DoraPlatform.vck190()
        self.policy = policy or Policy.dora()
        self._compiler = DoraCompiler(self.platform, self.policy)
        self._cache: dict[tuple, tuple[CompileResult, SimReport]] = {}
        self._solo_cache: dict[tuple, CompileResult] = {}
        self.cache_hits = 0
        self.cache_misses = 0

    # ------------------------------------------------------------- dispatch
    def _round_key(self, batch: list[tuple[TenantStream, int]],
                   config: ServingConfig,
                   shares: dict[str, float] | None) -> tuple:
        share_key = tuple(sorted(shares.items())) if shares else None
        return (tuple((st.name, n) for st, n in batch),
                config.engine, config.qos, config.interleave,
                config.latency_model, config.share_aware_stage1,
                config.mmu_cap, config.max_batch_per_tenant, share_key,
                config.vc_count, config.vc_arbitration)

    def _serve_batch(self, batch: list[tuple[TenantStream, int]],
                     config: ServingConfig,
                     shares: dict[str, float] | None
                     ) -> tuple[CompileResult, SimReport, bool]:
        """Compile + simulate one dispatch round.  Request k of tenant T
        becomes merged tenant ``T#k`` (all released at round start, so
        the compiled schedule and its simulation are reusable verbatim
        whenever the same batch shape recurs).  ``shares`` is the
        round's *effective* tenant share vector —
        ``config.bandwidth_shares`` for a static run, the adaptive
        policy's current vector otherwise — and is part of the cache
        key, so an adaptive run only pays a fresh compile per distinct
        (batch shape, share vector) pair (the policy's quantum grid
        keeps that set finite)."""
        key = self._round_key(batch, config, shares)
        hit = key in self._cache
        if hit:
            self.cache_hits += 1
            res, rep = self._cache[key]
            return res, rep, True
        self.cache_misses += 1
        mt = MultiTenantWorkload(
            "serving_batch", mmu_cap=config.mmu_cap,
            interleave=config.interleave or "none")
        slot_shares: dict[str, float] = {}
        for st, n in batch:
            for k in range(n):
                slot = f"{st.name}{SLOT_SEP}{k}"
                mt.add_tenant(slot, st.graph, priority=st.priority)
                if shares and st.name in shares:
                    # the tenant's guarantee splits across its in-flight
                    # requests: k concurrent instances each defend 1/k
                    slot_shares[slot] = shares[st.name] / n
        if slot_shares:
            mt.bandwidth_shares = slot_shares
        res = self._compiler.compile(mt, CompileOptions(
            engine=config.engine, qos=config.qos,
            latency_model=config.latency_model,
            share_aware_stage1=config.share_aware_stage1))
        plat = self.platform.with_vc(config.vc_count, config.vc_arbitration)
        rep = self._compiler.simulate(res, platform=plat)
        self._cache[key] = (res, rep)
        return res, rep, False

    def _compile_solo(self, st: TenantStream, config: ServingConfig
                      ) -> tuple[CompileResult, bool]:
        """Compile one tenant's model as a single-tenant workload — the
        unit of work the preemptive dispatcher admits per request.

        Unlike a round compile, the tenant's explicit bandwidth share
        (when set) prices the *whole* guarantee: the incremental
        simulator arbitrates the tenant's concurrent requests on one
        virtual channel, so the per-request split the round path does
        (share/n) happens at simulation time, not compile time.  Keyed
        in ``_solo_cache`` by every knob that affects the compiled
        program; the cache persists across ``serve()`` calls exactly
        like the batch-shape cache."""
        share = (config.bandwidth_shares.get(st.name)
                 if config.bandwidth_shares else None)
        key = (st.name, config.engine, config.qos, config.interleave,
               config.latency_model, config.share_aware_stage1,
               config.mmu_cap, share)
        if key in self._solo_cache:
            self.cache_hits += 1
            return self._solo_cache[key], True
        self.cache_misses += 1
        mt = MultiTenantWorkload(
            "serving_solo", mmu_cap=config.mmu_cap,
            interleave=config.interleave or "none")
        mt.add_tenant(st.name, st.graph, priority=st.priority)
        if share is not None:
            mt.bandwidth_shares = {st.name: share}
        res = self._compiler.compile(mt, CompileOptions(
            engine=config.engine, qos=config.qos,
            latency_model=config.latency_model,
            share_aware_stage1=config.share_aware_stage1))
        self._solo_cache[key] = res
        return res, False

    # --------------------------------------------------------- validation
    @staticmethod
    def _validate_serve(streams: list[TenantStream],
                        config: ServingConfig) -> list[str]:
        """Shared up-front validation of both dispatch paths; returns
        the tenant name list."""
        if not streams:
            raise ValueError("serve() needs at least one TenantStream")
        names = [st.name for st in streams]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant stream names in {names}")
        for st in streams:
            st.validate()
        if config.bandwidth_shares:
            unknown = set(config.bandwidth_shares) - set(names)
            if unknown:
                raise ValueError(f"bandwidth_shares name unknown tenants "
                                 f"{sorted(unknown)}")
            for n, s in config.bandwidth_shares.items():
                if s <= 0:
                    raise ValueError(f"tenant {n!r} bandwidth share must "
                                     f"be > 0, got {s}")
            if sum(config.bandwidth_shares.values()) > 1.0 + 1e-9:
                raise ValueError("bandwidth shares sum to "
                                 f"{sum(config.bandwidth_shares.values()):.6g}"
                                 " > 1")
        return names

    # ------------------------------------------------------------ the loop
    def serve(self, streams: list[TenantStream],
              config: ServingConfig | None = None) -> ServingResult:
        config = config or ServingConfig()
        names = self._validate_serve(streams, config)
        # validate the simulation platform knobs up front (fail fast)
        self.platform.with_vc(config.vc_count, config.vc_arbitration)
        if config.dispatch == "preemptive":
            return DynamicDispatcher(self, list(streams), config).run()

        arrivals = RequestStream(list(streams), config.horizon_s,
                                 config.seed).generate()
        stats = {st.name: ServingStats(
            tenant=st.name, slo_s=st.slo_s,
            queue_capacity=(st.queue_capacity
                            if st.queue_capacity is not None
                            else config.queue_capacity))
            for st in streams}
        queues: dict[str, deque[RequestRecord]] = {n: deque() for n in names}
        records: list[RequestRecord] = []
        rounds: list[DispatchRound] = []
        hits0, misses0 = self.cache_hits, self.cache_misses
        pol = config.policy
        reweights: list = []
        # the effective share vector rounds dispatch under: the static
        # config shares, or (with a policy) the policy's live vector
        # seeded from the resolved tenant shares
        if pol is not None:
            cur_shares: dict[str, float] | None = pol.start(
                _resolve_stream_shares(streams, config))
        else:
            cur_shares = config.bandwidth_shares

        def admit(req: Request) -> None:
            s = stats[req.tenant]
            q = queues[req.tenant]
            rec = RequestRecord(req.tenant, req.seq, req.arrival_s)
            records.append(rec)
            s.submitted += 1
            if s.queue_capacity is not None and len(q) >= s.queue_capacity:
                if config.admission == "reject":
                    rec.status = "rejected"
                    s.rejected += 1
                    return
                # shed-oldest: the stale head of the queue makes room
                old = q.popleft()
                old.status = "rejected"
                s.rejected += 1
            q.append(rec)
            s.max_queue_depth = max(s.max_queue_depth, len(q))

        t = 0.0
        ai = 0
        n_arrivals = len(arrivals)
        while True:
            while ai < n_arrivals and arrivals[ai].arrival_s <= t:
                admit(arrivals[ai])
                ai += 1
            if not config.drain and t >= config.horizon_s:
                break
            if all(not q for q in queues.values()):
                if ai >= n_arrivals:
                    break
                # idle machine: fast-forward to the next arrival
                t = arrivals[ai].arrival_s
                continue
            batch = [(st, min(len(queues[st.name]),
                              config.max_batch_per_tenant))
                     for st in streams if queues[st.name]]
            res, rep, hit = self._serve_batch(batch, config, cur_shares)
            served: list[tuple[str, int]] = []
            slot = 0
            for st, n in batch:
                s = stats[st.name]
                for _ in range(n):
                    rec = queues[st.name].popleft()
                    tstat = rep.tenant_stats[slot]
                    rec.status = "served"
                    rec.dispatch_s = t
                    rec.finish_s = t + tstat.finish_s
                    s.served += 1
                    s.latencies_s.append(rec.finish_s - rec.arrival_s)
                    s.miu_wait_s += tstat.miu_wait_s
                    s.miu_bytes += tstat.miu_bytes
                    served.append((rec.tenant, rec.seq))
                    slot += 1
                s.busy_s += rep.makespan_s
            rounds.append(DispatchRound(
                t, rep.makespan_s, tuple(served), hit,
                shares=(tuple((st.name, cur_shares[st.name])
                              for st in streams)
                        if pol is not None else None)))
            t += rep.makespan_s
            if pol is not None:
                # feed the policy this round's telemetry at the round
                # boundary; arrivals during the round are admitted
                # first so queue depths reflect the live backlog (the
                # loop top would admit the same requests identically)
                while ai < n_arrivals and arrivals[ai].arrival_s <= t:
                    admit(arrivals[ai])
                    ai += 1
                agg = {st.name: [0.0, 0.0, 0.0, 0] for st in streams}
                slot = 0
                for st, n in batch:
                    for _ in range(n):
                        tstat = rep.tenant_stats[slot]
                        row = agg[st.name]
                        row[0] += tstat.miu_wait_s
                        row[1] += tstat.miu_bytes
                        row[2] += tstat.expected_bytes
                        row[3] += 1
                        slot += 1
                dec = pol.observe(t, [TenantTelemetry(
                    tenant=st.name,
                    queue_depth=len(queues[st.name]),
                    miu_wait_s=agg[st.name][0],
                    satisfaction=(agg[st.name][1] / agg[st.name][2]
                                  if agg[st.name][2] > 0 else 1.0),
                    served=agg[st.name][3],
                    span_s=rep.makespan_s,
                    slo_s=st.slo_s) for st in streams])
                if dec is not None:
                    reweights.append(dec)
                    cur_shares = dict(dec.shares)
        # wind-down: arrivals after the stop point still pass admission
        # (the queue no longer drains), keeping the conservation
        # invariant exact for drain=False runs
        while ai < n_arrivals:
            admit(arrivals[ai])
            ai += 1
        for name_, q in queues.items():
            stats[name_].in_queue = len(q)
        return ServingResult(
            stats=stats, requests=records, rounds=rounds,
            arrivals=arrivals, end_s=t,
            compile_cache_hits=self.cache_hits - hits0,
            compile_cache_misses=self.cache_misses - misses0,
            reweights=reweights)


def _resolve_stream_shares(streams: list[TenantStream],
                           config: ServingConfig) -> dict[str, float]:
    """Tenant name -> resolved DRAM share, mirroring
    ``MultiTenantWorkload.resolve_bandwidth_shares``: explicit
    ``config.bandwidth_shares`` win, unlisted tenants split the
    leftover headroom priority-proportionally; without explicit shares
    every tenant's share is its priority over the priority sum.  The
    preemptive dispatcher pools these into per-virtual-channel wfq
    weights."""
    if not config.bandwidth_shares:
        psum = sum(st.priority for st in streams)
        return {st.name: st.priority / psum for st in streams}
    shares = {st.name: config.bandwidth_shares.get(st.name, 0.0)
              for st in streams}
    missing = [st for st in streams if shares[st.name] <= 0.0]
    if missing:
        rest = 1.0 - sum(config.bandwidth_shares.values())
        if rest <= 1e-12:
            raise ValueError(
                f"tenants {[st.name for st in missing]} have no bandwidth "
                "share and the explicit shares leave no headroom")
        psum = sum(st.priority for st in missing)
        for st in missing:
            shares[st.name] = rest * st.priority / psum
    return shares


class DynamicDispatcher:
    """Instruction-level preemptive dispatch: the ready/inflight/
    executed state machine over per-request compiled programs.

    Where the round loop serves synchronized joint batches (a short
    request waits for the whole round makespan), this dispatcher admits
    each request's solo-compiled program to an
    :class:`~.simulator.IncrementalSimulator` the moment a per-tenant
    in-flight slot is free, and advances simulated time *event by
    event*: the machine state between two events is exactly the set of
    committed instructions, so a newly admitted program joins the
    in-flight frontier at an instruction boundary — committed work is
    never rolled back, and nothing that starts at-or-after the event
    time has been granted when the event is processed.

    Request state machine (every transition logged as a
    :class:`DispatchEvent`):

        arrival --admit--> queued --dispatch--> inflight
                |                                   |
                +--reject / shed-oldest             +--all instructions
                                                       committed
                                                       --> executed

    Tenant ``i`` (stream declaration order) rides MIU virtual channel
    ``i % vc_count``; each channel's wfq weight pools its tenants'
    resolved shares (``_resolve_stream_shares``), so bandwidth
    guarantees keep defending tail latency across *requests*, not
    rounds.  ``max_batch_per_tenant`` bounds a tenant's concurrent
    in-flight requests.  With ``drain=False`` dispatch freezes at the
    first event at-or-after the horizon (in-flight programs still
    drain; admission continues so conservation stays exact).

    The whole run is a pure function of (streams, config, platform,
    policy): arrivals come from the same seeded ``RequestStream``,
    every tie in the simulator breaks deterministically, and the event
    loop holds no hidden state — same seed, bit-identical result."""

    def __init__(self, owner: ServingSimulator,
                 streams: list[TenantStream], config: ServingConfig):
        self.owner = owner
        self.streams = streams
        self.config = config
        self.by_name = {st.name: st for st in streams}
        vc = max(config.vc_count, 1)
        self.chan_of = {st.name: i % vc for i, st in enumerate(streams)}
        self.policy = config.policy
        shares = _resolve_stream_shares(streams, config)
        if self.policy is not None:
            shares = self.policy.start(shares)
        self.shares = shares
        self.sim = IncrementalSimulator(
            owner.platform, arbitration=config.vc_arbitration,
            channel_weights=self._pool_weights(shares))
        self.events: list[DispatchEvent] = []
        self.reweights: list = []

    def _pool_weights(self, shares: dict[str, float]) -> dict[int, float]:
        """Per-virtual-channel wfq weights: each channel pools the
        resolved shares of the tenants riding it."""
        weights: dict[int, float] = {}
        for st in self.streams:
            c = self.chan_of[st.name]
            weights[c] = weights.get(c, 0.0) + shares[st.name]
        return weights

    # ------------------------------------------------------------- snapshots
    def _snap(self, t: float, kind: str, tenant: str, seq: int,
              shares: tuple[tuple[str, float], ...] | None = None) -> None:
        queued = tuple((r.tenant, r.seq) for st in self.streams
                       for r in self._queues[st.name])
        inflight = tuple((r.tenant, r.seq)
                         for _, r in sorted(self._inflight.items()))
        self.events.append(DispatchEvent(
            t, kind, tenant, seq, queued, inflight,
            self._executed, self._rejected, shares))

    # ------------------------------------------------------------- the loop
    def run(self) -> ServingResult:
        config, streams = self.config, self.streams
        stats = {st.name: ServingStats(
            tenant=st.name, slo_s=st.slo_s,
            queue_capacity=(st.queue_capacity
                            if st.queue_capacity is not None
                            else config.queue_capacity))
            for st in streams}
        arrivals = RequestStream(list(streams), config.horizon_s,
                                 config.seed).generate()
        self._queues: dict[str, deque[RequestRecord]] = {
            st.name: deque() for st in streams}
        self._inflight: dict[int, RequestRecord] = {}   # pid -> record
        self._executed = 0
        self._rejected = 0
        queues = self._queues
        records: list[RequestRecord] = []
        rounds: list[DispatchRound] = []
        hit_of: dict[int, bool] = {}
        n_inflight = {st.name: 0 for st in streams}
        hits0, misses0 = self.owner.cache_hits, self.owner.cache_misses
        sim = self.sim
        heap: list[tuple[float, int]] = []
        frozen = False
        inf = float("inf")
        ai, n_arr = 0, len(arrivals)
        t_end = 0.0
        pol = self.policy
        # per-tenant MIU-wait snapshots: the policy sees the *window*
        # since its last observation, not the cumulative total
        last_obs_t = 0.0
        wait0 = {st.name: 0.0 for st in streams}

        def admit(req: Request, t: float) -> None:
            s = stats[req.tenant]
            q = queues[req.tenant]
            rec = RequestRecord(req.tenant, req.seq, req.arrival_s)
            records.append(rec)
            s.submitted += 1
            if s.queue_capacity is not None and len(q) >= s.queue_capacity:
                if config.admission == "reject":
                    rec.status = "rejected"
                    s.rejected += 1
                    self._rejected += 1
                    self._snap(t, "reject", rec.tenant, rec.seq)
                    return
                old = q.popleft()
                old.status = "rejected"
                s.rejected += 1
                self._rejected += 1
                self._snap(t, "reject", old.tenant, old.seq)
            q.append(rec)
            s.max_queue_depth = max(s.max_queue_depth, len(q))
            self._snap(t, "arrive", rec.tenant, rec.seq)

        def try_dispatch(name: str, t: float) -> None:
            if frozen:
                return
            q = queues[name]
            st = self.by_name[name]
            while q and n_inflight[name] < config.max_batch_per_tenant:
                rec = q.popleft()
                res, hit = self.owner._compile_solo(st, config)
                pid = sim.add_program(res.codegen, release_s=t,
                                      channel=self.chan_of[name])
                rec.dispatch_s = t
                self._inflight[pid] = rec
                hit_of[pid] = hit
                n_inflight[name] += 1
                self._snap(t, "dispatch", rec.tenant, rec.seq)

        while True:
            next_arr = arrivals[ai].arrival_s if ai < n_arr else inf
            next_comp = heap[0][0] if heap else inf
            if sim.has_pending:
                for pid, fin in sim.advance(min(next_arr, next_comp)):
                    heappush(heap, (fin, pid))
                next_comp = heap[0][0] if heap else inf
            t = min(next_arr, next_comp)
            if t == inf:
                if sim.has_pending or self._inflight:
                    raise RuntimeError(
                        "preemptive dispatcher stalled with in-flight work "
                        "and no next event")
                if not frozen and any(q for q in queues.values()):
                    raise RuntimeError(
                        "preemptive dispatcher stalled with queued requests "
                        "and free dispatch slots")
                break
            if not config.drain and not frozen and t >= config.horizon_s:
                # dispatch freeze: in-flight work drains (committed work
                # is never rolled back), admissions continue, no new
                # program joins the machine
                frozen = True
            t_end = max(t_end, t)
            if next_comp <= next_arr:
                fin, pid = heappop(heap)
                rec = self._inflight.pop(pid)
                prog = sim.programs[pid]
                s = stats[rec.tenant]
                rec.status = "served"
                rec.finish_s = fin
                s.served += 1
                s.latencies_s.append(fin - rec.arrival_s)
                s.miu_wait_s += prog.miu_wait_s
                s.miu_bytes += prog.miu_bytes
                s.busy_s += fin - rec.dispatch_s
                n_inflight[rec.tenant] -= 1
                self._executed += 1
                rounds.append(DispatchRound(
                    rec.dispatch_s, fin - rec.dispatch_s,
                    ((rec.tenant, rec.seq),), hit_of[pid]))
                self._snap(fin, "complete", rec.tenant, rec.seq)
                if pol is not None:
                    # completion events are the preemptive analogue of
                    # round boundaries: observe, then re-weight the
                    # channel arbitration before the next dispatch —
                    # weights are read at each MIU grant, so the change
                    # takes effect deterministically from ``fin`` on
                    dec = pol.observe(fin, [TenantTelemetry(
                        tenant=st.name,
                        queue_depth=len(queues[st.name]),
                        miu_wait_s=(stats[st.name].miu_wait_s
                                    - wait0[st.name]),
                        served=stats[st.name].served,
                        span_s=max(fin - last_obs_t, 0.0),
                        slo_s=st.slo_s)
                        for st in streams])
                    last_obs_t = fin
                    for st in streams:
                        wait0[st.name] = stats[st.name].miu_wait_s
                    if dec is not None:
                        self.reweights.append(dec)
                        sim.set_channel_weights(
                            self._pool_weights(dict(dec.shares)))
                        self._snap(fin, "reweight", rec.tenant, rec.seq,
                                   shares=dec.shares)
                try_dispatch(rec.tenant, fin)
            else:
                admit(arrivals[ai], next_arr)
                ai += 1
                tenant = records[-1].tenant
                try_dispatch(tenant, next_arr)
        for name, q in queues.items():
            stats[name].in_queue = len(q)
        return ServingResult(
            stats=stats, requests=records, rounds=rounds,
            arrivals=arrivals, end_s=t_end,
            compile_cache_hits=self.owner.cache_hits - hits0,
            compile_cache_misses=self.owner.cache_misses - misses0,
            dispatch="preemptive", events=self.events, dispatcher=self,
            reweights=self.reweights)


def serve(streams: list[TenantStream],
          config: ServingConfig | None = None,
          platform: DoraPlatform | None = None,
          policy: Policy | None = None) -> ServingResult:
    """One-shot convenience wrapper around ``ServingSimulator.serve``."""
    return ServingSimulator(platform, policy).serve(streams, config)
