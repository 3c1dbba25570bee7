"""Close the telemetry loop: offline knob auto-tuning and an online
adaptive bandwidth-share policy.

DORA's two-stage DSE searches a *schedule* per workload, but the knob
surface above the compiler (engine, vc_count, vc_arbitration, qos
shares, interleave, share_aware_stage1, latency_model, dispatch) has
outgrown hand selection — and the serving loop never reacted to what
the simulator measures.  This module adds both missing loops:

  offline   ``KnobSpace`` is the validated enumeration of the knob
            vector; ``autotune`` searches it against the existing
            compiler+simulator stack — coordinate descent over one
            knob axis at a time, seeded random restarts when a full
            cycle stops improving — and returns a ``TuneResult`` with
            the best config and the full per-trial trace.  Every
            evaluation is memoized on the knob vector, and the heavy
            lifting below is already cached (the process-level stage-1
            candidate memo, the serving batch-shape cache), so a
            25-trial budget costs far less than 25 cold compiles.
  online    ``AdaptiveSharePolicy`` is the expert-rule tier: between
            dispatch rounds (or at preemptive completion events) it
            re-weights ``bandwidth_shares`` from observed per-tenant
            telemetry (``miu_wait_s``, ``guaranteed_share_satisfaction``,
            queue depth), with hysteresis and min/max clamps so every
            emitted share vector provably satisfies the
            ``resolve_bandwidth_shares`` validity rules (each share
            > 0, sum <= the initial total <= 1).  ``core/serving.py``
            threads it through ``ServingConfig.policy`` and logs every
            re-weight decision, so runs stay pure seeded functions of
            their inputs.

Objectives (``TUNE_OBJECTIVES``): ``makespan`` scores a static
``MultiTenantWorkload`` by simulated joint makespan; ``p99`` and
``slo_violations`` score a list of ``TenantStream``s by worst-tenant
p99 latency / overall SLO-violation rate from ``ServingStats``
(``objective_tenant`` narrows either to one tenant).

Adaptive-policy invariants (checked by tests/test_tuning.py):

  clamps      every share stays in ``[min_share, max_share]`` and on
              the ``quantum`` grid; the share total is conserved
              exactly, so validity never erodes over a run.
  hysteresis  a proposed move smaller than ``deadband`` (total-share
              fraction) is dropped, and each accepted move is capped
              at ``step`` per tenant — on a constant workload the
              smoothed pressure converges, the proposed move falls
              under the deadband, and the shares freeze (no
              oscillation).
"""

from __future__ import annotations

import math
import zlib
from dataclasses import dataclass, field, fields, replace
from random import Random

from .compiler import ENGINES, CompileOptions, DoraCompiler
from .interleave import POLICIES as INTERLEAVE_POLICIES
from .multi_tenant import MultiTenantWorkload
from .perf_model import LATENCY_MODELS, VC_ARBITRATIONS, DoraPlatform, Policy
from .serving import (DISPATCH_MODES, ServingConfig, ServingResult,
                      ServingSimulator, TenantStream)
from .simulator import TenantTelemetry

# scalar objectives autotune can minimize (docs-synced by
# tests/test_docs.py): "makespan" needs a static MultiTenantWorkload,
# "p99" / "slo_violations" need TenantStreams (a serving run).
TUNE_OBJECTIVES = ("makespan", "p99", "slo_violations")


# --------------------------------------------------------------- knob space
@dataclass(frozen=True)
class KnobSpace:
    """The searchable knob vector: one axis per knob, each axis the
    tuple of values ``autotune`` may try.  Defaults cover the cheap,
    always-legal subset (the exact engines are opt-in: MILP/GA cost
    seconds per cold compile, the list engine milliseconds).

    ``share_split`` is the qos-shares axis: each entry is either None
    (priority-proportional fallback) or a tuple of per-tenant shares in
    stream/tenant declaration order (each > 0, sum <= 1).  Splits whose
    length does not match the target's tenant count fail validation at
    ``autotune`` time."""

    engine: tuple[str, ...] = ("list",)
    vc_count: tuple[int, ...] = (1, 2, 4)
    vc_arbitration: tuple[str, ...] = ("fifo", "rr", "wfq")
    share_split: tuple[tuple[float, ...] | None, ...] = (None,)
    interleave: tuple[str, ...] = ("none", "rr", "priority")
    share_aware_stage1: tuple[bool, ...] = (False, True)
    latency_model: tuple[str, ...] = ("analytic", "pipeline")
    dispatch: tuple[str, ...] = ("rounds",)

    def validate(self, n_tenants: int | None = None) -> None:
        legal = {"engine": ENGINES, "vc_arbitration": VC_ARBITRATIONS,
                 "interleave": INTERLEAVE_POLICIES,
                 "latency_model": LATENCY_MODELS,
                 "dispatch": DISPATCH_MODES}
        for f in fields(self):
            vals = getattr(self, f.name)
            if not vals:
                raise ValueError(f"knob axis {f.name!r} is empty")
            if len(set(vals)) != len(vals):
                raise ValueError(f"knob axis {f.name!r} repeats values: "
                                 f"{vals}")
            if f.name in legal:
                bad = set(vals) - set(legal[f.name])
                if bad:
                    raise ValueError(
                        f"knob axis {f.name!r} has illegal values "
                        f"{sorted(bad)}; expected a subset of "
                        f"{legal[f.name]}")
        if any(v < 1 for v in self.vc_count):
            raise ValueError(f"vc_count values must be >= 1, got "
                             f"{self.vc_count}")
        if any(not isinstance(v, bool) for v in self.share_aware_stage1):
            raise ValueError("share_aware_stage1 values must be bools, "
                             f"got {self.share_aware_stage1}")
        for split in self.share_split:
            if split is None:
                continue
            if any(s <= 0.0 for s in split):
                raise ValueError(f"share split {split} has a share <= 0")
            if sum(split) > 1.0 + 1e-9:
                raise ValueError(f"share split {split} sums to "
                                 f"{sum(split):.6g} > 1")
            if n_tenants is not None and len(split) != n_tenants:
                raise ValueError(
                    f"share split {split} names {len(split)} tenants; "
                    f"the target has {n_tenants}")

    def axes(self) -> dict[str, tuple]:
        """Knob name -> value tuple, in declared (descent) order."""
        return {f.name: getattr(self, f.name) for f in fields(self)}

    @property
    def size(self) -> int:
        """Number of distinct knob vectors in the space."""
        n = 1
        for vals in self.axes().values():
            n *= len(vals)
        return n

    def default(self) -> KnobConfig:
        """The descent start: the first value of every axis."""
        return KnobConfig(**{k: v[0] for k, v in self.axes().items()})

    def sample(self, rng: Random) -> KnobConfig:
        """One uniform random knob vector (the restart draw)."""
        return KnobConfig(**{k: v[rng.randrange(len(v))]
                             for k, v in self.axes().items()})


@dataclass(frozen=True)
class KnobConfig:
    """One point of a ``KnobSpace``: a concrete knob vector, with the
    projections the rest of the stack consumes (``compile_options`` for
    the static path, ``serving_config`` for the serving loop)."""

    engine: str = "list"
    vc_count: int = 1
    vc_arbitration: str = "fifo"
    share_split: tuple[float, ...] | None = None
    interleave: str = "none"
    share_aware_stage1: bool = False
    latency_model: str = "analytic"
    dispatch: str = "rounds"

    def shares_for(self, names: list[str]) -> dict[str, float] | None:
        """The ``bandwidth_shares`` dict this split assigns the named
        tenants (declaration order), or None for the fallback."""
        if self.share_split is None:
            return None
        if len(self.share_split) != len(names):
            raise ValueError(
                f"share split {self.share_split} names "
                f"{len(self.share_split)} tenants; got {len(names)}")
        return dict(zip(names, self.share_split))

    def compile_options(self) -> CompileOptions:
        # share-aware stage 1 prices tables at resolved shares, which
        # exist only under qos="wfq" (priority-proportional when no
        # explicit split is set); otherwise qos=None defers as usual
        return CompileOptions(
            engine=self.engine, interleave=self.interleave,
            latency_model=self.latency_model,
            qos="wfq" if self.share_aware_stage1 else None,
            share_aware_stage1=self.share_aware_stage1)

    def serving_config(self, names: list[str],
                       base: ServingConfig | None = None) -> ServingConfig:
        """Overlay this knob vector on a base ``ServingConfig`` (the
        serving-side knobs — horizon, seed, queues, admission — come
        from the base; the searched knobs from this vector)."""
        base = base or ServingConfig()
        return replace(base, engine=self.engine, vc_count=self.vc_count,
                       vc_arbitration=self.vc_arbitration,
                       bandwidth_shares=self.shares_for(names),
                       interleave=self.interleave,
                       qos="wfq" if self.share_aware_stage1 else None,
                       share_aware_stage1=self.share_aware_stage1,
                       latency_model=self.latency_model,
                       dispatch=self.dispatch)


# ---------------------------------------------------------------- autotune
@dataclass(frozen=True)
class TuneTrial:
    """One scored knob vector in the search trace.  ``cached`` trials
    revisited an already-evaluated vector (free: no budget spent);
    ``best_so_far`` is nonincreasing by construction — the monotonicity
    tests/test_tuning.py locks."""

    index: int
    knobs: KnobConfig
    objective_s: float
    best_so_far: float
    cached: bool


@dataclass
class TuneResult:
    """The autotune outcome: winning knob vector, its objective value,
    and the full trial trace (a pure function of the inputs — same
    target/space/budget/seed, bit-identical trace)."""

    objective: str
    best: KnobConfig
    best_objective_s: float
    trials: list[TuneTrial]
    evaluations: int              # unique vectors scored (budget spent)
    budget: int
    space: KnobSpace

    def compile_options(self) -> CompileOptions:
        return self.best.compile_options()

    def serving_config(self, names: list[str],
                       base: ServingConfig | None = None) -> ServingConfig:
        return self.best.serving_config(names, base)


def _serving_objective(result: ServingResult, objective: str,
                       tenant: str | None) -> float:
    stats = result.stats
    if tenant is not None:
        stats = {tenant: stats[tenant]}
    if objective == "p99":
        tails = [s.p99_s for s in stats.values() if s.p99_s is not None]
        return max(tails) if tails else math.inf
    served = sum(s.served for s in stats.values())
    if not served:
        return math.inf
    return sum(s.slo_violations for s in stats.values()) / served


def autotune(target: MultiTenantWorkload | list[TenantStream],
             budget: int = 25, objective: str | None = None, *,
             space: KnobSpace | None = None, seed: int = 0,
             start: KnobConfig | None = None,
             platform: DoraPlatform | None = None,
             policy: Policy | None = None,
             base_config: ServingConfig | None = None,
             objective_tenant: str | None = None) -> TuneResult:
    """Search ``space`` for the knob vector minimizing ``objective`` on
    ``target`` — a static ``MultiTenantWorkload`` (objective
    ``makespan``) or a list of ``TenantStream``s (``p99`` /
    ``slo_violations``, run through ``ServingSimulator.serve``).

    Coordinate descent from ``start`` (default: the first value of
    every axis): sweep one axis at a time in declared order, keep the
    best value, repeat until a full cycle stops improving; then restart
    from seeded random draws (``Random(seed)``) while budget remains.
    ``budget`` caps *unique* evaluations — revisiting a scored vector
    is memoized and free — so the returned trace is deterministic and
    ``best_so_far`` never regresses.  For static targets the
    ``dispatch`` axis is skipped (it only shapes the serving loop)."""
    if budget < 1:
        raise ValueError(f"budget must be >= 1, got {budget}")
    serving = isinstance(target, (list, tuple))
    if serving and not target:
        raise ValueError("autotune needs at least one TenantStream")
    if objective is None:
        objective = "p99" if serving else "makespan"
    if objective not in TUNE_OBJECTIVES:
        raise ValueError(f"unknown objective {objective!r}; expected one "
                         f"of {TUNE_OBJECTIVES}")
    if serving and objective == "makespan":
        raise ValueError("objective 'makespan' needs a static "
                         "MultiTenantWorkload target")
    if not serving and objective != "makespan":
        raise ValueError(f"objective {objective!r} needs TenantStream "
                         "targets (a serving run)")
    space = space or KnobSpace()
    if serving:
        names = [st.name for st in target]
    else:
        names = [t.name for t in target.tenants]
        if not names:
            raise ValueError("autotune needs a workload with tenants")
    space.validate(n_tenants=len(names))
    if objective_tenant is not None and objective_tenant not in names:
        raise ValueError(f"objective_tenant {objective_tenant!r} not in "
                         f"{names}")

    plat = platform or DoraPlatform.vck190()
    pol = policy or Policy.dora()
    if serving:
        sim = ServingSimulator(plat, pol)
    else:
        compiler = DoraCompiler(plat, pol)

    def score(knobs: KnobConfig) -> float:
        if serving:
            cfg = knobs.serving_config(list(names), base_config)
            return _serving_objective(sim.serve(list(target), cfg),
                                      objective, objective_tenant)
        mt = target.with_knobs(
            bandwidth_shares=knobs.shares_for(list(names)),
            interleave=knobs.interleave)
        res = compiler.compile(mt, knobs.compile_options())
        rep = compiler.simulate(res, platform=plat.with_vc(
            knobs.vc_count, knobs.vc_arbitration))
        return rep.makespan_s

    seen: dict[KnobConfig, float] = {}
    trials: list[TuneTrial] = []
    best: list = [None, math.inf]    # [knobs, objective]

    def evaluate(knobs: KnobConfig) -> float:
        cached = knobs in seen
        val = seen[knobs] if cached else score(knobs)
        seen[knobs] = val
        if val < best[1]:
            best[0], best[1] = knobs, val
        trials.append(TuneTrial(len(trials), knobs, val, best[1], cached))
        return val

    axes = space.axes()
    if not serving:
        axes.pop("dispatch")          # static targets never dispatch

    rng = Random(seed)
    cur = start or space.default()
    evaluate(cur)
    exhausted = False
    while len(seen) < budget and len(seen) < space.size and not exhausted:
        improved = False
        for axis, values in axes.items():
            if len(seen) >= budget:
                break
            cand_best, cand_val = cur, seen[cur]
            for v in values:
                cand = replace(cur, **{axis: v})
                if cand == cur:
                    continue
                if cand not in seen and len(seen) >= budget:
                    continue
                val = evaluate(cand)
                if val < cand_val - 1e-15:
                    cand_best, cand_val = cand, val
            if cand_best != cur:
                cur, improved = cand_best, True
        if not improved:
            if len(seen) >= budget:
                break
            # seeded random restart; bounded draws so a fully-explored
            # space terminates instead of spinning on cached vectors
            cur = None
            for _ in range(64):
                cand = space.sample(rng)
                if cand not in seen:
                    cur = cand
                    break
            if cur is None:
                exhausted = True
            else:
                evaluate(cur)
    return TuneResult(objective=objective, best=best[0],
                      best_objective_s=best[1], trials=trials,
                      evaluations=len(seen), budget=budget, space=space)


# -------------------------------------------------------- adaptive policy
@dataclass(frozen=True)
class ShareDecision:
    """One accepted re-weight: the new share vector (tenant declaration
    order) and the smoothed pressures that drove it.  Logged verbatim
    on the serving run (``ServingResult.reweights``, the round/event
    records), so an adaptive run replays bit-for-bit."""

    time_s: float
    shares: tuple[tuple[str, float], ...]
    pressures: tuple[tuple[str, float], ...]


@dataclass
class AdaptiveSharePolicy:
    """Expert-rule re-weighting of ``bandwidth_shares`` from observed
    telemetry.  Each tenant's *pressure* is

        queue_weight  * queue_depth
      + wait_weight   * min(1, miu_wait_s / span_s)
      + starve_weight * max(0, 1 - satisfaction)

    scaled by an SLO *urgency* factor ``(tightest_slo / slo_s) **
    urgency`` when the telemetry carries per-tenant SLOs (tenants
    without one count as slack as the loosest published SLO; a queued
    request of a tight-SLO tenant outranks the same depth behind a
    loose one — without this a steadily backlogged batch tenant
    absorbs all the share), then smoothed by an exponential moving
    average (``smoothing`` is the new-sample weight).  The desired share vector is the conserved
    total split pressure-proportionally, clamped to
    ``[min_share, max_share]``; the move toward it is capped at
    ``step`` per tenant, dropped entirely while below ``deadband``
    (hysteresis), and projected onto the ``quantum`` grid by a
    deterministic largest-remainder allocation that conserves the total
    exactly.  Hence every emitted vector satisfies the
    ``resolve_bandwidth_shares`` validity rules by construction, and on
    a constant workload the shares converge and freeze.

    One policy instance is reusable across runs: ``start`` resets all
    internal state, so a run stays a pure function of its inputs."""

    min_share: float = 0.05
    max_share: float = 0.90
    step: float = 0.15
    deadband: float = 0.04
    smoothing: float = 0.5
    quantum: float = 0.01
    queue_weight: float = 1.0
    wait_weight: float = 1.0
    starve_weight: float = 1.0
    urgency: float = 1.0

    _names: list[str] = field(default_factory=list, repr=False)
    _shares: dict[str, float] = field(default_factory=dict, repr=False)
    _ema: dict[str, float] = field(default_factory=dict, repr=False)
    _total: float = field(default=0.0, repr=False)

    def __post_init__(self) -> None:
        if not 0.0 < self.min_share <= self.max_share <= 1.0:
            raise ValueError(
                f"need 0 < min_share <= max_share <= 1, got "
                f"[{self.min_share}, {self.max_share}]")
        if self.quantum <= 0.0 or self.quantum > self.min_share:
            raise ValueError(f"quantum must be in (0, min_share], got "
                             f"{self.quantum}")
        if self.step <= 0.0 or self.deadband < 0.0:
            raise ValueError("step must be > 0 and deadband >= 0, got "
                             f"step={self.step} deadband={self.deadband}")
        if self.deadband >= self.step:
            raise ValueError(f"deadband ({self.deadband}) must stay below "
                             f"step ({self.step}) or no move ever fires")
        if not 0.0 < self.smoothing <= 1.0:
            raise ValueError(f"smoothing must be in (0, 1], got "
                             f"{self.smoothing}")
        if self.urgency < 0.0:
            raise ValueError(f"urgency must be >= 0, got {self.urgency}")

    # ------------------------------------------------------------ lifecycle
    def start(self, shares: dict[str, float]) -> dict[str, float]:
        """Reset state and adopt the initial (resolved) share vector.
        The initial total is conserved by every later decision; it must
        admit the clamps (n*min_share <= total <= n*max_share)."""
        if not shares:
            raise ValueError("adaptive policy needs at least one tenant")
        total = sum(shares.values())
        n = len(shares)
        if total > 1.0 + 1e-9:
            raise ValueError(f"initial shares sum to {total:.6g} > 1")
        if not n * self.min_share - 1e-9 <= total \
                <= n * self.max_share + 1e-9:
            raise ValueError(
                f"share total {total:.6g} cannot satisfy {n} tenants "
                f"clamped to [{self.min_share}, {self.max_share}]")
        self._names = list(shares)
        self._total = min(total, 1.0)
        self._ema = {}
        self._shares = self._project(dict(shares))
        return dict(self._shares)

    @property
    def shares(self) -> dict[str, float]:
        """The current share vector (declaration order preserved)."""
        return dict(self._shares)

    # ------------------------------------------------------------- decision
    def observe(self, time_s: float,
                telemetry: list[TenantTelemetry]) -> ShareDecision | None:
        """Feed one observation window; returns the accepted re-weight
        or None when hysteresis holds the shares still."""
        if not self._names:
            raise RuntimeError("AdaptiveSharePolicy.observe before start()")
        tele = {t.tenant: t for t in telemetry}
        missing = [n for n in self._names if n not in tele]
        if missing:
            raise ValueError(f"telemetry missing tenants {missing}")
        urg = self._urgency_factors(tele)
        for n in self._names:
            p = self._pressure(tele[n]) * urg[n]
            prev = self._ema.get(n, p)
            self._ema[n] = self.smoothing * p + (1 - self.smoothing) * prev
        psum = sum(self._ema.values())
        if psum <= 1e-12:
            return None
        cur = self._shares
        desired = {n: min(self.max_share,
                          max(self.min_share,
                              self._total * self._ema[n] / psum))
                   for n in self._names}
        move = {n: max(-self.step, min(self.step, desired[n] - cur[n]))
                for n in self._names}
        if max(abs(m) for m in move.values()) < self.deadband:
            return None
        proposed = self._project({n: cur[n] + move[n]
                                  for n in self._names})
        if all(abs(proposed[n] - cur[n]) < 1e-12 for n in self._names):
            return None
        self._shares = proposed
        return ShareDecision(
            time_s=time_s,
            shares=tuple((n, proposed[n]) for n in self._names),
            pressures=tuple((n, self._ema[n]) for n in self._names))

    # ------------------------------------------------------------- internals
    def _urgency_factors(self, tele: dict[str, TenantTelemetry]
                         ) -> dict[str, float]:
        """Per-tenant SLO urgency multipliers: ``(tightest_slo / slo) **
        urgency`` in (0, 1].  Tenants publishing no SLO count as slack
        as the loosest published one; when no tenant publishes an SLO
        (or ``urgency`` is 0) every factor is 1.0 and pressure is the
        raw signal mix."""
        known = [t.slo_s for t in tele.values()
                 if t.slo_s is not None and t.slo_s > 0.0]
        if not known or self.urgency <= 0.0 or min(known) == max(known):
            return {n: 1.0 for n in self._names}
        tight, loose = min(known), max(known)
        return {n: (tight / (tele[n].slo_s or loose)) ** self.urgency
                for n in self._names}

    def _pressure(self, t: TenantTelemetry) -> float:
        wait_frac = (min(1.0, t.miu_wait_s / t.span_s)
                     if t.span_s > 0.0 else 0.0)
        starve = max(0.0, 1.0 - t.satisfaction)
        return (self.queue_weight * t.queue_depth
                + self.wait_weight * wait_frac
                + self.starve_weight * starve)

    def _project(self, desired: dict[str, float]) -> dict[str, float]:
        """Deterministic projection onto the valid set: clamp to
        [min_share, max_share], quantize to the ``quantum`` grid, and
        conserve the total exactly via largest-remainder allocation
        (ties broken by tenant declaration order)."""
        q = self.quantum
        total_u = int(round(self._total / q))
        min_u = int(math.ceil(self.min_share / q - 1e-9))
        max_u = int(math.floor(self.max_share / q + 1e-9))
        ideal = {n: min(self.max_share,
                        max(self.min_share, desired[n])) / q
                 for n in self._names}
        units = {n: min(max_u, max(min_u, int(math.floor(ideal[n] + 1e-9))))
                 for n in self._names}
        diff = total_u - sum(units.values())
        while diff != 0:
            if diff > 0:
                # grant a quantum to the most-underfilled tenant
                cands = [n for n in self._names if units[n] < max_u]
                pick = max(cands, key=lambda n: (ideal[n] - units[n],
                                                 -self._names.index(n)))
                units[pick] += 1
                diff -= 1
            else:
                cands = [n for n in self._names if units[n] > min_u]
                pick = min(cands, key=lambda n: (ideal[n] - units[n],
                                                 self._names.index(n)))
                units[pick] -= 1
                diff += 1
        return {n: units[n] * q for n in self._names}


# ------------------------------------------------------------ trace helper
def step_trace(rps_before: float, rps_after: float, step_s: float,
               horizon_s: float, seed: int = 0,
               name: str = "tenant") -> tuple[float, ...]:
    """A seeded Poisson arrival trace whose rate steps from
    ``rps_before`` to ``rps_after`` at ``step_s`` — the shifting-mix
    scenario generator.  Seeded exactly like ``RequestStream``
    (``Random(crc32(f"{seed}:{name}"))``), so the trace is a pure
    function of its arguments and can feed ``TenantStream.trace``
    directly."""
    if rps_before <= 0 or rps_after <= 0:
        raise ValueError("step_trace rates must be > 0, got "
                         f"{rps_before}/{rps_after}")
    if not 0.0 <= step_s <= horizon_s:
        raise ValueError(f"step_s must lie in [0, horizon_s], got "
                         f"{step_s} vs {horizon_s}")
    rng = Random(zlib.crc32(f"{seed}:{name}".encode()))
    times: list[float] = []
    t = 0.0
    while True:
        t += rng.expovariate(rps_before if t < step_s else rps_after)
        if t >= horizon_s:
            break
        times.append(t)
    return tuple(times)
