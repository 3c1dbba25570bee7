"""Multi-tenant workload scheduling: compile N DNNs onto one DORA
platform as a single joint scheduling problem.

DORA's pitch is stable efficiency across workloads whose operation
counts vary ~6x (paper §1); a production deployment therefore serves
*several* scenarios at once — the Herald-style multi-DNN setting — not
one model at a time.  This module merges N ``WorkloadGraph``s (each a
*tenant* with a priority and an arrival offset) into one joint graph:

  - tensor/layer names are namespaced ``tenant::name`` so the joint
    memory map never collides;
  - layer ids are offset per tenant, keeping the joint graph
    topologically indexed (deps never cross tenants);
  - a tenant's arrival offset becomes the *release time* of all its
    layers, enforced by every stage-2 engine (list / sequential / MILP
    branch-and-bound / GA) and re-checked by ``Schedule.validate``;
  - tenant priority biases the SGS decoder's pick order among layers
    of the *same arrival*: layer k of a priority-2 tenant beats layer
    2k of a priority-1 tenant.  The knob acts on the list engine
    directly and seeds the GA's population; the MILP and sequential
    engines optimize/serialize the joint makespan and ignore it;
  - unit exclusivity *across* tenants needs no new machinery — the
    joint schedule draws from the same per-unit pools — while
    ``mmu_cap`` (forwarded to the stage-1 candidate table) optionally
    keeps any single layer from monopolizing the MMU array.

The merged problem routes through ``DoraCompiler.compile`` unchanged;
codegen tags each instruction with its tenant and the simulator reports
per-tenant makespan, tail latency, and cross-tenant MIU interference.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .graph import Layer, WorkloadGraph
from .interleave import POLICIES as INTERLEAVE_POLICIES

TENANT_SEP = "::"

# QoS policies accepted by CompileOptions.qos (None defers to the
# workload: "wfq" when it carries bandwidth_shares, "none" otherwise)
QOS_POLICIES = ("none", "wfq")

# Tenant->PE placement strategies accepted by CompileOptions.placement
# and MultiTenantWorkload.placement (consumed by mesh.DoraMeshCompiler;
# a single-PE DoraCompiler validates and ignores the knob):
#   exhaustive — branch-and-bound over every assignment (exact);
#   lpt        — longest-processing-time greedy seed refined by a
#                node-capped branch-and-bound with a lower-bound prune;
#   auto       — exhaustive while n_pes ** n_tenants stays small,
#                lpt beyond (mesh.EXHAUSTIVE_LIMIT).
PLACEMENT_STRATEGIES = ("auto", "exhaustive", "lpt")


@dataclass(frozen=True)
class TenantSpec:
    """One resident workload: a graph plus its service parameters."""

    name: str
    graph: WorkloadGraph
    priority: float = 1.0        # larger = scheduled more eagerly
    arrival_s: float = 0.0       # earliest start of any of its layers


@dataclass
class MergedWorkload:
    """The joint scheduling problem produced by ``merge()``."""

    graph: WorkloadGraph
    tenant_of: dict[int, int]            # joint layer id -> tenant index
    release: dict[int, float]            # joint layer id -> earliest start
    priorities: dict[int, float]         # joint layer id -> SGS priority
    # (tenant index, tenant-local layer id) -> joint layer id
    layer_map: dict[tuple[int, int], int]

    def layers_of(self, tenant_idx: int) -> list[int]:
        return [lid for lid, ti in self.tenant_of.items() if ti == tenant_idx]


@dataclass
class MultiTenantWorkload:
    """N tenants sharing one DORA platform.

    ``mmu_cap`` is the fairness knob: the per-layer ceiling on MMUs any
    single candidate mode may claim (None = a layer may still take the
    whole array when it is alone).

    ``interleave`` is the MIU traffic-shaping knob: the tile-granularity
    codegen pass ("none" | "rr" | "priority") that alternates the
    tenants' MIU instruction streams instead of emitting each layer's
    full tile loop contiguously — the codegen half of the virtual-channel
    subsystem ("priority" weights channels by tenant priority).  A
    ``CompileOptions.interleave`` value overrides it per compile.

    ``bandwidth_shares`` is the QoS knob: tenant name -> guaranteed
    fraction of DRAM bandwidth, consumed by the simulator's ``wfq``
    virtual-channel arbitration and by the interleave-aware schedule
    bound.  Shares must be positive and sum to <= 1; tenants left out
    split the remaining headroom in proportion to their priorities.
    Setting it makes ``CompileOptions.qos`` default to "wfq"; leaving
    it None makes QoS fall back to priority-proportional shares when
    explicitly enabled.

    ``share_aware_stage1`` is the stage-1 pricing knob: True prices each
    tenant's candidate table at its resolved bandwidth share
    (``build_candidate_table`` ``layer_shares``) so low-share tenants
    shift to smaller, less MIU-hungry tiles; False forces the classic
    full-bandwidth table; None (default) defers — on iff explicit
    ``bandwidth_shares`` are set and QoS resolves to "wfq".  A
    ``CompileOptions.share_aware_stage1`` value overrides it per
    compile.

    ``placement`` is the mesh stage-0 knob: the tenant->PE placement
    strategy (one of ``PLACEMENT_STRATEGIES``) a ``DoraMeshCompiler``
    uses when this workload is compiled onto a multi-PE ``DoraMesh``.
    None (default) defers to "auto"; a ``CompileOptions.placement``
    value overrides it per compile; a single-PE ``DoraCompiler``
    validates and ignores it.
    """

    name: str
    tenants: list[TenantSpec] = field(default_factory=list)
    mmu_cap: int | None = None
    interleave: str = "none"
    bandwidth_shares: dict[str, float] | None = None
    share_aware_stage1: bool | None = None
    placement: str | None = None

    def add_tenant(self, name: str, graph: WorkloadGraph,
                   priority: float = 1.0,
                   arrival_s: float = 0.0) -> TenantSpec:
        if any(t.name == name for t in self.tenants):
            raise ValueError(f"duplicate tenant name {name!r}")
        if priority <= 0:
            raise ValueError(f"tenant {name!r}: priority must be > 0")
        if arrival_s < 0:
            raise ValueError(f"tenant {name!r}: arrival_s must be >= 0")
        spec = TenantSpec(name, graph, priority, arrival_s)
        self.tenants.append(spec)
        return spec

    def with_knobs(self, *, bandwidth_shares: dict[str, float] | None = None,
                   interleave: str | None = None,
                   mmu_cap: int | None = None,
                   share_aware_stage1: bool | None = None,
                   placement: str | None = None
                   ) -> MultiTenantWorkload:
        """A copy of this workload with workload-level knobs replaced —
        the auto-tuner's trial surface (``tuning.autotune`` re-knobs
        one declared tenant set per trial without re-merging graphs).
        The frozen ``TenantSpec``s are shared, not copied; a None
        argument keeps the current value (shares/mmu_cap therefore
        cannot be *cleared* here — build a fresh workload for that)."""
        mt = MultiTenantWorkload(
            self.name, list(self.tenants),
            mmu_cap=self.mmu_cap if mmu_cap is None else mmu_cap,
            interleave=self.interleave if interleave is None else interleave,
            bandwidth_shares=(self.bandwidth_shares
                              if bandwidth_shares is None
                              else dict(bandwidth_shares)),
            share_aware_stage1=(self.share_aware_stage1
                                if share_aware_stage1 is None
                                else share_aware_stage1),
            placement=self.placement if placement is None else placement)
        if mt.placement is not None and mt.placement not in \
                PLACEMENT_STRATEGIES:
            raise ValueError(f"{self.name}: unknown placement strategy "
                             f"{mt.placement!r}; expected one of "
                             f"{PLACEMENT_STRATEGIES}")
        if mt.bandwidth_shares is not None:
            mt.resolve_bandwidth_shares()    # validate the new shares
        return mt

    def subset(self, indices: list[int],
               name: str | None = None) -> MultiTenantWorkload:
        """The sub-workload holding the given tenant indices (original
        declaration order) — the per-PE compile input the mesh
        placement stage hands to each PE's ``DoraCompiler``.

        Knobs are inherited; explicit ``bandwidth_shares`` keep only
        the placed tenants' entries (and collapse to None when none of
        the placed tenants had one, so a share-less sub-workload falls
        back to priority-proportional shares exactly like a fresh
        workload would).  The frozen ``TenantSpec``s are shared, not
        copied, so ``subset(range(len(tenants)))`` compiles bit-for-bit
        identically to the full workload — the N=1 mesh lock."""
        if not indices:
            raise ValueError(f"{self.name}: subset of no tenants")
        seen: set[int] = set()
        for ti in indices:
            if not 0 <= ti < len(self.tenants):
                raise ValueError(f"{self.name}: tenant index {ti} out of "
                                 f"range (have {len(self.tenants)})")
            if ti in seen:
                raise ValueError(f"{self.name}: duplicate tenant index {ti}")
            seen.add(ti)
        order = sorted(indices)
        tenants = [self.tenants[ti] for ti in order]
        shares = None
        if self.bandwidth_shares is not None:
            kept = {t.name: self.bandwidth_shares[t.name] for t in tenants
                    if t.name in self.bandwidth_shares}
            shares = kept or None
        return MultiTenantWorkload(
            self.name if name is None else name, tenants,
            mmu_cap=self.mmu_cap, interleave=self.interleave,
            bandwidth_shares=shares,
            share_aware_stage1=self.share_aware_stage1,
            placement=self.placement)

    def resolve_bandwidth_shares(self) -> dict[int, float]:
        """Tenant index -> guaranteed DRAM bandwidth fraction.

        Explicit ``bandwidth_shares`` win (validated: known tenant
        names, every share > 0, sum <= 1; unlisted tenants split the
        leftover headroom priority-proportionally).  Without explicit
        shares, every tenant's share is its priority over the priority
        sum — so a plain priority-weighted workload already has a
        well-defined guarantee."""
        if not self.tenants:
            raise ValueError(f"{self.name}: no tenants")
        names = [t.name for t in self.tenants]
        if self.bandwidth_shares is None:
            psum = sum(t.priority for t in self.tenants)
            return {ti: t.priority / psum
                    for ti, t in enumerate(self.tenants)}
        unknown = set(self.bandwidth_shares) - set(names)
        if unknown:
            raise ValueError(f"{self.name}: bandwidth_shares name "
                             f"unknown tenants {sorted(unknown)}")
        for n, s in self.bandwidth_shares.items():
            if s <= 0.0:
                raise ValueError(f"{self.name}: tenant {n!r} bandwidth "
                                 f"share must be > 0, got {s}")
        total = sum(self.bandwidth_shares.values())
        if total > 1.0 + 1e-9:
            raise ValueError(f"{self.name}: bandwidth shares sum to "
                             f"{total:.6g} > 1")
        shares = {ti: self.bandwidth_shares.get(t.name, 0.0)
                  for ti, t in enumerate(self.tenants)}
        missing = [ti for ti, s in shares.items() if s <= 0.0]
        if missing:
            rest = 1.0 - total
            if rest <= 1e-12:
                raise ValueError(
                    f"{self.name}: tenants "
                    f"{[names[ti] for ti in missing]} have no bandwidth "
                    "share and the explicit shares leave no headroom")
            psum = sum(self.tenants[ti].priority for ti in missing)
            for ti in missing:
                shares[ti] = rest * self.tenants[ti].priority / psum
        return shares

    def merge(self, extend_from: MergedWorkload | None = None
              ) -> MergedWorkload:
        """Build the joint scheduling problem.

        ``extend_from`` is the incremental-merge surface for the online
        dispatcher: a ``MergedWorkload`` previously produced by this
        method for a *prefix* of the current tenant list.  The already-
        merged tenants' namespaced layers/inputs/releases are reused
        verbatim (never re-validated, never re-copied) and only the
        newly appended tenants merge on top.  ``extend_from`` is not
        mutated — the returned workload owns fresh containers — and the
        result is bit-identical to a from-scratch ``merge()`` (a
        property test pins this)."""
        if not self.tenants:
            raise ValueError(f"{self.name}: no tenants to merge")
        if self.interleave not in INTERLEAVE_POLICIES:
            raise ValueError(f"{self.name}: unknown interleave policy "
                             f"{self.interleave!r}")
        skip = 0
        if extend_from is not None:
            prev = extend_from
            skip = 1 + max(prev.tenant_of.values(), default=-1)
            if skip > len(self.tenants):
                raise ValueError(
                    f"{self.name}: extend_from merged {skip} tenants but "
                    f"only {len(self.tenants)} are declared")
            joint = WorkloadGraph(self.name)
            joint.inputs = dict(prev.graph.inputs)
            joint.layers = list(prev.graph.layers)
            tenant_of = dict(prev.tenant_of)
            release = dict(prev.release)
            priorities = dict(prev.priorities)
            layer_map = dict(prev.layer_map)
            offset = len(prev.graph.layers)
        else:
            joint = WorkloadGraph(self.name)
            tenant_of = {}
            release = {}
            priorities = {}
            layer_map = {}
            offset = 0
        for ti, t in enumerate(self.tenants):
            if ti < skip:
                continue
            t.graph.validate()
            ns = t.graph.namespaced_copy(t.name, TENANT_SEP)
            for iname, shape in ns.inputs.items():
                if iname in joint.inputs:
                    raise ValueError(f"tensor collision {iname!r}")
                joint.inputs[iname] = shape
            for l in ns.layers:
                gid = offset + l.id
                joint.layers.append(Layer(
                    gid, l.name, l.kind, l.M, l.K, l.N, l.nonlinear,
                    l.lhs, l.rhs, tuple(d + offset for d in l.deps)))
                tenant_of[gid] = ti
                release[gid] = t.arrival_s
                # smaller = earlier: a high-priority tenant's layer k
                # outranks a low-priority tenant's layer k (ties broken
                # deterministically by joint id inside list_schedule).
                priorities[gid] = (l.id + 1.0) / t.priority
                layer_map[(ti, l.id)] = gid
            offset += len(ns.layers)
        joint.validate()
        return MergedWorkload(joint, tenant_of, release, priorities,
                              layer_map)
