"""Tile-granularity MIU interleaving: the codegen-side half of the
virtual-channel subsystem.

``codegen.generate`` emits each layer's full tile loop contiguously (the
IDU fetch order, §5.2), so in a multi-tenant program one tenant's
stalled ``MIU_LOAD`` sits at the head of the single in-order MIU stream
and blocks every other tenant's *ready* traffic — the head-of-line
blocking that gave back most of the joint scheduler's cross-tenant
overlap (a finding recorded in ROADMAP.md).  DORA's thesis is instruction-level
control of data movement, so the fix is an instruction-stream pass: this
module re-orders the flat stream at *tile* granularity, round-robin or
priority-weighted across per-tenant (or per-layer) channels, so MIU
traffic from independent layers alternates instead of arriving in one
solid block per layer.

Correctness contract — the output stream is a *permutation* of the input
that preserves:

  - every dataflow edge in ``CodegenResult.meta`` (each producer still
    precedes its consumers; dep indices are remapped to the new order);
  - every ready-list ordering (a layer's final ``MIU_STORE`` still
    precedes any ``MIU_LOAD`` naming that layer in ``body.deps``);
  - each layer's internal instruction order (the sequential functional
    runtime interprets the flat stream positionally, so intra-layer
    ping/pong WAR hazards stay resolved by order);
  - the relative order of layers whose LMU logical-group ids collide
    (group ids cycle mod ``codegen._GROUP_MOD``; interleaving two
    colliding layers would clobber each other's group buffers in the
    runtime).

The contract is re-checked on every pass application (and for any
custom permutation routed through the exported helpers):
``apply_permutation`` refuses orders that break a layer's internal
instruction order, and ``validate_stream`` re-checks the dataflow,
ready-list, group-collision, and IDU-dispatch invariants of the
resulting stream.  The property tests in ``tests/test_interleave.py``
exercise the same contract exhaustively.

Granularity: a *chunk* is one k-iteration of a layer's tile loop (the
``LOAD, LOAD, MOVE, MOVE, GEMM...`` run opened by an ``MIU_LOAD`` whose
predecessor is not an ``MIU_LOAD``), carrying any trailing SFU/STORE
instructions.  Chunks from the same layer never reorder; chunks from
different channels merge subject to the dependency constraints above.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

from .codegen import _GROUP_MOD, CodegenResult, _finalize_is_last
from .isa import OpType, Program

POLICIES = ("none", "rr", "priority")


@dataclass
class _Chunk:
    """One tile-granularity unit of reordering: original index range
    ``[start, stop)`` plus the original indices that must be emitted
    before it (cross-chunk dataflow, ready-list, and group-collision
    edges)."""

    start: int
    stop: int
    ext: list[int] = field(default_factory=list)


def plan_interleave(result: CodegenResult, policy: str = "rr",
                    priorities: dict[int, float] | None = None,
                    by: str = "auto") -> list[int]:
    """Compute the interleaved emission order (a permutation of
    ``range(len(result.program))``).

    policy: "none" (identity) | "rr" (round-robin over channels) |
        "priority" (stride scheduling weighted by ``priorities``).
    priorities: channel key -> weight (larger = more chunks early);
        channel keys are tenant indices when interleaving by tenant,
        layer ids otherwise.
    by: "tenant" | "layer" | "auto" (tenant when the program is
        tenant-tagged, layer otherwise).
    """
    if policy not in POLICIES:
        raise ValueError(f"unknown interleave policy {policy!r}; "
                         f"expected one of {POLICIES}")
    if by not in ("auto", "tenant", "layer"):
        raise ValueError(f"unknown channel granularity {by!r}")
    instrs = result.program.instructions
    meta = result.meta
    n = len(instrs)
    if policy == "none" or n == 0:
        return list(range(n))
    use_tenant = by == "tenant" or (by == "auto" and bool(result.tenant_of))
    priorities = priorities or {}

    # --- segments: maximal runs of one layer's instructions ---------------
    segments: list[list[int]] = []   # [layer_id, start, stop]
    for i, m in enumerate(meta):
        if m.layer_id < 0:
            raise ValueError(
                f"cannot interleave: instruction {i} has no layer tag")
        if segments and segments[-1][0] == m.layer_id and segments[-1][2] == i:
            segments[-1][2] = i + 1
        else:
            segments.append([m.layer_id, i, i + 1])

    # --- chunk each segment; assign chunks to channels --------------------
    channels: dict[int, list[_Chunk]] = {}
    # group-id collision guard: (last layer, last original index) per
    # logical-group base class
    last_of_group: dict[int, tuple[int, int]] = {}
    for lid, s, e in segments:
        bounds = [s]
        for j in range(s + 1, e):
            if (instrs[j].op_type == OpType.MIU_LOAD
                    and instrs[j - 1].op_type != OpType.MIU_LOAD):
                bounds.append(j)
        bounds.append(e)
        key = result.tenant_of.get(lid, -1) if use_tenant else lid
        base = (4 * lid) % _GROUP_MOD
        collide = last_of_group.get(base)
        chunks = channels.setdefault(key, [])
        for ci, (b0, b1) in enumerate(zip(bounds, bounds[1:])):
            ext: list[int] = []
            for j in range(b0, b1):
                for d in meta[j].deps:
                    if d < b0:
                        ext.append(d)
                ins = instrs[j]
                if (ins.op_type == OpType.MIU_LOAD and ins.body is not None
                        and ins.body.deps):
                    for dep_layer in ins.body.deps:
                        rs = result.ready_store.get(dep_layer)
                        if rs is None or b0 <= rs < b1:
                            continue
                        if rs > j:
                            raise ValueError(
                                f"forward ready-list edge: load {j} of layer "
                                f"{lid} depends on store {rs}")
                        ext.append(rs)
            if ci == 0 and collide is not None and collide[0] != lid:
                ext.append(collide[1])
            chunks.append(_Chunk(b0, b1, ext))
        last_of_group[base] = (lid, e - 1)

    # --- deterministic merge: rr rotation or priority stride ---------------
    chan_keys = sorted(channels)
    heads = {c: 0 for c in chan_keys}
    served = {c: 0 for c in chan_keys}
    weight = {c: float(priorities.get(c, 1.0)) for c in chan_keys}
    if any(w <= 0 for w in weight.values()):
        raise ValueError("interleave priorities must be > 0")
    emitted = bytearray(n)
    order: list[int] = []
    remaining = sum(len(v) for v in channels.values())
    rr_ptr = 0

    def _ready(ck: _Chunk) -> bool:
        return all(emitted[d] for d in ck.ext)

    while remaining:
        eligible = [c for c in chan_keys
                    if heads[c] < len(channels[c])
                    and _ready(channels[c][heads[c]])]
        if not eligible:
            raise RuntimeError(
                "interleave deadlock: no channel has a ready chunk "
                f"({remaining} chunks left)")   # unreachable on valid input
        if policy == "rr":
            pick = None
            for off in range(len(chan_keys)):
                c = chan_keys[(rr_ptr + off) % len(chan_keys)]
                if c in eligible:
                    pick = c
                    break
            rr_ptr = (chan_keys.index(pick) + 1) % len(chan_keys)
        else:   # priority: smallest stride position wins, ties by key
            pick = min(eligible, key=lambda c: ((served[c] + 1) / weight[c], c))
        ck = channels[pick][heads[pick]]
        heads[pick] += 1
        served[pick] += 1
        remaining -= 1
        for j in range(ck.start, ck.stop):
            emitted[j] = 1
            order.append(j)
    return order


def apply_permutation(result: CodegenResult, order: list[int]
                      ) -> CodegenResult:
    """Re-emit ``result`` in ``order`` (a permutation of original
    indices): instructions are copied, ``meta.deps`` and ``ready_store``
    indices remapped, and per-unit ``is_last`` flags recomputed.  The
    input result is not mutated.

    Refuses permutations that reorder a layer's internal instructions:
    the sequential runtime resolves intra-layer ping/pong WAR hazards
    positionally (``meta.deps`` encodes only depth-2 back-pressure), so
    such an order would compute wrong numerics while every recorded
    dependency still held."""
    n = len(result.program.instructions)
    if sorted(order) != list(range(n)):
        raise ValueError("order is not a permutation of the stream")
    last_of_layer: dict[int, int] = {}
    for o in order:
        lid = result.meta[o].layer_id
        if lid < 0:
            continue
        if o < last_of_layer.get(lid, -1):
            raise ValueError(
                f"order reorders layer {lid}'s internal instructions "
                f"(index {o} after {last_of_layer[lid]})")
        last_of_layer[lid] = o
    new_of_old = [0] * n
    for new, old in enumerate(order):
        new_of_old[old] = new
    prog = Program([dataclasses.replace(result.program.instructions[o],
                                        is_last=False) for o in order])
    _finalize_is_last(prog)
    meta = [dataclasses.replace(
        result.meta[o], deps=[new_of_old[d] for d in result.meta[o].deps])
        for o in order]
    ready = {lid: new_of_old[i] for lid, i in result.ready_store.items()}
    return CodegenResult(prog, result.memmap, meta, ready,
                         dict(result.tenant_of))


def validate_stream(result: CodegenResult) -> None:
    """Assert the stream invariants every backend relies on: dataflow
    producers precede consumers, ready-list stores precede the loads
    that wait on them, layers whose LMU logical-group ids collide never
    interleave (their group buffers would clobber each other in the
    sequential runtime), and the IDU dispatch (is_last) is well formed.
    Raises ValueError on violation."""
    # layers sharing a group base must appear as disjoint blocks
    open_of_base: dict[int, int] = {}      # base -> currently open layer
    closed_of_base: dict[int, set[int]] = {}
    for m in result.meta:
        if m.layer_id < 0:
            continue
        base = (4 * m.layer_id) % _GROUP_MOD
        cur = open_of_base.get(base)
        if cur != m.layer_id:
            closed = closed_of_base.setdefault(base, set())
            if m.layer_id in closed:
                raise ValueError(
                    f"layers {m.layer_id} and {cur} share logical-group "
                    f"base {base} but interleave in the stream")
            if cur is not None:
                closed.add(cur)
            open_of_base[base] = m.layer_id
    for i, m in enumerate(result.meta):
        for d in m.deps:
            if d >= i:
                raise ValueError(f"dataflow edge {d} -> {i} is not "
                                 "producer-before-consumer")
    for i, ins in enumerate(result.program.instructions):
        if ins.op_type == OpType.MIU_LOAD and ins.body is not None:
            for dep_layer in ins.body.deps:
                rs = result.ready_store.get(dep_layer)
                if rs is not None and rs >= i:
                    raise ValueError(
                        f"ready-list order violated: load {i} precedes "
                        f"store {rs} of layer {dep_layer}")
    result.program.dispatch()   # raises on instructions after is_last


def interleave_stream(result: CodegenResult, policy: str = "rr",
                      priorities: dict[int, float] | None = None,
                      by: str = "auto") -> CodegenResult:
    """The pass: plan + apply + re-validate.  Identity plans return the
    input result unchanged (no copy)."""
    order = plan_interleave(result, policy=policy, priorities=priorities,
                            by=by)
    if order == list(range(len(order))):
        return result
    out = apply_permutation(result, order)
    validate_stream(out)
    return out
